"""Prometheus-style metrics registry: the reference's families under
their names, types, help and buckets, so that dashboards read the same
series from either package. Families that no port code books yet stay
at zero.

Role-equivalent to the reference's promauto counters/gauges/histograms
registered at var-init in every component with `tempo_`/`tempodb_`
namespaces (SURVEY.md §5 observability), exposed in the Prometheus text
format (0.0.4) by ``Registry.expose``. Labels are per-series
(cardinality-aware: the label set lives in the series key). The
reference's OpenMetrics exemplars link buckets to self-trace spans; the
port has no self-tracing yet, so it has no exemplars.
"""

from __future__ import annotations

import threading
from bisect import bisect_left

PROM_CONTENT_TYPE = "text/plain; version=0.0.4"

# label values arrive as strings or numbers (mode="mesh", le=0.5); the
# series key is the sorted (name, value) tuple
LabelValue = str | int | float
SeriesKey = tuple[tuple[str, LabelValue], ...]


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str = "",
                 registry: "Registry | None" = None):
        self.name = name
        self.help = help_
        self._series: dict[SeriesKey, float] = {}
        self._lock = threading.Lock()
        (registry or REGISTRY)._register(self)

    def _key(self, labels: dict[str, LabelValue] | None) -> SeriesKey:
        return tuple(sorted((labels or {}).items()))

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            for key, val in sorted(self._series.items()):
                lbl = ",".join(f'{k}="{v}"' for k, v in key)
                lines.append(f"{self.name}{{{lbl}}} {val}" if lbl
                             else f"{self.name} {val}")
        return "\n".join(lines)


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: float = 1, **labels: LabelValue) -> None:
        k = self._key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0) + n

    def labels(self, **labels: LabelValue) -> "_BoundCounter":
        """Precomputed-key handle for per-span hot paths: the sorted
        label-tuple build per inc() is paid once, not per call."""
        return _BoundCounter(self, self._key(labels))

    def value(self, **labels: LabelValue) -> float:
        # locked like every writer: a bare dict read races resize-in-
        # progress under free-threading and misses published updates
        with self._lock:
            return self._series.get(self._key(labels), 0)


class _BoundCounter:
    __slots__ = ("_m", "_k")

    def __init__(self, m: Counter, k: SeriesKey):
        self._m, self._k = m, k

    def inc(self, n: float = 1) -> None:
        m = self._m
        with m._lock:
            m._series[self._k] = m._series.get(self._k, 0) + n


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, **labels: LabelValue) -> None:
        with self._lock:
            self._series[self._key(labels)] = v

    def value(self, **labels: LabelValue) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0)


class Histogram(_Metric):
    kind = "histogram"
    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)

    def __init__(self, name: str, help_: str = "",
                 buckets: tuple[float, ...] | None = None,
                 registry: "Registry | None" = None):
        super().__init__(name, help_, registry)
        self.buckets: tuple[float, ...] = tuple(
            buckets or self.DEFAULT_BUCKETS)
        self._counts: dict[SeriesKey, list[int]] = {}
        self._sums: dict[SeriesKey, float] = {}

    def observe(self, v: float, **labels: LabelValue) -> None:
        self._observe_key(self._key(labels), v)

    def _observe_key(self, k: SeriesKey, v: float) -> None:
        # counts holds per-BIN tallies (bin i = first bucket >= v, last =
        # +Inf only); expose() cumsums into the prometheus cumulative-le
        # form
        i = bisect_left(self.buckets, v)
        with self._lock:
            counts = self._counts.get(k)
            if counts is None:
                counts = self._counts[k] = [0] * (len(self.buckets) + 1)
            counts[i] += 1
            self._sums[k] = self._sums.get(k, 0) + v

    def labels(self, **labels: LabelValue) -> "_BoundHistogram":
        return _BoundHistogram(self, self._key(labels))

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            for key, counts in sorted(self._counts.items()):
                base = dict(key)
                cum = 0
                for i, b in enumerate(self.buckets):
                    cum += counts[i]
                    lbl = ",".join(f'{k}="{v}"' for k, v in
                                   sorted({**base, "le": b}.items()))
                    lines.append(f"{self.name}_bucket{{{lbl}}} {cum}")
                total = cum + counts[-1]
                lbl = ",".join(f'{k}="{v}"' for k, v in
                               sorted({**base, "le": "+Inf"}.items()))
                lines.append(f"{self.name}_bucket{{{lbl}}} {total}")
                blbl = ",".join(f'{k}="{v}"' for k, v in key)
                suffix = f"{{{blbl}}}" if blbl else ""
                lines.append(f"{self.name}_sum{suffix} {self._sums.get(key, 0)}")
                lines.append(f"{self.name}_count{suffix} {total}")
        return "\n".join(lines)


class _BoundHistogram:
    __slots__ = ("_m", "_k")

    def __init__(self, m: Histogram, k: SeriesKey):
        self._m, self._k = m, k

    def observe(self, v: float) -> None:
        self._m._observe_key(self._k, v)


class Registry:
    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, m: _Metric) -> None:
        with self._lock:
            if m.name in self._metrics:
                raise ValueError(f"metric {m.name} already registered")
            self._metrics[m.name] = m

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    def expose(self) -> str:
        """Every family in the Prometheus text format (0.0.4)."""
        with self._lock:
            metrics = list(self._metrics.values())
        return "\n".join(m.expose() for m in metrics) + "\n"


REGISTRY = Registry()

# core framework metrics (registered once, labelled per tenant/status)
ingest_spans = Counter("tempo_distributor_spans_received_total",
                       "spans received by the distributor")
ingest_bytes = Counter("tempo_distributor_bytes_received_total",
                       "bytes received by the distributor")
push_failures = Counter("tempo_distributor_push_failures_total",
                        "failed pushes")
live_traces = Gauge("tempo_ingester_live_traces", "live traces per tenant")
flush_failures = Counter("tempo_ingester_failed_flushes_total",
                         "block completions that failed and were backed off")
blocks_completed = Counter("tempo_ingester_blocks_completed_total",
                           "blocks completed to the backend")
query_seconds = Histogram("tempo_query_seconds", "query latency")
search_inspected = Counter("tempo_search_inspected_traces_total",
                           "traces inspected by search")
compactions = Counter("tempodb_compaction_runs_total", "compaction runs")
retention_deleted = Counter("tempodb_retention_deleted_total",
                            "blocks hard-deleted by retention")
scan_dispatches = Counter("tempo_search_scan_dispatches_total",
                          "device scan kernel dispatches")
batch_cache_events = Counter("tempo_search_batch_cache_events_total",
                             "staged-batch HBM cache hits/misses/evictions")
coalesced_queries = Counter(
    "tempo_search_coalesced_queries_total",
    "queries served through fused multi-query scan dispatches; the "
    "coalesce ratio is this over scan_dispatches{mode=coalesced}")
coalesce_wait_seconds = Histogram(
    "tempo_search_coalesce_wait_seconds",
    "time a query spent waiting in the coalescing window before its "
    "fused dispatch launched",
    buckets=(0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1))
fallback_scans = Counter("tempo_search_fallback_scans_total",
                         "trace-block proto scans for blocks lacking "
                         "search data")
truncated_tag_entries = Counter(
    "tempo_search_truncated_entries_total",
    "entries whose tag set exceeded the kv-slot capacity at block build")

# ---- dispatch profiler (observability/profile.py) ----
dispatch_stage_seconds = Histogram(
    "tempo_search_dispatch_stage_seconds",
    "per-dispatch stage wall time: stage=build|h2d|compile|execute|d2h|"
    "lock_wait, mode=single|batched|coalesced|mesh|dict_probe|host_probe",
    buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1,
             5, 30))
jit_cache_events = Counter(
    "tempo_search_jit_cache_events_total",
    "dispatch-shape compile-cache outcomes (result=hit|miss); a miss "
    "means that dispatch paid XLA trace+compile")
h2d_bytes = Counter("tempo_search_h2d_bytes_total",
                    "bytes staged host->device (pages, dictionaries, "
                    "query tables)")
d2h_bytes = Counter("tempo_search_d2h_bytes_total",
                    "bytes fetched device->host (scan results/demux)")
hbm_cache_bytes = Gauge("tempo_search_hbm_cache_bytes",
                        "staged-batch HBM cache occupancy (bytes)")
host_cache_bytes = Gauge("tempo_search_host_cache_bytes",
                         "host-RAM stacked-batch tier occupancy (bytes)")
probe_dict_bytes = Gauge("tempo_search_probe_dict_bytes",
                         "HBM held by staged device-probe dictionaries "
                         "across resident batches (bytes)")
hbm_logical_bytes = Gauge("tempo_search_hbm_logical_bytes",
                          "unpacked-layout equivalent of the staged-batch "
                          "HBM occupancy — equals tempo_search_hbm_cache_"
                          "bytes unless search_packed_residency narrows "
                          "the resident columns")
host_logical_bytes = Gauge("tempo_search_host_logical_bytes",
                           "unpacked-layout equivalent of the host-RAM "
                           "stacked-batch tier occupancy")
coalesce_pending = Gauge("tempo_search_coalesce_pending_queries",
                         "queries parked in coalescing windows right now "
                         "(the coalescer queue depth)")
structural_stack_events = Counter(
    "tempo_search_structural_stack_events_total",
    "structural-query stacking outcomes at coalescer flush: "
    "result=stacked (member of a fused same-plan dispatch), "
    "stacked_bucketed (member of a fused MIXED-plan dispatch whose "
    "plans canonicalized into one bucket shape — "
    "search_structural_bucket_enabled), solo_shape (no peer shared "
    "the plan shape within the window), solo_disabled "
    "(search_structural_stack_enabled off) — unstackable plan shapes "
    "are visible here instead of silently flushing solo")

# ---- hot-tier live search (search/live_tier.py) ----
live_tier_entries = Gauge(
    "tempo_search_live_tier_entries",
    "in-flight traces held in the hot tier's per-tenant live stage "
    "(absorbed at push, evicted at cut)")
live_tier_scans = Counter(
    "tempo_search_live_tier_scans_total",
    "hot-tier live-stage scan outcomes (result=scan: answered by the "
    "fused kernel; fallback_overflow: stage past "
    "search_live_tier_max_entries, legacy walk ran; fallback: scan "
    "declined, legacy walk ran)")
live_tier_rebuilds = Counter(
    "tempo_search_live_tier_rebuilds_total",
    "columnar stage rebuilds (one per absorbed/evicted epoch actually "
    "searched — consecutive mutations between searches coalesce into "
    "one rebuild)")
live_tier_evictions = Counter(
    "tempo_search_live_tier_evictions_total",
    "entries leaving the live stage (reason=cut: trace cut to the WAL "
    "head, where the hot scan still covers it)")
live_tail_subscriptions = Gauge(
    "tempo_search_live_tail_subscriptions",
    "standing tail subscriptions registered per tenant")
live_tail_notifications = Counter(
    "tempo_search_live_tail_notifications_total",
    "tail notifications delivered to standing-query subscribers")
live_tail_dropped = Counter(
    "tempo_search_live_tail_dropped_total",
    "tail notifications/registrations dropped per tenant (reason=queue: "
    "a slow consumer's bounded queue overflowed, oldest dropped; cap: "
    "subscribe rejected at search_live_tail_max_subscriptions)")

# ---- SSE streaming surfaces (api/http.py /api/search/stream, /api/tail)
sse_active_streams = Gauge(
    "tempo_sse_active_streams",
    "SSE responses currently being written per tenant "
    "(endpoint=search_stream|tail) — live-tail SUBSCRIPTIONS are "
    "tempo_search_live_tail_subscriptions; this counts the HTTP legs, "
    "including ones draining after their subscription lapsed")
sse_events_streamed = Counter(
    "tempo_sse_events_total",
    "SSE events written to clients per tenant "
    "(endpoint=search_stream|tail, event = the SSE event name: "
    "result|trace|summary|subscribed|end|error|keepalive)")

# ---- device-side aggregate analytics (search/analytics.py) ----
search_analytics_dispatches = Counter(
    "tempo_search_analytics_dispatches_total",
    "aggregate-analytics count dispatches (route=device: the dense "
    "count kernel ran on the accelerator; host: breaker-open or "
    "overflow fallback computed the byte-identical numpy counts)")
search_analytics_staged_bytes = Gauge(
    "tempo_search_analytics_staged_bytes",
    "bytes staged to the device for the most recent analytics "
    "micro-batch (pow2-tier padded row columns)")
# ---- owner-routed HBM (search/ownership.py) ----
hbm_owner_generation = Gauge(
    "tempo_search_hbm_owner_generation",
    "ownership-map membership generation this process placed against; "
    "fleet members disagreeing here are mid-rebalance")
hbm_owner_groups = Gauge(
    "tempo_search_hbm_owner_groups",
    "placement groups this member owns under the current generation")
hbm_owner_rebalance_moves = Counter(
    "tempo_search_hbm_owner_rebalance_moves_total",
    "placement groups whose owner changed at a membership generation "
    "bump — the rebalance is a placement diff, never a cache flush")
hbm_owner_routed = Counter(
    "tempo_search_hbm_owner_routed_total",
    "batcher group routing decisions while ownership is enabled "
    "(route=owner|non_owner_host: device-resident serve vs the "
    "byte-identical host route on a non-owner)")
hbm_owner_rebalance_evictions = Counter(
    "tempo_search_hbm_owner_rebalance_evictions_total",
    "HBM batches released because a rebalance moved their group away "
    "(result=dropped|deferred; deferred batches drop at unpin)")
hbm_replica_promotions = Counter(
    "tempo_search_hbm_replica_promotions_total",
    "heat-table replica-set transitions (dir=up: a placement group's "
    "access rate crossed search_hbm_ownership_hot_rate and promoted to "
    "its rf-deep replica set; dir=down: rate decayed below the "
    "hysteresis floor and the group demoted back to its single owner)")
hedged_dispatches = Counter(
    "tempo_search_hedged_dispatches_total",
    "frontend hedged-dispatch outcomes over promoted groups "
    "(result=primary: primary answered inside the hedge delay; "
    "hedge_won: the replica's duplicate answered first; cancelled: a "
    "losing in-flight attempt was expired through its deadline)")

# ---- offload planner (search/planner.py) ----
offload_decisions = Counter(
    "tempo_search_offload_decisions_total",
    "offload-planner probe placements (target=host|device, "
    "site=stage|compile|offline); only counted while the planner is "
    "enabled — the static-threshold path books nothing")
offload_predict_error = Histogram(
    "tempo_search_offload_predict_error_ratio",
    "relative |predicted - actual| / actual of the planner's chosen-side "
    "probe cost, resolved when the matching probe run is observed",
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0))

# ---- per-query execution inspector (search/query_stats.py) ----
query_device_seconds = Counter(
    "tempo_search_query_device_seconds_total",
    "device-seconds attributed to queries per tenant: fused coalesced "
    "dispatches apportion their stage times across member queries by "
    "padded predicate rows (shares sum to the dispatch total), so this "
    "is the fleet's device-time bill by tenant")
query_bytes_inspected = Counter(
    "tempo_search_query_bytes_inspected_total",
    "bytes inspected by queries per tenant, split by placement=device "
    "(scan kernels over staged batches) vs placement=host (fallback "
    "proto scans, host dictionary probes)")
query_stage_seconds = Histogram(
    "tempo_search_query_stage_seconds",
    "per-QUERY stage wall time: host stages (header_prune|staging|"
    "prepare|dispatch|drain|fallback_scan) plus attributed device "
    "stages (device_build|device_h2d|device_compile|device_execute|"
    "device_d2h|device_lock_wait); exemplars link buckets to "
    "self-traces",
    buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1,
             5, 30))
slow_queries = Counter(
    "tempo_search_slow_queries_total",
    "queries slower than search_slow_query_log_s per tenant, booked "
    "ONCE per query per process (in-process sub-requests of a slow "
    "request don't re-count); the log line is additionally rate-limited "
    "per tenant")

# ---- write-path telemetry (observability/ingest_telemetry.py) ----
ingest_stage_seconds = Histogram(
    "tempo_ingest_stage_seconds",
    "write-path stage latency: stage=push_ack (distributor accept+"
    "replicate wall time) | live_cut (trace first-push -> cut into the "
    "WAL head) | block_cut (head-block age when cut for completion) | "
    "flush (block cut -> backend flush success, queue wait included) | "
    "flush_write (the backend completion write itself) | poll_visible "
    "(flush success -> first poll that lists the block) | "
    "push_to_searchable (oldest trace push -> poll visibility, the "
    "end-to-end freshness a reader actually experiences)",
    buckets=(0.001, 0.005, 0.025, 0.1, 0.5, 1, 5, 15, 60, 300, 1800))
search_freshness = Gauge(
    "tempo_search_freshness_seconds",
    "per-tenant search staleness: now - max end_time over the tenant's "
    "newest SEARCHABLE (polled) block; refreshed every poll cycle")
oldest_unflushed = Gauge(
    "tempo_ingest_oldest_unflushed_seconds",
    "per-tenant age of the oldest trace not yet flushed to the backend "
    "— live (uncut), WAL head, or completing blocks; 0 when everything "
    "is flushed")
flush_duration_seconds = Histogram(
    "tempo_ingester_flush_duration_seconds",
    "successful block completion (WAL -> backend) wall time per flush",
    buckets=(0.01, 0.05, 0.25, 1, 5, 30, 120, 600))
flush_queue_length = Gauge(
    "tempo_ingester_flush_queue_length",
    "per-tenant blocks cut and waiting for (or in) backend completion")
flush_retries = Counter(
    "tempo_ingester_flush_retries_total",
    "flush attempts that failed and were backed off, labeled by "
    "attempt bucket (attempt=1|2|3|4+) — distinguishes a one-off "
    "backend flake from a block stuck in exponential backoff")
wal_replay_seconds = Gauge(
    "tempo_ingester_wal_replay_seconds",
    "duration of the WAL replay this process performed at startup")
wal_replayed_blocks = Gauge(
    "tempo_ingester_wal_replayed_blocks",
    "WAL blocks replayed at startup")
wal_replayed_bytes = Gauge(
    "tempo_ingester_wal_replayed_bytes",
    "WAL bytes re-scanned at startup")
slow_flushes = Counter(
    "tempo_ingester_slow_flushes_total",
    "flushes slower than ingest_slow_flush_log_s per tenant (every one "
    "counts; the JSON log line is additionally rate-limited per tenant)")
blocklist_poll_seconds = Histogram(
    "tempodb_blocklist_poll_duration_seconds",
    "blocklist poll cycle wall time (backend list + meta reads + apply)",
    buckets=(0.005, 0.025, 0.1, 0.5, 2, 10, 60, 300))
blocklist_length = Gauge(
    "tempodb_blocklist_length",
    "per-tenant live blocks in this reader's blocklist after the last "
    "poll")
blocklist_index_age = Gauge(
    "tempodb_blocklist_index_age_seconds",
    "per-tenant age of the tenant index this poller last consumed "
    "(now - builder created_at); a growing value means the elected "
    "index builder stopped writing")
compaction_duration_seconds = Histogram(
    "tempodb_compaction_duration_seconds",
    "one compaction run (k-way merge + search rebuild) wall time",
    buckets=(0.05, 0.25, 1, 5, 30, 120, 600))
compaction_outstanding_bytes = Gauge(
    "tempodb_compaction_outstanding_bytes",
    "per-tenant bytes sitting in compactable input groups (>= "
    "min_inputs same-window blocks) — the compactor's input backlog")
compaction_outstanding_blocks = Gauge(
    "tempodb_compaction_outstanding_blocks",
    "per-tenant block count behind "
    "tempodb_compaction_outstanding_bytes — backlog in selector units "
    "(one run consumes at most compaction_max_inputs of these)")
canary_freshness = Gauge(
    "tempo_ingest_canary_freshness_seconds",
    "last MEASURED push->searchable latency of the synthetic ingest "
    "canary (black-box: a real push polled through real search)")
canary_failures = Counter(
    "tempo_ingest_canary_failures_total",
    "canary probes that never became searchable before their deadline "
    "— the wedged-flush/poll alarm")

# ---- robustness: breaker / watchdog / fault injection ----
device_faults = Counter(
    "tempo_search_device_faults_total",
    "device dispatch faults booked into the circuit breaker "
    "(kind=timeout|error|lock_timeout, mode = the profiler dispatch "
    "mode giving the fault its stage context); counted even with the "
    "breaker disabled")
breaker_transitions = Counter(
    "tempo_search_device_breaker_transitions_total",
    "circuit-breaker state transitions (from/to = "
    "closed|open|half_open); open means every scan/probe is routed "
    "through the byte-identical host path")
breaker_state = Gauge(
    "tempo_search_device_breaker_state",
    "current breaker state as a code: 0=closed 1=half_open 2=open")
dispatch_lock_timeouts = Counter(
    "tempo_search_dispatch_lock_timeouts_total",
    "bounded waits on the process-wide collective dispatch lock that "
    "timed out — some dispatch is wedged while holding it (each books "
    "a breaker fault kind=lock_timeout)")
partial_results = Counter(
    "tempo_search_partial_results_total",
    "sub-answers swallowed into a DEGRADED response, by why "
    "(reason=replica|backend|subrequest|deadline), booked at the "
    "swallow site — a failure past tolerate_failed_blocks still "
    "counts here even though the request then errors. The "
    "response-level twin is SearchMetrics.partial, which survives the "
    "frontend merge so a degraded answer is never indistinguishable "
    "from a complete one")
faults_injected = Counter(
    "tempo_robustness_faults_injected_total",
    "fault-injection firings per faultpoint (chaos/test harness only; "
    "always zero in production unless a faultpoint is armed)")

# ---- self-tracing health (the port has no self-tracing yet: zero) ----
selftrace_dropped_spans = Counter(
    "tempo_selftrace_dropped_spans_total",
    "self-trace spans dropped because the batch processor queue was "
    "full, labeled by exporter class like selftrace_export_failures — "
    "and the SINGLE source of truth: BatchProcessor.dropped derives "
    "from this series")
selftrace_export_failures = Counter(
    "tempo_selftrace_export_failures_total",
    "self-trace export batches that raised (swallowed to protect the "
    "flush loop; this counter is the only visible signal)")

# ---- build identity ----
build_info = Gauge(
    "tempo_build_info",
    "constant 1; the process's build/runtime identity rides the labels "
    "(version = tempo_tpu package version, jax = jax version or "
    "'absent', backend = initialized jax backend or "
    "uninitialized/unknown at set time, native = native libtempotpu.so "
    "state: loaded|present|absent|unknown) — the standard *_build_info "
    "idiom, set once at App init and mirrored live in /status")
