"""Per-query execution inspector: what did this query cost, and whose
device time was it?

Counterpart of the reference's ``search/query_stats.py``. A
``QueryStats`` rides a contextvar through the search path (``TempoDB``
-> batcher and coalescer -> engines -> dictionary probe and host probe),
so every search accumulates:

  - blocks scanned and skipped, with the skip reason (time_range,
    duration, dict);
  - bytes inspected on the host and on the device;
  - the staged cache as this query saw it (hbm_hit, hbm_miss_cold,
    probe_dict_staged; the port has no host-RAM tier, so never
    hbm_miss_host_hit);
  - staged bytes read, physical and logical (packed residency);
  - host stages, and per-stage device seconds attributed from its
    dispatches' profiler records (``observability/profile.py``). A fused
    dispatch splits each stage over its members by their weights
    (``apportion``), and the shares sum exactly to the dispatch's total.

A dispatch's record finishes where its outputs come to the host, and
the attribution happens then, on the thread that fetched them: for a
fused dispatch that is the first member to drain. A member that quit
early or withdrew after the flush took its query still gets its share,
so every dispatch conserves: its share is booked into its QueryStats when
the record finishes, through the fetch of another member, a later sweep,
its own ``settle`` at the end of the search, or the profiler's reaper
thread; a share that lands after the query was published is booked into
the per-tenant counters alone (``QueryStatsRegistry.book_late``).

Surfaces: ``SearchRequest.explain`` returns the breakdown as
``SearchMetrics.query_stats_json`` (the reference's keys);
``device_seconds`` always rides the metrics (the scans book
``inspected_bytes_device`` themselves, stats on or off); the registry
keeps the recent ring, per-tenant aggregates, top-K by device seconds and
by bytes, the per-tenant counters and the slow-query log.

With a database's profiling gate off no record opens: on the CPU a
dispatch's wall time (its synchronous plain call) books as its execute
stage, as the reference's does; on a CUDA device nothing books, since
the host's time to issue async launches is not the device's, and
``device_seconds`` stays 0.

Noop contract: a database with ``search_query_stats_enabled`` off creates
no QueryStats (``begin`` returns None), reads no clock for them, and
answers as with it on, ``device_seconds`` (a timing, then 0) aside. The
gate is per database; the registry is process-wide, as in the
reference.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import math
import threading
import time
from collections import deque

from ..observability import metrics as obs
from ..observability import profile
from ..observability.log import TenantTokenBucket, get_logger
from .structural import STRUCTURAL_QUERY_TAG

log = get_logger("tempo_tpu_torch.querystats")
slow_log = get_logger("tempo_tpu_torch.slowquery")

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "tempo_torch_query_stats", default=None)
# True on threads executing sub-requests for an in-process frontend: exec
# records born there suppress their own slow-query line (the frontend's
# request-scope line covers the query)
_FRONTED: contextvars.ContextVar = contextvars.ContextVar(
    "tempo_torch_query_fronted", default=False)

_TOP_K = 10  # entries kept per ranking


class QueryStats:
    """One query's accumulating record. Thread-safe: attribution arrives
    from whichever thread fetches a dispatch's outputs."""

    __slots__ = ("tenant", "scope", "query",
                 "t0", "wall_s", "blocks_inspected", "skipped",
                 "bytes_host", "bytes_device", "cache", "stages",
                 "device_stages", "h2d_bytes", "dispatches",
                 "fused_dispatches", "coalesced_with", "planner",
                 "host_probe", "subqueries", "fronted",
                 "staged_physical", "staged_logical", "structural",
                 "_open", "_published", "_lock")

    def __init__(self, tenant: str, scope: str = "exec",
                 query: dict | None = None):
        self.tenant = tenant
        self.scope = scope
        self.query = query or {}
        self.t0 = time.perf_counter()
        self.wall_s = 0.0
        self.blocks_inspected = 0
        self.skipped: dict[str, int] = {}
        self.bytes_host = 0
        self.bytes_device = 0
        self.cache: dict[str, int] = {}
        self.stages: dict[str, float] = {}         # host wall stages
        self.device_stages: dict[str, float] = {}  # attributed dispatch
        self.h2d_bytes = 0.0                       # attributed h2d share
        self.dispatches = 0
        self.fused_dispatches = 0
        self.coalesced_with = 0   # peer queries sharing my dispatches
        self.planner = {"host": 0, "device": 0, "predicted_ms": 0.0}
        self.host_probe = {"count": 0, "seconds": 0.0, "bytes": 0}
        self.staged_physical = 0
        self.staged_logical = 0
        # node id -> {op, detail, est_bytes} over this query's compiled
        # structural plans; to_dict apportions the execute seconds over
        # the byte weights (one fused kernel has no per-node timer)
        self.structural: dict | None = None
        self.subqueries = 0
        self.fronted = _FRONTED.get()
        self._open: list = []        # records this query waits on
        self._published = False
        self._lock = threading.Lock()

    # ---- recording ----

    def add_skip(self, reason: str, n: int = 1) -> None:
        with self._lock:
            self.skipped[reason] = self.skipped.get(reason, 0) + n

    def add_inspected(self, blocks: int = 0, nbytes: int = 0,
                      placement: str = "device") -> None:
        with self._lock:
            self.blocks_inspected += blocks
            if placement == "device":
                self.bytes_device += nbytes
            else:
                self.bytes_host += nbytes

    def add_cache(self, event: str, n: int = 1) -> None:
        with self._lock:
            self.cache[event] = self.cache.get(event, 0) + n

    def add_stage(self, name: str, seconds: float) -> None:
        with self._lock:
            self.stages[name] = self.stages.get(name, 0.0) + seconds

    def add_stages(self, stages: dict) -> None:
        """add_stage for each (name, seconds) of `stages`."""
        with self._lock:
            for name, seconds in stages.items():
                self.stages[name] = self.stages.get(name, 0.0) + seconds

    def add_device_stages(self, stages: dict, h2d_bytes: float = 0,
                          fused_q: int = 1, count: bool = True) -> None:
        """Fold one dispatch's (possibly apportioned) stage share in.
        `fused_q`: how many queries shared the dispatch; `count`: False
        for an addition to a dispatch already counted. A share landing
        after ``finish`` still reaches the tenant's bill."""
        with self._lock:
            for k, v in stages.items():
                self.device_stages[k] = self.device_stages.get(k, 0.0) + v
            self.h2d_bytes += h2d_bytes
            if count:
                self.dispatches += 1
                if fused_q > 1:
                    self.fused_dispatches += 1
                    self.coalesced_with += fused_q - 1
            late = self._published
        if late:
            REGISTRY.book_late(self, sum(stages.values()))

    def add_planner(self, target: str, predicted_s: float) -> None:
        with self._lock:
            self.planner[target] = self.planner.get(target, 0) + 1
            self.planner["predicted_ms"] += predicted_s * 1e3

    def add_staged(self, physical: int, logical: int) -> None:
        """Staged bytes one group's scan read: physical (as resident) and
        logical (the unpacked layout's)."""
        with self._lock:
            self.staged_physical += int(physical)
            self.staged_logical += int(logical)

    def add_host_probe(self, seconds: float, nbytes: int) -> None:
        with self._lock:
            self.host_probe["count"] += 1
            self.host_probe["seconds"] += seconds
            self.host_probe["bytes"] += nbytes

    def add_structural(self, compiled) -> None:
        """Register a compiled structural plan (one per scanned group;
        the plans of a query's groups are alike, their bytes sum)."""
        with self._lock:
            if self.structural is None:
                self.structural = {}
            for nid, op, detail in compiled.node_info:
                node = self.structural.get(nid)
                if node is None:
                    node = self.structural[nid] = {
                        "op": op, "detail": detail, "est_bytes": 0}
                node["est_bytes"] += int(compiled.node_bytes.get(nid, 0))

    def track(self, rec) -> None:
        """A dispatch record attributed to this query that had not
        finished when its launches returned (see ``settle``)."""
        with self._lock:
            self._open.append(rec)

    def settle(self) -> None:
        """Finish the detached records this query tracks (an abandoned
        dispatch, a probe whose masks fed a scan) whose launches are done,
        and hand the others to the profiler's reaper thread. Reads no
        event that has not completed, so it waits for nothing. Raises for
        records the reaper lost (``DispatchProfiler.raise_lost``)."""
        with self._lock:
            recs, self._open = self._open, []
        for rec in recs:
            rec.settle()
        profile.PROFILER.raise_lost()

    # ---- derived ----

    @property
    def device_seconds(self) -> float:
        with self._lock:
            return sum(self.device_stages.values())

    def absorb_metrics(self, m) -> None:
        """Request-scope fill from merged SearchMetrics when no explain
        breakdown travelled: totals only."""
        with self._lock:
            self.blocks_inspected += int(m.inspected_blocks)
            dev = int(m.inspected_bytes_device)
            self.bytes_device += dev
            self.bytes_host += max(0, int(m.inspected_bytes) - dev)
            if m.device_seconds:
                self.device_stages["total"] = \
                    self.device_stages.get("total", 0.0) + m.device_seconds
            if m.skipped_blocks:
                self.skipped["all"] = \
                    self.skipped.get("all", 0) + int(m.skipped_blocks)

    def merge_child(self, child: dict) -> None:
        """Fold a sub-response's explain dict into a request-scope record
        (numeric leaves sum)."""
        with self._lock:
            self.subqueries += 1
            self.blocks_inspected += int(child.get("blocks_inspected", 0))
            b = child.get("bytes_inspected") or {}
            self.bytes_host += int(b.get("host", 0))
            self.bytes_device += int(b.get("device", 0))
            self.h2d_bytes += int(child.get("h2d_bytes", 0))
            self.dispatches += int(child.get("dispatches", 0))
            self.fused_dispatches += int(child.get("fused_dispatches", 0))
            self.coalesced_with += int(child.get("coalesced_with", 0))
            for d, mine in ((child.get("skipped_blocks"), self.skipped),
                            (child.get("cache"), self.cache)):
                for k, v in (d or {}).items():
                    mine[k] = mine.get(k, 0) + v
            for d, mine in ((child.get("stages_ms"), self.stages),
                            (child.get("device_stages_ms"),
                             self.device_stages)):
                for k, v in (d or {}).items():
                    mine[k] = mine.get(k, 0.0) + v / 1e3
            sb = child.get("staged_bytes") or {}
            self.staged_physical += int(sb.get("physical", 0))
            self.staged_logical += int(sb.get("logical", 0))
            for k, v in (child.get("planner") or {}).items():
                self.planner[k] = self.planner.get(k, 0) + v
            hp = child.get("host_probe") or {}
            self.host_probe["count"] += int(hp.get("count", 0))
            self.host_probe["seconds"] += float(hp.get("ms", 0.0)) / 1e3
            self.host_probe["bytes"] += int(hp.get("bytes", 0))
            sn = (child.get("structural") or {}).get("nodes")
            if sn:
                # sub-responses share one plan (node ids are preorder
                # positions of one IR): bytes and measured shares sum
                if self.structural is None:
                    self.structural = {}
                for node in sn:
                    mine = self.structural.get(node["id"])
                    if mine is None:
                        mine = self.structural[node["id"]] = {
                            "op": node.get("op", "?"),
                            "detail": node.get("detail", ""),
                            "est_bytes": 0, "_device_ms": 0.0}
                    mine["est_bytes"] += int(node.get("est_bytes", 0))
                    mine["_device_ms"] = (mine.get("_device_ms", 0.0)
                                          + float(node.get("device_ms",
                                                           0.0)))

    def to_dict(self) -> dict:
        with self._lock:
            d = {
                "tenant": self.tenant,
                "scope": self.scope,
                "wall_ms": round((self.wall_s or
                                  (time.perf_counter() - self.t0)) * 1e3,
                                 3),
                "blocks_inspected": self.blocks_inspected,
                "skipped_blocks": dict(self.skipped),
                "bytes_inspected": {"host": self.bytes_host,
                                    "device": self.bytes_device},
                "device_seconds": round(
                    sum(self.device_stages.values()), 9),
                "device_stages_ms": {k: round(v * 1e3, 6)
                                     for k, v in
                                     self.device_stages.items()},
                "stages_ms": {k: round(v * 1e3, 3)
                              for k, v in self.stages.items()},
                "dispatches": self.dispatches,
                "fused_dispatches": self.fused_dispatches,
                "coalesced_with": self.coalesced_with,
                "h2d_bytes": int(round(self.h2d_bytes)),
                "cache": dict(self.cache),
            }
            if self.staged_physical or self.staged_logical:
                d["staged_bytes"] = {"physical": self.staged_physical,
                                     "logical": self.staged_logical}
            if self.structural:
                # the plan tree with per-node device ms: the execute total
                # apportioned over the registered byte weights
                exec_s = (self.device_stages.get("execute")
                          or sum(self.device_stages.values()))
                total_b = max(1, sum(n["est_bytes"]
                                     for n in self.structural.values()))
                d["structural"] = {
                    "nodes": [
                        {"id": nid, "op": n["op"],
                         **({"detail": n["detail"]} if n["detail"]
                            else {}),
                         "est_bytes": n["est_bytes"],
                         "device_ms": round(
                             n["_device_ms"] if "_device_ms" in n
                             else exec_s * (n["est_bytes"] / total_b)
                             * 1e3, 6)}
                        for nid, n in sorted(self.structural.items())
                    ],
                }
            if self.query:
                d["query"] = dict(self.query)
            if self.planner["host"] or self.planner["device"]:
                d["planner"] = {k: (round(v, 3) if k == "predicted_ms"
                                    else v)
                                for k, v in self.planner.items()}
            if self.host_probe["count"]:
                d["host_probe"] = {
                    "count": self.host_probe["count"],
                    "ms": round(self.host_probe["seconds"] * 1e3, 3),
                    "bytes": self.host_probe["bytes"],
                }
            if self.subqueries:
                d["subqueries"] = self.subqueries
            return d

    def finish(self) -> dict:
        """Close the record: settle its records, stamp the wall time and
        publish to the registry (counters, ring, slow log). Returns the
        final dict."""
        self.settle()
        self.wall_s = time.perf_counter() - self.t0
        return REGISTRY.publish(self)


def apportion(totals: dict, weights: list) -> list[dict]:
    """Split per-stage totals over members in proportion to `weights`,
    conserving each total exactly under any summation order. Every share
    but the last is floored to a multiple of ``math.ulp(total)`` and the
    last takes the rest: each partial sum of such shares is then a
    multiple of that ulp no larger than the total, so every addition is
    exact (Python 3.12's compensated ``sum`` included) and
    ``sum(shares) == total``. No share is negative for a total >= 0, and
    each is within one ulp of ``total * w / W``."""
    n = len(weights)
    if n == 1:
        return [dict(totals)]
    W = float(sum(weights))
    if W <= 0:
        weights, W = [1] * n, float(n)
    shares: list[dict] = [{} for _ in range(n)]
    for stage, total in totals.items():
        if not math.isfinite(total) or total == 0:
            for i in range(n - 1):
                shares[i][stage] = 0.0 * total
            shares[n - 1][stage] = total
            continue
        u = math.ulp(total)
        parts = [math.trunc(total * (weights[i] / W) / u) * u
                 for i in range(n - 1)]
        acc = 0.0
        for p in parts:
            acc += p
        # rounding in w / W could leave the floors a hair past the total;
        # take it back from the largest share (exact: multiples of u)
        while abs(acc) > abs(total):
            j = max(range(n - 1), key=lambda i: abs(parts[i]))
            step = math.copysign(min(abs(parts[j]), abs(acc) - abs(total)),
                                 total)
            parts[j] -= step
            acc -= step
        for i, p in enumerate(parts):
            shares[i][stage] = p
        shares[n - 1][stage] = total - acc
    return shares


_SlowLogLimiter = TenantTokenBucket
_STAGE_HISTS: dict = {}   # stage -> query_stage_seconds series handle


def _stage_hist(stage: str):
    h = _STAGE_HISTS.get(stage)
    if h is None:
        h = _STAGE_HISTS[stage] = obs.query_stage_seconds.labels(
            stage=stage)
    return h


class QueryStatsRegistry:
    """Process-wide sink (module singleton ``REGISTRY``): finished records
    land in a bounded ring, per-tenant aggregates, top-K rankings, the
    per-tenant counters and, past the threshold, the slow-query log. The
    gate is each database's (``begin``'s `enabled`)."""

    def __init__(self, slow_s: float = 10.0, ring_size: int = 256):
        self.slow_s = slow_s
        self._ring: deque = deque(maxlen=ring_size)
        self._lock = threading.Lock()
        # tenant -> {queries, device_seconds, bytes_host, bytes_device,
        # slow_queries}; exec scope only (request scope would count an
        # in-process query twice)
        self._tenants: dict[str, dict] = {}
        self._top_device: list[tuple] = []   # (device_seconds, dict)
        self._top_bytes: list[tuple] = []    # (bytes_total, dict)
        self._limiter = _SlowLogLimiter()
        self._published = 0

    @staticmethod
    def _top_insert(top: list, key: float, d: dict) -> None:
        if key <= 0 or (len(top) >= _TOP_K and key <= top[-1][0]):
            return
        top.append((key, d))
        top.sort(key=lambda t: t[0], reverse=True)
        del top[_TOP_K:]

    def publish(self, qs: QueryStats) -> dict:
        # everything below reads the locked snapshot `d`, never the live
        # record: a late share may still arrive on another thread
        with qs._lock:
            qs._published = True
        d = qs.to_dict()
        dev_s = d["device_seconds"]
        b = d["bytes_inspected"]
        bytes_host, bytes_device = b["host"], b["device"]
        with self._lock:
            self._published += 1
            self._ring.append(d)
            self._top_insert(self._top_device, dev_s, d)
            self._top_insert(self._top_bytes, bytes_host + bytes_device, d)
            if qs.scope == "exec":
                t = self._tenant_locked(qs.tenant)
                t["queries"] += 1
                t["device_seconds"] += dev_s
                t["bytes_host"] += bytes_host
                t["bytes_device"] += bytes_device
        if qs.scope == "exec":
            if dev_s:
                obs.query_device_seconds.inc(dev_s, tenant=qs.tenant)
            if bytes_device:
                obs.query_bytes_inspected.inc(
                    bytes_device, tenant=qs.tenant, placement="device")
            if bytes_host:
                obs.query_bytes_inspected.inc(
                    bytes_host, tenant=qs.tenant, placement="host")
            for stage, ms in d["stages_ms"].items():
                _stage_hist(stage).observe(ms / 1e3)
            for stage, ms in d["device_stages_ms"].items():
                _stage_hist("device_" + stage).observe(ms / 1e3)
        if self.slow_s > 0 and qs.wall_s >= self.slow_s:
            # one booking per query per process: an exec record under an
            # in-process frontend is covered by the request-scope one
            if qs.scope == "request" or not qs.fronted:
                obs.slow_queries.inc(tenant=qs.tenant)
                with self._lock:
                    t = self._tenants.get(qs.tenant)
                    if t is not None:
                        t["slow_queries"] += 1
                if self._limiter.allow(qs.tenant):
                    slow_log.warning("%s", json.dumps(
                        {"msg": "slow query",
                         "threshold_s": self.slow_s, **d},
                        separators=(",", ":"), sort_keys=True))
        return d

    def _tenant_locked(self, tenant: str) -> dict:
        t = self._tenants.get(tenant)
        if t is None:
            t = self._tenants[tenant] = {
                "queries": 0, "device_seconds": 0.0, "bytes_host": 0,
                "bytes_device": 0, "slow_queries": 0}
        return t

    def book_late(self, qs: QueryStats, seconds: float) -> None:
        """A device share that reached `qs` after it was published (a
        dispatch the query abandoned, finished afterwards): it goes to
        the tenant's bill, as the query's own seconds did."""
        if qs.scope != "exec" or not seconds:
            return
        with self._lock:
            self._tenant_locked(qs.tenant)["device_seconds"] += seconds
        obs.query_device_seconds.inc(seconds, tenant=qs.tenant)

    def snapshot(self, recent: int = 32) -> dict:
        with self._lock:
            return {
                "slow_query_log_s": self.slow_s,
                "published": self._published,
                "tenants": {k: dict(v, device_seconds=round(
                    v["device_seconds"], 6))
                    for k, v in sorted(self._tenants.items())},
                "top_by_device_seconds": [d for _, d in self._top_device],
                "top_by_bytes": [d for _, d in self._top_bytes],
                "recent": list(self._ring)[-recent:] if recent > 0 else [],
            }

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._tenants.clear()
            self._top_device.clear()
            self._top_bytes.clear()
            self._limiter = _SlowLogLimiter()
            self._published = 0


REGISTRY = QueryStatsRegistry()


def configure(slow_s: float | None = None,
              ring_size: int | None = None) -> QueryStatsRegistry:
    """The process-wide registry's settings: the slow-query threshold
    (<= 0: no log line) and the recent-query ring's size. The process
    owner sets them; no database does."""
    if slow_s is not None:
        REGISTRY.slow_s = float(slow_s)
    if ring_size is not None:
        with REGISTRY._lock:
            REGISTRY._ring = deque(REGISTRY._ring, maxlen=int(ring_size))
    return REGISTRY


def query_summary(req) -> dict:
    """Low-cardinality request summary for the record: the tags (the
    structural transport tag shown unquoted), the limit and the window."""
    try:
        tags = dict(req.tags)
        out = {
            "tags": tags,
            "limit": req.limit or 20,
            "window_s": ((req.end - req.start)
                         if req.end and req.start else 0),
        }
        raw = tags.pop(STRUCTURAL_QUERY_TAG, None)
        if raw is not None:
            import urllib.parse

            out["structural_q"] = urllib.parse.unquote(raw)
        return out
    except Exception:  # noqa: BLE001 -- diagnostics never fail a query
        return {}


def begin(tenant: str, req=None, scope: str = "exec",
          enabled: bool = True) -> QueryStats | None:
    """A new QueryStats when the database's gate (`enabled`) is on, else
    None: the one branch a database with stats off pays."""
    if not enabled:
        return None
    return QueryStats(tenant, scope=scope,
                      query=query_summary(req) if req is not None else {})


@contextlib.contextmanager
def activate(qs: QueryStats | None):
    """Make `qs` the active stats for the body (a contextvar; None is a
    noop), so deep layers record through ``current()``."""
    if qs is None:
        yield None
        return
    token = _ACTIVE.set(qs)
    try:
        yield qs
    finally:
        _ACTIVE.reset(token)


def current() -> QueryStats | None:
    return _ACTIVE.get()


@contextlib.contextmanager
def fronted():
    """Mark this thread as running sub-requests for an in-process
    frontend (see _FRONTED)."""
    token = _FRONTED.set(True)
    try:
        yield
    finally:
        _FRONTED.reset(token)


# per-thread count of attributions made by attributed_dispatch bodies: an
# outer context must not fall back to its wall time when an inner one
# already billed the work (a record goes to the innermost collector only)
_attr_local = threading.local()


def _attribute_to(qs: QueryStats):
    def on_record(rec) -> None:
        qs.add_device_stages(dict(rec.stages), h2d_bytes=rec.h2d_bytes)
    return on_record


def wall_is_device_time(device) -> bool:
    """Whether a dispatch body's wall time is its device time: on the CPU
    the plain versions run synchronously, so it is; on a CUDA device the
    host's time to issue async launches is not."""
    return device is not None and getattr(device, "type", device) == "cpu"


@contextlib.contextmanager
def attributed_dispatch(qs: QueryStats | None = None, device=None):
    """Attribute every profiler record opened inside the body to `qs`
    (default: the active stats), 100%, when it finishes: the non-fused
    dispatch sites. With profiling off (no record), the body's wall time
    is booked as ``execute`` only on the CPU (`device`, see
    ``wall_is_device_time``): on a CUDA device, or without a `device`
    (bodies that are mostly host work and only sometimes dispatch, as
    query compilation), nothing is. Nests: a body that runs a
    self-attributing engine (the distributed single-block engine) bills
    once."""
    qs = qs if qs is not None else current()
    if qs is None:
        yield
        return
    wall_ok = wall_is_device_time(device)
    before = getattr(_attr_local, "consumed", 0)
    t0 = time.perf_counter() if wall_ok else 0.0
    with profile.collect_records(_attribute_to(qs)) as recs:
        yield
    if recs.opened:
        for rec in recs.opened:
            if not rec.finished:
                qs.track(rec)
        _attr_local.consumed = before + 1
    elif wall_ok and getattr(_attr_local, "consumed", 0) == before:
        qs.add_device_stages({"execute": time.perf_counter() - t0})
        _attr_local.consumed = before + 1
