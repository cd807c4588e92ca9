"""The live tier: search over traces that are not yet in a backend block.

Counterpart of the reference's ``search/live_tier.py``. A tenant's
in-flight traces (absorbed as encoded ``SearchData``, one push member at a
time) live in a rolling stage; the WAL head (``streaming.py``
``StreamingSearchBlock``) scans its entries through the same
``scan_search_data``. A search builds the stage's columnar container
(``ColumnarPages.build``) only when the entry set's epoch moved since the
last build, pads its page axis to a power of two (the ``tier``), copies it
to the database's device, and runs B9 there (``kernels/live.py``
``hot_scan``: K1s and K2 over the live pages, K6 first for a structural
request).

Differences from the reference, all deliberate:

- ``LiveTier`` belongs to one database (``TempoDB.live_tier``, configured
  from its ``search_live_*`` fields), not to the process.
- The scan runs on that database's device; the reference pins it to
  JAX's CPU backend.
- Each build is published as one immutable ``_StageRecord`` (epoch, host
  pages, device columns, span columns, tier) in one assignment, so two
  searches racing a rebuild never mix one epoch's pages with another's
  columns.
- The reference's Prometheus counters are kept, with their names and
  labels, in ``LiveTier.stats()``.

Two host routes stay as the reference has them. Past ``max_entries`` a
tenant's ``search`` declines (returns False): the walk that follows is the
caller's. Tail subscriptions are evaluated per push member on the host
(``data.search_data_matches``); no kernel runs for one entry. A fault in
the hot scan is never caught: it raises, and nothing walks.

With the gate off (the default) every hook reads one attribute and
returns.
"""

from __future__ import annotations

import dataclasses
import struct
import threading
import time
from collections import deque

from ..device import resolve_device
from .columnar import ColumnarPages
from .data import (SearchData, clone_search_data, decode_search_data,
                   search_data_matches)
from . import structural
from .engine import ScanEngine, StagedPages, fetch_scan_out, stage
from .kernels.live import hot_scan
from .multiblock import place_spans
from .pipeline import compile_query


class LiveStats:
    """The live tier's counters and gauges, keyed as Prometheus prints a
    series: ``name{label="value",...}`` with the labels sorted."""

    def __init__(self):
        self._lock = threading.Lock()
        self._v: dict[str, int] = {}

    @staticmethod
    def _key(name: str, labels: dict) -> str:
        if not labels:
            return name
        return name + "{" + ",".join(
            f'{k}="{labels[k]}"' for k in sorted(labels)) + "}"

    def inc(self, name: str, n: int = 1, **labels) -> None:
        k = self._key(name, labels)
        with self._lock:
            self._v[k] = self._v.get(k, 0) + n

    def set(self, name: str, v: int, **labels) -> None:
        with self._lock:
            self._v[self._key(name, labels)] = v

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._v)


@dataclasses.dataclass(frozen=True)
class _StageRecord:
    """One epoch's stage, never changed once published: the host pages
    (which render results), the device columns padded to `tier` pages
    (span segment staged or not), and what the build cost."""
    epoch: int
    pages: ColumnarPages
    staged: StagedPages
    tier: int
    spans_staged: bool
    build_s: float      # ColumnarPages.build, on the host
    copy_s: float       # padding and copy to the device (spans too)


class _HotStage:
    """The epoch-cached stage of one entry set. ``ensure`` builds only
    when the epoch moved; a structural request stages the span segment
    of the current build once. Publishing is one assignment under a
    small lock, and an older epoch's build never replaces a newer one."""

    def __init__(self):
        self._lock = threading.Lock()
        self.record: _StageRecord | None = None

    def ensure(self, entries: list[SearchData], epoch: int, device,
               spans: bool, stats: LiveStats) -> _StageRecord:
        rec = self.record
        if rec is not None and rec.epoch == epoch:
            if rec.spans_staged or not spans:
                return rec
            t0 = time.perf_counter()
            span_dev, max_run = place_spans(
                structural.stage_single(rec.pages, rec.tier), device)
            rec = dataclasses.replace(
                rec, staged=dataclasses.replace(
                    rec.staged, span_device=span_dev, span_max_run=max_run),
                spans_staged=True,
                copy_s=rec.copy_s + time.perf_counter() - t0)
        else:
            t0 = time.perf_counter()
            pages = ColumnarPages.build(entries)
            t1 = time.perf_counter()
            # the host-only compile never probes on the device, so no
            # dictionary stages (probe_min_vals 0)
            sp = stage(pages, device, probe_min_vals=0, spans=spans)
            rec = _StageRecord(
                epoch=epoch, pages=pages, staged=sp,
                tier=int(sp.device["kv_key"].shape[0]), spans_staged=spans,
                build_s=t1 - t0, copy_s=time.perf_counter() - t1)
            stats.inc("live_tier_rebuilds")
        with self._lock:
            if self.record is None or self.record.epoch <= epoch:
                self.record = rec
        return rec


def scan_search_data(entries: list[SearchData], req, results,
                     hot: _HotStage, epoch: int, live: "LiveTier") -> bool:
    """Answer `req` over an entry set (in trace-id order) with B9 on
    `live`'s device: the replacement for the per-entry
    ``search_data_matches`` walk, the same answer as a backend block
    holding these entries. The request compiles on the host against the
    stage's dictionaries (a prune returns with no launch and nothing
    inspected), a structural request against the stage's spans. Returns
    True: the request was answered and `results` updated. A structural
    request with the database's gate off raises ValueError first."""
    expr = structural.structural_query(req, live.structural_cfg)
    if not entries:
        return True
    engine = live.engine
    rec = hot.ensure(entries, epoch, engine.device, expr is not None,
                     live.counters)
    pages = rec.pages
    cq = compile_query(pages.key_dict, pages.val_dict, req,
                       cache_on=pages, cache=engine.compile_cache)
    if cq is None:      # the dictionaries prune: no entry can match
        return True
    if expr is not None:
        cq.structural = structural.compile_structural(
            expr, [pages], entry_kv_slots=pages.geometry.kv_per_entry)
    _count, inspected, scores, idx = fetch_scan_out(
        hot_scan(engine, rec.staged, pages.n_pages, cq))
    results.metrics.inspected_traces += inspected
    for m in engine.results(rec.staged, cq, scores, idx):
        results.add(m)
    return True


class TailSubscription:
    """One standing query: a bounded notification queue that drops its
    oldest notification when full (a slow consumer sees `dropped` rise;
    the push path never blocks)."""

    def __init__(self, tenant: str, req, stats: LiveStats,
                 max_queue: int = 256):
        self.tenant = tenant
        self.req = req
        self.dropped = 0
        self.closed = False
        self._q: deque = deque()
        self._max_queue = max_queue
        self._stats = stats
        self._cond = threading.Condition()

    def offer(self, meta) -> None:
        with self._cond:
            if self.closed:
                return
            if len(self._q) >= self._max_queue:
                self._q.popleft()
                self.dropped += 1
                self._stats.inc("live_tail_dropped", reason="queue",
                                tenant=self.tenant)
            self._q.append(meta)
            self._cond.notify_all()

    def poll(self, timeout_s: float | None = None) -> list:
        """Drain what is queued, waiting up to timeout_s for the first
        notification. [] on timeout or once closed."""
        with self._cond:
            if not self._q and not self.closed:
                self._cond.wait(timeout_s)
            out = list(self._q)
            self._q.clear()
            return out

    def close(self) -> None:
        with self._cond:
            self.closed = True
            self._cond.notify_all()


class _TenantHot:
    def __init__(self):
        self.entries: dict[bytes, SearchData] = {}   # live (uncut) traces
        self.epoch = 0
        # the entries in trace-id order as of epoch `sorted_epoch`: a list
        # replaced, never changed, so a search reads it outside the lock
        self.sorted: list[SearchData] = []
        self.sorted_epoch = 0
        self.stage = _HotStage()
        self.visible: set[str] = set()   # poll-visible backend block ids
        self.subs: list[TailSubscription] = []


class LiveTier:
    """One database's live tier: its gate, the per-tenant rolling stages
    and the tail subscriptions. `device` is where stages live and B9
    runs: ``cuda`` unless the caller passes one (``cpu`` runs the plain
    version). `structural_cfg` is the database's structural gate; the
    gate and the caps are TempoDBConfig's search_live_tier_enabled,
    search_live_tier_max_entries and
    search_live_tail_max_subscriptions."""

    def __init__(self, device=None,
                 structural_cfg: structural.StructuralConfig = structural.OFF,
                 enabled: bool = False, max_entries: int = 4096,
                 max_subscriptions: int = 16):
        self.device = resolve_device(device)
        self.structural_cfg = structural_cfg
        self.engine = ScanEngine(self.device)
        self.counters = LiveStats()
        self.enabled = bool(enabled)
        self.max_entries = int(max_entries)
        self.max_subscriptions = int(max_subscriptions)
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantHot] = {}

    def stats(self) -> dict:
        """The reference's counters and gauges by series (LiveStats):
        live_tier_entries{tenant}, live_tier_scans{result=scan|fallback|
        fallback_overflow}, live_tier_rebuilds, live_tier_evictions{
        reason=cut}, live_tail_subscriptions{tenant},
        live_tail_notifications{tenant}, live_tail_dropped{reason=queue|
        cap, tenant}."""
        return self.counters.snapshot()

    def stage_record(self, tenant: str) -> _StageRecord | None:
        """The tenant's newest published stage, or None."""
        with self._lock:
            t = self._tenants.get(tenant)
        return None if t is None else t.stage.record

    def _tenant(self, tenant: str) -> _TenantHot:
        t = self._tenants.get(tenant)
        if t is None:
            t = self._tenants[tenant] = _TenantHot()
        return t

    # ---- ingest-side hooks

    def absorb(self, tenant: str, trace_id: bytes, raw: bytes) -> None:
        """Absorb one push member (encoded SearchData) into the tenant's
        live set, merged copy-on-write into an earlier member of the same
        trace. Bytes that do not decode are dropped, as the ingester's
        lazy decode drops them."""
        if not self.enabled:
            return
        if not raw:
            return
        try:
            sd = decode_search_data(raw, trace_id)
        except (struct.error, IndexError):   # bytes that do not decode
            return
        with self._lock:
            t = self._tenant(tenant)
            prev = t.entries.get(trace_id)
            if prev is not None:
                merged = clone_search_data(prev)
                merged.merge(sd)
                t.entries[trace_id] = merged
            else:
                t.entries[trace_id] = sd
            t.epoch += 1
            n = len(t.entries)
        self.counters.set("live_tier_entries", n, tenant=tenant)

    def mark_cut(self, tenant: str, trace_ids) -> None:
        """Cut traces leave the live set (the WAL head answers for them
        now)."""
        if not self.enabled:
            return
        with self._lock:
            t = self._tenants.get(tenant)
            if t is None:
                return
            evicted = sum(t.entries.pop(tid, None) is not None
                          for tid in trace_ids)
            if evicted:
                t.epoch += 1
            n = len(t.entries)
        if evicted:
            self.counters.inc("live_tier_evictions", evicted, reason="cut")
            self.counters.set("live_tier_entries", n, tenant=tenant)

    def drop_tenant(self, tenant: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._tenants.pop(tenant, None)

    # ---- poll visibility (fed by TempoDB.poll)

    def mark_poll_visible(self, metas_by_tenant: dict) -> None:
        """Record the backend blocks a poll made visible, so the
        ingester's recently-flushed leg can retire them early."""
        if not self.enabled:
            return
        with self._lock:
            for tenant, ms in metas_by_tenant.items():
                self._tenant(tenant).visible = {m.block_id for m in ms}

    def poll_visible(self, tenant: str, block_id: str) -> bool:
        if not self.enabled:
            return False
        with self._lock:
            t = self._tenants.get(tenant)
            return t is not None and block_id in t.visible

    # ---- search

    def search(self, tenant: str, req, results) -> bool:
        """Scan the tenant's live set with B9. True: answered (the
        caller runs no walk). False: the gate is off, or the live set is
        past max_entries (the caller walks; counted as
        fallback_overflow)."""
        if not self.enabled:
            return False
        with self._lock:
            t = self._tenants.get(tenant)
            if t is not None and len(t.entries) > self.max_entries:
                self.counters.inc("live_tier_scans",
                                result="fallback_overflow")
                return False
            entries, epoch, hot = [], 0, None
            if t is not None:
                if t.sorted_epoch != t.epoch:
                    t.sorted = [t.entries[tid] for tid in sorted(t.entries)]
                    t.sorted_epoch = t.epoch
                entries, epoch, hot = t.sorted, t.epoch, t.stage
        handled = scan_search_data(entries, req, results, hot, epoch, self)
        if entries:
            self.counters.inc("live_tier_scans",
                            result="scan" if handled else "fallback")
        return handled

    # ---- tail subscriptions

    def subscribe(self, tenant: str, req,
                  max_queue: int = 256) -> TailSubscription | None:
        """Register a standing query; None when the gate is off or the
        tenant is at its cap. A structural query with the database's
        gate off raises ValueError here, not at a push."""
        if not self.enabled:
            return None
        structural.structural_query(req, self.structural_cfg)
        with self._lock:
            t = self._tenant(tenant)
            t.subs = [s for s in t.subs if not s.closed]
            if len(t.subs) >= self.max_subscriptions:
                self.counters.inc("live_tail_dropped", reason="cap",
                                tenant=tenant)
                return None
            sub = TailSubscription(tenant, req, self.counters,
                                   max_queue=max_queue)
            t.subs.append(sub)
            n = len(t.subs)
        self.counters.set("live_tail_subscriptions", n, tenant=tenant)
        return sub

    def unsubscribe(self, sub: TailSubscription) -> None:
        if not self.enabled:
            return
        sub.close()
        with self._lock:
            t = self._tenants.get(sub.tenant)
            if t is None:
                return
            t.subs = [s for s in t.subs if s is not sub and not s.closed]
            n = len(t.subs)
        self.counters.set("live_tail_subscriptions", n, tenant=sub.tenant)

    def has_subscribers(self, tenant: str) -> bool:
        if not self.enabled:
            return False
        with self._lock:
            t = self._tenants.get(tenant)
            return bool(t and t.subs)

    def notify_push(self, tenant: str, trace_id: bytes, raw: bytes) -> None:
        """Evaluate the tenant's standing queries against one push member
        on the host, decoding it only when someone listens."""
        if not self.enabled:
            return
        with self._lock:
            t = self._tenants.get(tenant)
            subs = list(t.subs) if t else []
        if not subs or not raw:
            return
        try:
            sd = decode_search_data(raw, trace_id)
        except (struct.error, IndexError):   # a corrupt push notifies no one
            return
        from .streaming import _meta_from_sd

        meta = None
        for sub in subs:
            if sub.closed or not search_data_matches(
                    sd, sub.req, self.structural_cfg):
                continue
            if meta is None:
                meta = _meta_from_sd(sd)
            sub.offer(meta)
            self.counters.inc("live_tail_notifications", tenant=tenant)
