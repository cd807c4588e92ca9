"""Serving-path batch scanning: many blocks, few dispatches.

Counterpart of the reference's ``search/batcher.py`` on its default path.
Jobs (one per block, or per page range of a block) group into batches
whose pages stack along the device page axis and scan in one dispatch of
the two kernels. What the grouping keeps from the reference:

- **stable and churn-local**: jobs sort by key and group boundaries are
  content-defined (a job starts a group from a hash of its own key), so
  the same blocklist yields the same groups query after query;
- **bucketed**: only jobs of one page geometry stack together;
- **prune-aware without cache churn**: header- or dictionary-pruned jobs
  stay in the staged batch, the compiled query neutralises them, and
  their entries come off the inspected count on the host;
- **pipelined with early quit**: up to ``pipeline_depth`` dispatches are
  in flight, the next group stages in the background while the current
  one scans, and dispatch stops once the result limit is met;
- **probe dictionaries in the budget**: a batch's staged value
  dictionaries (the device probe's input) count against the same byte
  budget as its pages, and leave with the batch when it is evicted;
- **physical bytes in the budget**: with packed residency
  (``packed=True``, ``packing.py``) the budget charges the packed bytes,
  and ``debug_stats`` reports the staged total both physical and logical
  (what the unpacked layout would hold; equal when not packed);
- **coalesced across requests**: concurrent searches whose dispatches
  land on the same staged batch within a short window stack their
  queries and share one fused dispatch (``QueryCoalescer``); a dispatch
  that no other in-flight search can share skips the window;
- **structural queries** (``structural.py``, the database's gate on): a
  batch stages its span segment, the predicate compiles per (batch,
  predicate) beside the tag terms, and kernel K6 feeds K1 its verdicts.
  In the coalescer a structural query dispatches alone at once unless
  stacking is on; then it groups with same-plan peers, or with
  same-bucket peers when bucketing is on too (K6 over the members'
  lanes, then K4);
- **aggregates** (``analytics.py``, the database's gate on): a request
  carrying the ``?agg=`` tag gets the batch's staged composite keys on its
  own copy of the memoized query, kernel K7 counts them over the scan's
  accepted entries, the counts come back on the dispatch's one copy and
  fold into the results group by group. In the coalescer agg queries
  group apart from plain ones;
- **deterministic release**: a staging lookahead hands its batch to the
  search and keeps nothing of it, and a flush thread drops the batch and
  its members' queries before it publishes their outputs, so a batch the
  budget evicted is freed once the searches holding it return;
- **sharded over a mesh** (an exchange, ``parallel/mesh.py``): each rank
  stages its page shard of every batch and every dispatch runs the B10
  chains, whose collectives every rank must issue in one order. So each
  decision that leads to a collective reads only what is equal on every
  rank: the request, the host batch (the cache charges a batch's whole
  bytes, not the rank's share) and the merged outputs (early quit). With
  more than one rank the coalescer is off, the staging lookahead too, and
  the batcher serves one search at a time, because a wall-clock window or
  a background thread could order them differently on two ranks; at
  world size 1 the coalescer fuses through the dist coalesced chain.

- **attributed**: a search books into its active ``QueryStats``
  (``query_stats.py``) its skip reasons, the staged cache as it saw it,
  the bytes it inspected and staged, its structural plan, its host
  stages, and the device stages of every dispatch it ran; the coalescer
  splits a fused dispatch's stages over its members by their table
  weights (``QueryCoalescer._attribute``), when the dispatch's record
  finishes at the first member's fetch.

Left out of this slice on purpose, each listed in ROADMAP.md: the
breaker's host route and ``host_scan``, the dispatch watchdog, HBM
ownership and hedging, and the host-RAM tier of the staged cache.
Nothing here falls back to the CPU: a batch is staged on the engine's
device and scanned there, and a fused dispatch that raises fails every
member.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import heapq
import threading
import time
import zlib
import contextlib
from collections import OrderedDict, deque
from dataclasses import dataclass, field

from ..observability import profile
from . import query_stats, structural
from .analytics import agg_requested, stage_for_batch
from .engine import (DEFAULT_TOP_K, fetch_coalesced_out, fetch_scan_out,
                     resolve_top_k)
from .kernels.scan import MAX_QUERIES
from .multiblock import MultiBlockEngine, compile_multi, stack_queries
from .pipeline import block_header_skip_reason, is_exhaustive, tags_sig
from .results import SearchResults


@dataclass
class ScanJob:
    """One schedulable scan unit: a page range of one block's search
    container (whole block = range [0, n_pages))."""
    key: tuple              # (block_id, start_page, n_pages) — cache identity
    pages_fn: object        # () -> ColumnarPages for this range (host)
    header: dict            # search-header rollup (pruning + sizes)
    n_pages: int
    n_entries: int
    geometry: tuple         # (entries_per_page, kv_per_entry) bucket key

    @property
    def bytes_est(self) -> int:
        """Share of the block's compressed bytes this job covers."""
        total = max(1, self.header.get("n_pages", self.n_pages))
        return int(self.header.get("compressed_size", 0) * self.n_pages
                   / total)


@dataclass
class _CachedBatch:
    batch: object           # multiblock.BlockBatch
    nbytes: int             # physical: what the budget charges
    logical: int            # the unpacked layout's equivalent
    # per-predicate memo: header prune, per-block tables, metric sums
    query_cache: OrderedDict = field(default_factory=OrderedDict)
    # searches holding this batch between staging and their last drain;
    # eviction skips pinned entries
    pins: int = 0


_QUERY_CACHE_MAX = 32
_PRUNE_CACHE_MAX = 4096


def _predicate_sig(req) -> tuple:
    """Everything about the request that affects pruning and compilation
    (not the limit, which is filled per query). The raw structural tag
    rides separately: tags_sig leaves it out (it is not a dictionary
    term), but two requests that differ only in it must not share a
    memo."""
    return (tags_sig(req), req.min_duration_ms or 0,
            req.max_duration_ms or 0, req.start or 0, req.end or 0,
            req.tags.get(structural.STRUCTURAL_QUERY_TAG, ""))


def _skip_reason_counts(skip: list, reasons: list) -> dict:
    """reason -> count over the skipped jobs: the header prune's reason
    (time_range, duration), or dict for a job skipped beyond it (no value
    of its dictionary satisfies a term)."""
    out: dict = {}
    for s, r in zip(skip, reasons):
        if s:
            key = r or "dict"
            out[key] = out.get(key, 0) + 1
    return out


def _table_weight(mq) -> int:
    """A member's weight in a fused dispatch's split: its tag-table
    elements, plus its own structural plan's table elements."""
    w = max(1, int(mq.term_keys.size))
    if mq.structural is not None:
        w += mq.structural.weight()
    return w


def _abandon_out(out) -> None:
    """A dispatch's outputs that its search drops without fetching: its
    record finishes without them (``profile.Dispatch.detach``)."""
    if isinstance(out, _FusedSlice):
        out.abandon()
    else:
        profile.record_of(out).detach()


def _abandon_done(fut: concurrent.futures.Future) -> None:
    if not fut.cancelled() and fut.exception() is None:
        _abandon_out(fut.result())


class _PendingCoalesce:
    """Queries waiting on one staged batch for the window to close."""

    __slots__ = ("batch", "gen", "items")

    def __init__(self, batch, gen: int):
        self.batch = batch
        self.gen = gen
        self.items: list = []     # [(mq, top_k, Future, QueryStats|None)]


class _FusedOut:
    """One fused dispatch's device outputs, fetched lazily: the first
    member to drain claims the one device-to-host copy and makes it
    outside any lock; later members wait on the event. A failed fetch is
    raised to every member. The fetch finishes the dispatch's record, so
    its stages split over the members then. If every member abandons its
    slice unfetched, the last one detaches the record."""

    __slots__ = ("_out", "_host", "_exc", "_claimed", "_done", "_n",
                 "_abandons", "_lock")

    def __init__(self, out, n_members: int = 1):
        self._out = out
        self._host = None
        self._exc = None
        self._claimed = threading.Lock()
        self._done = threading.Event()
        self._n = n_members
        self._abandons = 0
        self._lock = threading.Lock()

    def abandon(self) -> None:
        with self._lock:
            self._abandons += 1
            last = self._abandons >= self._n
        if last and self._claimed.acquire(blocking=False):
            out, self._out = self._out, None
            self._exc = RuntimeError("every member abandoned the dispatch")
            self._done.set()
            profile.record_of(out).detach()

    def host(self) -> tuple:
        if not self._done.is_set() and self._claimed.acquire(blocking=False):
            try:
                self._host = fetch_coalesced_out(self._out)
                self._out = None
            except Exception as e:  # noqa: BLE001 -- raised to every member
                self._exc = e
            finally:
                self._done.set()
        else:
            self._done.wait()
        if self._exc is not None:
            raise self._exc
        if self._host is None:
            raise RuntimeError("fused fetch aborted before it published")
        return self._host


class _FusedSlice:
    """One member's view of a _FusedOut: iterates as the host
    (count, inspected, scores, idx[, agg]) of a solo dispatch."""

    __slots__ = ("_shared", "_qi")

    def __init__(self, shared: _FusedOut, qi: int):
        self._shared = shared
        self._qi = qi

    def __iter__(self):
        counts, inspected, scores, idx, *agg = self._shared.host()
        qi = self._qi
        return iter((int(counts[qi]), inspected, scores[qi], idx[qi])
                    + tuple(a[qi] for a in agg))

    def abandon(self) -> None:
        self._shared.abandon()


class _Lookahead:
    """One group staged in the background for a search. The staging
    thread keeps nothing of the batch once it signals: the search takes
    the entry over (``take``), so when the search lets go of a batch the
    budget evicted, nothing else holds it."""

    __slots__ = ("_entry", "_exc", "_done")

    def __init__(self):
        self._entry = self._exc = None
        self._done = threading.Event()

    def run(self, stage, group) -> None:
        try:
            self._entry = stage(group)
        except BaseException as e:  # noqa: BLE001 -- raised by take()
            self._exc = e
        finally:
            self._done.set()

    def take(self):
        self._done.wait()
        if self._exc is not None:
            raise self._exc
        entry, self._entry = self._entry, None
        return entry


class QueryCoalescer:
    """Cross-request query coalescing: concurrent searches whose next
    dispatch targets the same staged batch stack their compiled queries
    and run as one fused dispatch (K4 + K2r).

    ``submit`` parks a query in the batch's pending group and arms a
    window (`window_s`); the group flushes when the window closes or at
    once when it holds `max_queries`. A submit whose `peers` hint (the
    in-flight searches that could target this batch, itself included) is
    <= 1 flushes at once: no peer can come. A single-query flush runs the
    ordinary dispatch (K1 + K2). One scheduler thread serves every
    window from a deadline heap, handing due groups to a small flush
    pool; a group's generation number lets it skip deadlines that a size
    flush already took. An exception in a flush is set on every member's
    future.

    A structural query groups by the engine's structural gate
    (``StructuralConfig.stack_group_key``): with stacking off it
    dispatches alone at once; with it on it waits with same-plan peers
    (same-bucket peers with bucketing), apart from plain queries. A query
    asking for an aggregate waits only with others that do: a fused
    group runs K7 for every member or for none.

    Each item carries its submitter's active ``QueryStats`` (the
    contextvar does not reach the flush threads); a dispatch's stages
    split over its members when its record finishes (``_attribute``)."""

    def __init__(self, engine: MultiBlockEngine, window_s: float = 0.003,
                 max_queries: int = 8, active_fn=None):
        self.engine = engine
        self.window_s = window_s
        # K4 takes at most MAX_QUERIES queries a launch
        self.max_queries = min(max(2, max_queries), MAX_QUERIES)
        # in-flight searches when the caller gives no hint
        self._active_fn = active_fn or (lambda: 2)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # (id(batch), None) for plain queries, the structural group key
        # for structural ones -> group
        self._pending: dict[tuple, _PendingCoalesce] = {}
        self._deadlines: list = []       # heap of (deadline, gen, key)
        self._sched: threading.Thread | None = None
        self._flush_pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._gen = 0
        self._closed = False
        self.dispatches = 0   # dispatches issued here, solo and fused
        self.fused = 0        # dispatches that served more than one query
        self.queries = 0      # queries served
        self.structural_queries = 0   # structural queries served
        self.structural_stacked = 0   # ...that shared a fused dispatch
        self.structural_bucketed = 0  # ...whose fused group mixed plans
        # bucket descriptor -> {queries, dispatches, active_nodes,
        # slot_nodes}: mixed-plan fusion's padding, per bucket
        self._bucket_stats: dict[str, dict] = {}

    def submit(self, batch, mq, top_k: int,
               peers: int | None = None) -> concurrent.futures.Future:
        """Queue one compiled query against `batch`. The future resolves
        to the device outputs of a solo dispatch (as ``scan_async``
        returns them) or to a _FusedSlice of a fused one."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        qs = query_stats.current()
        key = (id(batch), None)
        if mq.structural is not None:
            skey = self.engine.structural_cfg.stack_group_key(batch,
                                                             mq.structural)
            if skey is None:
                # stacking off: dispatch alone, now
                grp = _PendingCoalesce(batch, -1)
                grp.items.append((mq, top_k, fut, qs))
                self._run(grp)
                return fut
            key = skey
        if mq.agg_stage is not None:
            key = key + ("agg",)
        flush_now = None
        with self._lock:
            if self._closed:
                raise RuntimeError("the query coalescer is closed")
            grp = self._pending.get(key)
            if grp is None:
                self._gen += 1
                grp = self._pending[key] = _PendingCoalesce(batch, self._gen)
            grp.items.append((mq, top_k, fut, qs))
            if len(grp.items) >= self.max_queries:
                del self._pending[key]
                flush_now = grp
            elif len(grp.items) == 1:
                hint = peers if peers is not None else self._active_fn()
                if hint <= 1:
                    # no peer can share this dispatch: a window would
                    # only add latency
                    del self._pending[key]
                    flush_now = grp
                else:
                    heapq.heappush(self._deadlines,
                                   (time.perf_counter() + self.window_s,
                                    grp.gen, key))
                    if self._sched is None:
                        self._flush_pool = \
                            concurrent.futures.ThreadPoolExecutor(
                                max_workers=4,
                                thread_name_prefix="coalesce-flush")
                        self._sched = threading.Thread(
                            target=self._window_loop, daemon=True,
                            name="coalesce-window")
                        self._sched.start()
                    self._cv.notify()
        if flush_now is not None:
            self._run(flush_now)
        return fut

    def withdraw(self, fut: concurrent.futures.Future) -> bool:
        """Take a query whose caller no longer wants its outputs out of
        its pending group, and cancel its future. A group it leaves empty
        goes with its deadline, so no dispatch runs for nobody. Returns
        False when a flush has already taken the query (it then runs as
        it would have)."""
        with self._lock:
            for key, grp in self._pending.items():
                for j, item in enumerate(grp.items):
                    if item[2] is fut:
                        break
                else:
                    continue
                del grp.items[j]
                if not grp.items:
                    del self._pending[key]
                    self._deadlines = [d for d in self._deadlines
                                       if d[1] != grp.gen]
                    heapq.heapify(self._deadlines)
                    self._cv.notify()
                fut.cancel()
                return True
        return False

    def _window_loop(self) -> None:
        """The scheduler thread: pop due deadlines, skip those whose group
        a size flush already took, hand the rest to the flush pool."""
        while True:
            with self._cv:
                while not self._deadlines and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                deadline, gen, key = self._deadlines[0]
                wait = deadline - time.perf_counter()
                if wait > 0:
                    self._cv.wait(wait)
                    continue
                heapq.heappop(self._deadlines)
                grp = self._pending.get(key)
                if grp is None or grp.gen != gen:
                    continue
                del self._pending[key]
            self._flush_pool.submit(self._run, grp)

    def _run(self, grp: _PendingCoalesce) -> None:
        """Dispatch a group and publish each member's outputs. The
        dispatch runs in a frame of its own that empties the group first,
        so once a member sees its outputs this thread holds nothing of
        the batch or the members' queries."""
        futs = [item[2] for item in grp.items]
        try:
            outs = self._dispatch(grp)
        except BaseException as e:  # noqa: BLE001 -- set on every member
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)
            return
        for fut, out in zip(futs, outs):
            fut.set_result(out)

    def _dispatch(self, grp: _PendingCoalesce) -> list:
        """The group's dispatch, solo or fused: each member's outputs.
        Its record's stages split over the members' stats when it
        finishes. With profiling off, on the CPU the launch's wall time
        books as execute at once; on a CUDA device nothing does (see
        ``query_stats.wall_is_device_time``)."""
        batch, items = grp.batch, grp.items
        grp.batch, grp.items = None, []
        sts = [item[0].structural for item in items]
        with self._lock:
            self.dispatches += 1
            self.queries += len(items)
            if len(items) > 1:
                self.fused += 1
            if sts[0] is not None:
                self.structural_queries += len(items)
                if len(items) > 1:
                    self.structural_stacked += len(items)
                    if any(st.plan != sts[0].plan for st in sts[1:]):
                        self.structural_bucketed += len(items)
        stats = [item[3] for item in items]
        on_record = None
        if any(qs is not None for qs in stats):
            weights = [_table_weight(item[0]) for item in items]

            def on_record(rec, stats=stats, weights=weights):
                self._attribute(stats, weights, dict(rec.stages),
                                rec.h2d_bytes)
            wall_ok = query_stats.wall_is_device_time(self.engine.device)
            t0 = time.perf_counter()
        with profile.collect_records(on_record) as recs:
            if len(items) == 1:
                outs = [self.engine.scan_async(batch, items[0][0])]
            else:
                cq = stack_queries([item[0] for item in items],
                                   self.engine.structural_cfg
                                   .bucket_max_nodes)
                self._book_bucket(cq.structural)
                k = max(item[1] for item in items)
                shared = _FusedOut(
                    self.engine.coalesced_scan_async(batch, cq, k),
                    len(items))
                outs = [_FusedSlice(shared, qi) for qi in range(len(items))]
        if on_record is not None:
            if not recs.opened and wall_ok:
                self._attribute(stats, weights,
                                {"execute": time.perf_counter() - t0}, 0)
            for rec in recs.opened:
                if not rec.finished:
                    for qs in stats:
                        if qs is not None:
                            qs.track(rec)
        return outs

    @staticmethod
    def _attribute(stats: list, weights: list, totals: dict,
                   h2d: float) -> None:
        """Split one (possibly fused) dispatch's stage seconds and h2d
        bytes over the members' stats by their table weights
        (``_table_weight``): per stage the shares sum exactly to the
        dispatch's total (``query_stats.apportion``)."""
        shares = query_stats.apportion(totals, weights)
        byte_shares = query_stats.apportion({"b": float(h2d)}, weights)
        for qs, share, bs in zip(stats, shares, byte_shares):
            if qs is not None:
                qs.add_device_stages(share, h2d_bytes=bs["b"],
                                     fused_q=len(stats))

    def _book_bucket(self, st) -> None:
        """A mixed-plan fused dispatch's bucket occupancy: its members'
        real nodes against the bucket's slots."""
        if st is None or not getattr(st, "slot_nodes", 0):
            return
        with self._lock:
            row = self._bucket_stats.setdefault(
                str(st.plan), {"queries": 0, "dispatches": 0,
                               "active_nodes": 0, "slot_nodes": 0})
            row["queries"] += st.n_queries
            row["dispatches"] += 1
            row["active_nodes"] += st.active_nodes
            row["slot_nodes"] += st.slot_nodes

    def stats(self) -> dict:
        with self._lock:
            pending = sum(len(g.items) for g in self._pending.values())
            rows = {bk: dict(row) for bk, row in self._bucket_stats.items()}
            return {"dispatches": self.dispatches,
                    "fused_dispatches": self.fused,
                    "queries": self.queries,
                    "ratio": round(self.queries / max(1, self.dispatches),
                                   3),
                    "pending": pending,
                    "window_ms": self.window_s * 1e3,
                    "structural_queries": self.structural_queries,
                    "structural_stacked": self.structural_stacked,
                    "structural_stack_ratio": round(
                        self.structural_stacked
                        / max(1, self.structural_queries), 3),
                    "structural_bucketed": self.structural_bucketed,
                    "buckets": {
                        bk: {"queries": row["queries"],
                             "dispatches": row["dispatches"],
                             "stack_ratio": round(
                                 row["queries"]
                                 / max(1, row["dispatches"]), 3),
                             "occupancy": round(
                                 row["active_nodes"]
                                 / max(1, row["slot_nodes"]), 3)}
                        for bk, row in rows.items()}}

    def close(self) -> None:
        """Stop the scheduler thread and the flush pool. Queries still
        parked in a window are flushed first, so no member waits
        forever."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            sched = self._sched
        if sched is not None:
            sched.join(timeout=10)
        with self._lock:
            parked = list(self._pending.values())
            self._pending.clear()
            self._deadlines.clear()
        for grp in parked:
            self._run(grp)
        if self._flush_pool is not None:
            self._flush_pool.shutdown(wait=True)


class BlockBatcher:
    """Groups ScanJobs into staged device batches and runs searches over
    them. Thread-safe; one instance per TempoDB."""

    def __init__(self, device, top_k: int = DEFAULT_TOP_K,
                 max_batch_pages: int = 4096,
                 cache_bytes: int = 4 << 30,
                 pipeline_depth: int = 2,
                 io_workers: int = 8,
                 device_probe_min_vals: int | None = None,
                 coalesce_window_s: float = 0.003,
                 coalesce_max_queries: int = 8,
                 packed: bool = False,
                 structural_cfg: structural.StructuralConfig = structural.OFF,
                 analytics_enabled: bool = False,
                 profiling: profile.Gate = profile.OFF):
        """`coalesce_max_queries` <= 1 disables coalescing: every
        dispatch runs at once, on the caller's thread. `packed` stages
        batches in the packed layout (packing.py). `structural_cfg`: the
        database's structural gate and stacking knobs.
        `analytics_enabled`: the database's ?agg= gate (analytics.py);
        off, the tag is ignored. `profiling`: the database's profiling
        gate. ``set_exchange`` shards it over a mesh."""
        self.engine = MultiBlockEngine(
            device, top_k=top_k, device_probe_min_vals=device_probe_min_vals,
            packed=packed, structural_cfg=structural_cfg,
            profiling=profiling)
        self.max_batch_pages = max_batch_pages
        self.cache_bytes = cache_bytes
        self.pipeline_depth = max(1, pipeline_depth)
        self.io_workers = io_workers
        self._cache: OrderedDict[tuple, _CachedBatch] = OrderedDict()
        self._cache_total = 0
        # the share of _cache_total held by staged probe dictionaries
        self._probe_dict_total = 0
        # _cache_total in the unpacked layout's bytes
        self._cache_logical = 0
        self._staging: dict[tuple, threading.Event] = {}
        self._prune_cache: OrderedDict = OrderedDict()
        self._plan_cache: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        # staging lookahead: stages group i+1 while group i scans
        self._prefetcher = concurrent.futures.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="stage-prefetch")
        # peers of a dispatch, for the coalescer: _interest counts per
        # group key the in-flight searches that plan to scan it and have
        # not dispatched it yet; _unplanned the searches whose plan is not
        # final (they could target any group)
        self._interest: dict[tuple, int] = {}
        self._unplanned = 0
        self.coalescer = None
        if coalesce_max_queries > 1:
            self.coalescer = QueryCoalescer(
                self.engine, window_s=coalesce_window_s,
                max_queries=coalesce_max_queries)
        self.last_dispatches = 0   # dispatch submits of the last search
        self.analytics_enabled = analytics_enabled
        # more than one rank: one search at a time, no lookahead, no
        # coalescer (set_exchange)
        self._serial = False
        self._search_lock = threading.Lock()

    def set_exchange(self, exchange) -> None:
        """Shard this batcher's batches over `exchange`'s ranks
        (``parallel.mesh.ShardExchange``); before the first search. With
        more than one rank the coalescer goes and searches run one at a
        time."""
        self.engine.exchange = exchange
        self._serial = exchange.world > 1
        if self._serial and self.coalescer is not None:
            self.coalescer.close()
            self.coalescer = None

    def close(self) -> None:
        """Stop the staging threads (pending lookaheads are cancelled) and
        the coalescer's."""
        self._prefetcher.shutdown(wait=True, cancel_futures=True)
        if self.coalescer is not None:
            self.coalescer.close()

    def debug_stats(self) -> dict:
        """The coalescer's counters, the peer counters and the staged
        cache's bytes: physical (charged to the budget) and logical (the
        unpacked layout's equivalent; equal when not packed), and the
        ?agg= keys staged on the cached batches (not charged: a batch
        stages them at its first agg request)."""
        with self._lock:
            peers = {"interest": dict(self._interest),
                     "unplanned": self._unplanned}
            cache = {"bytes": self._cache_total,
                     "logical_bytes": self._cache_logical,
                     "dict_bytes": self._probe_dict_total,
                     "agg_bytes": sum(
                         c.batch.agg_stage.device_nbytes
                         for c in self._cache.values()
                         if c.batch.agg_stage is not None)}
        return {"coalesce": (self.coalescer.stats()
                             if self.coalescer is not None else None),
                "peers": peers, "cache": cache}

    # ------------------------------------------------------------------
    # planning

    def _cuts(self, j: ScanJob) -> bool:
        """Content-defined group boundary: depends only on this job's key
        and size, so group composition is a local property."""
        divisor = max(2, self.max_batch_pages // (2 * max(1, j.n_pages)))
        return zlib.crc32(repr(j.key).encode()) % divisor == 0

    def plan(self, jobs: list[ScanJob]) -> list[list[ScanJob]]:
        buckets: dict[tuple, list[ScanJob]] = {}
        for j in sorted(jobs, key=lambda j: j.key):
            buckets.setdefault(j.geometry, []).append(j)
        groups = []
        for _geo, js in sorted(buckets.items()):
            cur: list[ScanJob] = []
            cur_pages = 0
            min_pages = self.max_batch_pages // 4
            for j in js:
                if cur and (cur_pages + j.n_pages > self.max_batch_pages
                            or (cur_pages >= min_pages and self._cuts(j))):
                    groups.append(cur)
                    cur, cur_pages = [], 0
                cur.append(j)
                cur_pages += j.n_pages
            if cur:
                groups.append(cur)
        return groups

    # ------------------------------------------------------------------
    # staged cache

    def _evict_locked(self) -> None:
        """LRU-evict unpinned batches until the byte budget holds (caller
        holds self._lock)."""
        while self._cache_total > self.cache_bytes and len(self._cache) > 1:
            victim = next((k for k, v in self._cache.items() if v.pins <= 0),
                          None)
            if victim is None:
                break  # everything pinned: over budget until a drain
            self._drop_locked(victim)

    def _drop_locked(self, key) -> None:
        """Forget a staged batch (caller holds self._lock). Its arrays and
        probe dictionaries are freed with the last reference: at once, or
        when a search that still holds it lets go."""
        entry = self._cache.pop(key)
        self._cache_total -= entry.nbytes
        self._cache_logical -= entry.logical
        self._probe_dict_total -= entry.batch.dict_nbytes

    def _staged(self, group: list[ScanJob]) -> _CachedBatch:
        """The group's staged batch: a cache hit, or IO + decompress +
        stack + one host-to-device copy. Concurrent stagers of one group
        wait for the first."""
        key = tuple(j.key for j in group)
        while True:
            with self._lock:
                hit = self._cache.get(key)
                if hit is not None:
                    self._cache.move_to_end(key)
                    return hit
                ev = self._staging.get(key)
                if ev is None:
                    ev = self._staging[key] = threading.Event()
                    break
            ev.wait()
        try:
            if len(group) > 1:
                with concurrent.futures.ThreadPoolExecutor(
                        max_workers=min(self.io_workers, len(group))) as ex:
                    pages = list(ex.map(lambda j: j.pages_fn(), group))
            else:
                pages = [group[0].pages_fn()]
            batch = self.engine.place(self.engine.stage_host(pages))
            entry = _CachedBatch(batch=batch, nbytes=batch.nbytes,
                                 logical=batch.logical_nbytes)
            with self._lock:
                if key in self._cache:
                    self._drop_locked(key)
                self._cache[key] = entry
                self._cache_total += entry.nbytes
                self._cache_logical += entry.logical
                self._probe_dict_total += batch.dict_nbytes
                self._evict_locked()
            return entry
        finally:
            with self._lock:
                self._staging.pop(key, None)
            ev.set()

    def invalidate(self, live_block_ids: set[str]) -> None:
        """Drop staged batches holding blocks no longer in the blocklist."""
        with self._lock:
            for k in [k for k in self._cache
                      if any(jk[0] not in live_block_ids for jk in k)]:
                self._drop_locked(k)

    # ------------------------------------------------------------------
    # search

    def search(self, jobs: list[ScanJob], req,
               results: SearchResults | None = None,
               plan_key=None, groups: list | None = None) -> SearchResults:
        """Run the request over all jobs: group, stage, compile, dispatch
        (pipelined, early-quitting), merge. `plan_key` (tenant, epoch, ...)
        memoizes the grouping, a pure function of the job list; a caller
        that already holds the plan passes `groups`. Concurrent searches
        coalesce their dispatches over a shared staged batch. A
        structural request is refused (ValueError) when the gate is
        off."""
        expr = structural.structural_query(req, self.engine.structural_cfg)
        with (self._search_lock if self._serial
              else contextlib.nullcontext()):
            with self._lock:
                self._unplanned += 1
            pinned: list[_CachedBatch] = []
            interest: list[tuple] = []    # group keys not yet dispatched
            planned = [False]
            try:
                return self._search_impl(jobs, req, expr, results, plan_key,
                                         groups, pinned, interest, planned)
            finally:
                with self._lock:
                    if planned[0]:
                        for k in interest:
                            self._release_locked(k)
                    else:
                        self._unplanned -= 1
                    for c in pinned:
                        c.pins -= 1
                    self._evict_locked()

    def _abandon(self, inflight: deque) -> None:
        """Drop a search's undrained dispatches: a query still parked in
        the coalescer is withdrawn from its pending group; a dispatch that
        ran (or will, its flush having taken the query) finishes its
        record without a fetch, so its cost still reaches its members."""
        for _cached, _mq, _pre, out in inflight:
            if isinstance(out, concurrent.futures.Future):
                if self.coalescer is not None \
                        and self.coalescer.withdraw(out):
                    continue
                out.add_done_callback(_abandon_done)
            else:
                _abandon_out(out)
        inflight.clear()

    def _release_locked(self, gkey) -> None:
        n = self._interest.get(gkey, 0) - 1
        if n <= 0:
            self._interest.pop(gkey, None)
        else:
            self._interest[gkey] = n

    def _plan_for(self, jobs, plan_key):
        if plan_key is None:
            return self.plan(jobs)
        tenant_key, gen = plan_key[0], plan_key[1:]
        with self._lock:
            hit = self._plan_cache.get(tenant_key)
            if hit is not None and hit[0] == gen:
                return hit[1]
        groups = self.plan(jobs)
        with self._lock:
            self._plan_cache[tenant_key] = (gen, groups)
            while len(self._plan_cache) > 64:
                self._plan_cache.popitem(last=False)
        return groups

    def _search_impl(self, jobs, req, expr, results, plan_key, groups,
                     pinned, interest, planned) -> SearchResults:
        results = results or SearchResults.for_request(req)
        exhaustive = is_exhaustive(req)
        want_agg = self.analytics_enabled and agg_requested(req)
        # the active query stats (None with the database's stats off):
        # every booking below sits behind this one read, and so does
        # every clock read of the host stages
        qs = query_stats.current()
        stages = (None if qs is None else
                  {"header_prune": 0.0, "staging": 0.0, "prepare": 0.0,
                   "dispatch": 0.0, "drain": 0.0})
        if groups is None:
            groups = self._plan_for(jobs, plan_key)
        # the plan is final: declare the groups this search will scan, so
        # the coalescer can tell a real peer on a batch from an unrelated
        # concurrent search
        with self._lock:
            self._unplanned -= 1
            planned[0] = True
            for g in groups:
                k = tuple(j.key for j in g)
                self._interest[k] = self._interest.get(k, 0) + 1
                interest.append(k)
        sig = _predicate_sig(req)
        inflight: deque = deque()
        dispatches = 0

        def drain_one():
            t0 = time.perf_counter() if qs is not None else 0.0
            cached, mq, pre, out = inflight.popleft()
            if isinstance(out, concurrent.futures.Future):
                out = out.result()
            if isinstance(out, _FusedSlice):
                count, inspected, scores, idx, *agg = out
            else:
                count, inspected, scores, idx, *agg = fetch_scan_out(out)
            # the dispatch has run (on a window's flush thread, perhaps):
            # keep its uploaded tables for the next request of this
            # predicate over this batch. A fused dispatch uploads stacked
            # tables instead and leaves none.
            if mq.device_tables is not None:
                with self._lock:
                    if pre.get("device_tables") is None:
                        pre["device_tables"] = mq.device_tables
            inspected -= pre["entries_skipped"]
            m = results.metrics
            m.inspected_blocks += pre["inspected_blocks"]
            m.inspected_bytes += pre["inspected_bytes"]
            m.inspected_bytes_device += pre["inspected_bytes"]
            m.truncated_entries += pre["truncated"]
            m.inspected_traces += max(0, inspected)
            for meta in self.engine.results(cached.batch, mq, scores, idx):
                results.add(meta)
            if agg:
                results.add_agg(mq.agg_stage.decode(agg[0]))
            if qs is not None:
                qs.add_inspected(blocks=pre["inspected_blocks"],
                                 nbytes=pre["inspected_bytes"],
                                 placement="device")
                # the staged bytes this group's scan read, physical and
                # logical (equal when not packed)
                b = cached.batch
                qs.add_staged(b.device_nbytes,
                              int(b.logical_device_nbytes
                                  or b.device_nbytes))
                stages["drain"] += time.perf_counter() - t0

        def prepare(group, batch, skip, reasons) -> dict:
            """Predicate work over one group, memoized per (batch,
            predicate): per-block compile (the structural predicate's
            too), metric sums and the skip reasons."""
            mq = compile_multi(list(batch.blocks), req, skip=skip,
                               memo=batch.memo,
                               cache=self.engine.compile_cache,
                               staged_dicts=batch.staged_dicts,
                               packed=self.engine.packed)
            if mq is None:
                return {"all_skip": True, "skipped": len(group),
                        "skip_reasons": _skip_reason_counts(
                            [True] * len(group), reasons)}
            if expr is not None:
                blocks = list(batch.blocks)
                mq.structural = structural.compile_structural(
                    expr, blocks, staged_dicts=batch.staged_dicts,
                    packed=self.engine.packed, memo=batch.memo,
                    entry_kv_slots=blocks[0].geometry.kv_per_entry)
            if not exhaustive and mq.n_terms:
                dict_pruned = (mq.term_keys == -1).all(axis=1)
                skip = [s or bool(dict_pruned[i]) for i, s in enumerate(skip)]
            return {
                "all_skip": False,
                "mq": mq,
                "skipped": sum(skip),
                "skip_reasons": _skip_reason_counts(skip, reasons),
                "entries_skipped": sum(
                    j.n_entries for j, s in zip(group, skip) if s),
                "inspected_blocks": sum(1 for s in skip if not s),
                "inspected_bytes": sum(
                    j.bytes_est for j, s in zip(group, skip) if not s),
                "truncated": sum(
                    int(j.header.get("truncated_entries", 0) or 0)
                    for j, s in zip(group, skip)
                    if not s and j.key[1] == 0),
            }

        def hdr_reasons_for(group):
            """Header-only prune before staging: a group the headers rule
            out costs no IO and no device memory. The reason of each job
            (None: scan it). Memoized."""
            t0 = time.perf_counter() if qs is not None else 0.0
            gkey = tuple(j.key for j in group)
            with self._lock:
                reasons = self._prune_cache.get((gkey, sig))
                if reasons is not None:
                    self._prune_cache.move_to_end((gkey, sig))
            if reasons is None:
                reasons = [block_header_skip_reason(j.header, req)
                           for j in group]
                with self._lock:
                    self._prune_cache[(gkey, sig)] = reasons
                    while len(self._prune_cache) > _PRUNE_CACHE_MAX:
                        self._prune_cache.popitem(last=False)
            if qs is not None:
                stages["header_prune"] += time.perf_counter() - t0
            return reasons

        # group key -> (_Lookahead, its future, the cache event this query
        # saw: judged when the lookahead started, since by the time the
        # search takes the batch its own lookahead has cached it)
        prefetched: dict = {}

        def submit_prefetch(from_idx):
            """Stage the next live group in the background while this
            group's kernels run (host-to-device overlaps compute); not
            with more than one rank, where the cache must change in the
            same order on every rank."""
            if self._serial:
                return
            for g in groups[from_idx:]:
                if all(hdr_reasons_for(g)):
                    continue
                k = tuple(j.key for j in g)
                with self._lock:
                    resident = k in self._cache
                if not resident and k not in prefetched:
                    ahead = _Lookahead()
                    prefetched[k] = (ahead, self._prefetcher.submit(
                        ahead.run, self._staged, g), "hbm_miss_cold")
                return

        # resident groups dispatch first: a cold group's staging then
        # overlaps their scans, and an early quit may skip it entirely
        with self._lock:
            resident = set(self._cache)
        if resident:
            groups = sorted(
                groups, key=lambda g: tuple(j.key for j in g) not in resident)

        try:
            for gi, group in enumerate(groups):
                if results.complete:
                    break
                gkey = tuple(j.key for j in group)
                hdr_reasons = hdr_reasons_for(group)
                if all(hdr_reasons):
                    results.metrics.skipped_blocks += len(group)
                    if qs is not None:
                        for r in hdr_reasons:
                            qs.add_skip(r)
                    continue
                t0 = time.perf_counter() if qs is not None else 0.0
                ahead = prefetched.pop(gkey, None)
                if qs is not None:
                    # the staged cache as this query saw it (the port has
                    # no host-RAM tier: a miss is always cold)
                    if ahead is not None:
                        event = ahead[2]
                    else:
                        with self._lock:
                            event = ("hbm_hit" if gkey in self._cache
                                     else "hbm_miss_cold")
                cached = (ahead[0].take() if ahead is not None
                          else self._staged(group))
                if qs is not None:
                    stages["staging"] += time.perf_counter() - t0
                    qs.add_cache(event)
                    if event != "hbm_hit" and cached.batch.staged_dicts:
                        qs.add_cache("probe_dict_staged",
                                     len(cached.batch.staged_dicts))
                with self._lock:
                    cached.pins += 1
                pinned.append(cached)
                submit_prefetch(gi + 1)
                with self._lock:
                    pre = cached.query_cache.get(sig)
                    if pre is not None:
                        cached.query_cache.move_to_end(sig)
                if pre is None:
                    t0 = time.perf_counter() if qs is not None else 0.0
                    # compilation may launch the device probe: its record
                    # is this query's (no wall fallback: compilation is
                    # mostly host work)
                    with query_stats.attributed_dispatch(qs):
                        pre = prepare(group, cached.batch,
                                      [r is not None for r in hdr_reasons],
                                      hdr_reasons)
                    if qs is not None:
                        stages["prepare"] += time.perf_counter() - t0
                    with self._lock:
                        cached.query_cache[sig] = pre
                        while len(cached.query_cache) > _QUERY_CACHE_MAX:
                            cached.query_cache.popitem(last=False)
                if qs is not None:
                    for r, n in pre["skip_reasons"].items():
                        qs.add_skip(r, n)
                results.metrics.skipped_blocks += pre["skipped"]
                if pre["all_skip"]:
                    continue
                base = pre["mq"]
                if qs is not None and base.structural is not None:
                    # the plan's node weights: the explain tree's split
                    qs.add_structural(base.structural)
                # the limit and the aggregate are per request; the tables (and
                # their device copies, made at the first dispatch) are shared
                # through `pre`
                mq = dataclasses.replace(
                    base, limit=req.limit or 20,
                    device_tables=pre.get("device_tables"),
                    agg_stage=(stage_for_batch(cached.batch) if want_agg
                               else None))
                t0 = time.perf_counter() if qs is not None else 0.0
                if self.coalescer is not None:
                    with self._lock:
                        peers = self._interest.get(gkey, 1) + self._unplanned
                    out = self.coalescer.submit(
                        cached.batch, mq,
                        resolve_top_k(self.engine.top_k, mq.limit), peers=peers)
                else:
                    with query_stats.attributed_dispatch(
                            qs, self.engine.device):
                        out = self.engine.scan_async(cached.batch, mq)
                if qs is not None:
                    stages["dispatch"] += time.perf_counter() - t0
                dispatches += 1
                inflight.append((cached, mq, pre, out))
                # this search does not come back to this group: later peers
                # need not wait for it (a parked query still fuses with them)
                with self._lock:
                    self._release_locked(gkey)
                interest.remove(gkey)
                while len(inflight) >= self.pipeline_depth:
                    drain_one()
            while inflight:
                if results.complete:
                    self._abandon(inflight)
                    break
                drain_one()
        except BaseException:
            # a raising dispatch leaves later queries parked: withdraw
            # them, so no window flushes them for nobody
            self._abandon(inflight)
            raise
        # an early quit leaves a lookahead pending: cancel it if it has
        # not started (a running one completes into the cache)
        for _ahead, f, _event in prefetched.values():
            f.cancel()
        if qs is not None:
            qs.add_stages(stages)
        self.last_dispatches = dispatches
        return results
