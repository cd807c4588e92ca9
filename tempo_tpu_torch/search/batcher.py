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
  one scans, and dispatch stops once the result limit is met.

Left out of this slice on purpose, each listed in ROADMAP.md: the
breaker's host route and ``host_scan``, the dispatch watchdog, the query
coalescer, HBM ownership and hedging, per-query stats and profiling, and
the host-RAM tier of the staged cache. Nothing here falls back to the CPU:
a batch is staged on the engine's device and scanned there.
"""

from __future__ import annotations

import concurrent.futures
import threading
import zlib
from collections import OrderedDict, deque
from dataclasses import dataclass, field

from .engine import DEFAULT_TOP_K, fetch_scan_out
from .multiblock import MultiBlockEngine, MultiQuery, compile_multi
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
    nbytes: int
    # per-predicate memo: header prune, per-block tables, metric sums
    query_cache: OrderedDict = field(default_factory=OrderedDict)
    # searches holding this batch between staging and their last drain;
    # eviction skips pinned entries
    pins: int = 0


_QUERY_CACHE_MAX = 32
_PRUNE_CACHE_MAX = 4096


def _predicate_sig(req) -> tuple:
    """Everything about the request that affects pruning and compilation
    (not the limit, which is filled per query)."""
    return (tags_sig(req), req.min_duration_ms or 0,
            req.max_duration_ms or 0, req.start or 0, req.end or 0)


class BlockBatcher:
    """Groups ScanJobs into staged device batches and runs searches over
    them. Thread-safe; one instance per TempoDB."""

    def __init__(self, device, top_k: int = DEFAULT_TOP_K,
                 max_batch_pages: int = 4096,
                 cache_bytes: int = 4 << 30,
                 pipeline_depth: int = 2,
                 io_workers: int = 8):
        self.engine = MultiBlockEngine(device, top_k=top_k)
        self.max_batch_pages = max_batch_pages
        self.cache_bytes = cache_bytes
        self.pipeline_depth = max(1, pipeline_depth)
        self.io_workers = io_workers
        self._cache: OrderedDict[tuple, _CachedBatch] = OrderedDict()
        self._cache_total = 0
        self._staging: dict[tuple, threading.Event] = {}
        self._prune_cache: OrderedDict = OrderedDict()
        self._plan_cache: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        # staging lookahead: stages group i+1 while group i scans
        self._prefetcher = concurrent.futures.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="stage-prefetch")
        self.last_dispatches = 0   # dispatches of the last search

    def close(self) -> None:
        """Stop the staging threads (pending lookaheads are cancelled)."""
        self._prefetcher.shutdown(wait=True, cancel_futures=True)

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
            self._cache_total -= self._cache.pop(victim).nbytes

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
            entry = _CachedBatch(batch=batch, nbytes=batch.nbytes)
            with self._lock:
                prev = self._cache.pop(key, None)
                if prev is not None:
                    self._cache_total -= prev.nbytes
                self._cache[key] = entry
                self._cache_total += entry.nbytes
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
                self._cache_total -= self._cache.pop(k).nbytes

    # ------------------------------------------------------------------
    # search

    def search(self, jobs: list[ScanJob], req,
               results: SearchResults | None = None,
               plan_key=None, groups: list | None = None) -> SearchResults:
        """Run the request over all jobs: group, stage, compile, dispatch
        (pipelined, early-quitting), merge. `plan_key` (tenant, epoch, ...)
        memoizes the grouping, a pure function of the job list; a caller
        that already holds the plan passes `groups`."""
        pinned: list[_CachedBatch] = []
        try:
            return self._search_impl(jobs, req, results, plan_key, groups,
                                     pinned)
        finally:
            with self._lock:
                for c in pinned:
                    c.pins -= 1
                self._evict_locked()

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

    def _search_impl(self, jobs, req, results, plan_key, groups,
                     pinned) -> SearchResults:
        results = results or SearchResults.for_request(req)
        exhaustive = is_exhaustive(req)
        if groups is None:
            groups = self._plan_for(jobs, plan_key)
        sig = _predicate_sig(req)
        inflight: deque = deque()
        dispatches = 0

        def drain_one():
            cached, mq, pre, out = inflight.popleft()
            count, inspected, scores, idx = fetch_scan_out(out)
            inspected -= pre["entries_skipped"]
            m = results.metrics
            m.inspected_blocks += pre["inspected_blocks"]
            m.inspected_bytes += pre["inspected_bytes"]
            m.truncated_entries += pre["truncated"]
            m.inspected_traces += max(0, inspected)
            for meta in self.engine.results(cached.batch, mq, scores, idx):
                results.add(meta)

        def prepare(group, batch, skip) -> dict:
            """Predicate work over one group, memoized per (batch,
            predicate): per-block compile and metric sums."""
            mq = compile_multi(list(batch.blocks), req, skip=skip,
                               memo=batch.memo,
                               cache=self.engine.compile_cache)
            if mq is None:
                return {"all_skip": True, "skipped": len(group)}
            if not exhaustive and mq.n_terms:
                dict_pruned = (mq.term_keys == -1).all(axis=1)
                skip = [s or bool(dict_pruned[i]) for i, s in enumerate(skip)]
            return {
                "all_skip": False,
                "mq": mq,
                "skipped": sum(skip),
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
            out costs no IO and no device memory. Memoized."""
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
            return reasons

        prefetched: dict = {}

        def submit_prefetch(from_idx):
            """Stage the next live group in the background while this
            group's kernels run (host-to-device overlaps compute)."""
            for g in groups[from_idx:]:
                if all(hdr_reasons_for(g)):
                    continue
                k = tuple(j.key for j in g)
                with self._lock:
                    resident = k in self._cache
                if not resident and k not in prefetched:
                    prefetched[k] = self._prefetcher.submit(self._staged, g)
                return

        # resident groups dispatch first: a cold group's staging then
        # overlaps their scans, and an early quit may skip it entirely
        with self._lock:
            resident = set(self._cache)
        if resident:
            groups = sorted(
                groups, key=lambda g: tuple(j.key for j in g) not in resident)

        for gi, group in enumerate(groups):
            if results.complete:
                break
            gkey = tuple(j.key for j in group)
            hdr_reasons = hdr_reasons_for(group)
            if all(hdr_reasons):
                results.metrics.skipped_blocks += len(group)
                continue
            fut = prefetched.pop(gkey, None)
            cached = fut.result() if fut is not None else self._staged(group)
            with self._lock:
                cached.pins += 1
            pinned.append(cached)
            submit_prefetch(gi + 1)
            with self._lock:
                pre = cached.query_cache.get(sig)
                if pre is not None:
                    cached.query_cache.move_to_end(sig)
            if pre is None:
                pre = prepare(group, cached.batch,
                              [r is not None for r in hdr_reasons])
                with self._lock:
                    cached.query_cache[sig] = pre
                    while len(cached.query_cache) > _QUERY_CACHE_MAX:
                        cached.query_cache.popitem(last=False)
            results.metrics.skipped_blocks += pre["skipped"]
            if pre["all_skip"]:
                continue
            base = pre["mq"]
            # the limit is per request; the tables (and their device
            # copies, made at the first dispatch) are shared through `pre`
            mq = MultiQuery(
                term_keys=base.term_keys, val_ranges=base.val_ranges,
                dur_lo=base.dur_lo, dur_hi=base.dur_hi,
                win_start=base.win_start, win_end=base.win_end,
                limit=req.limit or 20, n_terms=base.n_terms,
                device_tables=pre.get("device_tables"))
            out = self.engine.scan_async(cached.batch, mq)
            pre["device_tables"] = mq.device_tables
            dispatches += 1
            inflight.append((cached, mq, pre, out))
            while len(inflight) >= self.pipeline_depth:
                drain_one()
        while inflight:
            if results.complete:
                inflight.clear()
                break
            drain_one()
        # an early quit leaves a lookahead pending: cancel it if it has
        # not started (a running one completes into the cache)
        for f in prefetched.values():
            f.cancel()
        self.last_dispatches = dispatches
        return results
