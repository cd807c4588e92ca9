"""TempoDB facade for the port: the backend read path.

Counterpart of the read half of the reference's ``db/tempodb.py``:
``poll`` of the blocklist from the backend (which also tells the live
tier, ``live_tier``, what became visible), ``search`` of a tenant's
blocks, ``search_block`` of one page-range job and ``search_blocks`` of a
list of them, all through the batched device engine, each answering an
``?agg=`` aggregate when the database's analytics gate is on; and
``find_trace_by_id``, host work over each block's bloom, index and one
data page. Given a mesh (``parallel.mesh.make_mesh``), or with
``auto_mesh`` once ``torch.distributed`` is initialized with more than
one rank, the three searches shard every batch over the mesh's ranks
(one rank per device; B10's chains and K9); the live tier stays on the
rank's own device, unsharded. Completing blocks from the WAL, compaction
and retention are later slices; the blocks this reads are written by
``encoding.v2.streaming_block.StreamingBlock`` (trace objects) and
``search.backend_search_block.write_search_block`` (search containers),
or by the reference, which writes the same bytes.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from dataclasses import dataclass

import torch

from ..backend.raw import DoesNotExist, RawBackend
from ..backend.types import NAME_SEARCH_HEADER, BlockMeta
from ..device import resolve_device
from ..encoding.v2.backend_block import BackendBlock
from ..search.backend_search_block import BackendSearchBlock
from ..search.batcher import BlockBatcher, ScanJob
from ..search.live_tier import LiveTier
from ..search.results import SearchResults
from ..search.structural import StructuralConfig
from ..utils.ids import pad_trace_id
from .blocklist import Blocklist
from .poller import Poller
from .pool import run_jobs


@dataclass
class TempoDBConfig:
    """The search-read fields of the reference's TempoDBConfig, same names
    and defaults."""
    search_cache_blocks: int = 64         # open search-block objects kept
    search_max_batch_pages: int = 4096    # pages stacked per dispatch
    search_batch_cache_bytes: int = 4 << 30   # staged-batch device budget
    search_pipeline_depth: int = 2        # dispatches in flight
    # value dictionaries with at least this many distinct values stage on
    # the device and answer substring terms with the probe kernel (K3);
    # None = dict_probe.DEVICE_PROBE_MIN_VALS (50k), <= 0 = host only
    search_device_probe_min_vals: int | None = None
    # concurrent searches whose dispatches land on one staged batch
    # within this window share one fused dispatch, up to max_queries of
    # them; max_queries <= 1 turns coalescing off
    search_coalesce_window_s: float = 0.003
    search_coalesce_max_queries: int = 8
    # packed residency (search/packing.py): staged kv columns at the width
    # the dictionaries need, durations as u16 (buckets plus residual when
    # longer than 65,535 ms), probe hit masks as 32-bit words; the
    # kernels read them as they are. Same answers, fewer staged bytes.
    # Per database here; the reference's gate is process-wide.
    search_packed_residency: bool = False
    # structural queries (search/structural.py): the x-structural-q
    # request tag is served, and staged batches carry the blocks' span
    # segments; off, a request carrying the tag is refused (ValueError).
    # With stacking, concurrent structural queries of one plan share a
    # fused dispatch; with bucketing too, plans that canonicalize into one
    # bucket of at most _bucket_max_nodes slots do. Per database here;
    # the reference's gate is process-wide.
    search_structural_enabled: bool = False
    search_structural_stack_enabled: bool = False
    search_structural_bucket_enabled: bool = False
    search_structural_bucket_max_nodes: int = 16
    # on a mesh: the span segment reshards so each rank holds only its
    # pages' spans (structural.shard_span_segment), and the page axis pads
    # to the least multiple of the shard count (structural.remainder_pad)
    search_structural_shard_spans: bool = False
    search_structural_remainder_pages: bool = False
    # aggregate analytics (search/analytics.py): a request carrying the
    # ?agg= tag (analytics.attach_agg) gets its group-by-service calls,
    # errors and latency histogram in metrics.agg_json; off, the tag is
    # ignored (no aggregate, and still no early quit). Per database here;
    # the reference's gate is process-wide.
    search_analytics_enabled: bool = False
    # the live tier (search/live_tier.py): tenants' in-flight traces and
    # the WAL head searched on the device (B9) before they reach a
    # backend block; past max_entries live traces a tenant's live search
    # declines, and a tenant holds at most max_subscriptions standing
    # tail queries. Per database here; the reference's gate is
    # process-wide.
    search_live_tier_enabled: bool = False
    search_live_tier_max_entries: int = 4096
    search_live_tail_max_subscriptions: int = 16
    # concurrent meta reads per poll, and blocks a trace-by-id lookup
    # reads at once
    pool_workers: int = 50
    # bounded wait on the process-wide collective dispatch lock
    # (parallel.mesh.dispatch_lock); a timeout raises DispatchLockTimeout.
    # <= 0 waits forever
    search_dispatch_lock_timeout_s: float = 60.0
    # shard batches over make_mesh() when torch.distributed is initialized
    # with more than one rank (resolved at the first search); a mesh given
    # to TempoDB wins, at any world size
    auto_mesh: bool = True

    def structural(self) -> StructuralConfig:
        return StructuralConfig(
            enabled=self.search_structural_enabled,
            stack_enabled=self.search_structural_stack_enabled,
            bucket_enabled=self.search_structural_bucket_enabled,
            bucket_max_nodes=max(2, self.search_structural_bucket_max_nodes),
            shard_spans=self.search_structural_shard_spans,
            remainder_pages=self.search_structural_remainder_pages)


class TempoDB:
    """The search reader over one backend, on one device, or on one rank
    of a mesh."""

    def __init__(self, backend: RawBackend, cfg: TempoDBConfig | None = None,
                 device: str | torch.device | None = None, mesh=None):
        """`device`: where staged batches live and the kernels run —
        ``cuda`` by default; ``cpu`` runs the kernels' plain versions.
        Raises when CUDA is asked for (or defaulted to) and absent.
        `mesh`: a ``parallel.mesh.make_mesh`` DeviceMesh to shard batched
        scans over, this process one of its ranks; its process group must
        carry `device`'s tensors (NCCL for CUDA, gloo for the CPU), or
        this raises ValueError."""
        self.backend = backend
        self.cfg = cfg or TempoDBConfig()
        self.device = resolve_device(device)
        self.blocklist = Blocklist()
        self.poller = Poller(backend, concurrency=self.cfg.pool_workers)
        self.batcher = BlockBatcher(
            self.device,
            max_batch_pages=self.cfg.search_max_batch_pages,
            cache_bytes=self.cfg.search_batch_cache_bytes,
            pipeline_depth=self.cfg.search_pipeline_depth,
            device_probe_min_vals=self.cfg.search_device_probe_min_vals,
            coalesce_window_s=self.cfg.search_coalesce_window_s,
            coalesce_max_queries=self.cfg.search_coalesce_max_queries,
            packed=self.cfg.search_packed_residency,
            structural_cfg=self.cfg.structural(),
            analytics_enabled=self.cfg.search_analytics_enabled)
        self.mesh = None
        # auto_mesh resolves at the first search (_ensure_mesh)
        self._mesh_resolved = mesh is not None
        if mesh is not None:
            self._use_mesh(mesh)
        self.live_tier = LiveTier(
            self.device, self.cfg.structural(),
            enabled=self.cfg.search_live_tier_enabled,
            max_entries=self.cfg.search_live_tier_max_entries,
            max_subscriptions=self.cfg.search_live_tail_max_subscriptions)
        self._search_blocks: OrderedDict[str, BackendSearchBlock] = \
            OrderedDict()
        self._headers: OrderedDict[str, dict] = OrderedDict()
        self._headers_max = 131_072
        self._jobs_cache: dict[str, tuple] = {}
        # (epoch, jobs, groups) per search_blocks job list
        self._breq_jobs_cache: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def close(self) -> None:
        """Stop the batcher's staging and coalescing threads."""
        self.batcher.close()

    def _use_mesh(self, mesh) -> None:
        from ..parallel.mesh import ShardExchange

        self.batcher.set_exchange(ShardExchange(
            mesh, self.device, self.cfg.search_dispatch_lock_timeout_s))
        self.mesh = mesh

    def _ensure_mesh(self) -> None:
        """auto_mesh: shard over make_mesh() when torch.distributed is
        initialized at the first search with more than one rank (as the
        reference shards only over more than one device); the flag is set
        last, under the lock, so no search sees a half-configured
        batcher."""
        if self._mesh_resolved:
            return
        with self._lock:
            if self._mesh_resolved:
                return
            import torch.distributed as dist

            if self.cfg.auto_mesh and dist.is_available() \
                    and dist.is_initialized() and dist.get_world_size() > 1:
                from ..parallel.mesh import make_mesh

                self._use_mesh(make_mesh())
            self._mesh_resolved = True

    # ------------------------------------------------------------------
    # blocklist

    def poll(self) -> None:
        """Replace the blocklist with the backend's current block metas and
        drop cached state of blocks that are gone."""
        metas = self.poller.poll()
        self.blocklist.apply_poll_results(metas)
        if self.live_tier.enabled:
            self.live_tier.mark_poll_visible(metas)
        live = {m.block_id for ms in metas.values() for m in ms}
        with self._lock:
            for bid in [b for b in self._search_blocks if b not in live]:
                del self._search_blocks[bid]
            for bid in [b for b in self._headers if b not in live]:
                del self._headers[bid]
        self.batcher.invalidate(live)

    # ------------------------------------------------------------------
    # trace by id

    @staticmethod
    def _include_block(m: BlockMeta, block_start: str, block_end: str,
                       start_s: int = 0, end_s: int = 0) -> bool:
        """Block id in the [block_start, block_end] shard range, and the
        block's time range overlapping [start_s, end_s]."""
        if block_start and m.block_id < block_start:
            return False
        if block_end and m.block_id > block_end:
            return False
        if start_s and m.end_time and m.end_time < start_s:
            return False
        if end_s and m.start_time and m.start_time > end_s:
            return False
        return True

    def find_trace_by_id(self, tenant: str, trace_id: bytes,
                         block_start: str = "", block_end: str = ""
                         ) -> tuple[bytes | None, int]:
        """The tenant's stored object of `trace_id` (8 or 16 bytes), or
        None, and the count of blocks that failed. Every block in range is
        read on the pool (bloom, index, one data page); a trace found in
        several blocks (until compaction merges them) comes back combined
        by the codec of the first meta's data_encoding, its partials in
        the order the pool returned them. A block that raises (a missing
        object, a corrupt index page) counts as failed and is left out.
        Host work only: no device is touched."""
        key = pad_trace_id(trace_id)
        metas = [m for m in self.blocklist.metas(tenant)
                 if self._include_block(m, block_start, block_end)]

        def job(m: BlockMeta):
            return BackendBlock(self.backend, m).find_by_id(key)

        found, errors = run_jobs(metas, job, workers=self.cfg.pool_workers)
        if not found:
            return None, len(errors)
        if len(found) == 1:
            return found[0], len(errors)
        # protobuf is imported only where partials must be combined: the
        # search path does not need it
        from ..model.codec import codec_for

        return (codec_for(metas[0].data_encoding).combine(*found),
                len(errors))

    # ------------------------------------------------------------------
    # search

    def _search_block_for(self, meta: BlockMeta) -> BackendSearchBlock:
        with self._lock:
            bsb = self._search_blocks.get(meta.block_id)
            if bsb is None:
                bsb = BackendSearchBlock(
                    self.backend, meta,
                    header=self._headers.get(meta.block_id),
                    probe_min_vals=self.cfg.search_device_probe_min_vals,
                    device=self.device,
                    packed=self.cfg.search_packed_residency,
                    structural_cfg=self.cfg.structural())
                self._search_blocks[meta.block_id] = bsb
                while len(self._search_blocks) > self.cfg.search_cache_blocks:
                    self._search_blocks.popitem(last=False)
            return bsb

    def _header_for(self, m: BlockMeta) -> dict:
        """The block's search-header rollup, cached by block id. Raises
        DoesNotExist when the block has no search container."""
        with self._lock:
            hdr = self._headers.get(m.block_id)
            if hdr is not None:
                self._headers.move_to_end(m.block_id)
                return hdr
        hdr = json.loads(self.backend.read(m.tenant_id, m.block_id,
                                           NAME_SEARCH_HEADER))
        with self._lock:
            self._headers[m.block_id] = hdr
            while len(self._headers) > self._headers_max:
                self._headers.popitem(last=False)
        return hdr

    def _scan_job(self, m: BlockMeta, start_page: int = 0,
                  pages: int | None = None) -> ScanJob:
        """A batcher job over pages [start_page, start_page + pages) of a
        block's search container (the whole block by default). Only the
        header is read here; the container loads at staging time. Raises
        DoesNotExist when the block has no search container."""
        hdr = self._header_for(m)
        total = hdr["n_pages"]
        n = total - start_page if pages is None else min(pages,
                                                          total - start_page)
        n = max(0, n)
        if start_page == 0 and n == total:
            def pages_fn(self=self, m=m):
                return self._search_block_for(m).pages()
            n_entries = hdr["n_entries"]
        else:
            def pages_fn(self=self, m=m, s=start_page, c=n):
                return self._search_block_for(m).pages().slice_pages(s, c)
            # entries fill pages densely in build order, so page p holds
            # min(E, n_entries - p*E) of them: exact, because the batcher
            # subtracts a pruned job's entries from the kernel's count
            E = hdr["entries_per_page"]
            n_entries = sum(max(0, min(E, hdr["n_entries"] - p * E))
                            for p in range(start_page, start_page + n))
        return ScanJob(key=(m.block_id, start_page, n), pages_fn=pages_fn,
                       header=hdr, n_pages=n, n_entries=n_entries,
                       geometry=(hdr["entries_per_page"],
                                 hdr["kv_per_entry"]))

    def _jobs(self, tenant: str, epoch: int) -> list[ScanJob]:
        with self._lock:
            hit = self._jobs_cache.get(tenant)
        if hit is not None and hit[0] == epoch:
            return hit[1]
        jobs = []
        for m in self.blocklist.metas(tenant):
            try:
                jobs.append(self._scan_job(m))
            except DoesNotExist:
                raise self._no_container(tenant, m.block_id) from None
        with self._lock:
            self._jobs_cache[tenant] = (epoch, jobs)
        return jobs

    @staticmethod
    def _no_container(tenant: str, block_id: str):
        # the reference answers such blocks from their trace objects (a
        # proto scan); that path is not part of this slice, and leaving
        # the blocks out would be a silently wrong answer
        return NotImplementedError(
            f"block {block_id} of tenant {tenant!r} has no search "
            "container; the trace-object fallback scan is not ported yet")

    def search(self, tenant: str, req,
               results: SearchResults | None = None) -> SearchResults:
        """Search all blocks of a tenant through the batched device engine,
        stopping early at the result limit."""
        self._ensure_mesh()
        results = results or SearchResults.for_request(req)
        epoch = self.blocklist.epoch()
        jobs = self._jobs(tenant, epoch)
        return self.batcher.search(jobs, req, results,
                                   plan_key=(tenant, epoch, len(jobs)))

    def search_block(self, req) -> SearchResults:
        """One search job (SearchBlockRequest): pages [start_page,
        start_page + pages_to_search) of one block's search container,
        with the block meta carried in the request. Runs through the
        batcher, so a repeated job hits the staged cache. Raises
        NotImplementedError when the block has no search container."""
        meta = BlockMeta(
            tenant_id=req.tenant_id, block_id=req.block_id,
            encoding=req.encoding or "zstd", version=req.version or "vT1",
            data_encoding=req.data_encoding or "v2",
            start_time=req.start_time, end_time=req.end_time)
        self._ensure_mesh()
        results = SearchResults.for_request(req.search_req)
        try:
            job = self._scan_job(meta, req.start_page,
                                 req.pages_to_search or None)
        except DoesNotExist:
            raise self._no_container(req.tenant_id, req.block_id) from None
        if job.n_pages > 0:
            self.batcher.search([job], req.search_req, results)
        return results

    def search_blocks(self, breq) -> SearchResults:
        """A batched job request (SearchBlocksRequest): many page-range
        jobs, planned into groups and scanned like ``search``. The jobs
        and their plan are memoized per job list and blocklist epoch.
        Zero-page jobs (a stale meta, a start past the container) are
        dropped."""
        self._ensure_mesh()
        req = breq.search_req
        results = SearchResults.for_request(req)
        sig = (breq.tenant_id,
               tuple((j.block_id, j.start_page, j.pages_to_search,
                      j.encoding, j.version, j.data_encoding)
                     for j in breq.jobs))
        epoch = self.blocklist.epoch()
        with self._lock:
            hit = self._breq_jobs_cache.get(sig)
        if hit is None or hit[0] != epoch:
            jobs = []
            for j in breq.jobs:
                meta = BlockMeta(
                    tenant_id=breq.tenant_id, block_id=j.block_id,
                    encoding=j.encoding or "zstd",
                    version=j.version or "vT1",
                    data_encoding=j.data_encoding or "v2",
                    start_time=j.start_time, end_time=j.end_time)
                try:
                    job = self._scan_job(meta, j.start_page,
                                         j.pages_to_search or None)
                except DoesNotExist:
                    raise self._no_container(breq.tenant_id,
                                             j.block_id) from None
                if job.n_pages > 0:
                    jobs.append(job)
            hit = (epoch, jobs, self.batcher.plan(jobs))
            with self._lock:
                self._breq_jobs_cache[sig] = hit
                while len(self._breq_jobs_cache) > 32:
                    self._breq_jobs_cache.popitem(last=False)
        return self.batcher.search(hit[1], req, results, groups=hit[2])
