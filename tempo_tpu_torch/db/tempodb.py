"""TempoDB facade for the port: the backend search read path.

Counterpart of the search half of the reference's ``db/tempodb.py``:
``poll`` of the blocklist from the backend, ``search`` of a tenant's
blocks and ``search_blocks`` of a list of page-range jobs, both through
the batched device engine. Writing trace blocks, trace-by-id lookup,
compaction and retention are later slices; the search blocks this reads are written
by ``search.backend_search_block.write_search_block`` (or by the
reference, which writes the same bytes).
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
from ..search.backend_search_block import BackendSearchBlock
from ..search.batcher import BlockBatcher, ScanJob
from ..search.results import SearchResults
from .blocklist import Blocklist
from .poller import Poller


@dataclass
class TempoDBConfig:
    """The search-read fields of the reference's TempoDBConfig, same names
    and defaults."""
    search_cache_blocks: int = 64         # open search-block objects kept
    search_max_batch_pages: int = 4096    # pages stacked per dispatch
    search_batch_cache_bytes: int = 4 << 30   # staged-batch device budget
    search_pipeline_depth: int = 2        # dispatches in flight
    pool_workers: int = 50                # concurrent meta reads per poll


class TempoDB:
    """The search reader over one backend, on one device."""

    def __init__(self, backend: RawBackend, cfg: TempoDBConfig | None = None,
                 device: str | torch.device | None = None):
        """`device`: where staged batches live and the kernels run —
        ``cuda`` by default; ``cpu`` runs the kernels' plain versions.
        Raises when CUDA is asked for (or defaulted to) and absent."""
        self.backend = backend
        self.cfg = cfg or TempoDBConfig()
        self.device = resolve_device(device)
        self.blocklist = Blocklist()
        self.poller = Poller(backend, concurrency=self.cfg.pool_workers)
        self.batcher = BlockBatcher(
            self.device,
            max_batch_pages=self.cfg.search_max_batch_pages,
            cache_bytes=self.cfg.search_batch_cache_bytes,
            pipeline_depth=self.cfg.search_pipeline_depth)
        self._search_blocks: OrderedDict[str, BackendSearchBlock] = \
            OrderedDict()
        self._headers: OrderedDict[str, dict] = OrderedDict()
        self._headers_max = 131_072
        self._jobs_cache: dict[str, tuple] = {}
        # (epoch, jobs, groups) per search_blocks job list
        self._breq_jobs_cache: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def close(self) -> None:
        self.batcher.close()

    # ------------------------------------------------------------------
    # blocklist

    def poll(self) -> None:
        """Replace the blocklist with the backend's current block metas and
        drop cached state of blocks that are gone."""
        metas = self.poller.poll()
        self.blocklist.apply_poll_results(metas)
        live = {m.block_id for ms in metas.values() for m in ms}
        with self._lock:
            for bid in [b for b in self._search_blocks if b not in live]:
                del self._search_blocks[bid]
            for bid in [b for b in self._headers if b not in live]:
                del self._headers[bid]
        self.batcher.invalidate(live)

    # ------------------------------------------------------------------
    # search

    def _search_block_for(self, meta: BlockMeta) -> BackendSearchBlock:
        with self._lock:
            bsb = self._search_blocks.get(meta.block_id)
            if bsb is None:
                bsb = BackendSearchBlock(self.backend, meta,
                                         header=self._headers.get(
                                             meta.block_id))
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
        results = results or SearchResults.for_request(req)
        epoch = self.blocklist.epoch()
        jobs = self._jobs(tenant, epoch)
        return self.batcher.search(jobs, req, results,
                                   plan_key=(tenant, epoch, len(jobs)))

    def search_blocks(self, breq) -> SearchResults:
        """A batched job request (SearchBlocksRequest): many page-range
        jobs, planned into groups and scanned like ``search``. The jobs
        and their plan are memoized per job list and blocklist epoch.
        Zero-page jobs (a stale meta, a start past the container) are
        dropped."""
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
