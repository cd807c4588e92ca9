"""TempoDB facade for the port: block writes and the backend read path.

Counterpart of the reference's ``db/tempodb.py`` without compaction and
retention:

- writes: ``complete_block`` turns a WAL head block (``wal.AppendBlock``)
  into a backend block, and ``write_block_direct`` writes one from
  objects; each writes the trace objects (``StreamingBlock``: data pages,
  index, bloom, meta.json) and, given search entries, the columnar search
  container (``write_search_block``), the reference's bytes for the same
  input. With a ``wal_dir`` the database owns a ``WAL``.
- reads: ``poll`` of the blocklist from the backend (which also tells the
  live tier, ``live_tier``, what became visible), ``search`` of a
  tenant's blocks, ``search_block`` of one page-range job and
  ``search_blocks`` of a list of them, all through the batched device
  engine, each answering an ``?agg=`` aggregate when the database's
  analytics gate is on; and ``find_trace_by_id``, host work over each
  block's bloom, index and one data page.

A block without a search container is searched on the host from its
trace objects (``_fallback_search``: decode, ``model.matches``), after
the batched pass and only while the result is not complete.

``prewarm`` stages tenants' groups ahead of queries (after every poll
with ``search_prewarm_on_poll``); the search headers persist as a
snapshot under ``host_state_dir`` (by default ``<wal_dir>/host-state``),
so a restarted database plans its first query without reading them from
the backend. Each database owns an offload planner
(``search/planner.py``, ``search_offload_planner_enabled``), carried on
its profiling gate, which places each large dictionary's probe on the
host or on the device.

With ``search_query_stats_enabled`` (the default) each of the three
searches books a query's ``QueryStats`` (``search/query_stats.py``) and
returns its device seconds in the response's metrics; under
``SearchRequest.explain`` its whole breakdown too (``query_stats_json``).
The bytes the scans inspected on the device ride every response.
``search_profiling_enabled`` opens a profiler record a device dispatch
(``observability/profile.py``). Both gates belong to the database; the
recent-query and recent-dispatch rings are the process's, and no
database sets them. Given a mesh
(``parallel.mesh.make_mesh``), or with ``auto_mesh`` once
``torch.distributed`` is initialized with more than one rank, the three
searches shard every batch over the mesh's ranks (one rank per device;
B10's chains and K9); the live tier stays on the rank's own device,
unsharded.
"""

from __future__ import annotations

import atexit
import gzip
import json
import os
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field

import torch

from ..backend.raw import DoesNotExist, RawBackend
from ..backend.types import NAME_SEARCH_HEADER, BlockMeta
from ..device import resolve_device
from ..encoding.compression import usable, why_unusable
from ..encoding.v2.backend_block import BackendBlock
from ..encoding.v2.streaming_block import StreamingBlock
from ..observability import metrics as obs
from ..observability import profile
from ..observability.log import get_logger
from ..search import query_stats, structural
from ..search.planner import OffloadPlanner
from ..search.backend_search_block import (BackendSearchBlock,
                                           write_search_block)
from ..search.batcher import BlockBatcher, ScanJob
from ..search.columnar import PageGeometry
from ..search.live_tier import LiveTier
from ..search.results import SearchResults
from ..search.structural import StructuralConfig
from ..utils.ids import pad_trace_id
from .blocklist import Blocklist
from .poller import Poller
from .pool import run_jobs

log = get_logger("tempo_tpu_torch.db")


@dataclass
class TempoDBConfig:
    """The reference's TempoDBConfig fields for block writes and search
    reads, same names and defaults."""
    # codecs of block data pages, WAL records and search containers; a
    # codec this process cannot use raises at the first write (the WAL's
    # when it is built), it is never swapped for another
    block_encoding: str = "zstd"
    wal_encoding: str = "auto"            # auto: snappy, else zlib (wal.py)
    search_encoding: str = "zstd"
    block_page_size: int = 1 << 20        # uncompressed bytes a data page
    # a completing block streams its pages to the backend every this
    # many compressed bytes
    complete_flush_bytes: int = 30 << 20
    search_geometry: PageGeometry = field(default_factory=PageGeometry)
    search_cache_blocks: int = 64         # open search-block objects kept
    search_max_batch_pages: int = 4096    # pages stacked per dispatch
    search_batch_cache_bytes: int = 4 << 30   # staged-batch device budget
    # the host-RAM tier under the device budget: stacked host batches, so
    # a batch the device budget evicted re-stages with one host-to-device
    # copy. None = min(32 GiB, half the physical RAM): the tier holds
    # what it keeps, so a fixed default could exhaust a small host
    search_host_cache_bytes: int | None = None
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
    # the offload planner (search/planner.py): above the
    # search_device_probe_min_vals floor, a cost model over this
    # database's profiler records chooses host or device for each
    # dictionary's substring probe, at staging and at query compile
    # (seeded by a one-shot microbenchmark on the database's device at
    # its first decision). Off (the default), the static threshold alone
    # decides. Both placements are exact. EWMA smoothing of the observed
    # rates, and the decision ring's length. Per database here; the
    # reference's planner is process-wide.
    search_offload_planner_enabled: bool = False
    search_offload_planner_ewma: float = 0.25
    search_offload_planner_ring: int = 256
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
    # stage every tenant's groups (host tier and device, up to budget) in
    # a background thread after each poll, with one throwaway dispatch a
    # batch layout, so the first query pays neither staging nor a kernel
    # library load; off by default (a write-only process stages nothing)
    search_prewarm_on_poll: bool = False
    # restartable host state: the search-header snapshot
    # (search-headers.json.gz), saved after every poll and prewarm and
    # loaded at start, so a restarted database plans its first query
    # without reading a header from the backend. None = <wal_dir>/
    # host-state (none without a wal_dir); "" = off; a path = there. The
    # reference also keeps JAX's compile cache there (xla-cache) and has
    # search_compile_cache_dir; the port's kernel libraries persist,
    # content-hashed, in tempo_tpu_torch/csrc/build, so neither has a
    # counterpart.
    host_state_dir: str | None = None
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
    # dispatch profiler (observability/profile.py): a record a device
    # dispatch, its execute stage the device time between CUDA events.
    # Off, every dispatch site gets the shared noop record. The fence
    # synchronises the stream after each dispatch (triage only: it ends
    # the dispatch/drain pipelining). Per database here; the reference's
    # gate is process-wide.
    search_profiling_enabled: bool = True
    search_profiling_fence: bool = False
    # per-query stats (search/query_stats.py): blocks and bytes, skip
    # reasons, cache events, host stages and attributed device seconds a
    # search, device_seconds in every response, the breakdown under
    # SearchRequest.explain. Off, no QueryStats is created and responses
    # are the same but for device_seconds (0), a timing. Per database
    # here. The recent-query ring and the slow-query threshold are the
    # process's (query_stats.configure), as are the profiler's ring
    # (profile.configure): a database sets none of them.
    search_query_stats_enabled: bool = True

    def structural(self) -> StructuralConfig:
        return StructuralConfig(
            enabled=self.search_structural_enabled,
            stack_enabled=self.search_structural_stack_enabled,
            bucket_enabled=self.search_structural_bucket_enabled,
            bucket_max_nodes=max(2, self.search_structural_bucket_max_nodes),
            shard_spans=self.search_structural_shard_spans,
            remainder_pages=self.search_structural_remainder_pages)


class TempoDB:
    """The block writer and search reader over one backend, on one
    device, or on one rank of a mesh."""

    def __init__(self, backend: RawBackend, cfg: TempoDBConfig | None = None,
                 device: str | torch.device | None = None, mesh=None,
                 wal_dir: str | None = None):
        """`device`: where staged batches live and the kernels run —
        ``cuda`` by default; ``cpu`` runs the kernels' plain versions.
        Raises when CUDA is asked for (or defaulted to) and absent.
        `mesh`: a ``parallel.mesh.make_mesh`` DeviceMesh to shard batched
        scans over, this process one of its ranks; its process group must
        carry `device`'s tensors (NCCL for CUDA, gloo for the CPU), or
        this raises ValueError. `wal_dir`: where the database's ``WAL``
        (``self.wal``, codec ``cfg.wal_encoding``) keeps its files; None
        (the default) gives a database with no WAL."""
        self.backend = backend
        self.cfg = cfg or TempoDBConfig()
        self.device = resolve_device(device)
        self.wal = None
        if wal_dir is not None:
            from ..wal import WAL

            self.wal = WAL(wal_dir, encoding=self.cfg.wal_encoding)
        self._structural = self.cfg.structural()
        # the database's offload planner rides its profiling gate: the
        # gate's records and observations feed it alone, and its engines
        # consult it (never the process planner)
        self.planner = OffloadPlanner(
            enabled=self.cfg.search_offload_planner_enabled,
            alpha=self.cfg.search_offload_planner_ewma,
            ring_size=self.cfg.search_offload_planner_ring,
            device=self.device)
        self.profiling = profile.Gate(self.cfg.search_profiling_enabled,
                                      self.cfg.search_profiling_fence,
                                      planner=self.planner)
        if (self.cfg.search_offload_planner_enabled
                and not self.cfg.search_profiling_enabled):
            # the planner's device-side feed (the probe's rate, the
            # compile and collective costs, the h2d rate) comes only
            # through the profiler's records: without them it decides
            # from its seed alone. Answers are the same either way.
            log.warning(
                "search_offload_planner_enabled without "
                "search_profiling_enabled: the planner cannot "
                "self-calibrate (no dispatch-profiler feed) and will "
                "decide from its microbenchmark seed only; enable "
                "search_profiling_enabled for cost-model calibration")
        self.blocklist = Blocklist()
        self.poller = Poller(backend, concurrency=self.cfg.pool_workers)
        self.batcher = BlockBatcher(
            self.device,
            max_batch_pages=self.cfg.search_max_batch_pages,
            cache_bytes=self.cfg.search_batch_cache_bytes,
            host_cache_bytes=self.cfg.search_host_cache_bytes,
            pipeline_depth=self.cfg.search_pipeline_depth,
            device_probe_min_vals=self.cfg.search_device_probe_min_vals,
            coalesce_window_s=self.cfg.search_coalesce_window_s,
            coalesce_max_queries=self.cfg.search_coalesce_max_queries,
            packed=self.cfg.search_packed_residency,
            structural_cfg=self.cfg.structural(),
            analytics_enabled=self.cfg.search_analytics_enabled,
            profiling=self.profiling)
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
        # (epoch, jobs, fallback, missing, groups) per search_blocks job list
        self._breq_jobs_cache: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self._prewarm_stop = None     # the running prewarm's stop event
        self._prewarm_thread = None
        self._prewarm_atexit = False
        # restartable host state: under the WAL directory, in a
        # subdirectory (WAL replay removes unknown files in its root)
        sd = self.cfg.host_state_dir
        if sd is None:
            self._state_dir = (os.path.join(wal_dir, "host-state")
                               if wal_dir is not None else None)
        else:
            self._state_dir = sd or None
        if self._state_dir:
            self._load_host_state()

    def close(self) -> None:
        """Stop a running prewarm, then the batcher's staging and
        coalescing threads."""
        self.stop_prewarm()
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
    # writer

    def _check_codecs(self, search: bool) -> None:
        for name in ("block_encoding",) + (("search_encoding",) if search
                                           else ()):
            enc = getattr(self.cfg, name)
            if not usable(enc):
                raise ValueError(f"{name} {enc!r} cannot be used in this "
                                 f"process: {why_unusable(enc)}")

    def _write_block(self, meta: BlockMeta, objects, search_entries
                     ) -> BlockMeta:
        """Stream (id, object, start, end) in ascending id order into a
        backend block, then the search container when there are entries,
        and add the block to the blocklist. A failed write deletes what it
        wrote and raises."""
        self._check_codecs(bool(search_entries))
        sb = StreamingBlock(meta, page_size=self.cfg.block_page_size,
                            backend=self.backend,
                            flush_size=self.cfg.complete_flush_bytes)
        try:
            for oid, obj, s, e in objects:
                sb.add_object(oid, obj, s, e)
            out = sb.complete(self.backend)
        except BaseException:
            sb.abort()
            raise
        if search_entries:
            write_search_block(self.backend, out, search_entries,
                               geometry=self.cfg.search_geometry,
                               encoding=self.cfg.search_encoding)
        self.blocklist.add(out.tenant_id, [out])
        return out

    def complete_block(self, block, search_entries=None) -> BlockMeta:
        """A WAL head block (``wal.AppendBlock``) as a backend block with
        the same id: its traces in id order, each trace's segments as one
        object, and the search container built from `search_entries` (the
        head's ``StreamingSearchBlock.entries()``). Without entries the
        block has no container and is searched from its trace objects."""
        from ..model.codec import codec_for

        codec = codec_for(block.meta.data_encoding)
        meta = BlockMeta(tenant_id=block.meta.tenant_id,
                         block_id=block.meta.block_id,
                         encoding=self.cfg.block_encoding,
                         data_encoding=block.meta.data_encoding)

        def objects():
            for oid, obj in block.iterator():
                r = codec.fast_range(obj) or (0, 0)
                yield oid, obj, r[0], r[1]

        return self._write_block(meta, objects(), search_entries)

    def write_block_direct(self, tenant: str, objects, search_entries=None,
                           data_encoding: str = "v2") -> BlockMeta:
        """A backend block from (id, object, start, end) tuples in
        ascending id order, with a new block id."""
        meta = BlockMeta(tenant_id=tenant, encoding=self.cfg.block_encoding,
                         data_encoding=data_encoding)
        return self._write_block(meta, objects, search_entries)

    # ------------------------------------------------------------------
    # blocklist

    def poll(self) -> None:
        """Replace the blocklist with the backend's current block metas,
        drop cached state of blocks that are gone, and save the host
        state. A running prewarm is cancelled before the staged caches
        are invalidated (it could put back a dead block's batch); with
        ``search_prewarm_on_poll`` a new one starts."""
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
        if self._prewarm_stop is not None:
            self._prewarm_stop.set()
        if self.cfg.search_prewarm_on_poll:
            # the new prewarm joins the old one, then invalidates again
            self.batcher.invalidate(live)
            self.prewarm(tenants=list(metas), reinvalidate=live)
        else:
            self.stop_prewarm()
            self.batcher.invalidate(live)
        self.save_host_state()

    def prewarm(self, tenants: list[str], background: bool = True,
                reinvalidate: set | None = None):
        """Stage every tenant's groups (host tier and device, up to the
        device budget) and make one throwaway dispatch a batch layout
        (``BlockBatcher.prewarm``), so the first query after a poll pays
        neither staging nor a kernel library load. In a background thread
        by default (returned; a newer prewarm cancels it), else inline
        (the groups staged are returned). `reinvalidate`: the live block
        ids, applied again once the previous prewarm has stopped (its
        staging in flight may have put back a dead block's batch)."""
        self._ensure_mesh()
        if self._prewarm_stop is not None:
            self._prewarm_stop.set()
        prev = self._prewarm_thread
        stop = self._prewarm_stop = threading.Event()
        if not self._prewarm_atexit:
            # stop and join before the interpreter tears down, through a
            # weakref so the registry does not keep the database alive
            ref = weakref.ref(self)
            atexit.register(lambda: getattr(ref(), "stop_prewarm",
                                            lambda: None)())
            self._prewarm_atexit = True

        def run() -> int:
            if prev is not None and prev.is_alive():
                prev.join()
            if reinvalidate is not None:
                self.batcher.invalidate(reinvalidate)
            staged = 0
            for tenant in tenants:
                if stop.is_set():
                    break
                jobs = []
                for m in self.blocklist.metas(tenant):
                    try:
                        jobs.append(self._scan_job(m))
                    except DoesNotExist:
                        continue
                staged += self.batcher.prewarm(self.batcher.plan(jobs),
                                               stop=stop)
            # planning read every live block's header: keep them
            if not stop.is_set():
                self.save_host_state()
            return staged

        if not background:
            return run()
        t = threading.Thread(target=run, name="search-prewarm", daemon=True)
        t.start()
        self._prewarm_thread = t
        return t

    def stop_prewarm(self, timeout_s: float = 120.0) -> None:
        """Cancel a running background prewarm and wait for it to reach
        the end of the group it is staging."""
        if self._prewarm_stop is not None:
            self._prewarm_stop.set()
        t = self._prewarm_thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout_s)

    # ------------------------------------------------------------------
    # restartable host state

    def _snapshot_path(self) -> str | None:
        return (os.path.join(self._state_dir, "search-headers.json.gz")
                if self._state_dir else None)

    def _load_host_state(self) -> None:
        """Load the search-header snapshot a previous process saved, so
        the first query's job planning reads no header from the backend.
        A torn or corrupt snapshot is ignored (the headers load lazily);
        entries of deleted blocks go at the next poll."""
        path = self._snapshot_path()
        if not path:
            return
        try:
            with open(path, "rb") as f:
                doc = json.loads(gzip.decompress(f.read()))
            headers = doc["headers"] if doc.get("v") == 1 else {}
        except (OSError, EOFError, ValueError, KeyError, TypeError,
                AttributeError):
            return
        with self._lock:
            for bid, hdr in headers.items():
                if isinstance(bid, str) and isinstance(hdr, dict):
                    self._headers[bid] = hdr
            while len(self._headers) > self._headers_max:
                self._headers.popitem(last=False)

    def save_host_state(self) -> None:
        """Write the header cache as a gzip JSON snapshot, renamed into
        place (a reader never sees half a file). Called after every poll
        and prewarm. A failed write is ignored: the snapshot is a cache."""
        path = self._snapshot_path()
        if not path:
            return
        with self._lock:
            doc = {"v": 1, "headers": dict(self._headers)}
        try:
            os.makedirs(self._state_dir, exist_ok=True)
            blob = gzip.compress(json.dumps(doc).encode(), compresslevel=1)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except OSError:
            pass

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
                    structural_cfg=self.cfg.structural(),
                    profiling=self.profiling)
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

    def _jobs(self, tenant: str, epoch: int) -> tuple[list, list]:
        """The tenant's scan jobs and its blocks without a search
        container, cached per blocklist epoch. A cached container-less
        block is probed again at each search: its DoesNotExist may have
        been a read that came before the write."""
        with self._lock:
            hit = self._jobs_cache.get(tenant)
        if hit is not None and hit[0] == epoch:
            jobs, fallback = hit[1], hit[2]
            if fallback:
                promoted, still = [], []
                for m in fallback:
                    try:
                        promoted.append(self._scan_job(m))
                    except DoesNotExist:
                        still.append(m)
                if promoted:
                    jobs, fallback = jobs + promoted, still
                    with self._lock:
                        self._jobs_cache[tenant] = (epoch, jobs, fallback)
            return jobs, fallback
        jobs, fallback = [], []
        for m in self.blocklist.metas(tenant):
            try:
                jobs.append(self._scan_job(m))
            except DoesNotExist:
                fallback.append(m)
        with self._lock:
            self._jobs_cache[tenant] = (epoch, jobs, fallback)
        return jobs, fallback

    def _fallback_search(self, metas: list[BlockMeta], req,
                         results: SearchResults) -> None:
        """Blocks without a search container, searched on the host: each
        trace object decoded and held against the request
        (``model.matches``), the whole block, stopping when the results
        are complete. A block counts as inspected with its data pages'
        bytes, booked as the query's host bytes, and as one
        ``tempo_search_fallback_scans_total``; the scan's wall time is
        the query's ``fallback_scan`` stage."""
        from ..model.codec import codec_for
        from ..model.matches import matches, trace_search_metadata

        qs = query_stats.current()
        t0 = time.perf_counter() if qs is not None else 0.0
        try:
            for m in metas:
                block = BackendBlock(self.backend, m)
                codec = codec_for(m.data_encoding)
                obs.fallback_scans.inc(tenant=m.tenant_id)
                results.metrics.inspected_blocks += 1
                nbytes = block.bytes_in_pages(0, None)
                results.metrics.inspected_bytes += nbytes
                if qs is not None:
                    qs.add_inspected(blocks=1, nbytes=nbytes,
                                     placement="host")
                for oid, obj in block.iter_objects():
                    results.metrics.inspected_traces += 1
                    trace = codec.prepare_for_read(obj)
                    if matches(trace, req, self._structural):
                        results.add(trace_search_metadata(oid, trace))
                    if results.complete:
                        return
        finally:
            if qs is not None:
                qs.add_stage("fallback_scan", time.perf_counter() - t0)

    def _begin(self, tenant: str, req):
        """This database's QueryStats for a search, or None with its
        stats gate off."""
        return query_stats.begin(
            tenant, req, enabled=self.cfg.search_query_stats_enabled)

    @staticmethod
    def _finalize_query_stats(qs, req, results: SearchResults) -> None:
        """Close the query's record and put it on the response: the device
        seconds always ride the metrics, the JSON breakdown (the
        reference's keys, sorted) only under ``req.explain``. finish()
        also publishes to the process registry. (The device bytes are
        booked by the scans themselves, stats on or off, so a database
        with its stats off answers as one with them on, the timing
        aside; the reference books them here.)"""
        d = qs.finish()
        m = results.metrics
        m.device_seconds += d["device_seconds"]
        if getattr(req, "explain", False):
            m.query_stats_json = json.dumps(d, separators=(",", ":"),
                                            sort_keys=True)

    def search(self, tenant: str, req,
               results: SearchResults | None = None) -> SearchResults:
        """Search all blocks of a tenant through the batched device engine,
        stopping early at the result limit; then, while the results are
        not complete, the blocks without a search container whose meta
        range meets the request's window (``_fallback_search``; the others
        count as skipped)."""
        self._ensure_mesh()
        results = results or SearchResults.for_request(req)
        qs = self._begin(tenant, req)
        with query_stats.activate(qs):
            epoch = self.blocklist.epoch()
            jobs, fallback = self._jobs(tenant, epoch)
            self.batcher.search(jobs, req, results,
                                plan_key=(tenant, epoch, len(jobs)))
            if fallback and not results.complete:
                live = [m for m in fallback
                        if self._include_block(m, "", "", req.start,
                                               req.end)]
                results.metrics.skipped_blocks += len(fallback) - len(live)
                if qs is not None and len(fallback) > len(live):
                    qs.add_skip("time_range", len(fallback) - len(live))
                if live:
                    self._fallback_search(live, req, results)
            if qs is not None:
                self._finalize_query_stats(qs, req, results)
        return results

    def search_block(self, req) -> SearchResults:
        """One search job (SearchBlockRequest): pages [start_page,
        start_page + pages_to_search) of one block's search container,
        with the block meta carried in the request. Runs through the
        batcher, so a repeated job hits the staged cache. A block without
        a container is scanned whole from its trace objects by the job
        that starts at page 0 (container pages do not address its
        objects), if its meta range meets the window; other jobs of it
        add nothing."""
        meta = BlockMeta(
            tenant_id=req.tenant_id, block_id=req.block_id,
            encoding=req.encoding or "zstd", version=req.version or "vT1",
            data_encoding=req.data_encoding or "v2",
            start_time=req.start_time, end_time=req.end_time)
        self._ensure_mesh()
        sr = req.search_req
        results = SearchResults.for_request(sr)
        qs = self._begin(req.tenant_id, sr)
        with query_stats.activate(qs):
            try:
                job = self._scan_job(meta, req.start_page,
                                     req.pages_to_search or None)
            except DoesNotExist:
                structural.structural_query(sr, self._structural)  # refuse
                if req.start_page == 0:
                    if self._include_block(meta, "", "", sr.start, sr.end):
                        self._fallback_search([meta], sr, results)
                    else:
                        results.metrics.skipped_blocks += 1
                        if qs is not None:
                            qs.add_skip("time_range")
                job = None
            if job is not None and job.n_pages > 0:
                self.batcher.search([job], sr, results)
            if qs is not None:
                self._finalize_query_stats(qs, sr, results)
        return results

    def search_blocks(self, breq) -> SearchResults:
        """A batched job request (SearchBlocksRequest): many page-range
        jobs, planned into groups and scanned like ``search``. The jobs
        and their plan are memoized per job list and blocklist epoch.
        Zero-page jobs (a stale meta, a start past the container) are
        dropped. Jobs of blocks without a container follow
        ``search_block``: the page-0 job scans the block's trace objects
        after the batched pass; the others are kept aside, and both are
        probed again at each search."""
        self._ensure_mesh()
        req = breq.search_req
        results = SearchResults.for_request(req)
        qs = self._begin(breq.tenant_id, req)
        with query_stats.activate(qs):
            self._search_blocks_impl(breq, req, results, qs)
            if qs is not None:
                self._finalize_query_stats(qs, req, results)
        return results

    def _search_blocks_impl(self, breq, req, results: SearchResults,
                            qs) -> None:
        sig = (breq.tenant_id,
               tuple((j.block_id, j.start_page, j.pages_to_search,
                      j.encoding, j.version, j.data_encoding)
                     for j in breq.jobs))
        epoch = self.blocklist.epoch()
        with self._lock:
            hit = self._breq_jobs_cache.get(sig)
        if hit is not None and hit[0] == epoch:
            _, jobs, fallback, missing, groups = hit
            if fallback or missing:
                promoted, still_fb, still_miss = [], [], []
                for meta in fallback:
                    try:
                        promoted.append(self._scan_job(meta))
                    except DoesNotExist:
                        still_fb.append(meta)
                for meta, sp, pp in missing:
                    try:
                        job = self._scan_job(meta, sp, pp or None)
                    except DoesNotExist:
                        still_miss.append((meta, sp, pp))
                        continue
                    if job.n_pages > 0:
                        promoted.append(job)
                if promoted:
                    jobs = jobs + promoted
                    fallback, missing = still_fb, still_miss
                    hit = (epoch, jobs, fallback, missing,
                           self.batcher.plan(jobs))
                    self._remember_breq(sig, hit)
        else:
            jobs, fallback, missing = [], [], []
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
                    if j.start_page == 0:
                        fallback.append(meta)
                    else:
                        missing.append((meta, j.start_page,
                                        j.pages_to_search))
                    continue
                if job.n_pages > 0:
                    jobs.append(job)
            hit = (epoch, jobs, fallback, missing, self.batcher.plan(jobs))
            self._remember_breq(sig, hit)
        _, jobs, fallback, _, groups = hit
        self.batcher.search(jobs, req, results, groups=groups)
        for meta in fallback:
            if results.complete:
                break
            if not self._include_block(meta, "", "", req.start, req.end):
                results.metrics.skipped_blocks += 1
                if qs is not None:
                    qs.add_skip("time_range")
                continue
            self._fallback_search([meta], req, results)

    def _remember_breq(self, sig: tuple, hit: tuple) -> None:
        with self._lock:
            self._breq_jobs_cache[sig] = hit
            while len(self._breq_jobs_cache) > 32:
                self._breq_jobs_cache.popitem(last=False)
