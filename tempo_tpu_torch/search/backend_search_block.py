"""Backend search block: write the columnar container, read it back,
search it alone.

Counterpart of the reference's ``search/backend_search_block.py``. At
block completion the search entries are built into the columnar container
(object ``search``, compressed) plus a small JSON header
(``search-header.json``) used to prune the block without touching the
container. Blocks written here are read by the reference and vice versa.
``BackendSearchBlock.search`` answers a request from one block: header
prune, compile against its dictionaries (through the device probe when
its value dictionary was staged), kernels K1s and K2 on the device (K6
first for a structural request). It has no host route: the reference's
breaker fallback (``host_scan_single``) is not part of the port. Like the
reference's single-block engine it has no aggregate stage: an ``?agg=``
request is answered without ``agg_json``, its tag no term.
"""

from __future__ import annotations

import json
import threading

from ..backend.raw import RawBackend
from ..backend.types import NAME_SEARCH, NAME_SEARCH_HEADER, BlockMeta
from ..device import resolve_device
from ..encoding.compression import compress, decompress
from ..observability import profile
from .columnar import ColumnarPages, PageGeometry
from .data import SearchData
from . import query_stats, structural
from .engine import ScanEngine, StagedPages, stage
from .pipeline import block_header_skip_reason, compile_query, \
    dict_fingerprint
from .results import SearchResults


def write_search_block(backend: RawBackend, meta: BlockMeta,
                       entries: list[SearchData],
                       geometry: PageGeometry = PageGeometry(),
                       encoding: str = "zlib") -> dict:
    """Build the container from per-trace search data and write it."""
    return write_search_pages(backend, meta,
                              ColumnarPages.build(entries, geometry),
                              encoding)


def write_search_pages(backend: RawBackend, meta: BlockMeta,
                       pages: ColumnarPages, encoding: str = "zlib") -> dict:
    """Write an already-built container and its header, then re-commit the
    block meta with the container geometry. Returns the header."""
    header = write_search_objects(backend, meta, pages, encoding)
    backend.write_block_meta(meta)
    return header


def write_search_objects(backend: RawBackend, meta: BlockMeta,
                         pages: ColumnarPages, encoding: str = "zlib"
                         ) -> dict:
    """``write_search_pages`` without the meta commit: the container and
    its header are written and `meta` gains the container geometry, for a
    writer that commits meta.json itself once the block's other objects
    are written. Returns the header."""
    blob = compress(pages.to_bytes(), encoding)
    header = dict(pages.header)
    header["encoding"] = encoding
    header["compressed_size"] = len(blob)
    backend.write(meta.tenant_id, meta.block_id, NAME_SEARCH, blob)
    backend.write(meta.tenant_id, meta.block_id, NAME_SEARCH_HEADER,
                  json.dumps(header).encode())
    meta.search_pages = header["n_pages"]
    meta.search_size = len(blob)
    meta.search_entries_per_page = header["entries_per_page"]
    meta.search_kv_per_entry = header["kv_per_entry"]
    return header


class BackendSearchBlock:
    """One block's search header and container, loaded lazily and cached,
    and its single-block search."""

    def __init__(self, backend: RawBackend, meta: BlockMeta,
                 header: dict | None = None,
                 probe_min_vals: int | None = None, device=None,
                 packed: bool = False,
                 structural_cfg: structural.StructuralConfig = structural.OFF,
                 profiling: profile.Gate = profile.OFF):
        """`header`: an already-fetched rollup (saves one backend read).
        `probe_min_vals`: the device-probe staging threshold
        (TempoDBConfig.search_device_probe_min_vals; None = 50k, <= 0 =
        host probing only). `device`: where ``staged`` puts the block —
        ``cuda`` by default, raising without a card. `packed`: stage the
        block in the packed layout (TempoDBConfig.
        search_packed_residency; packing.py). `structural_cfg`: the
        database's structural gate (TempoDBConfig.search_structural_*);
        on, the block stages its span segment and structural requests are
        served. `profiling`: the database's profiling gate (the search's
        ``single`` record, the staging's h2d observation)."""
        self.backend = backend
        self.meta = meta
        self.probe_min_vals = probe_min_vals
        self.packed = packed
        self.structural_cfg = structural_cfg
        self.profiling = profiling
        self.device = resolve_device(device)
        self._header = header
        self._pages: ColumnarPages | None = None
        self._staged: StagedPages | None = None
        self._engine: ScanEngine | None = None
        self._lock = threading.Lock()

    def header(self) -> dict:
        if self._header is None:
            self._header = json.loads(self.backend.read(
                self.meta.tenant_id, self.meta.block_id, NAME_SEARCH_HEADER))
        return self._header

    def pages(self) -> ColumnarPages:
        with self._lock:
            if self._pages is None:
                hdr = self.header()
                blob = self.backend.read(self.meta.tenant_id,
                                         self.meta.block_id, NAME_SEARCH)
                raw = decompress(blob, hdr.get("encoding", "zstd"))
                self._pages = ColumnarPages.from_bytes(raw)
            return self._pages

    def staged(self) -> StagedPages:
        """This block alone on the device (cached). The batched path stages
        groups of blocks through the batcher instead."""
        with self._lock:
            if self._staged is not None:
                return self._staged
        sp = stage(self.pages(), self.device,
                   probe_min_vals=self.probe_min_vals, packed=self.packed,
                   spans=self.structural_cfg.enabled,
                   profiling=self.profiling)
        with self._lock:
            if self._staged is None:
                self._staged = sp
            return self._staged

    def engine(self) -> ScanEngine:
        """The block's own single-block engine (and compile cache)."""
        with self._lock:
            if self._engine is None:
                self._engine = ScanEngine(self.device, packed=self.packed,
                                          profiling=self.profiling)
            return self._engine

    def search(self, req,
               results: SearchResults | None = None) -> SearchResults:
        """Answer `req` from this block alone, adding to `results`. The
        block counts as inspected; a header or dictionary prune counts it
        as skipped too, as the reference does. A structural request is
        refused (ValueError) when the gate is off. The active query stats
        book the skip and its reason, the compile's probe and the scan's
        dispatch, and the block's bytes."""
        expr = structural.structural_query(req, self.structural_cfg)
        engine = self.engine()
        results = results or SearchResults.for_request(req)
        qs = query_stats.current()
        m = results.metrics
        m.inspected_blocks += 1
        reason = block_header_skip_reason(self.header(), req)
        if reason is not None:
            m.skipped_blocks += 1
            if qs is not None:
                qs.add_skip(reason)
            return results
        sp = self.staged()
        with query_stats.attributed_dispatch(qs):
            cq = compile_query(sp.pages.key_dict, sp.pages.val_dict, req,
                               cache_on=sp.pages, cache=engine.compile_cache,
                               staged_dict=sp.staged_dict,
                               packed=engine.packed)
            if cq is not None and expr is not None:
                pages = sp.pages
                staged = None if sp.staged_dict is None else {
                    dict_fingerprint(pages, pages.key_dict, pages.val_dict):
                    sp.staged_dict}
                cq.structural = structural.compile_structural(
                    expr, [pages], staged_dicts=staged, packed=engine.packed,
                    entry_kv_slots=pages.geometry.kv_per_entry)
                if qs is not None:
                    qs.add_structural(cq.structural)
        if cq is None:
            m.skipped_blocks += 1
            if qs is not None:
                qs.add_skip("dict")
            return results
        with query_stats.attributed_dispatch(qs, self.device):
            _count, inspected, scores, idx = engine.scan_staged(sp, cq)
        hdr = self.header()
        nbytes = int(hdr.get("compressed_size", 0))
        m.inspected_traces += inspected
        m.inspected_bytes += nbytes
        m.inspected_bytes_device += nbytes
        if qs is not None:
            qs.add_inspected(blocks=1, nbytes=nbytes, placement="device")
        m.truncated_entries += int(hdr.get("truncated_entries", 0) or 0)
        for meta in engine.results(sp, cq, scores, idx):
            results.add(meta)
        return results
