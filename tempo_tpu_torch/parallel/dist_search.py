"""Distributed single-block scan: the page axis over a mesh's ranks.

Counterpart of the reference's ``parallel/dist_search.py``, whose
``DistributedScanEngine._dist_kernel`` (TPU kernel family B10) runs the
single-block predicate under ``shard_map``, ``psum``s the counts and
``all_gather``s the per-shard top-k into a global top-k. Here it is a
chain over the exchange (``mesh.py``): each local rank runs K1s (K6
first for a structural query) and K2 over its slice of the block's pages
(``ScanEngine.scan_staged_async``), then one ``all_reduce`` of the counts,
one ``all_gather`` of the candidates, then K9
(``kernels.dist.shard_topk``). The answer equals the single-device
``ScanEngine``'s exactly, top-k indices included.

Staging pads the page axis to the least multiple of the shard count, as
the reference does; the span segment stages whole on every rank or, with
``StructuralConfig.shard_spans``, in ``structural.shard_span_segment``'s
per-shard layout; a value dictionary at or above ``probe_min_vals``
stages split over the value axis. ``probe_min_vals`` defaults to 0 (no
dictionary stages), the reference's default for this engine.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..observability import profile
from ..search import dict_probe, packing, query_stats, structural
from ..search.columnar import ColumnarPages
from ..search.engine import (DEFAULT_TOP_K, ScanEngine, StagedPages,
                             fetch_scan_out, pad_page_axis, resolve_top_k)
from ..search.kernels import dist as dist_k
from ..search.multiblock import _to_device, place_spans, rank_share
from ..search.pipeline import CompiledQuery, compile_query, \
    dict_fingerprint


@dataclass
class ShardedPages:
    """One block staged over a mesh: the StagedPages of each page shard
    this process runs, beside the host container."""
    shards: list                # StagedPages per local rank
    ranks: tuple
    exchange: object
    n_pages: int                # the block's own pages (before padding)
    pages: ColumnarPages
    local_flat: int             # entries a shard holds
    # dict_probe.ShardedDeviceDict when the value dictionary cleared the
    # probe threshold at staging time
    staged_dict: object = None
    span_sharded: bool = False


class DistributedScanEngine:
    """Mesh-wide single-block engine: the API of ``ScanEngine`` over a
    block whose pages shard across the exchange's ranks."""

    def __init__(self, exchange, device: torch.device,
                 top_k: int = DEFAULT_TOP_K, probe_min_vals: int | None = 0,
                 structural_cfg: structural.StructuralConfig = structural.OFF,
                 profiling: profile.Gate = profile.OFF):
        """`probe_min_vals`: the device-probe staging threshold (None =
        dict_probe.DEVICE_PROBE_MIN_VALS; <= 0, the default, stages no
        dictionary). `structural_cfg`: as for ScanEngine's stage.
        `profiling`: the gate of the chain's ``mesh`` record."""
        self.exchange = exchange
        self.device = torch.device(device)
        self.top_k = top_k
        self.probe_min_vals = probe_min_vals
        self.structural_cfg = structural_cfg
        self.profiling = profiling
        # the local step (unprofiled: the chain is one record), and the
        # compile cache of the blocks served
        self.local = ScanEngine(self.device, top_k)

    # ---- staging

    def stage(self, pages: ColumnarPages) -> ShardedPages:
        ex = self.exchange
        S = ex.world
        E = pages.geometry.entries_per_page
        B = -(-pages.n_pages // S) * S
        host = {k: packing.device_view(v)
                for k, v in pad_page_axis(pages, B).items()}
        spans = None
        sharded = False
        if self.structural_cfg.enabled:
            spans = structural.stage_single(pages, B)
            if spans is not None:
                sh = structural.shard_span_segment(self.structural_cfg,
                                                   spans, S, B, E)
                sharded = sh is not None
                spans = sh if sharded else spans
        mv = (dict_probe.DEVICE_PROBE_MIN_VALS if self.probe_min_vals is None
              else self.probe_min_vals)
        pd = None
        if 0 < mv <= len(pages.val_dict):
            pd = dataclasses.replace(dict_probe.packed_for(pages),
                                     n_shards=S)
        shards = []
        for r in ex.ranks:
            cols, rspans = rank_share(host, spans, sharded, E, r, S)
            span_dev, max_run = place_spans(rspans, self.device)
            shards.append(StagedPages(
                device={k: _to_device(v, self.device)
                        for k, v in cols.items()},
                pages=pages, span_device=span_dev, span_max_run=max_run,
                staged_dict=None if pd is None else
                dict_probe.place_device_dict(pd.shard(r), self.device,
                                             self.profiling)))
        staged = None if pd is None else dict_probe.ShardedDeviceDict(
            packed=pd, exchange=ex,
            shards=tuple(s.staged_dict for s in shards),
            profiling=self.profiling)
        return ShardedPages(shards=shards, ranks=tuple(ex.ranks), exchange=ex,
                            n_pages=pages.n_pages, pages=pages,
                            local_flat=B // S * E, staged_dict=staged,
                            span_sharded=sharded)

    # ---- compile, scan, render

    def compile(self, sp: ShardedPages, req) -> CompiledQuery | None:
        """The request compiled against the block (through the mesh probe
        when its dictionary staged); None when the block cannot match. A
        structural request compiles its predicate too (ValueError when the
        gate is off)."""
        expr = structural.structural_query(req, self.structural_cfg)
        pages = sp.pages
        cq = compile_query(pages.key_dict, pages.val_dict, req,
                           cache_on=pages, cache=self.local.compile_cache,
                           staged_dict=sp.staged_dict)
        if cq is not None and expr is not None:
            staged = None if sp.staged_dict is None else {
                dict_fingerprint(pages, pages.key_dict, pages.val_dict):
                sp.staged_dict}
            cq.structural = structural.compile_structural(
                expr, [pages], staged_dicts=staged,
                entry_kv_slots=pages.geometry.kv_per_entry)
        return cq

    def scan_staged_async(self, sp: ShardedPages, cq: CompiledQuery):
        """The B10 chain: K6?, K1s and K2 over each local shard, the
        exchange, K9; device tensors (counts [2] = (match count,
        inspected), top-k scores, top-k flat indices), no sync. The chain
        is one ``mesh`` record, which the fetch finishes."""
        k = resolve_top_k(self.top_k, cq.limit)
        rec = self.profiling.dispatch("mesh", self.device)
        rec.compile_check(("scan", "topk", "dist")
                          + (("structural",) if cq.structural is not None
                             else ()))
        with rec.launch():
            outs, counts, top_s, top_i = dist_k.exchange_merge(
                sp.exchange, sp.shards, sp.ranks,
                lambda s, r: self.local.scan_staged_async(s, cq),
                lambda o: o[:1], lambda o: torch.stack(o[1:3])[:, None],
                sp.local_flat, k, dist_k.SINGLE_LAUNCHES)
        rec.set(n_pages=sp.n_pages, shards=sp.exchange.world)
        return rec.attach((counts.to(outs[0][0].dtype), top_s[0], top_i[0]))

    def scan_staged(self, sp: ShardedPages, cq: CompiledQuery) -> tuple:
        """(count, inspected, scores, idx) on the host. The dispatch is
        attributed to the active query stats here (a caller's own
        attribution around it then bills nothing twice)."""
        with query_stats.attributed_dispatch(device=self.device):
            return fetch_scan_out(self.scan_staged_async(sp, cq))

    def scan(self, pages: ColumnarPages, cq: CompiledQuery) -> tuple:
        return self.scan_staged(self.stage(pages), cq)

    def results(self, sp: ShardedPages, cq: CompiledQuery, scores,
                idx) -> list:
        """TraceSearchMetadata of the top-k, as ScanEngine renders them
        (global flat indices over the block's pages)."""
        return self.local.results(sp, cq, scores, idx)
