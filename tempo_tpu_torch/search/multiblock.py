"""Multi-block batched scanning.

Counterpart of the reference's ``search/multiblock.py`` on its default
path. Many blocks' pages stack along one page axis and scan in one
dispatch; a per-page block index (``page_block``) selects each page's row
of the per-block term tables, because every block keeps its own
dictionaries and the query compiles per block. Value dictionaries at or
above the probe threshold stage with the batch (``staged_dicts``), and
their blocks' terms compile through the device probe (K3) to hit masks,
stacked per distinct dictionary as ``val_hits [G, T, Vm]`` with a
``block_group [B]`` row map; the other blocks keep their id ranges, so
one batch mixes both. The dispatch is two hand-written kernels: K1
(``kernels.scan.multi_scan``) evaluates the predicate and writes a score
per entry plus the match and inspected counts, and K2
(``kernels.topk.topk``) picks the k most recent matches. Concurrent
requests over one staged batch stack along a query axis
(``stack_queries``) and run as one fused dispatch
(``MultiBlockEngine.coalesced_scan_async``): K4
(``kernels.scan.coalesced_scan``) then K2r (``kernels.topk.topk_rows``).
An engine made with ``packed=True`` stages its batches in the packed
layout of ``packing.py`` (``HostBatch.widths``), which the kernels read
as they are, and its probe products are word masks. An engine whose
structural gate is on (``structural.StructuralConfig``) stages the
blocks' span segments with each batch (``HostBatch.span_cat``); a query
carrying a compiled structural predicate (``MultiQuery.structural``)
runs K6 (``kernels.structural.structural_mask``) first and hands its
verdicts to K1, or, stacked, to K4. A query asking for an ``?agg=``
aggregate (``MultiQuery.agg_stage``, the batch's staged composite keys of
``analytics.py``) runs K7 (``kernels.agg``) over K1's scores, or over
K4's rows, before the top-k.

An engine given an exchange (``parallel/mesh.py``) runs the reference's
mesh kernels ``dist_multi_scan_kernel`` and ``dist_coalesced_scan_kernel``
(TPU kernel family B10) as per-shard chains: its batches pad the page
axis as the reference's mesh staging does (``stage_host``) and stage
only the pages of the ranks this process runs (``shard_host``,
``ShardedBatch``); a dispatch runs the local chain (K6, K1 or K4, K7,
K2 or K2r) over each local shard, then the exchange (``all_reduce`` of
counts, inspected and aggregates, ``all_gather`` of the top-k
candidates), then K9 (``kernels.dist.shard_topk``), the merge, which
gives the single-device answer exactly.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..model.types import TraceSearchMetadata
from ..observability import profile
from . import dict_probe, packing, structural
from .columnar import ColumnarPages
from .engine import DEFAULT_TOP_K, fetch_scan_out, resolve_top_k
from .kernels import dist as dist_k
from .kernels.agg import agg_counts, agg_counts_rows
from .kernels.scan import coalesced_scan, multi_scan
from .kernels.structural import structural_mask
from .kernels.topk import topk, topk_rows
from .pipeline import CompileCache, CompiledQuery, compile_query, \
    dict_fingerprint

# kv columns narrow to int8 / int16 / int32 by dictionary size (or pack,
# see packing.py); the entry columns keep the container's uint32 bits in
# int32 tensors (torch has few uint32 ops) and the kernel compares them as
# uint32
_PAGE_ARRAYS = ("kv_key", "kv_val", "entry_start", "entry_end", "entry_dur",
                "entry_valid")


@dataclass
class HostBatch:
    """Stacked, padded numpy arrays of a group of blocks, ready for one
    host-to-device copy."""
    cat: dict                       # name -> stacked array, incl. page_block
    page_block: np.ndarray          # int32 [P_total], -1 on pad pages
    blocks: list                    # list[ColumnarPages]
    page_offset: list               # first stacked page of each block
    # fp -> dict_probe.PackedDeviceDict of each distinct value dictionary
    # at or above the probe threshold
    packed_dicts: dict = field(default_factory=dict)
    # packing.py's (key, value, duration) widths; None = the unpacked
    # layout
    widths: tuple | None = None
    # bytes the unpacked layout would stage for `cat` (== its bytes when
    # widths is None)
    cat_logical_nbytes: int = 0
    # the blocks' span segments (structural.stack_spans), staged when the
    # engine's structural gate is on and some block carries spans
    span_cat: dict | None = None
    # span_cat is in shard_span_segment's per-shard layout
    span_sharded: bool = False

    @property
    def nbytes(self) -> int:
        """What placing the whole batch on one device pins: the stacked
        arrays, the span segment and the probe dictionaries."""
        return int(sum(v.nbytes for v in self.cat.values())) \
            + self._side_nbytes

    @property
    def logical_nbytes(self) -> int:
        """`nbytes` in the unpacked layout."""
        if self.widths is None:
            return self.nbytes
        return self.cat_logical_nbytes + self._side_nbytes

    @property
    def dict_nbytes(self) -> int:
        return int(sum(d.nbytes for d in self.packed_dicts.values()))

    @property
    def _side_nbytes(self) -> int:
        return self.dict_nbytes + int(sum(
            v.nbytes for v in (self.span_cat or {}).values()))


@dataclass
class BlockBatch:
    """A HostBatch's arrays resident on the device."""
    device: dict                    # name -> tensor [P_total, ...]
    page_block: np.ndarray          # host copy, for result rendering
    blocks: list
    page_offset: list
    memo: dict = field(default_factory=dict)   # query-independent memos
    # fp -> dict_probe.DeviceDict: the staged value dictionaries whose
    # blocks compile through the device probe
    staged_dicts: dict = field(default_factory=dict)
    widths: tuple | None = None     # as HostBatch.widths
    logical_device_nbytes: int = 0  # HostBatch.cat_logical_nbytes
    # HostBatch.span_cat on the device (uint32 span_dur as int32 bits),
    # and the longest entry run (K6's scratch length for a run longer
    # than its tiles hold)
    span_device: dict | None = None
    span_max_run: int = 0
    # the ?agg= composite keys (analytics.AggStage), staged at the first
    # agg request over the batch (analytics.stage_for_batch)
    agg_stage: object = None

    @property
    def n_pages(self) -> int:
        return int(self.page_block.shape[0])

    @property
    def dict_nbytes(self) -> int:
        """Device bytes pinned by the staged dictionaries."""
        return int(sum(d.nbytes for d in self.staged_dicts.values()))

    @property
    def span_nbytes(self) -> int:
        """Device bytes pinned by the staged span segment (its span axis
        padded to a power of two)."""
        return int(sum(t.numel() * t.element_size()
                       for t in (self.span_device or {}).values()))

    @property
    def device_nbytes(self) -> int:
        """Device bytes of the stacked arrays and the span segment, which
        a scan reads (the staged bytes a query's stats book; packed bytes
        when packed)."""
        return int(sum(t.numel() * t.element_size()
                       for t in self.device.values())) + self.span_nbytes

    @property
    def nbytes(self) -> int:
        """Device bytes pinned by the stacked arrays, the span segment and
        the staged dictionaries: physical bytes, what the staged cache's
        budget charges."""
        return int(sum(t.numel() * t.element_size()
                       for t in self.device.values())) + self.dict_nbytes \
            + self.span_nbytes

    @property
    def logical_nbytes(self) -> int:
        """What `nbytes` would be in the unpacked layout (the same when
        the batch is not packed)."""
        if self.widths is None:
            return self.nbytes
        return self.logical_device_nbytes + self.dict_nbytes \
            + self.span_nbytes


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _narrow(n: int):
    return (np.int8 if n <= 127          # the -1 pad stays in range
            else np.int16 if n <= 32_767 else np.int32)


def pack_batch_dicts(blocks: list[ColumnarPages],
                     probe_min_vals: int | None, n_shards: int = 1) -> dict:
    """fp -> PackedDeviceDict for every distinct value dictionary with at
    least `probe_min_vals` values (None = dict_probe's default; <= 0
    disables), split over `n_shards` value shards. The packing memoizes
    on the immutable block container, so an evicted batch re-stacked from
    the same blocks packs nothing."""
    mv = (dict_probe.DEVICE_PROBE_MIN_VALS if probe_min_vals is None
          else probe_min_vals)
    out: dict = {}
    if mv <= 0:
        return out
    for b in blocks:
        if len(b.val_dict) < mv:
            continue
        fp = dict_fingerprint(b, b.key_dict, b.val_dict)
        if fp not in out:
            out[fp] = dataclasses.replace(dict_probe.packed_for(b),
                                          n_shards=n_shards)
    return out


def stack_host(blocks: list[ColumnarPages],
               pad_to: int | None = None,
               probe_min_vals: int | None = 0,
               packed: bool = False, spans: bool = False,
               n_shards: int = 1) -> HostBatch:
    """Concatenate blocks of one entries-per-page along the page axis.

    The kv columns narrow to the smallest dtype the group's largest
    dictionary allows (the reference's ``multiblock.py:257-261`` rule), and
    narrower-C blocks pad their slots with -1. Pages past the blocks' own,
    up to `pad_to`, are pad pages: page_block -1, kv -1, invalid entries.
    `probe_min_vals` routes dictionaries at or above that size into the
    probe staging (``pack_batch_dicts``); the default 0 stages none.

    With `packed`, the reference's packed branch (``multiblock.py:
    237-340``): widths from the largest dictionaries and the largest
    header duration (``packing.plan_widths``), C padded to even for u4,
    each block's kv columns packed before stacking, durations packed
    before the page padding (adding ``entry_dur_res`` when bucketed), pad
    pages with code 0. Unsigned 16 and 32-bit columns (the entry columns'
    u32 in either layout) hold their bits in int16/int32 arrays
    (``packing.device_view``). With `spans` (the structural gate on), the
    blocks' span segments stack too (``structural.stack_spans``).
    `n_shards` splits the probe dictionaries over a mesh's value axis
    (``dict_probe.PackedDeviceDict.shard``)."""
    E = blocks[0].geometry.entries_per_page
    C = C0 = max(b.geometry.kv_per_entry for b in blocks)
    n_keys = max(len(b.key_dict) for b in blocks)
    n_vals = max(len(b.val_dict) for b in blocks)
    widths = None
    if packed:
        widths = packing.plan_widths(n_keys, n_vals,
                                     max(b.max_dur_ms() for b in blocks))
        if "u4" in widths[:2] and C % 2:
            C += 1   # both kv columns unpack to one (even) slot count
    kv_dtype = {"kv_key": _narrow(n_keys), "kv_val": _narrow(n_vals)}
    kv_width = None if widths is None else {"kv_key": widths[0],
                                            "kv_val": widths[1]}
    arrays = {name: [] for name in _PAGE_ARRAYS}
    page_block = []
    page_offset = []
    total = 0
    for bi, b in enumerate(blocks):
        if b.geometry.entries_per_page != E:
            raise ValueError("blocks must share entries_per_page to batch")
        page_offset.append(total)
        P = b.n_pages
        for name in _PAGE_ARRAYS:
            arr = getattr(b, name)
            if name in kv_dtype:
                if kv_width is None:
                    arr = arr.astype(kv_dtype[name], copy=False)
                if arr.shape[2] < C:
                    pad = np.full((P, E, C - arr.shape[2]), -1,
                                  dtype=arr.dtype)
                    arr = np.concatenate([arr, pad], axis=2)
                if kv_width is not None:
                    arr = packing.pack_ids_array(arr, kv_width[name])
            arrays[name].append(arr)
        page_block.extend([bi] * P)
        total += P
    if len(blocks) == 1 and not (pad_to and pad_to > total):
        cat = {k: v[0] for k, v in arrays.items()}
    else:
        cat = {k: np.concatenate(v, axis=0) for k, v in arrays.items()}
    page_block = np.asarray(page_block, dtype=np.int32)
    if widths is not None:
        # before the page padding, so pad rows are zero buckets
        q, res = packing.pack_duration(cat["entry_dur"], widths[2])
        cat["entry_dur"] = q
        if res is not None:
            cat["entry_dur_res"] = res
    if pad_to and pad_to > total:
        extra = pad_to - total
        for name, arr in cat.items():
            pad = np.zeros((extra,) + arr.shape[1:], dtype=arr.dtype)
            if name in kv_dtype and widths is None:
                pad -= 1         # the packed layout pads with code 0
            cat[name] = np.concatenate([arr, pad], axis=0)
        page_block = np.concatenate(
            [page_block, np.full(extra, -1, dtype=np.int32)])
    # unsigned bits in signed arrays: the u32 entry columns, and the
    # packed layout's u16/u32 ones
    cat = {k: packing.device_view(v) for k, v in cat.items()}
    cat["page_block"] = page_block
    entries_padded = int(page_block.shape[0]) * E
    logical = (packing.logical_nbytes(entries_padded, C0, n_keys, n_vals)
               + int(page_block.nbytes) if widths is not None
               else int(sum(v.nbytes for v in cat.values())))
    span_cat = (structural.stack_spans(blocks, E, int(page_block.shape[0]))
                if spans else None)
    return HostBatch(cat=cat, page_block=page_block, blocks=blocks,
                     page_offset=page_offset,
                     packed_dicts=pack_batch_dicts(blocks, probe_min_vals,
                                                   n_shards),
                     widths=widths, cat_logical_nbytes=logical,
                     span_cat=span_cat)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    # arrays decoded from a container are read-only views of its bytes;
    # torch wants a writable buffer even when it only copies from it
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")
    return torch.from_numpy(a).to(device)


def place_batch(host: HostBatch, device: torch.device,
                profiling: profile.Gate = profile.OFF,
                mode: str = "batched") -> BlockBatch:
    """Host-to-device copy of a stacked batch, its span segment and its
    probe dictionaries. `profiling` observes the stacked arrays' copy as
    an h2d stage of `mode` (the dictionaries' as mode dict_probe), and
    the dictionaries keep it for their probe's records."""
    t0 = time.perf_counter() if profiling.enabled else 0.0
    dev = {k: _to_device(v, device) for k, v in host.cat.items()}
    if profiling.enabled:
        profiling.observe_stage(
            "h2d", mode, time.perf_counter() - t0,
            nbytes=sum(int(v.nbytes) for v in host.cat.values()))
    staged = {fp: dict_probe.place_device_dict(pd, device, profiling)
              for fp, pd in host.packed_dicts.items()}
    span_dev, max_run = place_spans(host.span_cat, device)
    return BlockBatch(device=dev, page_block=host.page_block,
                      blocks=host.blocks, page_offset=host.page_offset,
                      staged_dicts=staged, widths=host.widths,
                      logical_device_nbytes=host.cat_logical_nbytes,
                      span_device=span_dev, span_max_run=max_run)


def place_spans(span_cat: dict | None, device: torch.device) -> tuple:
    """(span columns on the device, the longest entry run), or (None, 0)
    for a batch without spans."""
    if span_cat is None:
        return None, 0
    return ({k: _to_device(packing.device_view(v), device)
             for k, v in span_cat.items()},
            structural.max_entry_run(span_cat))


def rank_share(cols: dict, span_cat: dict | None, span_sharded: bool,
               E: int, rank: int, world: int) -> tuple:
    """Rank `rank`'s share of page-major columns stacked for `world` page
    shards (the page count a multiple of `world`): (its contiguous page
    slice of every column, its span columns by ``structural.rank_spans``
    or None without spans)."""
    P = int(next(iter(cols.values())).shape[0])
    if P % world:
        raise ValueError(f"{P} pages do not split over {world} shards")
    pp = P // world
    rows = slice(rank * pp, (rank + 1) * pp)
    spans = None if span_cat is None else structural.rank_spans(
        span_cat, rank, world, span_sharded, E)
    return {k: v[rows] for k, v in cols.items()}, spans


def shard_host(host: HostBatch, rank: int, world: int) -> HostBatch:
    """Rank `rank`'s share of a batch stacked for `world` page shards (the
    page count a multiple of `world`): its contiguous page slice of the
    stacked columns (kv and entry columns, page_block), its value range
    of each probe dictionary, and its span columns
    (``structural.rank_spans``). The blocks, their page offsets and every
    per-block table stay global: a page's block index is the same on
    every rank."""
    cat, spans = rank_share(host.cat, host.span_cat, host.span_sharded,
                            host.blocks[0].geometry.entries_per_page, rank,
                            world)
    return dataclasses.replace(
        host, cat=cat, page_block=cat["page_block"], span_cat=spans,
        packed_dicts={fp: pd.shard(rank)
                      for fp, pd in host.packed_dicts.items()})


@dataclass
class ShardedBatch:
    """A batch staged over a mesh: the BlockBatch of each page shard this
    process runs (one on a ShardExchange, every rank's on a
    LocalExchange), beside the host facts every rank holds alike. Its
    byte sizes are the whole batch's (``HostBatch.nbytes``), equal on
    every rank, so the staged cache evicts alike on every rank."""
    shards: list                    # BlockBatch per local rank
    ranks: tuple                    # their ranks
    exchange: object
    page_block: np.ndarray          # global [P]
    blocks: list
    page_offset: list
    local_flat: int                 # entries a shard holds
    staged_dicts: dict              # fp -> dict_probe.ShardedDeviceDict
    widths: tuple | None
    nbytes: int
    logical_nbytes: int
    dict_nbytes: int
    span_sharded: bool = False
    memo: dict = field(default_factory=dict)
    agg_stage: object = None
    logical_device_nbytes: int = 0  # the whole HostBatch.cat_logical_nbytes

    @property
    def n_pages(self) -> int:
        return int(self.page_block.shape[0])

    @property
    def world(self) -> int:
        return self.exchange.world

    @property
    def device_nbytes(self) -> int:
        """BlockBatch.device_nbytes of the whole batch, equal on every
        rank."""
        return self.nbytes - self.dict_nbytes


def place_sharded(host: HostBatch, exchange, device: torch.device,
                  profiling: profile.Gate = profile.OFF) -> ShardedBatch:
    """Host-to-device copy of the local ranks' shares of a batch stacked
    for ``exchange.world`` shards (h2d observed as mode mesh)."""
    world = exchange.world
    shards = [place_batch(shard_host(host, r, world), device, profiling,
                          "mesh")
              for r in exchange.ranks]
    staged = {fp: dict_probe.ShardedDeviceDict(
                  packed=pd, exchange=exchange,
                  shards=tuple(b.staged_dicts[fp] for b in shards),
                  profiling=profiling)
              for fp, pd in host.packed_dicts.items()}
    E = host.blocks[0].geometry.entries_per_page
    return ShardedBatch(
        shards=shards, ranks=tuple(exchange.ranks), exchange=exchange,
        page_block=host.page_block, blocks=host.blocks,
        page_offset=host.page_offset,
        local_flat=int(host.page_block.shape[0]) // world * E,
        staged_dicts=staged, widths=host.widths, nbytes=host.nbytes,
        logical_nbytes=host.logical_nbytes, dict_nbytes=host.dict_nbytes,
        span_sharded=host.span_sharded,
        logical_device_nbytes=host.cat_logical_nbytes)


@dataclass
class MultiQuery:
    """Per-block compiled query folded into block-indexed tables."""
    term_keys: np.ndarray    # int32 [B, T']; -1 = this block cannot match
    val_ranges: np.ndarray   # int32 [B, T', R, 2]
    dur_lo: int
    dur_hi: int
    win_start: int
    win_end: int
    limit: int
    n_terms: int
    # device-probe product: [G, T', Vm] hit masks (bool, or int32 words
    # in a packed engine), one row per distinct probed dictionary, on the
    # device; and int32 [B] block ->
    # row (-1: the block's ranges apply). None when no block probed.
    val_hits: object = None
    block_group: np.ndarray | None = None
    # device copies of the tables (term_keys, val_ranges, block_group),
    # made at the first dispatch and reused by every later dispatch of
    # this query over the same batch
    device_tables: tuple | None = None
    # the request's structural predicate compiled against this batch
    # (structural.CompiledStructural), or None
    structural: object = None
    # the batch's analytics.AggStage when the request asks for an ?agg=
    # aggregate: set on the batcher's per-request copy, never on the
    # memoized query an agg and a plain twin share
    agg_stage: object = None


def _dict_groups(blocks: list[ColumnarPages], memo: dict | None = None):
    """(fp_of, rep_idx, rows_of): which blocks share which dictionary.
    Query-independent, so it memoizes on the staged batch."""
    if memo is not None and "dict_groups" in memo:
        return memo["dict_groups"]
    fp_of: list[bytes] = []
    rep_idx: dict[bytes, int] = {}
    rows_of: dict[bytes, list[int]] = {}
    for i, b in enumerate(blocks):
        fp = dict_fingerprint(b, b.key_dict, b.val_dict)
        fp_of.append(fp)
        rep_idx.setdefault(fp, i)
        rows_of.setdefault(fp, []).append(i)
    out = (fp_of, rep_idx, rows_of)
    if memo is not None:
        memo["dict_groups"] = out
    return out


def compile_multi(blocks: list[ColumnarPages], req,
                  skip: list[bool] | None = None, memo: dict | None = None,
                  cache: CompileCache | None = None,
                  staged_dicts: dict | None = None,
                  packed: bool = False) -> MultiQuery | None:
    """Compile the request against every block's dictionaries, once per
    distinct dictionary. Blocks that prune get key id -1 (no page of theirs
    can match); `skip[i]` marks blocks already pruned by their header, which
    stay in the batch and are masked back to that sentinel (group -1, key
    -1). `staged_dicts` (the batch's, by fingerprint) sends those
    dictionaries' terms to the device probe; with `packed` its hit masks
    come back as words. None when every block prunes."""
    fp_of, rep_idx, rows_of = _dict_groups(blocks, memo)
    staged_dicts = staged_dicts or {}
    compiled: dict[bytes, CompiledQuery | None] = {}
    for fp, i in rep_idx.items():
        b = blocks[i]
        compiled[fp] = compile_query(b.key_dict, b.val_dict, req,
                                     cache_on=b, cache=cache,
                                     staged_dict=staged_dicts.get(fp),
                                     packed=packed)
    per_block = [None if (skip is not None and skip[i]) else compiled[fp_of[i]]
                 for i in range(len(blocks))]
    if all(cq is None for cq in per_block):
        return None
    T = max((cq.n_terms for cq in per_block if cq is not None), default=0)
    B = len(blocks)
    rmax = 1
    for cq in per_block:
        if cq is not None and cq.n_terms:
            rmax = max(rmax, cq.val_ranges.shape[1])
    R = _pow2(rmax)
    term_keys = np.full((B, max(1, T)), -1, dtype=np.int32)
    val_ranges = np.tile(np.array([1, 0], dtype=np.int32),
                         (B, max(1, T), R, 1))
    for fp, cq in compiled.items():
        if cq is None or not cq.n_terms:
            continue
        rows = np.asarray(rows_of[fp], dtype=np.int64)
        t_n = min(cq.n_terms, term_keys.shape[1])
        r_n = min(cq.val_ranges.shape[1], val_ranges.shape[2])
        term_keys[rows[:, None], np.arange(t_n)] = cq.term_keys[:t_n]
        val_ranges[rows[:, None, None], np.arange(t_n)[:, None],
                   np.arange(r_n)] = cq.val_ranges[:t_n, :r_n]
    val_hits, block_group = _stack_hits(compiled, rows_of, B, max(1, T))
    if skip is not None and any(skip):
        sk = np.asarray(skip, dtype=bool)
        term_keys[sk] = -1
        val_ranges[sk] = np.array([1, 0], dtype=np.int32)
        if block_group is not None:
            block_group[sk] = -1
    any_cq = next(cq for cq in per_block if cq is not None)
    return MultiQuery(term_keys=term_keys, val_ranges=val_ranges,
                      dur_lo=any_cq.dur_lo, dur_hi=any_cq.dur_hi,
                      win_start=any_cq.win_start, win_end=any_cq.win_end,
                      limit=any_cq.limit, n_terms=T, val_hits=val_hits,
                      block_group=block_group)


def _stack_hits(compiled: dict, rows_of: dict, B: int, Tp: int):
    """(val_hits [G, Tp, Vm], block_group [B]) from the probed
    dictionaries' [T, V] masks (bool, or words), zero-padded to the
    widest dictionary; (None, None) when no dictionary probed. A single
    mask of full width is used as it is, with no copy. Word masks pass
    through as words (one compile_multi call compiles every dictionary
    in one format, its `packed`)."""
    probe_fps = [fp for fp, cq in compiled.items()
                 if cq is not None and cq.n_terms and cq.val_hits is not None]
    if not probe_fps:
        return None, None
    masks = [compiled[fp].val_hits for fp in probe_fps]
    Vm = max(int(h.shape[1]) for h in masks)
    if len(masks) == 1 and masks[0].shape[0] == Tp:
        val_hits = masks[0].unsqueeze(0)
    else:
        val_hits = torch.zeros((len(masks), Tp, Vm), dtype=masks[0].dtype,
                               device=masks[0].device)
        for g, h in enumerate(masks):
            t_n = min(int(h.shape[0]), Tp)
            val_hits[g, :t_n, :h.shape[1]] = h[:t_n]
    block_group = np.full(B, -1, dtype=np.int32)
    for g, fp in enumerate(probe_fps):
        block_group[np.asarray(rows_of[fp], dtype=np.int64)] = g
    return val_hits, block_group


@dataclass
class CoalescedQuery:
    """Several requests' MultiQueries over the same staged batch, stacked
    along a query axis for one fused dispatch (K4 + K2r)."""
    term_keys: np.ndarray    # int32 [Q, B, T]
    val_ranges: np.ndarray   # int32 [Q, B, T, R, 2]
    term_active: np.ndarray  # bool [Q, T]; False = padding term (no-op)
    dur_lo: np.ndarray       # uint32 [Q]
    dur_hi: np.ndarray       # uint32 [Q]
    win_start: np.ndarray    # uint32 [Q]
    win_end: np.ndarray      # uint32 [Q]
    n_terms: int             # T, padded
    n_queries: int           # real queries; the pad rows match nothing
    # device-probe members: Q entries, each the member's own hit tables
    # [G, T', V] (bool or words) on the device or None (a host-compiled
    # member, a
    # pad query), and int32 [Q, B] block -> group rows, all -1 for those
    # without tables. None when no member probed.
    val_hits: tuple | None = None
    block_group: np.ndarray | None = None
    # the members' structural predicates, one K6 lane each
    # (structural.StackedStructural or BucketedStructural), or None
    structural: object = None
    # the batch's analytics.AggStage when a member asks for an aggregate
    # (K7 then counts a row per real member)
    agg_stage: object = None


def stack_queries(mqs: list[MultiQuery],
                  bucket_max_nodes: int = 16) -> CoalescedQuery:
    """Stack compiled queries over the same block batch along the query
    axis, the reference's ``multiblock.stack_queries``. Q, T and R pad
    to powers of two. A real query's
    extra terms are inactive (neutral-true in the AND); a pad query gets
    the empty duration range dur_lo 1 > dur_hi 0, so it matches nothing.
    dur_hi and win_end clamp to uint32. Structural members stack when
    every member carries one and all share one plan, or all canonicalize
    into one bucket of at most `bucket_max_nodes` slots
    (``structural.stack_members``); a mixed group raises. Members share
    one batch, so an aggregate member's AggStage is the batch's, and any
    member asking for one turns K7 on for the group."""
    sts = [mq.structural for mq in mqs]
    stacked_st = None
    if any(st is not None for st in sts):
        if any(st is None for st in sts):
            raise ValueError(
                "coalesced structural queries must all share one plan")
        stacked_st = structural.stack_members(sts, bucket_max_nodes)
    Qn = len(mqs)
    B = mqs[0].term_keys.shape[0]
    Q = _pow2(Qn)
    T = _pow2(max(1, max(mq.n_terms for mq in mqs)))
    R = _pow2(max(mq.val_ranges.shape[2] for mq in mqs))
    term_keys = np.full((Q, B, T), -1, dtype=np.int32)
    val_ranges = np.tile(np.array([1, 0], dtype=np.int32), (Q, B, T, R, 1))
    term_active = np.zeros((Q, T), dtype=bool)
    dur_lo = np.ones(Q, dtype=np.uint32)
    dur_hi = np.zeros(Q, dtype=np.uint32)
    win_start = np.zeros(Q, dtype=np.uint32)
    win_end = np.zeros(Q, dtype=np.uint32)
    for qi, mq in enumerate(mqs):
        if mq.term_keys.shape[0] != B:
            raise ValueError("coalesced queries must share one batch")
        t_n = mq.term_keys.shape[1]
        term_keys[qi, :, :t_n] = mq.term_keys
        val_ranges[qi, :, :t_n, :mq.val_ranges.shape[2]] = mq.val_ranges
        term_active[qi, :mq.n_terms] = True
        dur_lo[qi] = mq.dur_lo
        dur_hi[qi] = min(mq.dur_hi, 0xFFFFFFFF)
        win_start[qi] = mq.win_start
        win_end[qi] = min(mq.win_end, 0xFFFFFFFF)
    val_hits = block_group = None
    if any(mq.val_hits is not None for mq in mqs):
        # each member keeps its own device tables; K4 reads them through
        # a table of their addresses instead of a stacked copy
        val_hits = tuple(mq.val_hits for mq in mqs) + (None,) * (Q - Qn)
        block_group = np.full((Q, B), -1, dtype=np.int32)
        for qi, mq in enumerate(mqs):
            if mq.val_hits is not None:
                block_group[qi] = mq.block_group
    aggs = [mq.agg_stage for mq in mqs if mq.agg_stage is not None]
    return CoalescedQuery(
        term_keys=term_keys, val_ranges=val_ranges, term_active=term_active,
        dur_lo=dur_lo, dur_hi=dur_hi, win_start=win_start, win_end=win_end,
        n_terms=T, n_queries=Qn, val_hits=val_hits, block_group=block_group,
        structural=stacked_st, agg_stage=aggs[0] if aggs else None)


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.bool_): torch.bool}


def _upload(arrays: list, device: torch.device) -> list:
    """Small int32/bool arrays on the device with one host-to-device copy:
    their bytes packed at 8-byte offsets into one buffer, viewed back."""
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.nbytes // 8) * 8
    buf = np.zeros(total, dtype=np.uint8)
    for a, o in zip(arrays, offs):
        buf[o:o + a.nbytes] = np.ascontiguousarray(a).view(np.uint8).ravel()
    dev = torch.from_numpy(buf).to(device)
    return [dev[o:o + a.nbytes].view(_TORCH_DTYPES[a.dtype]).reshape(a.shape)
            for a, o in zip(arrays, offs)]


class MultiBlockEngine:
    """Batched scan over many blocks in one dispatch on one device, or,
    given an exchange, over a mesh's page shards."""

    def __init__(self, device: torch.device, top_k: int = DEFAULT_TOP_K,
                 device_probe_min_vals: int | None = None,
                 packed: bool = False,
                 structural_cfg: structural.StructuralConfig = structural.OFF,
                 exchange=None, profiling: profile.Gate = profile.OFF):
        """`device_probe_min_vals`: value-dictionary size at which a
        batch stages the dictionary for the device probe (None =
        dict_probe.DEVICE_PROBE_MIN_VALS; <= 0 keeps every probe on the
        host). `packed`: stage batches in the packed layout and keep probe
        products as word masks (packing.py). `structural_cfg`: the
        database's structural gate; on, batches stage span segments.
        `exchange` (``parallel.mesh.ShardExchange`` or ``LocalExchange``):
        batches shard over its ranks and dispatches run the B10 chains.
        `profiling`: the database's gate; on, each dispatch opens a record
        (``batched``, ``coalesced``, or ``mesh`` over an exchange) that
        the fetch of its outputs finishes."""
        self.device = device
        self.top_k = top_k
        self.device_probe_min_vals = device_probe_min_vals
        self.packed = packed
        self.structural_cfg = structural_cfg
        self.exchange = exchange
        self.profiling = profiling
        self.compile_cache = CompileCache(profiling)

    def stage_host(self, blocks: list[ColumnarPages]) -> HostBatch:
        """Stack a batch on the host with its page count padded to a power
        of two (the reference buckets shapes this way to bound recompiles;
        the port keeps the layout so both scan the same padded batch). On
        a mesh of S shards, the reference's mesh staging: the page count
        doubles from S (or, with ``structural_cfg.remainder_pages``, is the
        least multiple of S), the probe dictionaries split over S value
        shards, and with ``shard_spans`` the span segment takes
        ``structural.shard_span_segment``'s layout."""
        total = sum(b.n_pages for b in blocks)
        if self.exchange is None:
            return stack_host(blocks, pad_to=_pow2(total),
                              probe_min_vals=self.device_probe_min_vals,
                              packed=self.packed,
                              spans=self.structural_cfg.enabled)
        S = self.exchange.world
        pad_to = structural.remainder_pad(self.structural_cfg, total, S)
        if pad_to is None:
            pad_to = S
            while pad_to < total:
                pad_to *= 2
        host = stack_host(blocks, pad_to=pad_to,
                          probe_min_vals=self.device_probe_min_vals,
                          packed=self.packed,
                          spans=self.structural_cfg.enabled, n_shards=S)
        if host.span_cat is not None:
            sh = structural.shard_span_segment(
                self.structural_cfg, host.span_cat, S, pad_to,
                blocks[0].geometry.entries_per_page)
            if sh is not None:
                host.span_cat, host.span_sharded = sh, True
        return host

    def place(self, host: HostBatch):
        """A BlockBatch, or on a mesh the ShardedBatch of the local
        ranks."""
        if self.exchange is None:
            return place_batch(host, self.device, self.profiling)
        return place_sharded(host, self.exchange, self.device,
                             self.profiling)

    def structural_verdicts(self, batch: BlockBatch,
                            lanes: structural.Lanes):
        """K6 over the batch for each lane: uint8 [Q, P*E]."""
        d = batch.device
        return structural_mask(
            d["kv_key"], d["kv_val"], d["entry_dur"], d["entry_valid"],
            d["page_block"], batch.span_device, batch.span_max_run,
            lanes.device(self.device), lanes.val_hits, batch.widths,
            d.get("entry_dur_res"))

    def scan_async(self, batch, mq: MultiQuery):
        """One dispatch, K1 then K2 on the current stream (K6 first for a
        structural query, its verdicts into K1; K7 over K1's scores before
        K2 for an agg query), without a device-to-host sync. Returns
        device tensors (counts [2] = (match count, inspected), top-k
        scores, top-k flat indices[, agg counts [K]]) carrying the
        dispatch's record (``batched``; ``mesh`` for a ShardedBatch, which
        runs ``dist_scan_async``)."""
        sharded = isinstance(batch, ShardedBatch)
        rec = self.profiling.dispatch("mesh" if sharded else "batched",
                                      self.device)
        with rec.stage("build"):
            self._upload_tables(mq)
        rec.compile_check(self._libs(mq.structural, mq.agg_stage, sharded))
        with rec.launch():
            out = (self.dist_scan_async(batch, mq) if sharded else
                   self._local_scan(batch, mq,
                                    resolve_top_k(self.top_k, mq.limit)))
        rec.set(kernel="multi", blocks=len(batch.blocks))
        return rec.attach(out)

    @staticmethod
    def _libs(st, agg, sharded: bool) -> tuple:
        """The kernel libraries a dispatch launches from."""
        return (("scan", "topk") + (("structural",) if st is not None
                                    else ())
                + (("agg",) if agg is not None else ())
                + (("dist",) if sharded else ()))

    def _upload_tables(self, mq: MultiQuery) -> None:
        """The query's block-indexed tables on the device, once a query
        (a memoized query shares them through the batcher)."""
        if mq.device_tables is None:
            mq.device_tables = (
                torch.from_numpy(mq.term_keys).to(self.device),
                torch.from_numpy(mq.val_ranges).to(self.device),
                None if mq.block_group is None else
                torch.from_numpy(mq.block_group).to(self.device))

    def dist_scan_async(self, batch: ShardedBatch, mq: MultiQuery):
        """The reference's ``dist_multi_scan_kernel`` as a chain: the
        local dispatch over each local shard (top-k k' = min(k, local
        entries), equal on every rank), one all_reduce of the counts and
        aggregate, one all_gather of the candidates [S, 2, k'], then K9.
        The same outputs as ``scan_async`` on one device."""
        k = resolve_top_k(self.top_k, mq.limit)
        outs, red, top_s, top_i = dist_k.exchange_merge(
            batch.exchange, batch.shards, batch.ranks,
            lambda b, r: self._local_scan(b, mq, k, (r, batch.world)),
            lambda o: (o[0],) + o[3:], lambda o: torch.stack(o[1:3])[:, None],
            batch.local_flat, k, dist_k.MULTI_LAUNCHES)
        head = outs[0]
        agg = () if len(head) < 4 else (red[2:].to(head[3].dtype),)
        return (red[:2].to(head[0].dtype), top_s[0], top_i[0]) + agg

    def _local_scan(self, batch: BlockBatch, mq: MultiQuery, k: int,
                    part: tuple | None = None):
        """scan_async's chain over one BlockBatch with top-k `k`; `part`
        (rank, world) names a page shard, for its slice of the agg
        keys."""
        self._upload_tables(mq)
        tk, vr, bg = mq.device_tables
        d = batch.device
        verdicts = None
        if mq.structural is not None:
            verdicts = self.structural_verdicts(batch,
                                                mq.structural.lanes())[0]
        scores, counts = multi_scan(
            d["kv_key"], d["kv_val"], d["entry_start"], d["entry_end"],
            d["entry_dur"], d["entry_valid"], d["page_block"], tk, vr,
            mq.n_terms, mq.dur_lo, min(mq.dur_hi, 0xFFFFFFFF), mq.win_start,
            min(mq.win_end, 0xFFFFFFFF), mq.val_hits, bg, batch.widths,
            d.get("entry_dur_res"), verdicts)
        agg = self._agg(mq.agg_stage, scores, part)
        top_scores, top_idx = topk(scores, k)
        return (counts, top_scores, top_idx) + agg

    def _agg(self, stage, scores, part: tuple | None = None) -> tuple:
        """K7 over a score column [N] or the members' rows [Qn, N]: (agg
        counts,), or () without a stage. `part`: as in _local_scan."""
        if stage is None:
            return ()
        keys = stage.device(self.device, part).reshape(-1)
        if scores.dim() == 1:
            return (agg_counts(scores, keys, stage.n_keys),)
        return (agg_counts_rows(scores, keys, stage.n_keys),)

    def scan(self, batch: BlockBatch, mq: MultiQuery) -> tuple:
        return fetch_scan_out(self.scan_async(batch, mq))

    def coalesced_tables(self, cq: CoalescedQuery) -> tuple:
        """K4's per-query inputs on the device: the stacked tables in one
        host-to-device copy, then the members' hit tables as they are.
        (term_keys, val_ranges, term_active, dur_lo, dur_hi, win_start,
        win_end, val_hits, block_group)."""
        bounds = [np.asarray(x, dtype=np.uint32).view(np.int32)
                  for x in (cq.dur_lo, cq.dur_hi, cq.win_start, cq.win_end)]
        arrays = [cq.term_keys, cq.val_ranges, cq.term_active, *bounds]
        if cq.val_hits is not None:
            arrays.append(cq.block_group)
        tk, vr, ta, dlo, dhi, ws, we, *bg = _upload(arrays, self.device)
        return (tk, vr, ta, dlo, dhi, ws, we, cq.val_hits,
                bg[0] if bg else None)

    def coalesced_scan_async(self, batch, cq: CoalescedQuery, top_k: int):
        """One fused dispatch for the stacked queries: the tables go up
        once, then (K6 over the structural members' lanes) K4 and K2r run
        on the current stream, without a device-to-host sync. `top_k` is
        the group's k, the largest of its members'. With an agg stage, K7
        counts the real members' rows before K2r. Returns device tensors
        (counts [Q], inspected, top-k scores [Q, k], top-k flat indices
        [Q, k][, agg counts [Qn, K]]) carrying the dispatch's record
        (``coalesced``; ``mesh`` for a ShardedBatch, which runs
        ``dist_coalesced_scan_async``)."""
        sharded = isinstance(batch, ShardedBatch)
        rec = self.profiling.dispatch("mesh" if sharded else "coalesced",
                                      self.device)
        with rec.stage("build"):
            tables = self.coalesced_tables(cq)
        if rec.enabled:
            rec.add_bytes(h2d=sum(int(t.numel() * t.element_size())
                                  for t in tables[:7]))
        rec.compile_check(self._libs(cq.structural, cq.agg_stage, sharded))
        with rec.launch():
            out = (self.dist_coalesced_scan_async(batch, cq, top_k, tables)
                   if sharded else
                   self._local_coalesced(batch, cq, tables, top_k))
        rec.set(kernel="coalesced", queries=cq.n_queries)
        return rec.attach(out)

    def dist_coalesced_scan_async(self, batch: ShardedBatch,
                                  cq: CoalescedQuery, top_k: int,
                                  tables: tuple | None = None):
        """The reference's ``dist_coalesced_scan_kernel`` as a chain: the
        fused local dispatch over each local shard, one all_reduce of the
        counts, inspected and aggregates, one all_gather of the candidates
        [S, 2, Q, k'], then K9 over the query rows. The same outputs as
        ``coalesced_scan_async`` on one device. `tables`: the uploaded
        ``coalesced_tables`` (made here when None)."""
        if tables is None:
            tables = self.coalesced_tables(cq)
        outs, red, top_s, top_i = dist_k.exchange_merge(
            batch.exchange, batch.shards, batch.ranks,
            lambda b, r: self._local_coalesced(b, cq, tables, top_k,
                                               (r, batch.world)),
            lambda o: o[:2] + o[4:], lambda o: torch.stack(o[2:4]),
            batch.local_flat, top_k, dist_k.COALESCED_LAUNCHES)
        head = outs[0]
        Q = int(head[0].shape[0])
        agg = () if len(head) < 5 else (
            red[Q + 1:].reshape(head[4].shape).to(head[4].dtype),)
        return (red[:Q].to(head[0].dtype), red[Q].to(head[1].dtype),
                top_s, top_i) + agg

    def _local_coalesced(self, batch: BlockBatch, cq: CoalescedQuery,
                         tables: tuple, top_k: int,
                         part: tuple | None = None):
        """coalesced_scan_async's chain over one BlockBatch, given the
        uploaded `tables`; `part` as in _local_scan."""
        d = batch.device
        verdicts = None
        if cq.structural is not None:
            verdicts = self.structural_verdicts(batch, cq.structural.lanes)
        scores, counts, inspected = coalesced_scan(
            d["kv_key"], d["kv_val"], d["entry_start"], d["entry_end"],
            d["entry_dur"], d["entry_valid"], d["page_block"], *tables,
            batch.widths, d.get("entry_dur_res"), verdicts)
        agg = self._agg(cq.agg_stage, scores[:cq.n_queries], part)
        top_scores, top_idx = topk_rows(scores, top_k)
        return (counts, inspected, top_scores, top_idx) + agg

    def results(self, batch: BlockBatch, mq: MultiQuery,
                scores: np.ndarray, idx: np.ndarray) -> list:
        """Map top-k flat indices back to TraceSearchMetadata, skipping pad
        pages, stopping at the first non-match or at the limit."""
        E = batch.blocks[0].geometry.entries_per_page
        out = []
        for s, i in zip(scores.tolist(), idx.tolist()):
            if s < 0 or len(out) >= mq.limit:
                break
            p, e = divmod(i, E)
            if p >= batch.n_pages:
                continue
            bi = int(batch.page_block[p])
            if bi < 0:
                continue
            pages = batch.blocks[bi]
            lp = p - batch.page_offset[bi]
            m = TraceSearchMetadata(
                trace_id=bytes(pages.trace_ids[lp, e]).hex(),
                start_time_unix_nano=int(pages.entry_start[lp, e])
                * 1_000_000_000,
                duration_ms=int(pages.entry_dur[lp, e]))
            svc = int(pages.entry_root_svc[lp, e])
            name = int(pages.entry_root_name[lp, e])
            if svc >= 0:
                m.root_service_name = pages.val_dict[svc]
            if name >= 0:
                m.root_trace_name = pages.val_dict[name]
            out.append(m)
        return out
