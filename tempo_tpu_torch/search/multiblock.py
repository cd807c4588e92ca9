"""Multi-block batched scanning.

Counterpart of the reference's ``search/multiblock.py`` on its default
path. Many blocks' pages stack along one page axis and scan in one
dispatch; a per-page block index (``page_block``) selects each page's row
of the per-block term tables, because every block keeps its own
dictionaries and the query compiles per block. The dispatch is two
hand-written kernels: K1 (``kernels.scan.multi_scan``) evaluates the
predicate and writes a score per entry plus the match and inspected
counts, and K2 (``kernels.topk.topk``) picks the k most recent matches.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..model.types import TraceSearchMetadata
from .columnar import ColumnarPages
from .engine import DEFAULT_TOP_K, fetch_scan_out, resolve_top_k
from .kernels.scan import multi_scan
from .kernels.topk import topk
from .pipeline import CompileCache, CompiledQuery, compile_query, \
    dict_fingerprint

# kv columns narrow to int8 / int16 / int32 by dictionary size; the entry
# columns keep the container's uint32 bits in int32 tensors (torch has few
# uint32 ops) and the kernel compares them as uint32
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


@dataclass
class BlockBatch:
    """A HostBatch's arrays resident on the device."""
    device: dict                    # name -> tensor [P_total, ...]
    page_block: np.ndarray          # host copy, for result rendering
    blocks: list
    page_offset: list
    memo: dict = field(default_factory=dict)   # query-independent memos

    @property
    def n_pages(self) -> int:
        return int(self.page_block.shape[0])

    @property
    def nbytes(self) -> int:
        """Device bytes pinned by the stacked arrays."""
        return int(sum(t.numel() * t.element_size()
                       for t in self.device.values()))


def _narrow(n: int):
    return (np.int8 if n <= 127          # the -1 pad stays in range
            else np.int16 if n <= 32_767 else np.int32)


def stack_host(blocks: list[ColumnarPages],
               pad_to: int | None = None) -> HostBatch:
    """Concatenate blocks of one entries-per-page along the page axis.

    The kv columns narrow to the smallest dtype the group's largest
    dictionary allows (the reference's ``multiblock.py:257-261`` rule), and
    narrower-C blocks pad their slots with -1. Pages past the blocks' own,
    up to `pad_to`, are pad pages: page_block -1, kv -1, invalid entries."""
    E = blocks[0].geometry.entries_per_page
    C = max(b.geometry.kv_per_entry for b in blocks)
    kv_dtype = {"kv_key": _narrow(max(len(b.key_dict) for b in blocks)),
                "kv_val": _narrow(max(len(b.val_dict) for b in blocks))}
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
                arr = arr.astype(kv_dtype[name], copy=False)
                if arr.shape[2] < C:
                    pad = np.full((P, E, C - arr.shape[2]), -1,
                                  dtype=kv_dtype[name])
                    arr = np.concatenate([arr, pad], axis=2)
            arrays[name].append(arr)
        page_block.extend([bi] * P)
        total += P
    if len(blocks) == 1 and not (pad_to and pad_to > total):
        cat = {k: v[0] for k, v in arrays.items()}
    else:
        cat = {k: np.concatenate(v, axis=0) for k, v in arrays.items()}
    page_block = np.asarray(page_block, dtype=np.int32)
    if pad_to and pad_to > total:
        extra = pad_to - total
        for name, arr in cat.items():
            pad = np.zeros((extra,) + arr.shape[1:], dtype=arr.dtype)
            if name in kv_dtype:
                pad -= 1
            cat[name] = np.concatenate([arr, pad], axis=0)
        page_block = np.concatenate(
            [page_block, np.full(extra, -1, dtype=np.int32)])
    for name in ("entry_start", "entry_end", "entry_dur"):
        cat[name] = cat[name].view(np.int32)
    cat["page_block"] = page_block
    return HostBatch(cat=cat, page_block=page_block, blocks=blocks,
                     page_offset=page_offset)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    # arrays decoded from a container are read-only views of its bytes;
    # torch wants a writable buffer even when it only copies from it
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")
    return torch.from_numpy(a).to(device)


def place_batch(host: HostBatch, device: torch.device) -> BlockBatch:
    """Host-to-device copy of a stacked batch."""
    dev = {k: _to_device(v, device) for k, v in host.cat.items()}
    return BlockBatch(device=dev, page_block=host.page_block,
                      blocks=host.blocks, page_offset=host.page_offset)


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
    # device copies of the two tables, made at the first dispatch and
    # reused by every later dispatch of this query over the same batch
    device_tables: tuple | None = None


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
                  cache: CompileCache | None = None) -> MultiQuery | None:
    """Compile the request against every block's dictionaries, once per
    distinct dictionary. Blocks that prune get key id -1 (no page of theirs
    can match); `skip[i]` marks blocks already pruned by their header, which
    stay in the batch and are masked back to that sentinel. None when every
    block prunes."""
    fp_of, rep_idx, rows_of = _dict_groups(blocks, memo)
    compiled: dict[bytes, CompiledQuery | None] = {}
    for fp, i in rep_idx.items():
        b = blocks[i]
        compiled[fp] = compile_query(b.key_dict, b.val_dict, req,
                                     cache_on=b, cache=cache)
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
    R = 1
    while R < rmax:
        R *= 2
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
    if skip is not None and any(skip):
        sk = np.asarray(skip, dtype=bool)
        term_keys[sk] = -1
        val_ranges[sk] = np.array([1, 0], dtype=np.int32)
    any_cq = next(cq for cq in per_block if cq is not None)
    return MultiQuery(term_keys=term_keys, val_ranges=val_ranges,
                      dur_lo=any_cq.dur_lo, dur_hi=any_cq.dur_hi,
                      win_start=any_cq.win_start, win_end=any_cq.win_end,
                      limit=any_cq.limit, n_terms=T)


class MultiBlockEngine:
    """Batched scan over many blocks in one dispatch on one device."""

    def __init__(self, device: torch.device, top_k: int = DEFAULT_TOP_K):
        self.device = device
        self.top_k = top_k
        self.compile_cache = CompileCache()

    def stage_host(self, blocks: list[ColumnarPages]) -> HostBatch:
        """Stack a batch on the host with its page count padded to a power
        of two (the reference buckets shapes this way to bound recompiles;
        the port keeps the layout so both scan the same padded batch)."""
        total = sum(b.n_pages for b in blocks)
        pad_to = 1
        while pad_to < total:
            pad_to *= 2
        return stack_host(blocks, pad_to=pad_to)

    def place(self, host: HostBatch) -> BlockBatch:
        return place_batch(host, self.device)

    def scan_async(self, batch: BlockBatch, mq: MultiQuery):
        """One dispatch, K1 then K2 on the current stream, without a
        device-to-host sync. Returns device tensors (counts [2] = (match
        count, inspected), top-k scores, top-k flat indices)."""
        if mq.device_tables is None:
            mq.device_tables = (
                torch.from_numpy(mq.term_keys).to(self.device),
                torch.from_numpy(mq.val_ranges).to(self.device))
        tk, vr = mq.device_tables
        d = batch.device
        scores, counts = multi_scan(
            d["kv_key"], d["kv_val"], d["entry_start"], d["entry_end"],
            d["entry_dur"], d["entry_valid"], d["page_block"], tk, vr,
            mq.n_terms, mq.dur_lo, min(mq.dur_hi, 0xFFFFFFFF), mq.win_start,
            min(mq.win_end, 0xFFFFFFFF))
        top_scores, top_idx = topk(scores,
                                   resolve_top_k(self.top_k, mq.limit))
        return counts, top_scores, top_idx

    def scan(self, batch: BlockBatch, mq: MultiQuery) -> tuple:
        return fetch_scan_out(self.scan_async(batch, mq))

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
