"""K1 ``multi_scan``, K1s ``scan_single`` and K4 ``coalesced_scan``: the
tag-search predicate, count and score column.

K1 is the counterpart of ``tempo_tpu/search/multiblock.py``
``multi_entry_mask`` and the count/inspected half of ``multi_scan_kernel``
(TPU kernel B3 without its aggregate input), in range
mode or, given the dictionary probe's hit tables, in hit-mask mode. K1s is
the counterpart of ``tempo_tpu/search/engine.py`` ``entry_match_mask`` and
``scan_kernel`` (B1): the same predicate over one block. Both write the
score of ``engine.masked_topk``. The CUDA kernels are ``csrc/scan.cu``;
the plain PyTorch versions below are the CPU path and the references the
kernels are held against on the card.

K1 inputs (all on one device, contiguous):
  kv_key, kv_val          [P, E, C] int8 / int16 / int32 (as narrowed)
  entry_start/end/dur     [P, E] int32 holding the container's uint32 bits
  entry_valid             [P, E] bool
  page_block              [P] int32, -1 for pad pages
  term_keys               [B, T'] int32 (T' = max(1, n_terms))
  val_ranges              [B, T', R, 2] int32
  val_hits, block_group   optional, together: [G, T', Vm] hit table and
                          int32 [B]; a block with group g >= 0 tests a
                          value v by its bit of val_hits[g, t] instead of
                          the ranges
K1s inputs: kv int32 (or a packed layout, below), no page_block, term
tables [T'] and [T', R, 2], and an optional val_hits [T', V] used on
every page.
K1 and K1s also take an optional ``verdicts`` uint8 [P*E], the
structural verdicts of kernel K6 (``kernels/structural.py``), ANDed into
the match as the reference ANDs ``structural_entry_mask`` into the mask.
Outputs: scores int32 [P*E] (min(start, 2^31-1) where the entry matches,
else -1) and counts int32 [2] = (match count, inspected), inspected being
the valid entries (of non-pad pages).

Packed residency (``search/packing.py``, the scan half of TPU kernel B4):
given ``widths=(kw, vw, dw)``, the kv columns hold codes (id+1, pad 0):
"u4" uint8 [P, E, C/2] (two slots a byte, slot 2j in the low nibble),
"u8" uint8, "u16" int16 (uint16 bits), "u32" int32 (uint32 bits), each
[P, E, C], C being the unpacked slot count. entry_dur is int16 (uint16
bits): exact for dw "u16", buckets ``dur >> s`` for dw "q<s>", with
``entry_dur_res`` [P, E] the low s bits (uint8 for s <= 8, else int16).
A hit table is bool (one per value) or int32 words (uint32 bits; value
v is bit v & 31 of word v >> 5), in either layout. Each mode (layout,
hit mode, duration form) has its own launch count.

K4 is the counterpart of ``tempo_tpu/search/multiblock.py``
``coalesced_scan_kernel`` (B6) without its aggregate input: K1's
function for Q queries over the same staged pages, in one
launch. Its inputs are K1's page arrays and, per query, term_keys
[Q, B, T], val_ranges [Q, B, T, R, 2], term_active bool [Q, T] (an
inactive term is neutral-true) and the bounds dur_lo, dur_hi, win_start,
win_end as int32 [Q] holding uint32 bits; in hit-mask mode, val_hits, a
sequence of Q hit tables ([G_q, T_q, V_q], all bool or all words, or
None for a query compiled on the host), with block_group int32 [Q, B];
optionally ``verdicts`` uint8 [V, P*E], K6's verdicts of the first V
queries (a query past them matches nothing). Outputs: scores int32
[Q, P*E], counts int32 [Q] and inspected, an int32 scalar. The CUDA
kernel matches keys first, over each block's distinct terms;
``k4_terms`` is that reduction and ``coalesced_scan_keyfirst`` that rule
in PyTorch, which the CPU tests hold against ``coalesced_scan_plain``
and the reference.

K1's and K1s's CUDA kernels follow their own rule (``csrc/scan.cu``'s
header): with terms, a key run's 32-bit words are compared with each
term's lane value at once (SWAR), a slot's value is tested only where its
key names the term (a range block by a per-block bitmap of value ids), and
an entry stops at its first failing term; without terms, no slot is read.
``scan_tiled`` is that rule in PyTorch, which the CPU tests hold against
the plain versions and the reference. Their wrappers check a staged
batch's arrays and a predicate's tables once: a call's descriptor (its
pointers, layouts and bounds) is kept for as long as every tensor it was
checked on lives unchanged (``_K1_CALLS``, by identity and version), so a
repeated call checks only its verdicts, allocates one buffer (scores,
counts and the kernel's partial counts) and launches.

A launch with verdicts counts in ``VERDICT_LAUNCHES`` (K1),
``SINGLE_VERDICT_LAUNCHES`` (K1s) or ``COALESCED_VERDICT_LAUNCHES`` (K4),
whatever its layout and hit mode; the other counters count launches
without them.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from .. import packing
from . import LaunchCount
from .build import check, load, on_device

# unpacked layout
LAUNCHES = LaunchCount()         # K1 launches in range mode
HIT_LAUNCHES = LaunchCount()     # K1 launches in hit-mask mode
SINGLE_LAUNCHES = LaunchCount()  # K1s launches (either mode)
# B9 (``kernels/live.py`` ``hot_scan``): K1s and K2 over a live stage's
# live prefix; each such call also counts in K1s's and K2's counters
HOT_LAUNCHES = LaunchCount()
COALESCED_LAUNCHES = LaunchCount()      # K4 launches in range mode
COALESCED_HIT_LAUNCHES = LaunchCount()  # K4 launches in hit-mask mode
# packed layout
PACKED_LAUNCHES = LaunchCount()         # K1, range mode, u16 durations
PACKED_Q_LAUNCHES = LaunchCount()       # K1, range mode, bucketed ones
PACKED_HIT_LAUNCHES = LaunchCount()     # K1, hit-mask mode
SINGLE_PACKED_LAUNCHES = LaunchCount()  # K1s (either mode)
COALESCED_PACKED_LAUNCHES = LaunchCount()      # K4, range mode
COALESCED_PACKED_HIT_LAUNCHES = LaunchCount()  # K4, hit-mask mode
# with structural verdicts, any layout and hit mode
VERDICT_LAUNCHES = LaunchCount()             # K1
SINGLE_VERDICT_LAUNCHES = LaunchCount()      # K1s
COALESCED_VERDICT_LAUNCHES = LaunchCount()   # K4
MAX_QUERIES = 64                 # K4's query axis, at most

# csrc/scan.cu's K1Desc: the fields of a K1/K1s call's descriptor
_K1_DESC = ("key_layout", "val_layout", "kv_key", "kv_val", "start", "end",
            "dur", "dur_res", "dur_shift", "res_bytes", "valid",
            "page_block", "term_keys", "val_ranges", "val_hits",
            "hit_words", "block_group", "P", "E", "C", "n_terms",
            "t_stride", "R", "n_vals", "dur_lo", "dur_hi", "win_start",
            "win_end")
K1_MAX_GRID = 2048          # csrc/scan.cu kK1MaxGrid: CTAs, at most
_K1_CACHE_MAX = 4096
K1_PAT_TERMS = 32           # csrc/scan.cu kK1PatTerms: terms of the SWAR
                            # key test

# csrc/scan.cu's Layout numbers: the unpacked layout by dtype, the packed
# one by width (with the dtype its codes arrive in)
_ID_LAYOUTS = {torch.int8: 0, torch.int16: 1, torch.int32: 2}
_CODE_LAYOUTS = {"u4": (3, torch.uint8), "u8": (4, torch.uint8),
                 "u16": (5, torch.int16), "u32": (6, torch.int32)}
_U32 = 0xFFFFFFFF


def multi_scan(kv_key, kv_val, entry_start, entry_end, entry_dur,
               entry_valid, page_block, term_keys, val_ranges,
               n_terms: int, dur_lo: int, dur_hi: int, win_start: int,
               win_end: int, val_hits=None, block_group=None,
               widths=None, entry_dur_res=None, verdicts=None):
    """(scores, counts) — the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    fn = (multi_scan_plain if kv_key.device.type == "cpu"
          else _multi_scan_cuda)
    return fn(kv_key, kv_val, entry_start, entry_end, entry_dur,
              entry_valid, page_block, term_keys, val_ranges, n_terms,
              dur_lo, dur_hi, win_start, win_end, val_hits, block_group,
              widths, entry_dur_res, verdicts)


def scan_single(kv_key, kv_val, entry_start, entry_end, entry_dur,
                entry_valid, term_keys, val_ranges, n_terms: int,
                dur_lo: int, dur_hi: int, win_start: int, win_end: int,
                val_hits=None, widths=None, entry_dur_res=None,
                verdicts=None):
    """(scores, counts) over one block — the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    fn = (scan_single_plain if kv_key.device.type == "cpu"
          else _scan_single_cuda)
    return fn(kv_key, kv_val, entry_start, entry_end, entry_dur,
              entry_valid, term_keys, val_ranges, n_terms, dur_lo, dur_hi,
              win_start, win_end, val_hits, widths, entry_dur_res, verdicts)


def coalesced_scan(kv_key, kv_val, entry_start, entry_end, entry_dur,
                   entry_valid, page_block, term_keys, val_ranges,
                   term_active, dur_lo, dur_hi, win_start, win_end,
                   val_hits=None, block_group=None, widths=None,
                   entry_dur_res=None, verdicts=None):
    """(scores [Q, P*E], counts [Q], inspected) — the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    fn = (coalesced_scan_plain if kv_key.device.type == "cpu"
          else _coalesced_scan_cuda)
    return fn(kv_key, kv_val, entry_start, entry_end, entry_dur,
              entry_valid, page_block, term_keys, val_ranges, term_active,
              dur_lo, dur_hi, win_start, win_end, val_hits, block_group,
              widths, entry_dur_res, verdicts)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns of uint32 values -> their int64 values."""
    return x.to(torch.int64) & _U32


def _in_ranges(vv, lo, hi):
    """[P,E,C] bool: vv inside some [lo[..., r], hi[..., r]]; lo/hi
    broadcast against vv[..., None]."""
    return ((vv[..., None] >= lo) & (vv[..., None] <= hi)).any(dim=-1)


def _unpack_kv(kv_key, kv_val, widths):
    kw, vw = (None, None) if widths is None else widths[:2]
    return packing.unpack_ids(kv_key, kw), packing.unpack_ids(kv_val, vw)


def _and_verdicts(mask, verdicts):
    if verdicts is not None:
        mask &= verdicts.reshape(mask.shape) != 0
    return mask


def _finish(mask, live, entry_start, entry_end, entry_dur, entry_dur_res,
            widths, dur_lo, dur_hi, win_start, win_end):
    start = _u32(entry_start)
    mask &= packing.duration_ok(entry_dur, entry_dur_res, dur_lo, dur_hi,
                                None if widths is None else widths[2])
    mask &= _u32(entry_end) >= int(win_start)
    mask &= start <= int(win_end)
    scores = torch.where(mask, start.clamp(max=2**31 - 1),
                         torch.full_like(start, -1)).to(torch.int32)
    counts = torch.stack([mask.sum(), live.sum()]).to(torch.int32)
    return scores.reshape(-1), counts


def multi_scan_plain(kv_key, kv_val, entry_start, entry_end, entry_dur,
                     entry_valid, page_block, term_keys, val_ranges,
                     n_terms: int, dur_lo: int, dur_hi: int, win_start: int,
                     win_end: int, val_hits=None, block_group=None,
                     widths=None, entry_dur_res=None, verdicts=None):
    """K1's function in plain PyTorch ops, on whatever device the tensors
    are on; the packed columns unpack through ``packing``."""
    pb = page_block.to(torch.int64)
    safe = pb.clamp(min=0)
    live = entry_valid & (pb >= 0)[:, None]
    mask = _and_verdicts(live.clone(), verdicts)
    if n_terms:
        kk, vv = _unpack_kv(kv_key, kv_val, widths)
        if val_hits is not None:
            bg = block_group.to(torch.int64)[safe]                # [P]
            probe_page = (bg >= 0)[:, None, None]
            g_idx = bg.clamp(min=0)[:, None, None].expand_as(vv)
            safe_v = vv.clamp(min=0)
        for t in range(n_terms):
            keym = kk == term_keys[safe, t][:, None, None]
            valm = _in_ranges(vv, val_ranges[safe, t, :, 0][:, None, None],
                              val_ranges[safe, t, :, 1][:, None, None])
            if val_hits is not None:
                mh = packing.mask_select_grouped(val_hits, g_idx, t,
                                                 safe_v) & (vv >= 0)
                valm = torch.where(probe_page, mh, valm)
            mask &= (keym & valm).any(dim=-1)
    return _finish(mask, live, entry_start, entry_end, entry_dur,
                   entry_dur_res, widths, dur_lo, dur_hi, win_start,
                   win_end)


def coalesced_scan_plain(kv_key, kv_val, entry_start, entry_end,
                         entry_dur, entry_valid, page_block, term_keys,
                         val_ranges, term_active, dur_lo, dur_hi,
                         win_start, win_end, val_hits=None,
                         block_group=None, widths=None,
                         entry_dur_res=None, verdicts=None):
    """K4's function in plain PyTorch ops: K1's plain version once per
    query, over that query's active terms and verdict row."""
    rows, counts = [], []
    inspected = None
    for q in range(term_keys.shape[0]):
        act = term_active[q].nonzero().flatten()
        vh = bg = None
        if val_hits is not None and val_hits[q] is not None:
            vh, bg = val_hits[q][:, act], block_group[q]
        s, c = multi_scan_plain(
            kv_key, kv_val, entry_start, entry_end, entry_dur, entry_valid,
            page_block, term_keys[q][:, act], val_ranges[q][:, act],
            int(act.numel()), *(int(x[q]) & _U32 for x in (
                dur_lo, dur_hi, win_start, win_end)), vh, bg,
            widths=widths, entry_dur_res=entry_dur_res,
            verdicts=None if verdicts is None else (
                verdicts[q] if q < verdicts.shape[0]
                else torch.zeros_like(verdicts[0])))
        rows.append(s)
        counts.append(c[0])
        inspected = c[1]
    return torch.stack(rows), torch.stack(counts), inspected


def k4_terms(term_keys, val_ranges, term_active, dur_lo, dur_hi, b: int,
             val_hits=None, block_group=None, v_rows=None) -> dict:
    """Block b's term table as K4 builds it in each CTA (``csrc/scan.cu``
    ``build_terms``), from K4's per-query inputs. A (query, term) pair is
    active when its query can match (its duration range is not empty and,
    with verdicts, it has a verdict row: q < `v_rows`) and its term is. An
    active pair tests its key and either its member's hit row (block
    group g >= 0 and a table) or its ranges up to the last non-empty one.
    Pairs of the same key and test are one distinct term. Distinct terms
    are ordered by key (keys in order of their first pair), then hit rows
    before ranges, then pair, and cut into chunks of 64. Returns:
      terms      [{"key", "ranges": int64 [n, 2] or None, "row": the hit
                  row (bool [V] or int32 words) or None}], in that order
      need       need[k][q], a 64-bit mask: bit u says that query q needs
                 distinct term 64k + u
      segments   [(key, first term, first range term, end)]: each key's
                 terms within a chunk
      intervals  per segment, its range terms' endpoints (each range's lo
                 and hi + 1) sorted, and per endpoint the mask of the
                 terms whose ranges hold it: a value v passes the terms of
                 the last endpoint <= v (the kernel's binary search; it
                 tests the ranges in place when the tables would not fit)
      chunk_segs the first segment of each chunk, then the segment count
      queries    the mask of queries that can match at all."""
    Q, _B, T = term_keys.shape
    elig = 0
    for q in range(Q):
        if int(dur_lo[q]) & _U32 <= int(dur_hi[q]) & _U32 \
                and (v_rows is None or q < v_rows):
            elig |= 1 << q
    pairs = []          # per pair: (key, signature, term) or None
    for q in range(Q):
        h = g = None
        if val_hits is not None and val_hits[q] is not None \
                and val_hits[q].numel() and int(block_group[q, b]) >= 0:
            h, g = val_hits[q], int(block_group[q, b])
        for t in range(T):
            if not (elig >> q & 1 and bool(term_active[q, t])):
                pairs.append(None)
                continue
            key = int(term_keys[q, b, t])
            if h is not None:
                n = int(h.shape[2])
                row = g * int(h.shape[1]) + t
                sig = ("row", h.data_ptr() + row * n * h.element_size(), n)
                term = {"key": key, "ranges": None,
                        "row": h.reshape(-1, n)[row]}
            else:
                rg = val_ranges[q, b, t].to(torch.int64)
                r = int(rg.shape[0])
                while r and int(rg[r - 1, 0]) > int(rg[r - 1, 1]):
                    r -= 1
                sig = ("ranges", tuple(rg[:r].flatten().tolist()))
                term = {"key": key, "ranges": rg[:r], "row": None}
            pairs.append((key, sig, term))
    first_key: dict = {}
    leaders: dict = {}
    order = []          # (first pair of the key, kind, pair) of leaders
    for j, p in enumerate(pairs):
        if p is None:
            continue
        key, sig, term = p
        fk = first_key.setdefault(key, j)
        if (key, sig) not in leaders:
            leaders[(key, sig)] = j
            order.append((fk, term["row"] is None, j))
    order.sort()
    pos = {j: u for u, (_fk, _kind, j) in enumerate(order)}
    terms = [pairs[j][2] for _fk, _kind, j in order]
    U = len(terms)
    need = [[0] * Q for _ in range(-(-U // 64))]
    for j, p in enumerate(pairs):
        if p is not None:
            u = pos[leaders[(p[0], p[1])]]
            need[u >> 6][j // T] |= 1 << (u & 63)
    segments, chunk_segs = [], []
    for u in range(U):
        if u % 64 == 0:
            chunk_segs.append(len(segments))
        if u % 64 == 0 or terms[u]["key"] != terms[u - 1]["key"]:
            segments.append([terms[u]["key"], u, u, u + 1])
        else:
            segments[-1][3] = u + 1
        if terms[u]["row"] is not None:
            segments[-1][2] = u + 1
    chunk_segs.append(len(segments))
    intervals = []
    for _key, _beg, mid, end in segments:
        ranges = [(int(lo), int(hi), u) for u in range(mid, end)
                  for lo, hi in terms[u]["ranges"].tolist()]
        bnd = sorted(x for lo, hi, _u in ranges for x in (lo, hi + 1))
        intervals.append((bnd, [
            sum(1 << (u & 63) for u in {u for lo, hi, u in ranges
                                        if lo <= x <= hi})
            for x in bnd]))
    return {"terms": terms, "need": need,
            "segments": [tuple(s) for s in segments],
            "intervals": intervals, "chunk_segs": chunk_segs,
            "queries": elig}


def _row_hits(row: torch.Tensor, vv: torch.Tensor) -> torch.Tensor:
    """A hit row's value test over value ids `vv`."""
    if not row.numel():
        return torch.zeros_like(vv, dtype=torch.bool)
    return packing.mask_select(row, vv.clamp(min=0)) & (vv >= 0)


def _interval_masks(bnd: list, masks: list, vv: torch.Tensor):
    """The term mask of the last endpoint <= each value id (0 below the
    first), as int64 bits."""
    if not bnd:
        return torch.zeros_like(vv)
    b = torch.tensor(bnd, dtype=torch.int64)
    m = torch.tensor([x - (1 << 64) if x >> 63 else x for x in masks] + [0],
                     dtype=torch.int64)
    k = torch.searchsorted(b, vv.contiguous(), right=True) - 1
    return m[torch.where(k >= 0, k, len(bnd))]


def coalesced_scan_keyfirst(kv_key, kv_val, entry_start, entry_end,
                            entry_dur, entry_valid, page_block, term_keys,
                            val_ranges, term_active, dur_lo, dur_hi,
                            win_start, win_end, val_hits=None,
                            block_group=None, widths=None,
                            entry_dur_res=None, verdicts=None):
    """K4's function by K4's own rule, in plain PyTorch ops: per block,
    ``k4_terms``; per chunk, a slot whose key equals a segment's key sets
    the bits of that segment's terms its value passes (hit rows one by
    one, ranges through the endpoint tables), and query q keeps
    its terms while its need mask lies inside those bits; then K1's
    bounds and score per query. The same inputs and outputs as
    ``coalesced_scan_plain``, which it must equal."""
    kk, vv = _unpack_kv(kv_key, kv_val, widths)
    pb = page_block.to(torch.int64)
    live = entry_valid & (pb >= 0)[:, None]
    Q = term_keys.shape[0]
    v_rows = None if verdicts is None else int(verdicts.shape[0])
    passed = torch.zeros((Q,) + tuple(live.shape), dtype=torch.bool)
    for b in sorted(set(pb[pb >= 0].tolist())):
        sel = pb == b
        tab = k4_terms(term_keys, val_ranges, term_active, dur_lo, dur_hi,
                       b, val_hits, block_group, v_rows)
        kb, vb = kk[sel], vv[sel]
        p = torch.zeros((Q,) + tuple(kb.shape[:2]), dtype=torch.bool)
        for q in range(Q):
            if tab["queries"] >> q & 1:
                p[q] = live[sel]
                if verdicts is not None:
                    p[q] &= verdicts[q].reshape(live.shape)[sel] != 0
        for k, need in enumerate(tab["need"]):
            tm = torch.zeros(tuple(kb.shape[:2]) + (64,), dtype=torch.bool)
            for s in range(tab["chunk_segs"][k], tab["chunk_segs"][k + 1]):
                key, beg, mid, end = tab["segments"][s]
                keym = kb == key
                for u in range(beg, mid):
                    tm[..., u - 64 * k] = (keym & _row_hits(
                        tab["terms"][u]["row"], vb)).any(dim=-1)
                bits = _interval_masks(*tab["intervals"][s], vb)
                for u in range(mid, end):
                    tm[..., u - 64 * k] = (
                        keym & ((bits >> (u & 63)) & 1).bool()).any(dim=-1)
            for q in range(Q):
                for bit in range(64):
                    if need[q] >> bit & 1:
                        p[q] &= tm[..., bit]
        passed[:, sel] = p
    rows, counts = [], []
    inspected = None
    for q in range(Q):
        s, c = _finish(passed[q], live, entry_start, entry_end, entry_dur,
                       entry_dur_res, widths,
                       *(int(x[q]) & _U32 for x in (
                           dur_lo, dur_hi, win_start, win_end)))
        rows.append(s)
        counts.append(c[0])
        inspected = c[1]
    return torch.stack(rows), torch.stack(counts), inspected


def scan_single_plain(kv_key, kv_val, entry_start, entry_end, entry_dur,
                      entry_valid, term_keys, val_ranges, n_terms: int,
                      dur_lo: int, dur_hi: int, win_start: int,
                      win_end: int, val_hits=None, widths=None,
                      entry_dur_res=None, verdicts=None):
    """K1s's function in plain PyTorch ops, written from the reference's
    ``engine.entry_match_mask``: per term, key equality and value
    membership (a hit-table lookup when ``val_hits`` is given, else the
    range compares), OR over slots, AND over terms."""
    live = entry_valid
    mask = _and_verdicts(live.clone(), verdicts)
    if n_terms:
        kk, vv = _unpack_kv(kv_key, kv_val, widths)
        for t in range(n_terms):
            keym = kk == term_keys[t]
            if val_hits is not None:
                valm = packing.mask_select(val_hits[t], vv.clamp(min=0)) \
                    & (vv >= 0)
            else:
                valm = _in_ranges(vv, val_ranges[t, :, 0],
                                  val_ranges[t, :, 1])
            mask &= (keym & valm).any(dim=-1)
    return _finish(mask, live, entry_start, entry_end, entry_dur,
                   entry_dur_res, widths, dur_lo, dur_hi, win_start,
                   win_end)




K1_THREADS = 256             # csrc/scan.cu kThreads
K1_BIT_TERMS = 8             # kK1BitTerms: range terms with value bitmaps
K1_BIT_IDS = 8192            # kK1BitWords * 32: the ids a bitmap holds
K1_BIT_MAX_R = 16            # kK1BitMaxR: ranges a term, for bitmaps
# a key column's lane bits (csrc/scan.cu KeyLanes) by dtype or width, and
# whether its lanes hold ids (signed) or codes id + 1
_LANES = {torch.int8: (8, True), torch.int16: (16, True),
          torch.int32: (32, True), "u4": (4, False), "u8": (8, False),
          "u16": (16, False), "u32": (32, False)}


def k1_tile(E: int, terms: bool) -> int:
    """Entries a K1/K1s tile, as ``tt_scan_k1`` picks them: with terms,
    256 entries of a page (one a thread); without, 1,024 (four a thread),
    or the page rounded up to 4 when it is shorter."""
    if terms:
        return K1_THREADS
    return min(4 * K1_THREADS, (E + 3) // 4 * 4)


def _lane_holds(key: int, bits: int, ids: bool) -> bool:
    """Whether a key column of `bits`-bit lanes can hold key id `key`
    (csrc/scan.cu KeyLanes::lane)."""
    if ids:
        return bits == 32 or -(1 << (bits - 1)) <= key < (1 << (bits - 1))
    code = (key + 1) & _U32
    return bits == 32 or code < (1 << bits)


def scan_tiled(kv_key, kv_val, entry_start, entry_end, entry_dur,
               entry_valid, page_block, term_keys, val_ranges, n_terms: int,
               dur_lo: int, dur_hi: int, win_start: int, win_end: int,
               val_hits=None, block_group=None, widths=None,
               entry_dur_res=None, verdicts=None, grid: int = K1_MAX_GRID):
    """K1's function by the rule of its CUDA kernels, in plain PyTorch ops:
    tiles of ``k1_tile`` entries of one page, walked by `grid` CTAs in
    runs. With terms, per tile its page's block b and, when b changes, the
    block state: which terms (t < 32) a lane of the key column can hold,
    and for a range block (no hit table, R <= 16) a bitmap of value ids
    0..8,191 for each of its first 8 terms. Per entry, term by term in
    order: the key run's lanes, word by word (32 bits of lanes a word),
    that hold the term's key, in order, each value tested (by the bitmap
    where it holds the id, else the hit row or the ranges) until one
    passes; an entry stops at its first term that none passes; terms past
    32 one slot loop each. Without terms no slot is read. Then K1's bounds
    and score; the counts summed per CTA, then over the CTAs. With
    `page_block` None it is K1s: every page block 0, `term_keys` [T],
    `val_ranges` [T, R, 2] and `val_hits` [T, V] used on every page. The
    same inputs and outputs as ``multi_scan_plain`` /
    ``scan_single_plain``, which it must equal."""
    single = page_block is None
    kk, vv = _unpack_kv(kv_key, kv_val, widths)
    P, E, C = kk.shape
    if single:
        term_keys, val_ranges = term_keys[None], val_ranges[None]
        if val_hits is not None:
            val_hits = val_hits[None]
            block_group = torch.zeros(1, dtype=torch.int32)
        pb = [0] * P
    else:
        pb = page_block.tolist()
    lane_bits, lane_ids = _LANES[kv_key.dtype if widths is None
                                 else widths[0]]
    per_word = 32 // lane_bits
    tl = min(n_terms, K1_PAT_TERMS)
    R = int(val_ranges.shape[-2])
    te = k1_tile(E, bool(n_terms))
    tpp = -(-E // te)
    tiles = P * tpp
    ctas = max(1, min(grid, tiles))
    valid = entry_valid.reshape(P, E)
    verd = None if verdicts is None else verdicts.reshape(P, E)
    passed = torch.zeros((P, E), dtype=torch.bool)
    live = torch.zeros((P, E), dtype=torch.bool)

    def block_state(b):
        hit = val_hits is not None and int(block_group[b]) >= 0
        keys = term_keys[b].tolist()
        can = all(_lane_holds(k, lane_bits, lane_ids) for k in keys[:tl])
        bitmaps = {}
        if not hit and val_hits is None and R <= K1_BIT_MAX_R:
            ids = torch.arange(K1_BIT_IDS)
            for t in range(min(n_terms, K1_BIT_TERMS)):
                rg = val_ranges[b, t].to(torch.int64)
                bitmaps[t] = _in_ranges(ids, rg[:, 0], rg[:, 1])
        return hit, keys, can, bitmaps

    def value_ok(b, state, t, v):
        hit, _keys, _can, bitmaps = state
        if hit:
            return _row_hits(val_hits[int(block_group[b]), t], v)
        rg = val_ranges[b, t].to(torch.int64)
        ok = _in_ranges(v, rg[:, 0], rg[:, 1])
        if t in bitmaps:
            inside = (v >= 0) & (v < K1_BIT_IDS)
            ok = torch.where(inside, bitmaps[t][v.clamp(0, K1_BIT_IDS - 1)],
                             ok)
        return ok

    runs = [range(cta * tiles // ctas, (cta + 1) * tiles // ctas)
            for cta in range(ctas)]
    state_b, state = None, None
    for run in runs:
        for tile in run:
            page, e0 = tile // tpp, (tile % tpp) * te
            sl = slice(e0, min(E, e0 + te))
            b = pb[page]
            if b < 0:
                continue
            ok = valid[page, sl].clone()
            if verd is not None:
                ok &= verd[page, sl] != 0
            if n_terms:
                if b != state_b:
                    state_b, state = b, block_state(b)
                if not state[2]:
                    ok[:] = False
                for t in range(tl):
                    key = state[1][t]
                    found = torch.zeros_like(ok)
                    for w in range(0, C, per_word):
                        for c in range(w, min(C, w + per_word)):
                            named = ok & ~found & (kk[page, sl, c] == key)
                            found |= named & value_ok(b, state, t,
                                                      vv[page, sl, c])
                    ok &= found
                for t in range(K1_PAT_TERMS, n_terms):
                    keym = kk[page, sl] == term_keys[b, t]
                    ok &= (keym & value_ok(b, state, t, vv[page, sl])).any(
                        dim=-1)
            passed[page, sl] = ok
            live[page, sl] = valid[page, sl]
    scores, _counts = _finish(passed, live, entry_start, entry_end,
                              entry_dur, entry_dur_res, widths, dur_lo,
                              dur_hi, win_start, win_end)
    # the counts: each CTA's pair over its run, summed after the barrier
    match = (scores >= 0).reshape(P, E)
    counts = [0, 0]
    for run in runs:
        for tile in run:
            page, e0 = tile // tpp, (tile % tpp) * te
            counts[0] += int(match[page, e0:e0 + te].sum())
            counts[1] += int(live[page, e0:e0 + te].sum())
    return scores, torch.tensor(counts, dtype=torch.int32)


def _lib():
    lib = load("scan")
    if not getattr(lib, "_tt_typed", False):
        p = ctypes.c_void_p
        i32 = ctypes.c_int
        u32 = ctypes.c_uint32
        i64 = ctypes.c_int64
        # kv layouts, kv columns, start, end, dur, dur_res, shift, res
        # bytes, valid
        cols = [i32, i32] + [p] * 6 + [i32, i32, p]
        lib.tt_scan_k1.restype = i32
        lib.tt_scan_k1.argtypes = [p, p, p, i64, p]
        lib.tt_scan_k1_desc_len.restype = i32
        lib.tt_scan_k1_max_grid.restype = i32
        if (lib.tt_scan_k1_desc_len() != len(_K1_DESC)
                or lib.tt_scan_k1_max_grid() != K1_MAX_GRID):
            raise RuntimeError("csrc/scan.cu's K1 descriptor differs from "
                               "kernels/scan.py's")
        lib.tt_coalesced_scan.restype = i32
        lib.tt_coalesced_scan.argtypes = (
            cols + [p] * 10 + [i32, i64] + [i32] * 6 + [p, i32, p, i64, p,
                                                        p, p])
        lib.tt_coalesced_table_bytes.restype = i64
        lib.tt_coalesced_table_bytes.argtypes = [i32] * 4
        lib._tt_typed = True
    return lib


def _check_entries(kv_key, kv_val, entry_start, entry_end, entry_dur,
                   entry_valid, entry_dur_res, widths) -> tuple:
    """Check the page arrays against the layout `widths` names. Returns
    (key layout, value layout, C, duration shift, residual bytes): the
    layouts as csrc/scan.cu numbers them, C the unpacked slot count, and
    shift -1 for u32 durations, 0 for exact u16, s for u16 buckets."""
    if kv_key.dim() != 3 or kv_val.dim() != 3 \
            or kv_key.shape[:2] != kv_val.shape[:2]:
        raise ValueError("kv_key and kv_val must be [P, E, C] alike")
    P, E = kv_key.shape[:2]
    if widths is None:
        if kv_key.dtype not in _ID_LAYOUTS or kv_val.dtype not in _ID_LAYOUTS:
            raise TypeError(f"kv columns must be int8/int16/int32, got "
                            f"{kv_key.dtype}/{kv_val.dtype}")
        if kv_val.shape != kv_key.shape:
            raise ValueError("kv_key and kv_val must be [P, E, C] alike")
        layouts = (_ID_LAYOUTS[kv_key.dtype], _ID_LAYOUTS[kv_val.dtype])
        C = int(kv_key.shape[2])
        dur_dt, shift, res_bytes = torch.int32, -1, 0
    else:
        kw, vw, dw = widths
        slots = []
        layouts = []
        for name, col, w in (("kv_key", kv_key, kw), ("kv_val", kv_val, vw)):
            if w not in _CODE_LAYOUTS:
                raise ValueError(f"{name}: unknown width {w!r}")
            lay, dt = _CODE_LAYOUTS[w]
            if col.dtype != dt:
                raise TypeError(f"{name}: width {w} wants {dt}, got "
                                f"{col.dtype}")
            layouts.append(lay)
            slots.append(int(col.shape[2]) * (2 if w == "u4" else 1))
        if slots[0] != slots[1]:
            raise ValueError(f"kv columns unpack to {slots[0]} and "
                             f"{slots[1]} slots")
        C = slots[0]
        dur_dt = torch.int16
        shift = packing.dur_shift(dw)
        if not (dw == "u16" or (dw.startswith("q") and 1 <= shift <= 16)):
            raise ValueError(f"unknown duration width {dw!r}")
        res_bytes = 0 if shift == 0 else (1 if shift <= 8 else 2)
    if res_bytes:
        res_dt = torch.uint8 if res_bytes == 1 else torch.int16
        if entry_dur_res is None or entry_dur_res.dtype != res_dt \
                or tuple(entry_dur_res.shape) != (P, E):
            raise ValueError(f"entry_dur_res: want {res_dt} {(P, E)} for "
                             f"duration width {widths[2]}")
    elif entry_dur_res is not None:
        raise ValueError("entry_dur_res goes only with bucketed durations")
    for name, t, dt in (("entry_start", entry_start, torch.int32),
                        ("entry_end", entry_end, torch.int32),
                        ("entry_dur", entry_dur, dur_dt),
                        ("entry_valid", entry_valid, torch.bool)):
        if t is None and name in ("entry_start", "entry_end"):
            continue        # K6 reads neither
        if t.dtype != dt or tuple(t.shape) != (P, E):
            raise ValueError(f"{name}: want {dt} {(P, E)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    return layouts[0], layouts[1], C, shift, res_bytes


def _check_hit_table(h, dims: int, what: str) -> int:
    """1 when hit table `h` holds words (int32), 0 for bytes (bool)."""
    if h.dtype not in (torch.bool, torch.int32) or h.dim() != dims:
        raise ValueError(f"{what} must be a bool or int32-word table of "
                         f"{dims} dims, got {h.dtype} {tuple(h.shape)}")
    return int(h.dtype == torch.int32)


def _hit_meta(val_hits, dev) -> tuple:
    """(address table int64 [Q, 3] on the host, words flag) of per-query
    hit tables ([G, T, V] each on `dev`, all bool or all words, or None):
    each row is (address or 0, T, row length in elements), so a kernel
    finds every query's own table without a stacked copy. K4's launcher
    passes the rows to its kernel by value."""
    meta, formats = [], set()
    for h in val_hits:
        if h is None:
            meta.append((0, 0, 0))
            continue
        formats.add(_check_hit_table(h, 3, "each val_hits table"))
        if h.device != dev or not h.is_contiguous():
            raise ValueError("each val_hits table must be contiguous on the "
                             "kernel's device")
        meta.append((h.data_ptr() if h.numel() else 0, int(h.shape[1]),
                     int(h.shape[2])))
    if len(formats) > 1:
        raise ValueError("val_hits tables mix bytes and words")
    flat = [x for row in meta for x in row]
    return ((ctypes.c_int64 * len(flat))(*flat),
            formats.pop() if formats else 0)


def _check_same_device(dev, tensors, what):
    for t in tensors:
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{what} inputs must be contiguous tensors on "
                             "one device")


def _check_bounds(*bounds):
    for v in bounds:
        if not 0 <= int(v) <= _U32:
            raise ValueError(f"bound {v} outside uint32")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_verdicts(v, rows_shape, dev, what):
    """A verdict tensor: uint8, contiguous, on `dev`, of `rows_shape`
    (K4: any number of rows up to Q before the entry axis)."""
    if v is None:
        return
    ok = (v.dtype == torch.uint8 and v.device == dev and v.is_contiguous()
          and v.dim() == len(rows_shape)
          and tuple(v.shape[-1:]) == tuple(rows_shape[-1:])
          and all(a <= b for a, b in zip(v.shape[:-1], rows_shape[:-1])))
    if not ok:
        raise ValueError(f"{what}: verdicts must be contiguous uint8 "
                         f"{rows_shape} on the scan's device, got "
                         f"{v.dtype} {tuple(v.shape)} on {v.device}")


def _count(k4: bool, widths, hits: bool) -> LaunchCount:
    """The counter of one K1 (or, with `k4`, K4) launch's mode."""
    if widths is None:
        if k4:
            return COALESCED_HIT_LAUNCHES if hits else COALESCED_LAUNCHES
        return HIT_LAUNCHES if hits else LAUNCHES
    if k4:
        return (COALESCED_PACKED_HIT_LAUNCHES if hits
                else COALESCED_PACKED_LAUNCHES)
    if hits:
        return PACKED_HIT_LAUNCHES
    return PACKED_Q_LAUNCHES if widths[2].startswith("q") \
        else PACKED_LAUNCHES


class _K1Call:
    """A checked K1/K1s call: its descriptor for ``tt_scan_k1``, its
    entry count, device and launch counter, and weak references to the
    tensors it was checked on (a call's entry leaves the cache when one of
    them dies)."""

    __slots__ = ("desc", "n", "dev", "counter", "refs")


# checked calls, by the identity and version of every tensor and the
# scalars they were checked with: a staged batch's arrays and a
# predicate's tables are checked once, not once a call
_K1_CALLS: dict = {}


def _k1_key(single: bool, tensors: tuple, scalars: tuple):
    """The cache key of a call, or None when a tensor keeps no version
    counter (an inference tensor): such a call is checked every time."""
    try:
        return (single, scalars) + tuple(
            None if t is None else (id(t), t._version) for t in tensors)
    except RuntimeError:
        return None


def _k1_call(single: bool, tensors: tuple, scalars: tuple, check_fn):
    key = _k1_key(single, tensors, scalars)
    call = None if key is None else _K1_CALLS.get(key)
    if call is not None:
        return call
    call = check_fn()
    if key is not None:
        if len(_K1_CALLS) >= _K1_CACHE_MAX:
            _K1_CALLS.clear()

        def forget(_ref, key=key):
            _K1_CALLS.pop(key, None)

        call.refs = [weakref.ref(t, forget) for t in tensors
                     if t is not None]
        _K1_CALLS[key] = call
    return call


def _k1_desc(dev, kl, vl, shift, res_bytes, P, E, C, fields: dict,
             counter) -> _K1Call:
    vals = dict(fields, key_layout=kl, val_layout=vl, dur_shift=shift,
                res_bytes=res_bytes, P=P, E=E, C=C)
    call = _K1Call()
    call.desc = (ctypes.c_int64 * len(_K1_DESC))(
        *(int(vals.get(k) or 0) for k in _K1_DESC))
    call.n, call.dev, call.counter, call.refs = P * E, dev, counter, []
    return call


def _k1_launch(call: _K1Call, verdicts, what: str):
    """Launch K1/K1s for a checked call: scores, counts and the CTAs'
    partial counts in one int32 buffer (the kernel writes the counts, no
    launch zeroes them)."""
    dev, n = call.dev, call.n
    _check_verdicts(verdicts, (n,), dev, what)
    if not n:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.zeros(2, dtype=torch.int32, device=dev))
    out = torch.empty(n + 2 + 2 * K1_MAX_GRID, dtype=torch.int32,
                      device=dev)
    lib = _lib()
    rc = on_device(dev, lib.tt_scan_k1, call.desc, _ptr(verdicts),
                   out.data_ptr(), out.numel())
    check(lib, rc, what)
    (call.counter[1] if verdicts is not None else call.counter[0]).bump()
    return out[:n], out[n:n + 2]


def _multi_scan_cuda(kv_key, kv_val, entry_start, entry_end, entry_dur,
                     entry_valid, page_block, term_keys, val_ranges,
                     n_terms, dur_lo, dur_hi, win_start, win_end, val_hits,
                     block_group, widths=None, entry_dur_res=None,
                     verdicts=None):
    tensors = (kv_key, kv_val, entry_start, entry_end, entry_dur,
               entry_dur_res, entry_valid, page_block, term_keys,
               val_ranges, val_hits, block_group)
    scalars = (n_terms, dur_lo, dur_hi, win_start, win_end, widths)

    def checked() -> _K1Call:
        dev = kv_key.device
        kl, vl, C, shift, res_bytes = _check_entries(
            kv_key, kv_val, entry_start, entry_end, entry_dur, entry_valid,
            entry_dur_res, widths)
        P, E = kv_key.shape[:2]
        if page_block.dtype != torch.int32 \
                or tuple(page_block.shape) != (P,):
            raise ValueError(f"page_block: want int32 {(P,)}")
        if term_keys.dtype != torch.int32 \
                or val_ranges.dtype != torch.int32:
            raise TypeError("term tables must be int32")
        if term_keys.dim() != 2:
            raise ValueError("term_keys must be [B, T]")
        B, t_stride = term_keys.shape
        if val_ranges.dim() != 4 \
                or tuple(val_ranges.shape[:2]) != (B, t_stride) \
                or val_ranges.shape[3] != 2 or val_ranges.shape[2] < 1 \
                or not 0 <= n_terms <= t_stride:
            raise ValueError("val_ranges must be [B, T, R, 2] beside "
                             "term_keys [B, T]")
        n_vals = 0
        words = 0
        if (val_hits is None) != (block_group is None):
            raise ValueError("val_hits and block_group go together")
        if val_hits is not None:
            words = _check_hit_table(val_hits, 3, "val_hits")
            if val_hits.shape[1] != t_stride:
                raise ValueError("val_hits must be [G, T, V] beside "
                                 "term_keys [B, T]")
            if block_group.dtype != torch.int32 \
                    or tuple(block_group.shape) != (B,):
                raise ValueError(f"block_group: want int32 {(B,)}")
            n_vals = int(val_hits.shape[2])
        _check_same_device(dev, tensors, "multi_scan")
        _check_bounds(dur_lo, dur_hi, win_start, win_end)
        return _k1_desc(
            dev, kl, vl, shift, res_bytes, P, E, C, dict(
                kv_key=kv_key.data_ptr(), kv_val=kv_val.data_ptr(),
                start=entry_start.data_ptr(), end=entry_end.data_ptr(),
                dur=entry_dur.data_ptr(), dur_res=_ptr(entry_dur_res),
                valid=entry_valid.data_ptr(),
                page_block=page_block.data_ptr(),
                term_keys=term_keys.data_ptr(),
                val_ranges=val_ranges.data_ptr(), val_hits=_ptr(val_hits),
                hit_words=words, block_group=_ptr(block_group),
                n_terms=n_terms, t_stride=t_stride,
                R=val_ranges.shape[2], n_vals=n_vals, dur_lo=dur_lo,
                dur_hi=dur_hi, win_start=win_start, win_end=win_end),
            (_count(False, widths, val_hits is not None), VERDICT_LAUNCHES))

    return _k1_launch(_k1_call(False, tensors, scalars, checked), verdicts,
                      "multi_scan")


def _scan_single_cuda(kv_key, kv_val, entry_start, entry_end, entry_dur,
                      entry_valid, term_keys, val_ranges, n_terms, dur_lo,
                      dur_hi, win_start, win_end, val_hits, widths=None,
                      entry_dur_res=None, verdicts=None):
    tensors = (kv_key, kv_val, entry_start, entry_end, entry_dur,
               entry_dur_res, entry_valid, term_keys, val_ranges, val_hits)
    scalars = (n_terms, dur_lo, dur_hi, win_start, win_end, widths)

    def checked() -> _K1Call:
        dev = kv_key.device
        kl, vl, C, shift, res_bytes = _check_entries(
            kv_key, kv_val, entry_start, entry_end, entry_dur, entry_valid,
            entry_dur_res, widths)
        if widths is None and (kv_key.dtype != torch.int32
                               or kv_val.dtype != torch.int32):
            raise TypeError("scan_single takes int32 kv columns or a "
                            "packed layout")
        P, E = kv_key.shape[:2]
        if term_keys.dtype != torch.int32 \
                or val_ranges.dtype != torch.int32:
            raise TypeError("term tables must be int32")
        if term_keys.dim() != 1:
            raise ValueError("term_keys must be [T]")
        t_stride = term_keys.shape[0]
        if val_ranges.dim() != 3 or val_ranges.shape[0] != t_stride \
                or val_ranges.shape[2] != 2 or val_ranges.shape[1] < 1 \
                or not 0 <= n_terms <= t_stride:
            raise ValueError("val_ranges must be [T, R, 2] beside "
                             "term_keys [T]")
        n_vals = 0
        words = 0
        if val_hits is not None:
            words = _check_hit_table(val_hits, 2, "val_hits")
            if val_hits.shape[0] != t_stride:
                raise ValueError("val_hits rows must match term_keys")
            n_vals = int(val_hits.shape[1])
        _check_same_device(dev, tensors, "scan_single")
        _check_bounds(dur_lo, dur_hi, win_start, win_end)
        return _k1_desc(
            dev, kl, vl, shift, res_bytes, P, E, C, dict(
                kv_key=kv_key.data_ptr(), kv_val=kv_val.data_ptr(),
                start=entry_start.data_ptr(), end=entry_end.data_ptr(),
                dur=entry_dur.data_ptr(), dur_res=_ptr(entry_dur_res),
                valid=entry_valid.data_ptr(), term_keys=term_keys.data_ptr(),
                val_ranges=val_ranges.data_ptr(), val_hits=_ptr(val_hits),
                hit_words=words, n_terms=n_terms, t_stride=t_stride,
                R=val_ranges.shape[1], n_vals=n_vals, dur_lo=dur_lo,
                dur_hi=dur_hi, win_start=win_start, win_end=win_end),
            (SINGLE_LAUNCHES if widths is None else SINGLE_PACKED_LAUNCHES,
             SINGLE_VERDICT_LAUNCHES))

    return _k1_launch(_k1_call(True, tensors, scalars, checked), verdicts,
                      "scan_single")


def _coalesced_scan_cuda(kv_key, kv_val, entry_start, entry_end, entry_dur,
                         entry_valid, page_block, term_keys, val_ranges,
                         term_active, dur_lo, dur_hi, win_start, win_end,
                         val_hits, block_group, widths=None,
                         entry_dur_res=None, verdicts=None):
    dev = kv_key.device
    kl, vl, C, shift, res_bytes = _check_entries(
        kv_key, kv_val, entry_start, entry_end, entry_dur, entry_valid,
        entry_dur_res, widths)
    P, E = kv_key.shape[:2]
    if page_block.dtype != torch.int32 or tuple(page_block.shape) != (P,):
        raise ValueError(f"page_block: want int32 {(P,)}")
    if term_keys.dtype != torch.int32 or val_ranges.dtype != torch.int32 \
            or term_keys.dim() != 3:
        raise TypeError("term tables must be int32, term_keys [Q, B, T]")
    Q, B, T = term_keys.shape
    if not 1 <= Q <= MAX_QUERIES or T < 1:
        raise ValueError(f"coalesced_scan takes 1..{MAX_QUERIES} queries "
                         "and at least one term column")
    if val_ranges.dim() != 5 or tuple(val_ranges.shape[:3]) != (Q, B, T) \
            or val_ranges.shape[4] != 2 or val_ranges.shape[3] < 1:
        raise ValueError("val_ranges must be [Q, B, T, R, 2] beside "
                         "term_keys [Q, B, T]")
    if term_active.dtype != torch.bool \
            or tuple(term_active.shape) != (Q, T):
        raise ValueError(f"term_active: want bool {(Q, T)}")
    bounds = (dur_lo, dur_hi, win_start, win_end)
    for b in bounds:
        if b.dtype != torch.int32 or tuple(b.shape) != (Q,):
            raise ValueError(f"bounds: want int32 {(Q,)} (uint32 bits)")
    if (val_hits is None) != (block_group is None):
        raise ValueError("val_hits and block_group go together")
    hit_meta = None
    words = 0
    if val_hits is not None:
        if len(val_hits) != Q:
            raise ValueError(f"val_hits: want {Q} entries")
        if block_group.dtype != torch.int32 \
                or tuple(block_group.shape) != (Q, B):
            raise ValueError(f"block_group: want int32 {(Q, B)}")
        # the tables stay where the members' compiles left them (the
        # reference stacks them into one [Q, G, T, V] array, some 25 MB a
        # dispatch for the high-cardinality cell)
        hit_meta, words = _hit_meta(val_hits, dev)
    _check_same_device(dev, (kv_key, kv_val, entry_start, entry_end,
                             entry_dur, entry_dur_res, entry_valid,
                             page_block, term_keys, val_ranges, term_active,
                             *bounds, block_group), "coalesced_scan")
    _check_verdicts(verdicts, (Q, P * E), dev, "coalesced_scan")
    R = int(val_ranges.shape[3])
    lib = _lib()
    # scratch for the kernel's per-block term tables
    table_bytes = lib.tt_coalesced_table_bytes(Q, T, R, B)
    if table_bytes < 0:
        raise ValueError(f"coalesced_scan: no term tables for Q={Q}, T={T}, "
                         f"R={R}")
    tables = torch.empty(max(1, table_bytes), dtype=torch.uint8, device=dev)
    scores = torch.empty((Q, P * E), dtype=torch.int32, device=dev)
    counts = torch.empty(Q + 1, dtype=torch.int32, device=dev)  # zeroed there
    rc = on_device(
        dev, lib.tt_coalesced_scan, kl, vl, kv_key.data_ptr(),
        kv_val.data_ptr(), entry_start.data_ptr(), entry_end.data_ptr(),
        entry_dur.data_ptr(), _ptr(entry_dur_res), shift, res_bytes,
        entry_valid.data_ptr(), page_block.data_ptr(),
        term_keys.data_ptr(), val_ranges.data_ptr(),
        term_active.data_ptr(), *(b.data_ptr() for b in bounds),
        _ptr(block_group), hit_meta, words, P, E, C, Q, B, T, R,
        _ptr(verdicts), 0 if verdicts is None else int(verdicts.shape[0]),
        tables.data_ptr(), table_bytes, scores.data_ptr(),
        counts.data_ptr())
    check(lib, rc, "coalesced_scan")
    if P * E:
        (COALESCED_VERDICT_LAUNCHES if verdicts is not None
         else _count(True, widths, val_hits is not None)).bump()
    return scores, counts[:Q], counts[Q]
