"""K1 ``multi_scan``, K1s ``scan_single`` and K4 ``coalesced_scan``: the
tag-search predicate, count and score column.

K1 is the counterpart of ``tempo_tpu/search/multiblock.py``
``multi_entry_mask`` and the count/inspected half of ``multi_scan_kernel``
(TPU kernel B3 without its packed/structural/aggregate inputs), in range
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
  val_hits, block_group   optional, together: bool [G, T', Vm] and int32
                          [B]; a block with group g >= 0 tests a value v
                          by val_hits[g, t, v] instead of the ranges
K1s inputs: kv int32, no page_block, term tables [T'] and [T', R, 2], and
an optional val_hits bool [T', V] used on every page.
Outputs: scores int32 [P*E] (min(start, 2^31-1) where the entry matches,
else -1) and counts int32 [2] = (match count, inspected), inspected being
the valid entries (of non-pad pages).

K4 is the counterpart of ``tempo_tpu/search/multiblock.py``
``coalesced_scan_kernel`` (B6) without its structural and aggregate
inputs: K1's function for Q queries over the same staged pages, in one
launch. Its inputs are K1's page arrays and, per query, term_keys
[Q, B, T], val_ranges [Q, B, T, R, 2], term_active bool [Q, T] (an
inactive term is neutral-true) and the bounds dur_lo, dur_hi, win_start,
win_end as int32 [Q] holding uint32 bits; in hit-mask mode, val_hits, a
sequence of Q hit tables (bool [G_q, T_q, V_q], or None for a query
compiled on the host), with block_group int32 [Q, B]. Outputs: scores
int32 [Q, P*E], counts int32 [Q] and inspected, an int32 scalar.
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCount
from .build import check, load

LAUNCHES = LaunchCount()         # K1 launches in range mode
HIT_LAUNCHES = LaunchCount()     # K1 launches in hit-mask mode
SINGLE_LAUNCHES = LaunchCount()  # K1s launches (either mode)
COALESCED_LAUNCHES = LaunchCount()      # K4 launches in range mode
COALESCED_HIT_LAUNCHES = LaunchCount()  # K4 launches in hit-mask mode
MAX_QUERIES = 64                 # K4's query axis, at most

_KV_DTYPES = {torch.int8: 1, torch.int16: 2, torch.int32: 4}
_U32 = 0xFFFFFFFF


def multi_scan(kv_key, kv_val, entry_start, entry_end, entry_dur,
               entry_valid, page_block, term_keys, val_ranges,
               n_terms: int, dur_lo: int, dur_hi: int, win_start: int,
               win_end: int, val_hits=None, block_group=None):
    """(scores, counts) — the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if kv_key.device.type == "cpu":
        return multi_scan_plain(kv_key, kv_val, entry_start, entry_end,
                                entry_dur, entry_valid, page_block,
                                term_keys, val_ranges, n_terms, dur_lo,
                                dur_hi, win_start, win_end, val_hits,
                                block_group)
    return _multi_scan_cuda(kv_key, kv_val, entry_start, entry_end,
                            entry_dur, entry_valid, page_block, term_keys,
                            val_ranges, n_terms, dur_lo, dur_hi, win_start,
                            win_end, val_hits, block_group)


def scan_single(kv_key, kv_val, entry_start, entry_end, entry_dur,
                entry_valid, term_keys, val_ranges, n_terms: int,
                dur_lo: int, dur_hi: int, win_start: int, win_end: int,
                val_hits=None):
    """(scores, counts) over one block — the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if kv_key.device.type == "cpu":
        return scan_single_plain(kv_key, kv_val, entry_start, entry_end,
                                 entry_dur, entry_valid, term_keys,
                                 val_ranges, n_terms, dur_lo, dur_hi,
                                 win_start, win_end, val_hits)
    return _scan_single_cuda(kv_key, kv_val, entry_start, entry_end,
                             entry_dur, entry_valid, term_keys, val_ranges,
                             n_terms, dur_lo, dur_hi, win_start, win_end,
                             val_hits)


def coalesced_scan(kv_key, kv_val, entry_start, entry_end, entry_dur,
                   entry_valid, page_block, term_keys, val_ranges,
                   term_active, dur_lo, dur_hi, win_start, win_end,
                   val_hits=None, block_group=None):
    """(scores [Q, P*E], counts [Q], inspected) — the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    fn = (coalesced_scan_plain if kv_key.device.type == "cpu"
          else _coalesced_scan_cuda)
    return fn(kv_key, kv_val, entry_start, entry_end, entry_dur,
              entry_valid, page_block, term_keys, val_ranges, term_active,
              dur_lo, dur_hi, win_start, win_end, val_hits, block_group)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns of uint32 values -> their int64 values."""
    return x.to(torch.int64) & _U32


def _in_ranges(vv, lo, hi):
    """[P,E,C] bool: vv inside some [lo[..., r], hi[..., r]]; lo/hi
    broadcast against vv[..., None]."""
    return ((vv[..., None] >= lo) & (vv[..., None] <= hi)).any(dim=-1)


def _finish(mask, live, entry_start, entry_end, entry_dur, dur_lo, dur_hi,
            win_start, win_end):
    start = _u32(entry_start)
    dur = _u32(entry_dur)
    mask &= (dur >= int(dur_lo)) & (dur <= int(dur_hi))
    mask &= _u32(entry_end) >= int(win_start)
    mask &= start <= int(win_end)
    scores = torch.where(mask, start.clamp(max=2**31 - 1),
                         torch.full_like(start, -1)).to(torch.int32)
    counts = torch.stack([mask.sum(), live.sum()]).to(torch.int32)
    return scores.reshape(-1), counts


def multi_scan_plain(kv_key, kv_val, entry_start, entry_end, entry_dur,
                     entry_valid, page_block, term_keys, val_ranges,
                     n_terms: int, dur_lo: int, dur_hi: int, win_start: int,
                     win_end: int, val_hits=None, block_group=None):
    """K1's function in plain PyTorch ops, on whatever device the tensors
    are on."""
    pb = page_block.to(torch.int64)
    safe = pb.clamp(min=0)
    live = entry_valid & (pb >= 0)[:, None]
    mask = live.clone()
    if n_terms:
        kk = kv_key.to(torch.int32)
        vv = kv_val.to(torch.int32)
        if val_hits is not None:
            bg = block_group.to(torch.int64)[safe]                # [P]
            probe_page = (bg >= 0)[:, None, None]
            g_idx = bg.clamp(min=0)[:, None, None].expand_as(vv)
            # an id past the table clamps to its last entry, as the
            # reference's gather does
            safe_v = vv.clamp(min=0, max=val_hits.shape[2] - 1
                              ).to(torch.int64)
        for t in range(n_terms):
            keym = kk == term_keys[safe, t][:, None, None]
            valm = _in_ranges(vv, val_ranges[safe, t, :, 0][:, None, None],
                              val_ranges[safe, t, :, 1][:, None, None])
            if val_hits is not None:
                mh = val_hits[g_idx, t, safe_v] & (vv >= 0)
                valm = torch.where(probe_page, mh, valm)
            mask &= (keym & valm).any(dim=-1)
    return _finish(mask, live, entry_start, entry_end, entry_dur, dur_lo,
                   dur_hi, win_start, win_end)


def coalesced_scan_plain(kv_key, kv_val, entry_start, entry_end,
                         entry_dur, entry_valid, page_block, term_keys,
                         val_ranges, term_active, dur_lo, dur_hi,
                         win_start, win_end, val_hits=None,
                         block_group=None):
    """K4's function in plain PyTorch ops: K1's plain version once per
    query, over that query's active terms."""
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
                dur_lo, dur_hi, win_start, win_end)), vh, bg)
        rows.append(s)
        counts.append(c[0])
        inspected = c[1]
    return torch.stack(rows), torch.stack(counts), inspected


def scan_single_plain(kv_key, kv_val, entry_start, entry_end, entry_dur,
                      entry_valid, term_keys, val_ranges, n_terms: int,
                      dur_lo: int, dur_hi: int, win_start: int,
                      win_end: int, val_hits=None):
    """K1s's function in plain PyTorch ops, written from the reference's
    ``engine.entry_match_mask``: per term, key equality and value
    membership (a hit-table lookup when ``val_hits`` is given, else the
    range compares), OR over slots, AND over terms."""
    live = entry_valid
    mask = live.clone()
    if n_terms:
        kk = kv_key.to(torch.int32)
        vv = kv_val.to(torch.int32)
        for t in range(n_terms):
            keym = kk == term_keys[t]
            if val_hits is not None:
                row = val_hits[t]
                safe_v = vv.clamp(min=0, max=row.numel() - 1)
                valm = row[safe_v.to(torch.int64)] & (vv >= 0)
            else:
                valm = _in_ranges(vv, val_ranges[t, :, 0],
                                  val_ranges[t, :, 1])
            mask &= (keym & valm).any(dim=-1)
    return _finish(mask, live, entry_start, entry_end, entry_dur, dur_lo,
                   dur_hi, win_start, win_end)


def _lib():
    lib = load("scan")
    if not getattr(lib, "_tt_typed", False):
        p = ctypes.c_void_p
        i32 = ctypes.c_int
        u32 = ctypes.c_uint32
        i64 = ctypes.c_int64
        lib.tt_multi_scan.restype = i32
        lib.tt_multi_scan.argtypes = (
            [i32, i32] + [p] * 11 + [i64] + [i32] * 5 + [i64]
            + [u32] * 4 + [p, p, p])
        lib.tt_scan_single.restype = i32
        lib.tt_scan_single.argtypes = (
            [p] * 9 + [i64] + [i32] * 5 + [i64] + [u32] * 4 + [p, p, p])
        lib.tt_coalesced_scan.restype = i32
        lib.tt_coalesced_scan.argtypes = (
            [i32, i32] + [p] * 16 + [i64] + [i32] * 6 + [p, p, p])
        lib._tt_typed = True
    return lib


def _check_entries(kv_key, kv_val, entry_start, entry_end, entry_dur,
                   entry_valid):
    if kv_key.dtype not in _KV_DTYPES or kv_val.dtype not in _KV_DTYPES:
        raise TypeError(f"kv columns must be int8/int16/int32, got "
                        f"{kv_key.dtype}/{kv_val.dtype}")
    if kv_key.dim() != 3 or kv_val.shape != kv_key.shape:
        raise ValueError("kv_key and kv_val must be [P, E, C] alike")
    P, E, _C = kv_key.shape
    for name, t, dt in (("entry_start", entry_start, torch.int32),
                        ("entry_end", entry_end, torch.int32),
                        ("entry_dur", entry_dur, torch.int32),
                        ("entry_valid", entry_valid, torch.bool)):
        if t.dtype != dt or tuple(t.shape) != (P, E):
            raise ValueError(f"{name}: want {dt} {(P, E)}, got {t.dtype} "
                             f"{tuple(t.shape)}")


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


def _multi_scan_cuda(kv_key, kv_val, entry_start, entry_end, entry_dur,
                     entry_valid, page_block, term_keys, val_ranges,
                     n_terms, dur_lo, dur_hi, win_start, win_end, val_hits,
                     block_group):
    dev = kv_key.device
    _check_entries(kv_key, kv_val, entry_start, entry_end, entry_dur,
                   entry_valid)
    P, E, C = kv_key.shape
    if page_block.dtype != torch.int32 or tuple(page_block.shape) != (P,):
        raise ValueError(f"page_block: want int32 {(P,)}")
    if term_keys.dtype != torch.int32 or val_ranges.dtype != torch.int32:
        raise TypeError("term tables must be int32")
    B, t_stride = term_keys.shape
    if val_ranges.dim() != 4 or tuple(val_ranges.shape[:2]) != (B, t_stride) \
            or val_ranges.shape[3] != 2 or n_terms > t_stride:
        raise ValueError("val_ranges must be [B, T, R, 2] beside term_keys "
                         "[B, T]")
    n_vals = 0
    if (val_hits is None) != (block_group is None):
        raise ValueError("val_hits and block_group go together")
    if val_hits is not None:
        if val_hits.dtype != torch.bool or val_hits.dim() != 3 \
                or val_hits.shape[1] != t_stride:
            raise ValueError("val_hits must be bool [G, T, V] beside "
                             "term_keys [B, T]")
        if block_group.dtype != torch.int32 \
                or tuple(block_group.shape) != (B,):
            raise ValueError(f"block_group: want int32 {(B,)}")
        n_vals = int(val_hits.shape[2])
    _check_same_device(dev, (kv_key, kv_val, entry_start, entry_end,
                             entry_dur, entry_valid, page_block, term_keys,
                             val_ranges, val_hits, block_group), "multi_scan")
    _check_bounds(dur_lo, dur_hi, win_start, win_end)
    n = P * E
    scores = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_multi_scan(
            _KV_DTYPES[kv_key.dtype], _KV_DTYPES[kv_val.dtype],
            kv_key.data_ptr(), kv_val.data_ptr(), entry_start.data_ptr(),
            entry_end.data_ptr(), entry_dur.data_ptr(),
            entry_valid.data_ptr(), page_block.data_ptr(),
            term_keys.data_ptr(), val_ranges.data_ptr(), _ptr(val_hits),
            _ptr(block_group), n, E, C, int(n_terms), t_stride,
            int(val_ranges.shape[2]), n_vals, int(dur_lo), int(dur_hi),
            int(win_start), int(win_end), scores.data_ptr(),
            counts.data_ptr(), stream)
    check(lib, rc, "multi_scan")
    if n:
        (LAUNCHES if val_hits is None else HIT_LAUNCHES).bump()
    return scores, counts


def _scan_single_cuda(kv_key, kv_val, entry_start, entry_end, entry_dur,
                      entry_valid, term_keys, val_ranges, n_terms, dur_lo,
                      dur_hi, win_start, win_end, val_hits):
    dev = kv_key.device
    _check_entries(kv_key, kv_val, entry_start, entry_end, entry_dur,
                   entry_valid)
    if kv_key.dtype != torch.int32 or kv_val.dtype != torch.int32:
        raise TypeError("scan_single takes int32 kv columns")
    P, E, C = kv_key.shape
    if term_keys.dtype != torch.int32 or val_ranges.dtype != torch.int32:
        raise TypeError("term tables must be int32")
    if term_keys.dim() != 1:
        raise ValueError("term_keys must be [T]")
    t_stride = term_keys.shape[0]
    if val_ranges.dim() != 3 or val_ranges.shape[0] != t_stride \
            or val_ranges.shape[2] != 2 or n_terms > t_stride:
        raise ValueError("val_ranges must be [T, R, 2] beside term_keys [T]")
    n_vals = 0
    if val_hits is not None:
        if val_hits.dtype != torch.bool or val_hits.dim() != 2 \
                or val_hits.shape[0] < n_terms:
            raise ValueError("val_hits must be bool [T, V]")
        if val_hits.shape[0] != t_stride:
            raise ValueError("val_hits rows must match term_keys")
        n_vals = int(val_hits.shape[1])
    _check_same_device(dev, (kv_key, kv_val, entry_start, entry_end,
                             entry_dur, entry_valid, term_keys, val_ranges,
                             val_hits), "scan_single")
    _check_bounds(dur_lo, dur_hi, win_start, win_end)
    n = P * E
    scores = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_scan_single(
            kv_key.data_ptr(), kv_val.data_ptr(), entry_start.data_ptr(),
            entry_end.data_ptr(), entry_dur.data_ptr(),
            entry_valid.data_ptr(), term_keys.data_ptr(),
            val_ranges.data_ptr(), _ptr(val_hits), n, E, C, int(n_terms),
            t_stride, int(val_ranges.shape[1]), n_vals, int(dur_lo),
            int(dur_hi), int(win_start), int(win_end), scores.data_ptr(),
            counts.data_ptr(), stream)
    check(lib, rc, "scan_single")
    if n:
        SINGLE_LAUNCHES.bump()
    return scores, counts


def _coalesced_scan_cuda(kv_key, kv_val, entry_start, entry_end, entry_dur,
                         entry_valid, page_block, term_keys, val_ranges,
                         term_active, dur_lo, dur_hi, win_start, win_end,
                         val_hits, block_group):
    dev = kv_key.device
    _check_entries(kv_key, kv_val, entry_start, entry_end, entry_dur,
                   entry_valid)
    P, E, C = kv_key.shape
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
    if val_hits is not None:
        if len(val_hits) != Q:
            raise ValueError(f"val_hits: want {Q} entries")
        if block_group.dtype != torch.int32 \
                or tuple(block_group.shape) != (Q, B):
            raise ValueError(f"block_group: want int32 {(Q, B)}")
        meta = []
        for h in val_hits:
            if h is None:
                meta.append((0, 0, 0))
                continue
            if h.dtype != torch.bool or h.dim() != 3 or h.device != dev \
                    or not h.is_contiguous():
                raise ValueError("each val_hits table must be a contiguous "
                                 "bool [G, T, V] tensor on the scan's "
                                 "device")
            meta.append((h.data_ptr() if h.numel() else 0,
                         int(h.shape[1]), int(h.shape[2])))
        # the tables stay where the members' compiles left them: the
        # kernel finds each through this [Q, 3] table of addresses, so a
        # fused dispatch copies none of them (the reference stacks them
        # into one [Q, G, T, V] array, some 25 MB a dispatch for the
        # high-cardinality cell)
        hit_meta = torch.tensor(meta, dtype=torch.int64).to(dev)
    _check_same_device(dev, (kv_key, kv_val, entry_start, entry_end,
                             entry_dur, entry_valid, page_block, term_keys,
                             val_ranges, term_active, *bounds, block_group,
                             hit_meta), "coalesced_scan")
    scores = torch.empty((Q, P * E), dtype=torch.int32, device=dev)
    counts = torch.zeros(Q + 1, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_coalesced_scan(
            _KV_DTYPES[kv_key.dtype], _KV_DTYPES[kv_val.dtype],
            kv_key.data_ptr(), kv_val.data_ptr(), entry_start.data_ptr(),
            entry_end.data_ptr(), entry_dur.data_ptr(),
            entry_valid.data_ptr(), page_block.data_ptr(),
            term_keys.data_ptr(), val_ranges.data_ptr(),
            term_active.data_ptr(), *(b.data_ptr() for b in bounds),
            _ptr(block_group), _ptr(hit_meta), P, E, C, Q, B, T,
            int(val_ranges.shape[3]), scores.data_ptr(), counts.data_ptr(),
            stream)
    check(lib, rc, "coalesced_scan")
    if P * E:
        (COALESCED_LAUNCHES if val_hits is None
         else COALESCED_HIT_LAUNCHES).bump()
    return scores, counts[:Q], counts[Q]
