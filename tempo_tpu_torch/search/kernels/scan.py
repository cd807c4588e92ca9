"""K1 ``multi_scan``: the batched predicate, count and score column.

Counterpart of ``tempo_tpu/search/multiblock.py`` ``multi_entry_mask`` and
the count/inspected half of ``multi_scan_kernel`` (TPU kernel B3 without
its optional probe/structural/packed/aggregate inputs), plus the score of
``engine.masked_topk``. The CUDA kernel is ``csrc/scan.cu``; the plain
PyTorch version below is the CPU path and the reference the kernel is
held against on the card.

Inputs (all on one device, contiguous):
  kv_key, kv_val          [P, E, C] int8 / int16 / int32 (as narrowed)
  entry_start/end/dur     [P, E] int32 holding the container's uint32 bits
  entry_valid             [P, E] bool
  page_block              [P] int32, -1 for pad pages
  term_keys               [B, T'] int32 (T' = max(1, n_terms))
  val_ranges              [B, T', R, 2] int32
Outputs: scores int32 [P*E] (min(start, 2^31-1) where the entry matches,
else -1) and counts int32 [2] = (match count, inspected), inspected being
the valid entries of non-pad pages.
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCount
from .build import check, load

LAUNCHES = LaunchCount()

_KV_DTYPES = {torch.int8: 1, torch.int16: 2, torch.int32: 4}
_U32 = 0xFFFFFFFF


def multi_scan(kv_key, kv_val, entry_start, entry_end, entry_dur,
               entry_valid, page_block, term_keys, val_ranges,
               n_terms: int, dur_lo: int, dur_hi: int, win_start: int,
               win_end: int):
    """(scores, counts) — the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if kv_key.device.type == "cpu":
        return multi_scan_plain(kv_key, kv_val, entry_start, entry_end,
                                entry_dur, entry_valid, page_block,
                                term_keys, val_ranges, n_terms, dur_lo,
                                dur_hi, win_start, win_end)
    return _multi_scan_cuda(kv_key, kv_val, entry_start, entry_end,
                            entry_dur, entry_valid, page_block, term_keys,
                            val_ranges, n_terms, dur_lo, dur_hi, win_start,
                            win_end)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns of uint32 values -> their int64 values."""
    return x.to(torch.int64) & _U32


def multi_scan_plain(kv_key, kv_val, entry_start, entry_end, entry_dur,
                     entry_valid, page_block, term_keys, val_ranges,
                     n_terms: int, dur_lo: int, dur_hi: int, win_start: int,
                     win_end: int):
    """The same function in plain PyTorch ops, on whatever device the
    tensors are on."""
    pb = page_block.to(torch.int64)
    safe = pb.clamp(min=0)
    live = entry_valid & (pb >= 0)[:, None]
    mask = live.clone()
    if n_terms:
        kk = kv_key.to(torch.int32)
        vv = kv_val.to(torch.int32)
        R = val_ranges.shape[2]
        for t in range(n_terms):
            keym = kk == term_keys[safe, t][:, None, None]
            valm = torch.zeros_like(keym)
            for r in range(R):
                lo = val_ranges[safe, t, r, 0][:, None, None]
                hi = val_ranges[safe, t, r, 1][:, None, None]
                valm |= (vv >= lo) & (vv <= hi)
            mask &= (keym & valm).any(dim=-1)
    start = _u32(entry_start)
    dur = _u32(entry_dur)
    mask &= (dur >= int(dur_lo)) & (dur <= int(dur_hi))
    mask &= _u32(entry_end) >= int(win_start)
    mask &= start <= int(win_end)
    scores = torch.where(mask, start.clamp(max=2**31 - 1),
                         torch.full_like(start, -1)).to(torch.int32)
    counts = torch.stack([mask.sum(), live.sum()]).to(torch.int32)
    return scores.reshape(-1), counts


def _lib():
    lib = load("scan")
    if not getattr(lib, "_tt_typed", False):
        p = ctypes.c_void_p
        lib.tt_multi_scan.restype = ctypes.c_int
        lib.tt_multi_scan.argtypes = (
            [ctypes.c_int, ctypes.c_int] + [p] * 9
            + [ctypes.c_int64] + [ctypes.c_int] * 5
            + [ctypes.c_uint32] * 4 + [p, p, p])
        lib._tt_typed = True
    return lib


def _multi_scan_cuda(kv_key, kv_val, entry_start, entry_end, entry_dur,
                     entry_valid, page_block, term_keys, val_ranges,
                     n_terms, dur_lo, dur_hi, win_start, win_end):
    dev = kv_key.device
    if kv_key.dtype not in _KV_DTYPES or kv_val.dtype not in _KV_DTYPES:
        raise TypeError(f"kv columns must be int8/int16/int32, got "
                        f"{kv_key.dtype}/{kv_val.dtype}")
    P, E, C = kv_key.shape
    if kv_val.shape != kv_key.shape:
        raise ValueError("kv_key and kv_val shapes differ")
    for name, t, dt, shape in (
            ("entry_start", entry_start, torch.int32, (P, E)),
            ("entry_end", entry_end, torch.int32, (P, E)),
            ("entry_dur", entry_dur, torch.int32, (P, E)),
            ("entry_valid", entry_valid, torch.bool, (P, E)),
            ("page_block", page_block, torch.int32, (P,))):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if term_keys.dtype != torch.int32 or val_ranges.dtype != torch.int32:
        raise TypeError("term tables must be int32")
    B, t_stride = term_keys.shape
    if val_ranges.dim() != 4 or tuple(val_ranges.shape[:2]) != (B, t_stride) \
            or val_ranges.shape[3] != 2 or n_terms > t_stride:
        raise ValueError("val_ranges must be [B, T, R, 2] beside term_keys "
                         "[B, T]")
    args = (kv_key, kv_val, entry_start, entry_end, entry_dur, entry_valid,
            page_block, term_keys, val_ranges)
    for t in args:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("multi_scan inputs must be contiguous tensors "
                             "on one device")
    for v in (dur_lo, dur_hi, win_start, win_end):
        if not 0 <= int(v) <= _U32:
            raise ValueError(f"bound {v} outside uint32")
    n = P * E
    scores = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_multi_scan(
            _KV_DTYPES[kv_key.dtype], _KV_DTYPES[kv_val.dtype],
            *(t.data_ptr() for t in args), n, E, C, int(n_terms),
            t_stride, int(val_ranges.shape[2]), int(dur_lo), int(dur_hi),
            int(win_start), int(win_end), scores.data_ptr(),
            counts.data_ptr(), stream)
    check(lib, rc, "multi_scan")
    LAUNCHES.n += 1
    return scores, counts
