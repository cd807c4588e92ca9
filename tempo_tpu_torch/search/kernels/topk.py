"""K2 ``topk`` and K2r ``topk_rows``: the k most recent matches of a score
column, or of each row of Q score columns.

K2 is the counterpart of ``tempo_tpu/search/engine.py`` ``masked_topk``
(TPU kernel B2); K2r is the same function over a query axis, as the
reference's ``coalesced_scan_kernel`` (B6) lifts it with ``jax.vmap``.
Both take int32 scores (>= -1, as K1 and K4 write them) and k; K2 returns
(scores [min(k, N)], flat idx [min(k, N)]) for a column [N], K2r
(scores [Q, min(k, N)], idx [Q, min(k, N)]) for rows [Q, N], the index
counted within the row. The order is highest score first, lowest index
first among equal scores — lax.top_k's order. One CUDA launch chain
(``csrc/topk.cu``: radix select + gather + bitonic sort, the row on
``gridDim.y``) serves both; K2 is the case Q = 1. The plain version sorts
the same unique 63-bit keys, so the two agree exactly, indices included.
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCount
from .build import check, load

LAUNCHES = LaunchCount()        # K2: one score column
ROW_LAUNCHES = LaunchCount()    # K2r: Q rows in one launch chain


def topk(scores: torch.Tensor, k: int):
    """(top scores, flat indices) of a column [N] — the plain version for
    a CPU tensor, the CUDA kernel for a CUDA tensor."""
    if scores.device.type == "cpu":
        return topk_plain(scores, k)
    if scores.dim() != 1:
        raise ValueError("topk takes a 1-D tensor")
    s, i = _topk_rows_cuda(scores.view(1, -1), k)
    if s.numel():
        LAUNCHES.bump()
    return s[0], i[0]


def topk_rows(scores: torch.Tensor, k: int):
    """(top scores [Q, k'], indices [Q, k']) of each row of [Q, N] — the
    plain version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    if scores.device.type == "cpu":
        return topk_rows_plain(scores, k)
    if scores.dim() != 2:
        raise ValueError("topk_rows takes a 2-D tensor")
    s, i = _topk_rows_cuda(scores, k)
    if s.numel():
        ROW_LAUNCHES.bump()
    return s, i


def topk_rows_plain(scores: torch.Tensor, k: int):
    """K2r's function in plain PyTorch ops: a sort of each row's unique
    keys."""
    n = scores.shape[1]
    k_eff = min(int(k), n)
    idx = torch.arange(n, dtype=torch.int64, device=scores.device)
    keys = ((0x7FFFFFFF - scores.to(torch.int64)) << 31) | idx
    sel = torch.sort(keys, dim=1).values[:, :k_eff]
    return ((0x7FFFFFFF - (sel >> 31)).to(torch.int32),
            (sel & 0x7FFFFFFF).to(torch.int32))


def topk_plain(scores: torch.Tensor, k: int):
    """K2's function in plain PyTorch ops."""
    s, i = topk_rows_plain(scores.reshape(1, -1), k)
    return s[0], i[0]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _lib():
    lib = load("topk")
    if not getattr(lib, "_tt_typed", False):
        p = ctypes.c_void_p
        i32 = ctypes.c_int
        lib.tt_topk_rows.restype = i32
        lib.tt_topk_rows.argtypes = [p, i32, ctypes.c_int64, i32, i32,
                                     p, p, p, p, p, i32, p]
        lib._tt_typed = True
    return lib


def _topk_rows_cuda(scores: torch.Tensor, k: int):
    if scores.dtype != torch.int32 or not scores.is_contiguous():
        raise ValueError("topk takes a contiguous int32 tensor")
    rows, n = scores.shape
    if n >= 2**31:
        raise ValueError("topk supports fewer than 2^31 scores a row")
    if rows > 65535:
        raise ValueError("topk_rows supports at most 65535 rows")
    if k < 1:
        raise ValueError("k must be >= 1")
    dev = scores.device
    k_eff = min(int(k), n)
    out_s = torch.empty((rows, k_eff), dtype=torch.int32, device=dev)
    out_i = torch.empty((rows, k_eff), dtype=torch.int32, device=dev)
    if k_eff == 0 or rows == 0:
        return out_s, out_i
    n_pad = _next_pow2(k_eff)
    hist = torch.empty((rows, 2048), dtype=torch.int32, device=dev)
    state = torch.empty((rows, 5), dtype=torch.int64, device=dev)
    winners = torch.empty((rows, n_pad), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        sm = torch.cuda.get_device_properties(dev).multi_processor_count
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_topk_rows(scores.data_ptr(), rows, n, k_eff, n_pad,
                              hist.data_ptr(), state.data_ptr(),
                              winners.data_ptr(), out_s.data_ptr(),
                              out_i.data_ptr(), sm, stream)
    check(lib, rc, "topk")
    return out_s, out_i
