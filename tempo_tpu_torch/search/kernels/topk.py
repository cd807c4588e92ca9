"""K2 ``topk``: the k most recent matches of a score column.

Counterpart of ``tempo_tpu/search/engine.py`` ``masked_topk`` (TPU kernel
B2). Takes int32 scores [N] (>= -1, as K1 writes them) and k; returns
(scores [min(k, N)], flat idx [min(k, N)]) in the order highest score
first, lowest index first among equal scores — lax.top_k's order. The
CUDA kernel is ``csrc/topk.cu`` (radix select + gather + bitonic sort);
the plain version sorts the same unique 63-bit keys, so the two agree
exactly, indices included.
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCount
from .build import check, load

LAUNCHES = LaunchCount()


def topk(scores: torch.Tensor, k: int):
    """(top scores, flat indices) — the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor."""
    if scores.device.type == "cpu":
        return topk_plain(scores, k)
    return _topk_cuda(scores, k)


def _keys(scores: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(scores.numel(), dtype=torch.int64,
                       device=scores.device)
    return ((0x7FFFFFFF - scores.to(torch.int64)) << 31) | idx


def topk_plain(scores: torch.Tensor, k: int):
    """The same function in plain PyTorch ops (a sort of the unique keys)."""
    k_eff = min(int(k), scores.numel())
    sel = torch.sort(_keys(scores)).values[:k_eff]
    return ((0x7FFFFFFF - (sel >> 31)).to(torch.int32),
            (sel & 0x7FFFFFFF).to(torch.int32))


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _lib():
    lib = load("topk")
    if not getattr(lib, "_tt_typed", False):
        p = ctypes.c_void_p
        lib.tt_topk.restype = ctypes.c_int
        lib.tt_topk.argtypes = [p, ctypes.c_int64, ctypes.c_int,
                                ctypes.c_int, p, p, p, p, p, ctypes.c_int, p]
        lib._tt_typed = True
    return lib


def _topk_cuda(scores: torch.Tensor, k: int):
    if scores.dtype != torch.int32 or scores.dim() != 1 \
            or not scores.is_contiguous():
        raise ValueError("topk takes a contiguous 1-D int32 tensor")
    n = scores.numel()
    if n >= 2**31:
        raise ValueError("topk supports fewer than 2^31 scores")
    if k < 1:
        raise ValueError("k must be >= 1")
    dev = scores.device
    k_eff = min(int(k), n)
    out_s = torch.empty(k_eff, dtype=torch.int32, device=dev)
    out_i = torch.empty(k_eff, dtype=torch.int32, device=dev)
    if k_eff == 0:
        return out_s, out_i
    n_pad = _next_pow2(k_eff)
    hist = torch.empty(2048, dtype=torch.int32, device=dev)
    state = torch.empty(5, dtype=torch.int64, device=dev)
    winners = torch.empty(n_pad, dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        sm = torch.cuda.get_device_properties(dev).multi_processor_count
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_topk(scores.data_ptr(), n, k_eff, n_pad,
                         hist.data_ptr(), state.data_ptr(),
                         winners.data_ptr(), out_s.data_ptr(),
                         out_i.data_ptr(), sm, stream)
    check(lib, rc, "topk")
    LAUNCHES.n += 1
    return out_s, out_i
