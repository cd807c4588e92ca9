"""K2 ``topk`` and K2r ``topk_rows``: the k most recent matches of a score
column, or of each row of Q score columns.

K2 is the counterpart of ``tempo_tpu/search/engine.py`` ``masked_topk``
(TPU kernel B2); K2r is the same function over a query axis, as the
reference's ``coalesced_scan_kernel`` (B6) lifts it with ``jax.vmap``.
Both take contiguous int32 scores (>= -1, as K1 and K4 write them) and
k >= 1; K2 returns (scores [min(k, N)], flat idx [min(k, N)]) for a
column [N], K2r (scores [Q, min(k, N)], idx [Q, min(k, N)]) for rows
[Q, N], the index counted within the row. The order is highest score
first, lowest index first among equal scores — lax.top_k's order. One
CUDA launcher (``csrc/topk.cu``) serves both, K2 being the case Q = 1:
for k_eff <= ``COOP_MAX_K`` one cooperative launch (radix passes with
grid barriers, a gather and a rank of the gathered keys), past it a chain
of radix-select kernels and global bitonic stages. The plain version sorts
the same unique 63-bit keys, so the two agree exactly, indices included.
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCount
from .build import check, load, on_device

LAUNCHES = LaunchCount()        # K2: one score column
ROW_LAUNCHES = LaunchCount()    # K2r: Q rows in one launch

COOP_MAX_K = 4096               # csrc/topk.cu kCoopMaxK: one launch up to here
_BINS = 2048


def topk(scores: torch.Tensor, k: int):
    """(top scores, flat indices) of a column [N] — the plain version for
    a CPU tensor, the CUDA kernel for a CUDA tensor."""
    _check(scores, k, 1)
    if scores.device.type == "cpu":
        return topk_plain(scores, k)
    s, i = _topk_rows_cuda(scores.view(1, -1), int(k))
    if s.numel():
        LAUNCHES.bump()
    return s[0], i[0]


def topk_rows(scores: torch.Tensor, k: int):
    """(top scores [Q, k'], indices [Q, k']) of each row of [Q, N] — the
    plain version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    _check(scores, k, 2)
    if scores.device.type == "cpu":
        return topk_rows_plain(scores, k)
    s, i = _topk_rows_cuda(scores, int(k))
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


def _check(scores: torch.Tensor, k: int, dim: int) -> None:
    """What both routes refuse: another rank, dtype or layout, k < 1, rows
    of 2^31 scores or more, more than 65,535 rows."""
    if scores.dim() != dim:
        raise ValueError(f"{'topk' if dim == 1 else 'topk_rows'} takes a "
                         f"{dim}-D tensor")
    if scores.dtype != torch.int32 or not scores.is_contiguous():
        raise ValueError("topk takes a contiguous int32 tensor")
    if int(k) < 1:
        raise ValueError("k must be >= 1")
    if scores.shape[-1] >= 2**31:
        raise ValueError("topk supports fewer than 2^31 scores a row")
    if dim == 2 and scores.shape[0] > 65535:
        raise ValueError("topk_rows supports at most 65535 rows")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# csrc/topk.cu's scratch layout: per row of one cooperative launch, the
# keys to rank (8,192) and the copied-out candidates (32,768), three
# 2,048-bin histograms, two fill counters and four pass-0 scores; 16 step
# counts a launch
_COOP_ROW_BYTES = (8192 + 32768) * 8 + 3 * _BINS * 4 + 8 + 16
_ROWS_PER_LAUNCH: dict = {}     # device index -> rows one launch takes


def scratch_bytes(rows: int, k_eff: int, rows_per_launch: int) -> int:
    """Device scratch of one call (csrc/topk.cu ``tt_topk_scratch_bytes``):
    for the cooperative route, one launch's rows (launches share it);
    past COOP_MAX_K the chain's winners, state and histogram per row."""
    if k_eff <= COOP_MAX_K:
        return min(rows, rows_per_launch) * _COOP_ROW_BYTES + 16 * 4
    return rows * (_next_pow2(k_eff) * 8 + 5 * 8 + _BINS * 4)


def _rows_per_launch(dev: torch.device) -> int:
    per = _ROWS_PER_LAUNCH.get(dev.index)
    if per is None:
        _fn()
        with torch.cuda.device(dev):
            per = _LIB.tt_topk_rows_per_launch()
        if per <= 0:
            check(_LIB, -per, "topk")
        _ROWS_PER_LAUNCH[dev.index] = per
    return per


_LIB = None
_FN = None


def _fn():
    global _LIB, _FN
    if _FN is None:
        lib = load("topk")
        p = ctypes.c_void_p
        i32 = ctypes.c_int
        i64 = ctypes.c_longlong
        fn = lib.tt_topk_rows
        fn.restype = i32
        fn.argtypes = [p, i32, i64, i32, p, i64, p, p, p]
        lib.tt_topk_rows_per_launch.restype = i32
        lib.tt_topk_rows_per_launch.argtypes = []
        _LIB, _FN = lib, fn
    return _FN


def _topk_rows_cuda(scores: torch.Tensor, k: int):
    rows, n = scores.shape
    dev = scores.device
    k_eff = min(k, n)
    out_s, out_i = torch.empty((2, rows, k_eff), dtype=torch.int32,
                               device=dev).unbind(0)
    if k_eff == 0 or rows == 0:
        return out_s, out_i
    nbytes = scratch_bytes(rows, k_eff, _rows_per_launch(dev))
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    rc = on_device(dev, _fn(), scores.data_ptr(), rows, n, k_eff,
                   scratch.data_ptr(), nbytes, out_s.data_ptr(),
                   out_i.data_ptr())
    if rc:
        check(_LIB, rc, "topk")
    return out_s, out_i
