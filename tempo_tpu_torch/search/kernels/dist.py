"""K9 ``shard_topk``: the global top-k of the shards' gathered top-k lists,
and the launch counts of the B10 chains around it.

K9 replaces the post-gather tail of the reference's mesh kernels (TPU
kernel family B10): ``gidx = idx + shard * local_flat``, the
``all_gather``, ``jax.lax.top_k`` and ``all_idx[pos]``
(``tempo_tpu/search/multiblock.py:984-992`` and ``:1186-1200``,
``tempo_tpu/parallel/dist_search.py:225-235``). It takes the gathered
per-shard K2/K2r outputs, int32 scores and local flat indices
``[S, Q, k']``, and the entries each shard holds, ``local_flat``, and
returns per row the ``min(k, S*k')`` best as (scores ``[Q, kk]``, global
flat indices ``[Q, kk]``): highest score first, lowest global index first
among equal scores, K2's order. Shards own contiguous page ranges, so the
answer equals the single-device K2 answer exactly, indices included. The
CUDA kernel (``csrc/dist.cu``) ranks every candidate by binary searches
in the other sorted lists, over keys it builds once into shared memory, in
one launch; ``shard_topk_plain`` sorts the same unique 63-bit keys K2's
plain version sorts. ``shard_topk_gathered`` takes the gathered
``[S, 2, Q, k']`` tensor itself, as ``exchange_merge`` holds it, and the
kernel reads both halves in place.

``exchange_merge`` is the exchange-and-merge tail of the page-sharded
chains. The B10 chains count here too, one per dispatch that runs on the
card
(their K1/K1s/K4/K6/K3/K7/K2/K2r and K9 launches count in their own
counters as well): ``MULTI_LAUNCHES`` (``dist_multi_scan_kernel``),
``COALESCED_LAUNCHES`` (``dist_coalesced_scan_kernel``),
``SINGLE_LAUNCHES`` (``DistributedScanEngine._dist_kernel``) and
``PROBE_LAUNCHES`` (``dist_probe_kernel``).
"""

from __future__ import annotations

import ctypes
import struct
import threading

import torch

from . import LaunchCount
from .build import check, load, on_device

LAUNCHES = LaunchCount()             # K9
MULTI_LAUNCHES = LaunchCount()       # B10 dist_multi_scan chains
COALESCED_LAUNCHES = LaunchCount()   # B10 dist_coalesced_scan chains
SINGLE_LAUNCHES = LaunchCount()      # B10 DistributedScanEngine chains
PROBE_LAUNCHES = LaunchCount()       # B10 dist_probe chains

SMEM_KEYS_MAX = 200 * 1024   # csrc/dist.cu kSmemKeysMax: keys in shared memory


def _check_values(t: torch.Tensor, local_flat: int, k: int) -> None:
    if t.dtype != torch.int32:
        raise ValueError("shard_topk takes int32 scores and indices")
    if k < 1:
        raise ValueError("k must be >= 1")
    if t.shape[0] * int(local_flat) >= 2**31:
        raise ValueError("global flat indices must stay below 2^31")


def _check(scores: torch.Tensor, idx: torch.Tensor, local_flat: int,
           k: int) -> None:
    if scores.dim() != 3 or scores.shape != idx.shape:
        raise ValueError("shard_topk takes scores and indices [S, Q, k']")
    if idx.dtype != torch.int32:
        raise ValueError("shard_topk takes int32 scores and indices")
    if scores.device != idx.device:
        raise ValueError("shard_topk's inputs must share one device")
    _check_values(scores, local_flat, k)


def shard_topk(scores: torch.Tensor, idx: torch.Tensor, local_flat: int,
               k: int):
    """(top scores [Q, kk], global flat indices [Q, kk]) of the gathered
    shard lists — the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors. The kernel reads both tensors in place when they have
    the same strides and unit stride along k' (two contiguous tensors, or
    the two halves of one gathered ``[S, 2, Q, k']`` tensor); otherwise
    the wrapper first makes one contiguous copy of each."""
    _check(scores, idx, local_flat, k)
    if scores.device.type == "cpu":
        return shard_topk_plain(scores, idx, local_flat, k)
    if scores.stride() != idx.stride() or (scores.shape[2] > 1
                                           and scores.stride(2) != 1):
        scores, idx = scores.contiguous(), idx.contiguous()
    S, Q, kp = scores.shape
    ss, sq, _ = scores.stride()
    return _shard_topk_cuda(scores, scores.data_ptr(), idx.data_ptr(), S, Q,
                            kp, ss, sq, int(local_flat), int(k))


def shard_topk_gathered(cand: torch.Tensor, local_flat: int, k: int):
    """K9 over the gathered candidates ``[S, 2, Q, k']`` (axis 1: scores,
    then local flat indices), as the all_gather returns them: the same
    function as ``shard_topk(cand[:, 0], cand[:, 1], ...)``; on the card
    the kernel reads both halves in place, with no copy and no view made.
    Refuses a tensor whose k' axis is not of unit stride."""
    if cand.dim() != 4 or cand.shape[1] != 2:
        raise ValueError("shard_topk_gathered takes candidates "
                         "[S, 2, Q, k']")
    S, _, Q, kp = cand.shape
    ss, sc, sq, sj = cand.stride()
    if kp > 1 and sj != 1:
        raise ValueError("shard_topk_gathered needs unit stride along k'")
    _check_values(cand, local_flat, k)
    if cand.device.type == "cpu":
        return shard_topk_plain(cand[:, 0], cand[:, 1], local_flat, k)
    ptr = cand.data_ptr()
    return _shard_topk_cuda(cand, ptr, ptr + 4 * sc, S, Q, kp, ss, sq,
                            int(local_flat), int(k))


def shard_topk_plain(scores: torch.Tensor, idx: torch.Tensor,
                     local_flat: int, k: int):
    """K9's function in plain PyTorch ops: a stable sort of every row's
    unique keys over global indices."""
    S, Q, kp = scores.shape
    kk = min(int(k), S * kp)
    shift = torch.arange(S, dtype=torch.int64,
                         device=idx.device)[:, None, None] * int(local_flat)
    g = idx.to(torch.int64) + shift
    keys = ((0x7FFFFFFF - scores.to(torch.int64)) << 31) | g
    keys = keys.permute(1, 0, 2).reshape(Q, S * kp)
    sel = torch.sort(keys, dim=1).values[:, :kk]
    return ((0x7FFFFFFF - (sel >> 31)).to(torch.int32),
            (sel & 0x7FFFFFFF).to(torch.int32))


def exchange_merge(ex, shards, ranks, step, reduce_parts, candidates,
                   local_flat: int, k: int, chain: LaunchCount) -> tuple:
    """The tail every page-sharded B10 chain shares, issued in one order
    on every rank under the exchange's dispatch lock: `step(shard, rank)`
    over each local shard, one all_reduce of the int64 concatenation of
    `reduce_parts(out)` (tensors, flattened), one all_gather of
    `candidates(out)` (int32 [2, Q, k']: scores, then local flat
    indices), then K9 over the gathered tensor as it lies. `chain`
    counts the dispatch when it ran on the card. Returns (the local
    outputs, the sum [n], top scores [Q, kk], global flat indices
    [Q, kk])."""
    with ex.locked():
        outs = [step(s, r) for s, r in zip(shards, ranks)]
        red = ex.all_reduce([torch.cat([t.reshape(-1).to(torch.int64)
                                        for t in reduce_parts(o)])
                             for o in outs])
        cand = ex.all_gather([candidates(o) for o in outs])
        top_s, top_i = shard_topk_gathered(cand, local_flat, k)
    if top_s.device.type == "cuda":
        chain.bump()
    return outs, red, top_s, top_i


_LIB = None
_FN = None
# tt_shard_topk_packed's twelve int64 arguments, one buffer a thread
_PACK = struct.Struct("12q")


class _ArgBuf(threading.local):
    def __init__(self):
        self.buf = (ctypes.c_longlong * 12)()


_ARGS = _ArgBuf()


def _fn():
    global _LIB, _FN
    if _FN is None:
        lib = load("dist")
        fn = lib.tt_shard_topk_packed
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        _LIB, _FN = lib, fn
    return _FN


def _shard_topk_cuda(like: torch.Tensor, scores_ptr: int, idx_ptr: int,
                     S: int, Q: int, kp: int, ss: int, sq: int,
                     local_flat: int, k: int):
    """Launch K9 over the int32 lists at `scores_ptr` and `idx_ptr`
    (element (s, q, j) at s * ss + q * sq + j, in `like`'s storage) and
    count the launch: one output allocation, no view of the inputs, a
    device context only when `like`'s device is not the current one."""
    n = S * kp
    if n >= 2**31:
        raise ValueError("shard_topk supports fewer than 2^31 candidates")
    kk = min(k, n)
    out = like.new_empty((2, Q, kk))
    if Q and kk:
        keys = (like.new_empty((Q, n), dtype=torch.int64)
                if S > 1 and n * 8 > SMEM_KEYS_MAX else None)
        op = out.data_ptr()
        args = _ARGS.buf
        _PACK.pack_into(args, 0, scores_ptr, idx_ptr, S, Q, kp, ss, sq,
                        local_flat, kk, op, op + 4 * Q * kk,
                        0 if keys is None else keys.data_ptr())
        rc = on_device(like.device, _fn(), args)
        if rc:
            check(_LIB, rc, "shard_topk")
        LAUNCHES.bump()
    return out.unbind(0)
