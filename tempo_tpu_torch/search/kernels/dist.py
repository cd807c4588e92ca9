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
in the other sorted lists in one launch; ``shard_topk_plain`` sorts the
same unique 63-bit keys K2's plain version sorts.

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

import torch

from . import LaunchCount
from .build import check, load

LAUNCHES = LaunchCount()             # K9
MULTI_LAUNCHES = LaunchCount()       # B10 dist_multi_scan chains
COALESCED_LAUNCHES = LaunchCount()   # B10 dist_coalesced_scan chains
SINGLE_LAUNCHES = LaunchCount()      # B10 DistributedScanEngine chains
PROBE_LAUNCHES = LaunchCount()       # B10 dist_probe chains


def _check(scores: torch.Tensor, idx: torch.Tensor, local_flat: int,
           k: int) -> None:
    if scores.dim() != 3 or scores.shape != idx.shape:
        raise ValueError("shard_topk takes scores and indices [S, Q, k']")
    if scores.dtype != torch.int32 or idx.dtype != torch.int32:
        raise ValueError("shard_topk takes int32 scores and indices")
    if scores.device != idx.device:
        raise ValueError("shard_topk's inputs must share one device")
    if k < 1:
        raise ValueError("k must be >= 1")
    if scores.shape[0] * int(local_flat) >= 2**31:
        raise ValueError("global flat indices must stay below 2^31")


def shard_topk(scores: torch.Tensor, idx: torch.Tensor, local_flat: int,
               k: int):
    """(top scores [Q, kk], global flat indices [Q, kk]) of the gathered
    shard lists — the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors."""
    _check(scores, idx, local_flat, k)
    if scores.device.type == "cpu":
        return shard_topk_plain(scores, idx, local_flat, k)
    out = _shard_topk_cuda(scores.contiguous(), idx.contiguous(),
                           int(local_flat), int(k))
    if out[0].numel():
        LAUNCHES.bump()
    return out


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
    indices), then K9. `chain` counts the dispatch when it ran on the
    card. Returns (the local outputs, the sum [n], top scores [Q, kk],
    global flat indices [Q, kk])."""
    with ex.locked():
        outs = [step(s, r) for s, r in zip(shards, ranks)]
        red = ex.all_reduce([torch.cat([t.reshape(-1).to(torch.int64)
                                        for t in reduce_parts(o)])
                             for o in outs])
        cand = ex.all_gather([candidates(o) for o in outs])
        top_s, top_i = shard_topk(cand[:, 0], cand[:, 1], local_flat, k)
    if top_s.device.type == "cuda":
        chain.bump()
    return outs, red, top_s, top_i


def _lib():
    lib = load("dist")
    if not getattr(lib, "_tt_typed", False):
        p = ctypes.c_void_p
        i32 = ctypes.c_int
        lib.tt_shard_topk.restype = i32
        lib.tt_shard_topk.argtypes = [p, p, i32, i32, i32, ctypes.c_longlong,
                                      i32, p, p, p]
        lib._tt_typed = True
    return lib


def _shard_topk_cuda(scores: torch.Tensor, idx: torch.Tensor,
                     local_flat: int, k: int):
    S, Q, kp = scores.shape
    if S * kp >= 2**31:
        raise ValueError("shard_topk supports fewer than 2^31 candidates")
    kk = min(k, S * kp)
    dev = scores.device
    out_s = torch.empty((Q, kk), dtype=torch.int32, device=dev)
    out_i = torch.empty((Q, kk), dtype=torch.int32, device=dev)
    if Q == 0 or kk == 0:
        return out_s, out_i
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_shard_topk(scores.data_ptr(), idx.data_ptr(), S, Q, kp,
                               local_flat, kk, out_s.data_ptr(),
                               out_i.data_ptr(), stream)
    check(lib, rc, "shard_topk")
    return out_s, out_i
