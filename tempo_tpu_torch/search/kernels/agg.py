"""K7 ``agg_counts`` / ``agg_counts_rows`` and K8 ``analytics_count``:
dense integer histograms (TPU kernel B7).

K7 is the counterpart of ``tempo_tpu/search/multiblock.py``
``agg_entry_counts``, which the reference fuses into
``multi_scan_kernel`` and, through ``jax.vmap``, into
``coalesced_scan_kernel``. Here it is a launch of its own after K1 (or
K4), over the score column the scan writes: ``scores >= 0`` is exactly
the final mask there, verdicts and packed layouts included. For score
rows int32 [Q, N] and the batch's staged composite keys entry_agg int32
[N] it returns int32 [Q, n_keys]:

    hist[q, k] = #{i : scores[q, i] >= 0 and entry_agg[i] == k}

``agg_counts`` is the one-row case ([N] -> [n_keys]). K8 is the
counterpart of ``tempo_tpu/search/analytics.py``
``analytics_count_kernel``, the ingest side's (series, latency bucket)
count: for series ids int32 [n], durations int64 [n] (nanoseconds) and
ascending int64 thresholds [nb] it returns int32 [n_keys * (nb + 1)]:

    b = #{t : dur >= thresholds[t]},  key = min(sidx * (nb + 1) + b,
    n_keys * (nb + 1)),  counted where key < n_keys * (nb + 1)

The reference limbs durations into two int31 halves; K8 takes whole
int64 nanoseconds, so it is exact for every duration. In both a key
outside [0, K) is counted nowhere, as the reference's sort +
searchsorted + diff counts it nowhere. The CUDA kernels are
``csrc/agg.cu`` (a shared-memory histogram per CTA up to
``shared_bins()`` bins, global atomics past it); the plain versions below
are the reference's own formulation (sort, searchsorted, diff), the CPU
path and what the kernels are held against on the card. Launch counts:
``LAUNCHES`` (K7, one row), ``ROW_LAUNCHES`` (K7, a query axis) and
``COUNT_LAUNCHES`` (K8).
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCount
from .build import check, load

LAUNCHES = LaunchCount()        # K7 over one score column
ROW_LAUNCHES = LaunchCount()    # K7 over Q score rows in one launch
COUNT_LAUNCHES = LaunchCount()  # K8


def agg_counts(scores, entry_agg, n_keys: int):
    """[n_keys] counts of one score column [N] — the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    if scores.dim() != 1:
        raise ValueError("agg_counts takes a score column [N]")
    if scores.device.type == "cpu":
        return agg_counts_rows_plain(scores.view(1, -1), entry_agg,
                                     n_keys)[0]
    out = _agg_cuda(scores.view(1, -1), entry_agg, n_keys)
    LAUNCHES.bump()
    return out[0]


def agg_counts_rows(scores, entry_agg, n_keys: int):
    """[Q, n_keys] counts of score rows [Q, N] — the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if scores.dim() != 2:
        raise ValueError("agg_counts_rows takes score rows [Q, N]")
    if scores.device.type == "cpu":
        return agg_counts_rows_plain(scores, entry_agg, n_keys)
    out = _agg_cuda(scores, entry_agg, n_keys)
    ROW_LAUNCHES.bump()
    return out


def agg_counts_rows_plain(scores, entry_agg, n_keys: int):
    """K7's function as the reference computes it: rejected entries take
    the sentinel n_keys, each row sorts, and searchsorted over the key
    space diffs into counts."""
    Q = scores.shape[0]
    key = torch.where(scores >= 0, entry_agg.reshape(1, -1),
                      torch.tensor(n_keys, dtype=torch.int32,
                                   device=scores.device))
    skey = torch.sort(key, dim=1).values
    edges = torch.searchsorted(
        skey, torch.arange(n_keys + 1, dtype=torch.int32,
                           device=scores.device).expand(Q, -1).contiguous())
    return (edges[:, 1:] - edges[:, :-1]).to(torch.int32)


def analytics_count(sidx, dur, thresholds, n_keys: int):
    """[n_keys * (nb + 1)] counts — the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors."""
    if sidx.device.type == "cpu":
        return analytics_count_plain(sidx, dur, thresholds, n_keys)
    out = _count_cuda(sidx, dur, thresholds, n_keys)
    COUNT_LAUNCHES.bump()
    return out


def analytics_count_plain(sidx, dur, thresholds, n_keys: int):
    """K8's function as the reference computes it, on whole int64
    nanoseconds: bin by the thresholds, clamp the composite key to the
    sentinel, sort, searchsorted, diff."""
    nb1 = int(thresholds.numel()) + 1
    K = n_keys * nb1
    b = torch.zeros(dur.shape, dtype=torch.int64, device=dur.device)
    for t in thresholds.tolist():
        b += dur >= t
    key = torch.clamp(sidx.to(torch.int64) * nb1 + b, max=K)
    edges = torch.searchsorted(
        torch.sort(key).values,
        torch.arange(K + 1, dtype=torch.int64, device=dur.device))
    return (edges[1:] - edges[:-1]).to(torch.int32)


def _lib():
    lib = load("agg")
    if not getattr(lib, "_tt_typed", False):
        p = ctypes.c_void_p
        i32, i64 = ctypes.c_int, ctypes.c_int64
        lib.tt_agg_counts.restype = i32
        lib.tt_agg_counts.argtypes = [p, p, i32, i64, i32, p, i32, p]
        lib.tt_analytics_count.restype = i32
        lib.tt_analytics_count.argtypes = [p, p, i64, p, i32, i32, p, i32,
                                           p]
        lib.tt_agg_shared_bins.restype = i32
        lib.tt_agg_shared_bins.argtypes = []
        lib._tt_typed = True
    return lib


def shared_bins() -> int:
    """The bin count up to which the kernels count in shared memory (in
    global memory past it); builds the kernels."""
    return int(_lib().tt_agg_shared_bins())


def _need(t, dtype, what: str, dev) -> None:
    if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"{what} must be a contiguous {dtype} tensor on "
                         f"{dev}, got {t.dtype} on {t.device}")


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _agg_cuda(scores, entry_agg, n_keys: int):
    dev = scores.device
    _need(scores, torch.int32, "scores", dev)
    _need(entry_agg, torch.int32, "entry_agg", dev)
    Q, n = scores.shape
    if entry_agg.numel() != n:
        raise ValueError(f"entry_agg has {entry_agg.numel()} keys for "
                         f"{n} scores")
    if not 0 < n_keys < 2**31 or Q > 65535:
        raise ValueError(f"agg_counts: n_keys {n_keys}, {Q} rows")
    out = torch.empty((Q, n_keys), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_agg_counts(scores.data_ptr(), entry_agg.data_ptr(), Q, n,
                               n_keys, out.data_ptr(), _sm_count(dev),
                               stream)
    check(lib, rc, "agg_counts")
    return out


def _count_cuda(sidx, dur, thresholds, n_keys: int):
    dev = sidx.device
    _need(sidx, torch.int32, "sidx", dev)
    _need(dur, torch.int64, "dur", dev)
    _need(thresholds, torch.int64, "thresholds", dev)
    n = sidx.numel()
    nb = thresholds.numel()
    if dur.numel() != n or nb > 64:
        raise ValueError(f"analytics_count: {n} series ids, {dur.numel()} "
                         f"durations, {nb} thresholds (at most 64)")
    K = n_keys * (nb + 1)
    if not 0 < K < 2**31:
        raise ValueError(f"analytics_count: {K} bins")
    out = torch.empty(K, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_analytics_count(sidx.data_ptr(), dur.data_ptr(), n,
                                    thresholds.data_ptr(), nb, K,
                                    out.data_ptr(), _sm_count(dev), stream)
    check(lib, rc, "analytics_count")
    return out
