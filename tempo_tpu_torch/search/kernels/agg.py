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
``csrc/agg.cu``: K7 is one cooperative launch a call (per-CTA shared
histograms written as partials and summed by column after a grid
barrier, up to ``SHARED_BINS`` bins; global atomics past it), whose rule
``agg_counts_tiled`` renders in PyTorch; K8 is one cooperative launch a
call too, with per-CTA shared histograms summed the same way up to
``CTA_BINS`` bins and global atomics past it (``count_route``), whose
rule ``analytics_count_tiled`` renders. K8 takes its
thresholds on the host: they ride in the launch's parameters. The plain
versions below are the reference's own formulation (sort, searchsorted,
diff), the CPU path and what the kernels are held against on the card.
Launch counts: ``LAUNCHES`` (K7, one row), ``ROW_LAUNCHES`` (K7, a query
axis) and ``COUNT_LAUNCHES`` (K8).
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCount
from .build import check, load, on_device

LAUNCHES = LaunchCount()        # K7 over one score column
ROW_LAUNCHES = LaunchCount()    # K7 over Q score rows in one launch
COUNT_LAUNCHES = LaunchCount()  # K8

THREADS = 1024              # csrc/agg.cu kAggThreads: a K7 or K8 CTA's
TILE = 128                  # kTile: K rounds up to it (the partials' pitch)
SHARED_BINS = 56_320        # kSharedBins: K7's shared route, a K8 CTA's bins
CTA_BINS = 36_864           # kCtaBins: K8's CTA route, at most


def agg_counts(scores, entry_agg, n_keys: int):
    """[n_keys] counts of one score column [N] — the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    if scores.dim() != 1:
        raise ValueError("agg_counts takes a score column [N]")
    if scores.is_cpu:
        return agg_counts_rows_plain(scores.view(1, -1), entry_agg,
                                     n_keys)[0]
    out = _agg_cuda(scores, 1, entry_agg, n_keys)
    LAUNCHES.bump()
    return out[:n_keys]


def agg_counts_rows(scores, entry_agg, n_keys: int):
    """[Q, n_keys] counts of score rows [Q, N] — the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if scores.dim() != 2:
        raise ValueError("agg_counts_rows takes score rows [Q, N]")
    if scores.is_cpu:
        return agg_counts_rows_plain(scores, entry_agg, n_keys)
    Q = scores.shape[0]
    out = _agg_cuda(scores, Q, entry_agg, n_keys)
    ROW_LAUNCHES.bump()
    return out.as_strided((Q, n_keys), (n_keys, 1))


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


def agg_counts_tiled(scores, entry_agg, n_keys: int, grid: int):
    """K7's rule as its kernel runs it, in PyTorch (no card path uses
    it): `grid` CTAs split the Q rows into S = max(1, grid // Q) units a
    row; unit s of row q counts the row's 16-byte vectors
    [nv * s // S, nv * (s + 1) // S) from the row's first 16-byte-aligned
    score (by the tensors' addresses), and the entries before it and
    after the last whole vector one by one, entry j of those going to
    unit (j // THREADS) % S; a row whose address differs from the keys'
    modulo 16 is counted one by one whole. Each unit's histogram is a
    row of partials [Q * S, Kp] (K rounded up to ``TILE``; here its
    non-zero entries); the counts are their sum by column."""
    Q, n = scores.shape
    S = max(1, grid // Q)
    kp = pitch(n_keys)
    dev = scores.device
    kept = (entry_agg >= 0) & (entry_agg < n_keys)
    key_ptr = entry_agg.data_ptr()
    e = torch.arange(n, dtype=torch.int64, device=dev)
    out = torch.zeros(Q, kp + 1, dtype=torch.int64, device=dev)
    for q in range(Q):
        row = scores[q]
        ptr = row.data_ptr()
        head = (-(ptr // 4)) % 4
        if (ptr - key_ptr) % 16 or head > n:
            head = n
        nv = (n - head) // 4
        tail = head + 4 * nv
        bounds = torch.tensor([nv * s // S for s in range(S + 1)],
                              dtype=torch.int64, device=dev)
        vec = (e >= head) & (e < tail)
        unit_vec = torch.searchsorted(bounds, (e - head) // 4,
                                      right=True) - 1
        one = torch.where(e < head, e, e - tail + head)
        unit = torch.where(vec, unit_vec, (one // THREADS) % S)
        key = torch.where((row >= 0) & kept, entry_agg.to(torch.int64), kp)
        # the units' partial histograms (unit, bin) -> count, then by column
        cell, count = torch.unique(unit * (kp + 1) + key, return_counts=True)
        out[q].index_add_(0, cell % (kp + 1), count)
    return out[:, :n_keys].to(torch.int32)


def analytics_count(sidx, dur, thresholds, n_keys: int):
    """[n_keys * (nb + 1)] counts — the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (`thresholds` then on the host)."""
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


def analytics_count_tiled(sidx, dur, thresholds, n_keys: int, grid: int):
    """K8's rule as its kernel runs it, in PyTorch (no card path uses it),
    for `grid` CTAs. On the CTA route (``count_route``) CTA g counts the
    vectors [nv * g // G, nv * (g + 1) // G) of 4 entries from the first
    element where the series ids and the durations are both 16-byte
    aligned (by the tensors' addresses), and the entries before it and
    after the last whole vector one by one, entry j of those going to CTA
    (j // THREADS) % G; columns that are never aligned together are
    counted one by one whole. An entry whose key lies in [0, K) is counted
    in its CTA's histogram, one row of partials [G, K] (here its non-zero
    entries), and the counts are their sum by column. On the global route
    every entry adds into the output."""
    n = sidx.numel()
    nb1 = int(thresholds.numel()) + 1
    K = n_keys * nb1
    dev = sidx.device
    b = torch.zeros(n, dtype=torch.int64, device=dev)
    for t in thresholds.tolist():
        b += dur >= t
    key = sidx.to(torch.int64) * nb1 + b
    kept = (key >= 0) & (key < K)
    if count_route(K) == "global":
        return torch.bincount(key[kept], minlength=K)[:K].to(torch.int32)
    G = grid
    ps, pd = sidx.data_ptr(), dur.data_ptr()
    head = (-(ps // 4)) % 4
    if (pd + 8 * head) % 16 or head > n:
        head = n
    nv = (n - head) // 4
    tail = head + 4 * nv
    e = torch.arange(n, dtype=torch.int64, device=dev)
    bounds = torch.tensor([nv * g // G for g in range(G + 1)],
                          dtype=torch.int64, device=dev)
    vec = (e >= head) & (e < tail)
    cta_vec = torch.searchsorted(bounds, (e - head) // 4, right=True) - 1
    one = torch.where(e < head, e, e - tail + head)
    cta = torch.where(vec, cta_vec, (one // THREADS) % G)[kept]
    key = key[kept]
    if bool((cta < 0).any()) or bool((cta >= G).any()):
        raise AssertionError("an entry outside the grid's CTAs")
    kp = pitch(K)
    # the CTAs' partial rows (CTA, bin) -> count, then by column
    cell, count = torch.unique(cta * kp + key, return_counts=True)
    out = torch.zeros(kp, dtype=torch.int64, device=dev)
    out.index_add_(0, cell % kp, count)
    return out[:K].to(torch.int32)


_LIB = None     # the typed library, once checked against this module


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = load("agg")
    p = ctypes.c_void_p
    i32, i64 = ctypes.c_int, ctypes.c_int64
    lib.tt_agg_counts.restype = i32
    lib.tt_agg_counts.argtypes = [p, p, i32, i64, i32, p, i64, p]
    lib.tt_analytics_count.restype = i32
    lib.tt_analytics_count.argtypes = [p, p, i64, p, i32, i32, p, i64, p]
    lib.tt_agg_shared_bins.restype = i32
    lib.tt_agg_shared_bins.argtypes = []
    lib.tt_agg_out_ints.restype = i64
    lib.tt_agg_out_ints.argtypes = [i32, i32, i32]
    lib.tt_count_cta_bins.restype = i32
    lib.tt_count_cta_bins.argtypes = []
    lib.tt_count_out_ints.restype = i64
    lib.tt_count_out_ints.argtypes = [i32, i32]
    if (lib.tt_agg_shared_bins() != SHARED_BINS
            or lib.tt_agg_out_ints(3, 100, 5) != _out_ints(3, 100, 5)
            or lib.tt_count_cta_bins() != CTA_BINS
            or any(lib.tt_count_out_ints(K, 132) != count_out_ints(K, 132)
                   for K in (15, 960, CTA_BINS, CTA_BINS + 1, 61_440))):
        raise RuntimeError("csrc/agg.cu and kernels/agg.py disagree on "
                           "K7's or K8's constants")
    _LIB = lib
    return lib


def pitch(K: int) -> int:
    """Kp, K7's bins a partial row: K rounded up to ``TILE``."""
    return -(-K // TILE) * TILE


def route(K: int) -> str:
    """K7's route for K bins: "shared" (per-CTA histograms in shared
    memory, summed as partials) up to ``SHARED_BINS`` bins a row, else
    "global" (atomics into the output)."""
    return "shared" if pitch(K) <= SHARED_BINS else "global"


def count_route(K: int) -> str:
    """K8's route for K bins: "cta" (each CTA's histogram in its shared
    memory) while K rounded up to ``TILE`` is at most ``CTA_BINS``, else
    "global" (atomics into the output)."""
    return "cta" if pitch(K) <= CTA_BINS else "global"


def count_out_ints(K: int, sms: int) -> int:
    """csrc/agg.cu count_out_ints: the counts [K], then on the CTA route
    (from a 16-byte boundary) the partial rows of at most `sms` CTAs."""
    if count_route(K) == "global":
        return K
    return -(-K // 4) * 4 + sms * pitch(K)


def _out_ints(Q: int, K: int, sms: int) -> int:
    """csrc/agg.cu agg_out_ints: the counts [Q, K], then on the shared
    route (from a 16-byte boundary) the partials of at most max(Q, sms)
    units of Kp bins each."""
    if route(K) == "global":
        return Q * K
    return -(-Q * K // 4) * 4 + max(Q, sms) * pitch(K)


_SMS: dict = {}     # device index -> SM count


def _sms(dev) -> int:
    n = _SMS.get(dev.index)
    if n is None:
        n = _SMS[dev.index] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def _need(t, dtype, what: str, dev) -> None:
    if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"{what} must be a contiguous {dtype} tensor on "
                         f"{dev}, got {t.dtype} on {t.device}")


def _agg_cuda(scores, Q: int, entry_agg, n_keys: int):
    """One K7 launch over score rows [Q, N] (or a column, Q = 1): the
    counts [Q * n_keys] first in one int32 allocation, the kernel's
    partials after them; nothing else on the stream. Returns the
    allocation."""
    n = scores.shape[-1]
    if (scores.dtype != torch.int32 or entry_agg.dtype != torch.int32
            or entry_agg.get_device() != scores.get_device()
            or not scores.is_contiguous() or not entry_agg.is_contiguous()):
        _need(scores, torch.int32, "scores", scores.device)
        _need(entry_agg, torch.int32, "entry_agg", scores.device)
    if entry_agg.numel() != n:
        raise ValueError(f"entry_agg has {entry_agg.numel()} keys for "
                         f"{n} scores")
    if not 0 < n_keys < 2**31 - TILE or Q >= 2**31:
        raise ValueError(f"agg_counts: n_keys {n_keys}, {Q} rows")
    dev = scores.device
    ints = _out_ints(Q, n_keys, _sms(dev))
    out = torch.empty(ints, dtype=torch.int32, device=dev)
    lib = _LIB or _lib()
    rc = on_device(dev, lib.tt_agg_counts, scores.data_ptr(),
                   entry_agg.data_ptr(), Q, n, n_keys, out.data_ptr(), ints)
    if rc:
        check(lib, rc, "agg_counts")
    return out


def _count_cuda(sidx, dur, thresholds, n_keys: int):
    """One K8 launch: the counts [K] first in one int32 allocation, the
    kernel's partials after them; nothing else on the stream. Returns the
    counts. `thresholds` lie on the host (the launch's parameters carry
    them)."""
    dev = sidx.device
    if (sidx.dtype != torch.int32 or dur.dtype != torch.int64
            or dur.device != dev or not sidx.is_contiguous()
            or not dur.is_contiguous()):
        _need(sidx, torch.int32, "sidx", dev)
        _need(dur, torch.int64, "dur", dev)
    if thresholds.device.type != "cpu":
        raise ValueError("analytics_count: the thresholds of a CUDA count "
                         "must lie on the host (K8 takes them in its "
                         "launch's parameters)")
    _need(thresholds, torch.int64, "thresholds", thresholds.device)
    n = sidx.numel()
    nb = thresholds.numel()
    if dur.numel() != n or nb > 64:
        raise ValueError(f"analytics_count: {n} series ids, {dur.numel()} "
                         f"durations, {nb} thresholds (at most 64)")
    K = n_keys * (nb + 1)
    if not 0 < K < 2**31 - 2 * TILE:
        raise ValueError(f"analytics_count: {K} bins")
    ints = count_out_ints(K, _sms(dev))
    out = torch.empty(ints, dtype=torch.int32, device=dev)
    lib = _LIB or _lib()
    rc = on_device(dev, lib.tt_analytics_count, sidx.data_ptr(),
                   dur.data_ptr(), n, thresholds.data_ptr(), nb, K,
                   out.data_ptr(), ints)
    if rc:
        check(lib, rc, "analytics_count")
    return out[:K]
