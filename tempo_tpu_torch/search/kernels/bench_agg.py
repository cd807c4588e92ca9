"""Time the histogram kernels K7 (``agg_counts``, ``agg_counts_rows``) and
K8 (``analytics_count``) of one checkout of the port on one CUDA card, at
the shapes of their rows in PERF.md's kernel table, against their plain
versions; and the seeded edge cases (``K7_CASES``, ``K8_CASES``) that the
CPU tests and ``chip_smoke.k7_edges`` / ``k8_edges`` hold them to.

  python3 tempo_tpu_torch/search/kernels/bench_agg.py --root DIR \\
      --label NAME [--out FILE] [--case NAME ...] [--repeat R] \\
      [--breakdown]

imports ``tempo_tpu_torch`` and ``chip_smoke`` (the RED cell's corpus and
ingest batches) from DIR (this checkout, or an unpacked older commit),
stages the RED corpus's first 4,096-page group (64 blocks x 65,536
traces, ``chip_smoke.make_block`` with the RED cell's seed) through
``MultiBlockEngine.stage_host`` / ``place_batch`` and its composite keys
through ``analytics.stage_for_batch`` (for K7's cases only), scores
requests with the public ``scan.multi_scan`` / ``scan.coalesced_scan``,
calls only the public wrappers of ``kernels.agg``, and prints one JSON
object (also appended to FILE): per case, the card ms (CUDA events
around 50 calls back to back) and the host time spent launching the
same 50 calls (``host_us`` a call: where it is near the card ms, the
host sets the pace), the device ms (``bench_structural.event_ms``: the
median of 20 single synchronised calls between CUDA events), the bound
(bytes over 3.35 TB/s), the plain version's ms, the library call's ms,
and whether the kernel equals the plain version exactly; then ptxas's
registers and spills of every ``agg.cu`` build. ``--case`` (repeatable)
runs only the named cases, in the order below; ``--repeat R`` runs them
R times in turn, each pass's results under ``runs``. ``--breakdown``
(this checkout's ``csrc/agg.cu`` only) also builds ``csrc/agg.cu``
variants (``BREAKDOWN``: no grid barrier, no count, an empty launch, no
adds, no threshold walk, no warp vote, the global route, K7's tile
column sums for any number of rows, the CTA route up to the most bins
a CTA holds, and the dropped design of one
histogram a thread-block cluster of C = 2, 4 or 8 CTAs in distributed
shared memory, with C = 2 also adding locally) into
``csrc/build/variants/`` and times each, and the kernel itself, on the
1,048,576-row batch with its series ids as they are and spread to K =
15,360 up to 245,760. To compare two commits, run both in one command on
one card, in turns (old, new, new, old).

Cases:
  - K7 [1, N] red_all: K1's scores of ``?agg=red`` over the group (N =
    4,194,304, every entry accepted), K = 3,840;
  - K7 [1, N] red_svc: ``service.name=svc-007`` with the aggregate (1.6%
    accepted);
  - K7 K = 30,720: red_all's scores, keys spread to 1,024 services (the
    previous kernel's global route; the shared route now);
  - K7 K = 61,440: keys spread to 2,048 services (past the shared route);
  - K7 one hot bin: red_all's scores, every key equal;
  - K7r [8, N]: K4's rows of 8 ``svc-00i`` requests, K = 3,840;
  - K8 K = 960 (8,192 rows x 64 series) and K = 61,440 (1,048,576 x
    4,096): ``chip_smoke.red_ingest_batches``, the ingest count's two
    micro-batches;
  - K8 over the 1,048,576 rows with the series ids spread over 2,048
    (K = 30,720), 2,457 and 2,458 (either side of the CTA route's limit,
    K = 36,855 and 36,870), and one hot bin (every row series 7, 5 ms);
  - K8 dense_counts call: ``analytics.dense_counts`` on the 1,048,576
    rows, its host ms and its phases between CUDA events (two copies in,
    K8, the copy back).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
E = 1024
SEED = 20261017                # chip_smoke.py's default --seed
RED_BLOCKS, RED_TRACES = 64, 65_536
K_RED = 3840                   # the RED corpus's key space (128 services)

# K7's edge cases: name -> rows Q, entries n, bins K, the share of
# entries accepted, the keys ("uniform" over [0, K), "wide": over
# [-50, K + 50), "hot": all one key), and the element offsets of the
# score rows' and the keys' first element in their buffers
_BASE = dict(Q=1, n=4096 * 3 + 1, K=K_RED, accept=0.9, keys="uniform",
             s_off=0, k_off=0)
K7_CASES = {
    "N=0": dict(_BASE, n=0),
    "N=1": dict(_BASE, n=1),
    "N=3": dict(_BASE, n=3),
    "N=2,053": dict(_BASE, n=2053),
    "N=4,095": dict(_BASE, n=4095),
    "N=4,096x3+1": dict(_BASE),
    "N=4,096x9+1": dict(_BASE, n=4096 * 9 + 1),
    "scores from element 1": dict(_BASE, s_off=1),
    "scores and keys from element 1": dict(_BASE, s_off=1, k_off=1),
    "scores from element 2, keys from 3": dict(_BASE, s_off=2, k_off=3),
    "K=1": dict(_BASE, K=1),
    "K=33": dict(_BASE, K=33),
    "K just below the shared limit": dict(_BASE, K=56_320 - 7),
    "K just above the shared limit": dict(_BASE, K=56_320 + 1),
    "K=30,720": dict(_BASE, K=30_720),
    "keys past K and negative": dict(_BASE, keys="wide"),
    "keys past K, global route": dict(_BASE, K=60_000, keys="wide"),
    "all rejected": dict(_BASE, accept=0.0),
    "all accepted": dict(_BASE, accept=1.0),
    "one hot bin": dict(_BASE, keys="hot"),
    "one hot bin, global route": dict(_BASE, K=60_000, keys="hot"),
    "red_svc ~10% accepted": dict(_BASE, n=4096 * 9 + 1, accept=0.1),
    "rows [8, N], N % 4 = 2": dict(_BASE, Q=8, n=4096 * 2 + 2),
    "rows [8, N], global route": dict(_BASE, Q=8, n=4096 + 3, K=60_000,
                                      keys="wide"),
    "rows [3, N] from element 1": dict(_BASE, Q=3, n=4096 + 1, s_off=1),
    "rows [200, 64]": dict(_BASE, Q=200, n=64, K=100),
}


def k7_case(seed: int, name: str, dev) -> tuple:
    """``k7_inputs`` of the case `name`, seeded with `seed` plus the
    case's place among the sorted names."""
    return k7_inputs(seed + sorted(K7_CASES).index(name), K7_CASES[name],
                     dev)


def k7_inputs(seed: int, spec: dict, dev) -> tuple:
    """(scores int32 [Q, n], keys int32 [n], K) on `dev` for one of
    ``K7_CASES``, made from the seed with numpy: each tensor a view into a
    larger buffer at its element offset. Accepted scores are uniform over
    [0, 2^31 - 1) with some exactly 0; rejected ones -1 or -2^31."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    Q, n, K = spec["Q"], spec["n"], spec["K"]
    acc = rng.random((Q, n)) < spec["accept"]
    sc = np.where(acc, rng.integers(0, 2**31 - 1, size=(Q, n)),
                  rng.choice([-1, -2**31], size=(Q, n))).astype(np.int32)
    sc[:, :5] = np.where(acc[:, :5], 0, sc[:, :5])
    if spec["keys"] == "hot":
        keys = np.full(n, min(7, K - 1), dtype=np.int32)
    else:
        lo, hi = (-50, K + 50) if spec["keys"] == "wide" else (0, K)
        keys = rng.integers(lo, hi, size=n).astype(np.int32)
    s_buf = np.zeros(Q * n + spec["s_off"], dtype=np.int32)
    s_buf[spec["s_off"]:] = sc.reshape(-1)
    k_buf = np.zeros(n + spec["k_off"], dtype=np.int32)
    k_buf[spec["k_off"]:] = keys
    s = torch.from_numpy(s_buf).to(dev, copy=True)[spec["s_off"]:] \
        .view(Q, n)
    k = torch.from_numpy(k_buf).to(dev, copy=True)[spec["k_off"]:]
    return s, k, K


# K8's edge cases: name -> rows n, series n_keys, thresholds nb (the
# first nb ingest latency edges, so K = n_keys * (nb + 1)), the series
# ids ("uniform" over [0, n_keys) with a few at n_keys, "wide" over
# [-50, n_keys + 50), "hot": all one series), the durations ("edges":
# seeded over [0, 20 s) with the first rows on every threshold and one
# either side of it, then 0 and 2^62 - 1; "huge": the same and the last
# rows 2^62, 2^62 + 12,345 and 2^63 - 1; "hot": all 5 ms), and the element
# offsets of the series ids' and the durations' first element in their
# buffers. The route limit: one CTA's histogram up to 36,864 bins
# (``agg.CTA_BINS``), global atomics past that.
_K8 = dict(n=4097, n_keys=64, nb=14, sidx="uniform", dur="edges", s_off=0,
           d_off=0)
K8_CASES = {
    "n=0": dict(_K8, n=0),
    "n=1": dict(_K8, n=1),
    "n=3": dict(_K8, n=3),
    "n=2,053": dict(_K8, n=2053),
    "n=4,097": dict(_K8),
    "n=4,096x5+3": dict(_K8, n=4096 * 5 + 3),
    "series ids from element 1, durations from 1 (in phase)":
        dict(_K8, s_off=1, d_off=1),
    "series ids from element 2, durations from 2 (in phase)":
        dict(_K8, s_off=2, d_off=2),
    "series ids from element 3, durations from 1 (in phase)":
        dict(_K8, s_off=3, d_off=1),
    "series ids from element 1 (out of phase)": dict(_K8, s_off=1),
    "series ids from element 2, durations from 1 (out of phase)":
        dict(_K8, s_off=2, d_off=1),
    "K=15": dict(_K8, n_keys=1),
    "K=61,440": dict(_K8, n_keys=4096, n=4096 * 3 + 1),
    "K=36,864, one CTA's limit": dict(_K8, n_keys=36_864, nb=0),
    "K=36,865, the global route": dict(_K8, n_keys=36_865, nb=0),
    "K=450,560, the global route": dict(_K8, n_keys=450_560, nb=0),
    "no thresholds": dict(_K8, nb=0),
    "series ids past n_keys and negative": dict(_K8, sidx="wide"),
    "series ids past n_keys and negative, K=61,440":
        dict(_K8, n_keys=4096, sidx="wide"),
    "durations at and past 2^62": dict(_K8, dur="huge"),
    "durations at and past 2^62, K=61,440":
        dict(_K8, n_keys=4096, dur="huge"),
    "one hot bin": dict(_K8, sidx="hot", dur="hot"),
    "one hot bin, K=61,440": dict(_K8, n_keys=4096, sidx="hot", dur="hot"),
}


def k8_case(seed: int, name: str, dev) -> tuple:
    """``k8_inputs`` of the case `name`, seeded with `seed` plus the
    case's place among the sorted names."""
    return k8_inputs(seed + sorted(K8_CASES).index(name), K8_CASES[name],
                     dev)


def k8_inputs(seed: int, spec: dict, dev) -> tuple:
    """(series ids int32 [n], durations int64 [n], host thresholds int64
    [nb], n_keys, the bucket edges in seconds) on `dev` for one of
    ``K8_CASES``, made from the seed with numpy: each column a view into a
    larger buffer at its element offset."""
    import numpy as np
    import torch

    from tempo_tpu_torch.search.analytics import (LATENCY_BUCKETS_S,
                                                  _dur_thresholds_full)

    rng = np.random.default_rng(seed)
    n, n_keys = spec["n"], spec["n_keys"]
    buckets = LATENCY_BUCKETS_S[:spec["nb"]]
    thr = np.asarray(_dur_thresholds_full(buckets), dtype=np.int64)
    if spec["sidx"] == "hot":
        sidx = np.full(n, min(7, n_keys - 1), dtype=np.int64)
    elif spec["sidx"] == "wide":
        sidx = rng.integers(-50, n_keys + 50, size=n)
    else:
        sidx = rng.integers(0, n_keys, size=n)
        sidx[n // 3:n // 3 + 2] = n_keys
    if spec["dur"] == "hot":
        dur = np.full(n, 5_000_000, dtype=np.int64)
    else:
        dur = rng.integers(0, 20_000_000_000, size=n, dtype=np.int64)
        first = np.asarray([t + d for t in thr.tolist() for d in (-1, 0, 1)]
                           + [0, (1 << 62) - 1], dtype=np.int64)
        dur[:min(n, first.size)] = first[:n]
        if spec["dur"] == "huge" and n >= 3:
            dur[-3:] = [1 << 62, (1 << 62) + 12_345, (1 << 63) - 1]
    s_buf = np.zeros(n + spec["s_off"], dtype=np.int32)
    s_buf[spec["s_off"]:] = sidx
    d_buf = np.zeros(n + spec["d_off"], dtype=np.int64)
    d_buf[spec["d_off"]:] = dur
    s = torch.from_numpy(s_buf).to(dev, copy=True)[spec["s_off"]:]
    d = torch.from_numpy(d_buf).to(dev, copy=True)[spec["d_off"]:]
    return s, d, torch.from_numpy(thr), n_keys, buckets


def k8_library(sidx, dur, thr, n_keys: int):
    """torch.bucketize + one torch.bincount of the keys in [0, K) (the
    rest moved to K): the library call beside K8. `thr` on the data's
    device."""
    import torch

    nb1 = thr.numel() + 1
    K = n_keys * nb1
    key = sidx.to(torch.int64) * nb1 + torch.bucketize(dur, thr, right=True)
    key = torch.where((key >= 0) & (key < K), key, K)
    return torch.bincount(key, minlength=K + 1)[:K].to(torch.int32)


def k7_bytes(scores, keys, K: int) -> int:
    """K7's bound in bytes: the score rows read, the keys of the entries
    some row accepts (their 32-byte sectors) and the counts written."""
    from tempo_tpu_torch.search.kernels.bench_coalesced import sector_bytes

    Q, n = scores.shape
    return (Q * n * 4 + sector_bytes((scores >= 0).any(dim=0), 4)
            + Q * K * 4)


def k7_library(scores, keys, K: int):
    """One torch.bincount over all rows (a row offset each) of
    torch.where(scores >= 0, keys, K): the library call beside K7."""
    import torch

    Q = scores.shape[0]
    off = (torch.arange(Q, device=scores.device, dtype=torch.int64)
           * (K + 1))[:, None]
    k = torch.where((keys >= 0) & (keys < K), keys, K)
    return torch.bincount((torch.where(scores >= 0, k, K) + off)
                          .reshape(-1), minlength=Q * (K + 1)
                          ).reshape(Q, K + 1)[:, :K].to(torch.int32)


def card_host(fn, reps: int) -> tuple:
    """(card ms, host us) a call: CUDA events around `reps` calls back to
    back, and the host's clock around issuing the same calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    h1 = time.perf_counter()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, (h1 - h0) / reps * 1e6


def timed_case(fn, plain, library, need: int) -> dict:
    """A kernel call `fn` against its plain version and a library call:
    card ms and host us (``card_host``), device, bound, plain and library
    ms, and exact equality."""
    import torch

    from tempo_tpu_torch.search.kernels.bench_structural import (card_ms,
                                                                 event_ms)

    got, want = fn(), plain()
    torch.cuda.synchronize()
    exact = bool(got.shape == want.shape and torch.equal(got, want)
                 and torch.equal(library(), want))
    card, host = card_host(fn, 50)
    return {"card_ms": card, "host_us": host, "device_ms": event_ms(fn),
            "bound_ms": need / HBM_BYTES_PER_S * 1e3, "bytes": need,
            "plain_ms": card_ms(plain, 3), "library_ms": card_ms(library, 20),
            "exact": exact, "counted": int(got.sum())}


def spread_keys(keys, services: int):
    """The keys of `services` services (30 bins each) made from the RED
    keys by spreading each service over consecutive entries."""
    import torch

    idx = torch.arange(keys.numel(), device=keys.device, dtype=torch.int32)
    per = services // 64
    return ((((keys // 30) * per + idx % per) % services) * 30
            + keys % 30).to(torch.int32)


CASES = ("K7 [1, N] red_all", "K7 [1, N] red_svc", "K7 K=30,720",
         "K7 K=61,440", "K7 one hot bin", "K7r [8, N]", "K8 K=960",
         "K8 K=61,440", "K8 K=30,720", "K8 one hot bin",
         "K8 K=36,855, one CTA", "K8 K=36,870, global",
         "K8 dense_counts call")

# csrc/agg.cu variants for --breakdown: (text, replacement) pairs
BREAKDOWN = {
    "no grid barrier": [
        ("  cg::this_grid().sync();         // every partial row written",
         "  return;")],
    "no count": [
        ("  const int64_t lo = nv * g / G, hi = nv * (g + 1) / G;",
         "  const int64_t lo = 0, hi = 0;"),
        ("  const int64_t n_one = head + (a.n - tail);\n  for (int64_t j = ",
         "  const int64_t n_one = 0 * tail;\n  for (int64_t j = ")],
    "empty launch": [
        ("count_kernel(const __grid_constant__ CountArgs a) {",
         "count_kernel(const __grid_constant__ CountArgs a) {\n"
         "  if (a.n >= 0) return;")],
    "no adds": [
        ("                                        unsigned k, unsigned v) {",
         "                                        unsigned k, unsigned v) {\n"
         "  if (k != 0x7fffffffu) return;")],
    "no thresholds": [
        ("  for (int i = 0; i < a.nb; ++i) {\n    const long long edge",
         "  for (int i = 0; i < 0; ++i) {\n    const long long edge")],
    "no warp vote": [
        ("  if (__all_sync(act, same && key[0] == k0)) {",
         "  if (__all_sync(act, false)) {")],
    "the global route": [
        ("  const int route = count_route(K);",
         "  const int route = kRouteGlobal;")],
    "tile column sums": [
        ("  if (G <= kFewRows)", "  if (false)")],
    "one CTA up to 56,320 bins": [
        ("constexpr int kCtaBins = 36864;", "constexpr int kCtaBins = 56320;")],
}


def cluster_variant(C: int) -> list:
    """The (text, replacement) pairs that turn ``csrc/agg.cu``'s CTA route
    into the dropped design: a thread-block cluster of C CTAs holds one
    histogram of K bins, each CTA a slice of ceil(K / C) rounded up to 128
    in its shared memory, an entry one atomic add into its owner's slice
    (``map_shared_rank``), each cluster's slices one partial row, while a
    slice fits 56,320 bins (global atomics past that); the grid is whole
    clusters, as many as can be resident at once."""
    return [
        ("constexpr int kMaxThresholds = 64; ",
         f"constexpr int kC = {C};\nconstexpr int kMaxThresholds = 64; "),
        ("  atomicAdd((kRoute == kRouteGlobal ? (unsigned*)a.out : hist) + k, v);",
         "  if (kRoute == kRouteGlobal) {\n"
         "    atomicAdd((unsigned*)a.out + k, v);\n"
         "    return;\n"
         "  }\n"
         "  const unsigned slice = (unsigned)a.Kp / kC, o = k / slice;\n"
         "  atomicAdd(cg::this_cluster().map_shared_rank(hist + (k - o * slice),"
         " o), v);"),
        ("i < a.Kp / 4; i += kAggThreads)\n      reinterpret_cast<uint4*>(hist)",
         "i < a.Kp / 4 / kC; i += kAggThreads)\n"
         "      reinterpret_cast<uint4*>(hist)"),
        ("    __syncthreads();              // every bin zeroed before any add",
         "    cg::this_cluster().sync();"),
        ("  __syncthreads();                // every add has landed",
         "  cg::this_cluster().sync();"),
        ("  uint4* dst = reinterpret_cast<uint4*>(a.partials + (int64_t)g * a.Kp);\n"
         "  for (int i = t; i < a.Kp / 4; i += kAggThreads)",
         "  uint4* dst = reinterpret_cast<uint4*>(a.partials + (int64_t)(g / kC)"
         " * a.Kp + (int64_t)(g % kC) * (a.Kp / kC));\n"
         "  for (int i = t; i < a.Kp / 4 / kC; i += kAggThreads)"),
        ("  if (G <= kFewRows)\n"
         "    column_sums_few(a.partials, G, a.Kp, a.K, a.out);\n"
         "  else\n"
         "    column_sums(a.partials, 1, G, a.Kp, a.K, a.out, hist);",
         "  if (G / kC <= kFewRows)\n"
         "    column_sums_few(a.partials, G / kC, a.Kp, a.K, a.out);\n"
         "  else\n"
         "    column_sums(a.partials, 1, G / kC, a.Kp, a.K, a.out, hist);"),
        ("  return round_up(K, kTile) <= kCtaBins ? kRouteCta : kRouteGlobal;",
         "  return round_up((K + kC - 1) / kC, kTile) <= kSharedBins\n"
         "      ? kRouteCta : kRouteGlobal;"),
        ("  return round_up(K, 4) + (int64_t)sms * round_up(K, kTile);",
         "  return round_up(K, 4) + (int64_t)sms *"
         " round_up((K + kC - 1) / kC, kTile);"),
        ("int count_launch(const int32_t* sidx,",
         "int cluster_cap() {   // CTAs of the most clusters resident at once\n"
         "  static std::atomic<int> cap{0};\n"
         "  if (cap.load() > 0) return cap.load();\n"
         "  cudaLaunchAttribute at[1];\n"
         "  at[0].id = cudaLaunchAttributeClusterDimension;\n"
         "  at[0].val.clusterDim.x = kC;\n"
         "  at[0].val.clusterDim.y = 1;\n"
         "  at[0].val.clusterDim.z = 1;\n"
         "  cudaLaunchConfig_t cfg = {};\n"
         "  cfg.gridDim = dim3(kC);\n"
         "  cfg.blockDim = dim3(kAggThreads);\n"
         "  cfg.dynamicSmemBytes = (size_t)kSharedBins * 4;\n"
         "  cfg.attrs = at;\n"
         "  cfg.numAttrs = 1;\n"
         "  int clusters = 0;\n"
         "  if (cudaOccupancyMaxActiveClusters(\n"
         "          &clusters, (const void*)count_kernel<kRouteCta>, &cfg)"
         " != cudaSuccess)\n"
         "    return 0;\n"
         "  cap.store(clusters * kC);\n"
         "  return clusters * kC;\n"
         "}\n\n"
         "int count_launch(const int32_t* sidx,"),
        ("  cudaLaunchAttribute attr[1];", "  cudaLaunchAttribute attr[2];"),
        ("    const int64_t kp = round_up(K, kTile);\n    a.Kp = (int)kp;",
         "    const int64_t slc = round_up((K + kC - 1) / kC, kTile);\n"
         "    const int64_t kp = slc;\n"
         "    a.Kp = (int)(slc * kC);"),
        ("    if (want > sms) want = sms;\n    cfg.dynamicSmemBytes = (size_t)"
         "(kp * 4",
         "    if (want > cluster_cap()) want = cluster_cap();\n"
         "    want = want < kC ? kC : want - want % kC;\n"
         "    attr[1].id = cudaLaunchAttributeClusterDimension;\n"
         "    attr[1].val.clusterDim.x = kC;\n"
         "    attr[1].val.clusterDim.y = 1;\n"
         "    attr[1].val.clusterDim.z = 1;\n"
         "    cfg.numAttrs = 2;\n"
         "    cfg.dynamicSmemBytes = (size_t)(kp * 4"),
    ]


BREAKDOWN.update({f"a cluster of {C}": cluster_variant(C) for C in (2, 4, 8)})
BREAKDOWN["a cluster of 2, adds into its own CTA (wrong counts)"] = [
    *cluster_variant(2),
    ("  atomicAdd(cg::this_cluster().map_shared_rank(hist + (k - o * slice),"
     " o), v);", "  atomicAdd(hist + (k - o * slice), v);")]


def breakdown(s, d, thr, n_keys: int) -> dict:
    """Device ms (``event_ms``) of K8 and of its ``BREAKDOWN`` variants on
    one micro-batch, there and with the series ids spread over 16,384,
    8,192, 3,754, 2,731, 2,048 and 1,024 (K = 245,760, 122,880, 56,310,
    40,965, 30,720 and 15,360), each launched straight through its
    library's ``tt_analytics_count`` into an output of its own
    ``tt_count_out_ints``: what the launch, the count, its adds, the grid
    barrier, each route and each cluster size cost on the device."""
    import ctypes

    import torch

    from tempo_tpu_torch.search.kernels import agg, build
    from tempo_tpu_torch.search.kernels.bench_structural import event_ms

    src = (build.CSRC / "agg.cu").read_text()
    where = build.BUILD_DIR / "variants"
    where.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(BREAKDOWN.items()):
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise AssertionError(f"breakdown {name}: csrc/agg.cu has "
                                     f"{text.count(old)} of "
                                     f"{old.strip()!r}, not one")
            text = text.replace(old, new)
        cu, so = where / f"agg_v{i}.cu", where / f"libagg_v{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {"the kernel": agg._lib()}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"breakdown {name}: nvcc failed:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    for v in libs.values():
        v.tt_analytics_count.restype = ctypes.c_int
        v.tt_analytics_count.argtypes = \
            libs["the kernel"].tt_analytics_count.argtypes
        v.tt_count_out_ints.restype = ctypes.c_int64
        v.tt_count_out_ints.argtypes = [ctypes.c_int, ctypes.c_int]
    nb1 = thr.numel() + 1
    sms = torch.cuda.get_device_properties(s.device).multi_processor_count
    res = {}
    for nk in (n_keys, 16_384, 8192, 3754, 2731, 2048, 1024):
        sk = s if nk == n_keys else spread_series(s, nk)
        K = nk * nb1
        want = agg.analytics_count_plain(sk, d, thr, nk)
        for name, v in libs.items():
            ints = v.tt_count_out_ints(K, sms)
            if name.startswith("a cluster") and ints == K:
                continue            # past the cluster's slices: global
            out = torch.empty(ints, dtype=torch.int32, device=s.device)

            def fn(v=v, ints=ints, out=out, sk=sk, K=K, name=name):
                rc = v.tt_analytics_count(
                    sk.data_ptr(), d.data_ptr(), sk.numel(), thr.data_ptr(),
                    thr.numel(), K, out.data_ptr(), ints,
                    build._raw_stream(s.device.index))
                if rc:
                    raise RuntimeError(f"breakdown {name}, K = {K}: CUDA "
                                       f"error {rc}")
            key = f"{name}, K = {K}"
            res[key] = event_ms(fn)
            if name == "the kernel" or name.startswith("a cluster of") \
                    and "wrong" not in name:
                fn()
                if not torch.equal(out[:K], want):
                    raise AssertionError(f"breakdown {key}: counts differ "
                                         "from the plain version")
    return res


def spread_series(sidx, n_keys: int):
    """Series ids folded or spread over [0, n_keys): each row's id mixed
    with its place, so neighbouring rows fall in different series."""
    import torch

    idx = torch.arange(sidx.numel(), device=sidx.device, dtype=torch.int64)
    return ((sidx.to(torch.int64) * 131 + idx) % n_keys).to(torch.int32)


def measure(label: str, cases=CASES, repeat: int = 1,
            breakdown_on: bool = False) -> dict:
    import chip_smoke as cs
    import numpy as np
    import torch

    from tempo_tpu_torch.search import analytics
    from tempo_tpu_torch.search.analytics import thresholds_tensor
    from tempo_tpu_torch.search.kernels import agg, scan
    from tempo_tpu_torch.search.kernels.bench_coalesced import (
        compile_members, page_of)
    from tempo_tpu_torch.search.multiblock import (MultiBlockEngine,
                                                   place_batch,
                                                   stack_queries)

    dev = torch.device("cuda", 0)
    out = {"label": label, "card": torch.cuda.get_device_name(0),
           "cases": {}, "runs": []}

    t0 = time.perf_counter()
    blocks = [cs.make_block(SEED + 5, b, RED_TRACES, E, red=True)
              for b in range(RED_BLOCKS)]
    out["corpus_s"] = time.perf_counter() - t0
    inputs = {}

    def once(name, make):
        if name not in inputs:
            inputs[name] = make()
        return inputs[name]

    def staged():
        eng = MultiBlockEngine(dev)
        batch = place_batch(eng.stage_host(blocks), dev)
        stage = analytics.stage_for_batch(batch)
        return eng, batch, stage.device(dev).reshape(-1), stage.n_keys

    def scores_of(reqs):
        eng, batch, _k, _K = once("staged", staged)
        page = page_of(batch)
        mqs = compile_members(eng, batch, reqs)
        if len(mqs) == 1:
            mq = mqs[0]
            bg = (None if mq.block_group is None
                  else torch.from_numpy(mq.block_group).to(dev))
            return scan.multi_scan(
                *page, torch.from_numpy(mq.term_keys).to(dev),
                torch.from_numpy(mq.val_ranges).to(dev), mq.n_terms,
                mq.dur_lo, min(mq.dur_hi, 0xFFFFFFFF), mq.win_start,
                min(mq.win_end, 0xFFFFFFFF), mq.val_hits, bg,
                batch.widths, batch.device.get("entry_dur_res"))[0][None]
        cq = stack_queries(mqs)
        return scan.coalesced_scan(*page, *eng.coalesced_tables(cq),
                                   batch.widths,
                                   batch.device.get("entry_dur_res"))[0]

    def k7(s, k, n_keys):
        if s.shape[0] == 1:
            def fn():
                return agg.agg_counts(s[0], k, n_keys)[None]
        else:
            def fn():
                return agg.agg_counts_rows(s, k, n_keys)
        r = timed_case(fn, lambda: agg.agg_counts_rows_plain(s, k, n_keys),
                       lambda: k7_library(s, k, n_keys),
                       k7_bytes(s, k, n_keys))
        r.update(Q=int(s.shape[0]), N=int(s.shape[1]), K=n_keys,
                 accepted=float((s >= 0).float().mean()))
        return r

    def red_all():
        return scores_of([(dict(cs.AGG), {"limit": 20})])

    def red_svc():
        return scores_of([(dict(cs.AGG, **{"service.name": "svc-007"}),
                           {"limit": 20})])

    def rows():
        return scores_of([({"service.name": f"svc-00{i}"}, {"limit": 20})
                          for i in range(8)])

    def keys():
        return once("staged", staged)[2]

    def k7_cases(name):
        K = once("staged", staged)[3]
        s1 = once("red_all", red_all)
        return {"K7 [1, N] red_all": lambda: k7(s1, keys(), K),
                "K7 [1, N] red_svc": lambda: k7(once("red_svc", red_svc),
                                                keys(), K),
                "K7 K=30,720": lambda: k7(s1, spread_keys(keys(), 1024),
                                          1024 * 30),
                "K7 K=61,440": lambda: k7(s1, spread_keys(keys(), 2048),
                                          2048 * 30),
                "K7 one hot bin": lambda: k7(s1, torch.full_like(keys(), 7),
                                             K),
                "K7r [8, N]": lambda: k7(once("rows", rows), keys(), K),
                }[name]()

    # the ingest batches: 8,192 rows x 64 series and 1,048,576 x 4,096
    # (named "shared" and "global" before K8's redesign)
    def ingest():
        b = cs.red_ingest_batches(blocks, SEED)
        return (b["services"], b["operations"]) if "services" in b \
            else (b["shared"], b["global"])

    # K8 takes host thresholds since its redesign (its launch's
    # parameters carry them), device ones before
    thr_dev = thresholds_tensor(analytics.LATENCY_BUCKETS_S, dev)
    host_thr = hasattr(agg, "analytics_count_tiled")
    thr = (thresholds_tensor(analytics.LATENCY_BUCKETS_S,
                             torch.device("cpu")) if host_thr else thr_dev)
    nb1 = thr.numel() + 1

    def k8(which, n_keys=None, hot=False):
        sidx, dur, nk = once("ingest", ingest)[which]
        s = torch.from_numpy(sidx).to(dev)
        d = torch.from_numpy(dur).to(dev)
        if hot:          # one series, one duration: every row one bin
            s, d = torch.full_like(s, 7), torch.full_like(d, 5_000_000)
        elif n_keys is not None:
            s, nk = spread_series(s, n_keys), n_keys
        r = timed_case(lambda: agg.analytics_count(s, d, thr, nk),
                       lambda: agg.analytics_count_plain(s, d, thr, nk),
                       lambda: k8_library(s, d, thr_dev, nk),
                       s.numel() * 12 + nk * nb1 * 4)
        K = nk * nb1
        r.update(rows=int(s.numel()), K=K, route=agg.count_route(K))
        return r

    def dense_call():
        """One ``analytics.dense_counts`` call on the 1,048,576-row batch:
        its host ms (perf_counter, the median of 20 calls) and, replayed
        step by step between CUDA events, its phases' ms (the two pageable
        host-to-device copies, K8, the copy back and its numpy cast)."""
        sidx, dur, nk = once("ingest", ingest)[1]
        exact = bool(np.array_equal(
            analytics.dense_counts(sidx, dur, nk, device=dev),
            cs.host_dense_counts(sidx, dur, nk)))
        walls, phases = [], []
        for _ in range(20):
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            analytics.dense_counts(sidx, dur, nk, device=dev)
            walls.append((time.perf_counter() - h0) * 1e3)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            s = torch.from_numpy(np.ascontiguousarray(
                sidx, dtype=np.int32)).to(dev)
            ev[1].record()
            d = torch.from_numpy(np.ascontiguousarray(
                dur, dtype=np.int64)).to(dev)
            ev[2].record()
            o = agg.analytics_count(s, d, thr, nk)
            ev[3].record()
            o.cpu().numpy().astype(np.int64)
            ev[4].record()
            torch.cuda.synchronize()
            phases.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
        med = [sorted(p[i] for p in phases)[10] for i in range(4)]
        return {"host_ms": sorted(walls)[10], "sidx_copy_ms": med[0],
                "dur_copy_ms": med[1], "k8_ms": med[2],
                "copy_back_ms": med[3], "bytes_in": int(sidx.nbytes
                                                        + dur.nbytes),
                "exact": exact, "rows": int(sidx.size), "K": nk * nb1}

    run = {
        "K8 K=960": lambda: k8(0),
        "K8 K=61,440": lambda: k8(1),
        "K8 K=30,720": lambda: k8(1, 2048),
        "K8 one hot bin": lambda: k8(1, hot=True),
        "K8 K=36,855, one CTA": lambda: k8(1, 2457),
        "K8 K=36,870, global": lambda: k8(1, 2458),
        "K8 dense_counts call": dense_call,
    }
    for i in range(repeat):
        results = {}
        for name in cases:
            r = run[name]() if name in run else k7_cases(name)
            results[name] = r
            print(f"{label} {name}: {json.dumps(r)}", flush=True)
            if not r["exact"]:
                raise AssertionError(f"{label} {name}: the kernel differs "
                                     "from its plain version")
        out["runs"].append(results)
        if i == 0:
            out["cases"] = results
    if breakdown_on:
        sidx, dur, nk = once("ingest", ingest)[1]
        out["breakdown"] = breakdown(torch.from_numpy(sidx).to(dev),
                                     torch.from_numpy(dur).to(dev), thr, nk)
        print(f"{label} breakdown (K8 K=61,440, device ms): "
              f"{json.dumps(out['breakdown'])}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose tempo_tpu_torch and chip_smoke to "
                         "import")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--case", action="append", choices=CASES,
                    help="run only this case (repeatable)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="passes over the cases, in turn")
    ap.add_argument("--breakdown", action="store_true",
                    help="also time K8 and the csrc/agg.cu variants "
                         "(BREAKDOWN) over spread series ids")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_agg: no CUDA card", file=sys.stderr)
        return 2
    # this file's own directory must not shadow the checkout's modules
    sys.path = [p for p in sys.path
                if os.path.abspath(p or ".") != os.path.dirname(
                    os.path.abspath(__file__))]
    sys.path.insert(0, os.path.abspath(args.root))
    from tempo_tpu_torch.search.kernels import build
    from tempo_tpu_torch.search.kernels.bench_coalesced import ptxas_usage

    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    res = measure(args.label,
                  [c for c in CASES if c in args.case] if args.case
                  else CASES, args.repeat, args.breakdown)
    res["build_s"] = build_s
    res["ptxas"] = ptxas_usage(build.BUILD_LOG.get("agg", ""))
    res["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
