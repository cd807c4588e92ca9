"""Time the histogram kernels K7 (``agg_counts``, ``agg_counts_rows``) and
K8 (``analytics_count``) of one checkout of the port on one CUDA card, at
the shapes of their rows in PERF.md's kernel table, against their plain
versions; and the seeded edge cases (``K7_CASES``) that the CPU tests and
``chip_smoke.k7_edges`` hold K7 to.

  python3 tempo_tpu_torch/search/kernels/bench_agg.py --root DIR \\
      --label NAME [--out FILE] [--case NAME ...] [--repeat R]

imports ``tempo_tpu_torch`` and ``chip_smoke`` (the RED cell's corpus and
ingest batches) from DIR (this checkout, or an unpacked older commit),
stages the RED corpus's first 4,096-page group (64 blocks x 65,536
traces, ``chip_smoke.make_block`` with the RED cell's seed) through
``MultiBlockEngine.stage_host`` / ``place_batch`` and its composite keys
through ``analytics.stage_for_batch``, scores requests with the public
``scan.multi_scan`` / ``scan.coalesced_scan``, calls only the public
wrappers of ``kernels.agg``, and prints one JSON object (also appended to
FILE): per case, the card ms (CUDA events around 50 calls back to back)
and the host time spent launching the same 50 calls (``host_us`` a call:
where it is near the card ms, the host sets the pace), the device ms
(``bench_structural.event_ms``: the median of 20 single synchronised
calls between CUDA events), the bound (bytes over 3.35
TB/s), the plain version's ms, the library call's ms, and whether the
kernel equals the plain version exactly; then ptxas's registers and
spills of every ``agg.cu`` build. ``--case`` (repeatable) runs only the
named cases, in the order below; ``--repeat R`` runs them R times in
turn, each pass's results under ``runs``. To compare two commits, run
both in one command on one card, in turns (old, new, new, old).

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
  - K8 shared (8,192 rows x 64 series, K = 960) and global (1,048,576 x
    4,096, K = 61,440): ``chip_smoke.red_ingest_batches``.
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
         "K7 K=61,440", "K7 one hot bin", "K7r [8, N]", "K8 shared",
         "K8 global")


def measure(label: str, cases=CASES, repeat: int = 1) -> dict:
    import chip_smoke as cs
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
    eng = MultiBlockEngine(dev)
    batch = place_batch(eng.stage_host(blocks), dev)
    stage = analytics.stage_for_batch(batch)
    keys = stage.device(dev).reshape(-1)
    out["corpus_s"] = time.perf_counter() - t0
    K = stage.n_keys
    page = page_of(batch)

    def scores_of(reqs):
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

    red_all = scores_of([(dict(cs.AGG), {"limit": 20})])
    inputs = {}

    def red_svc():
        return scores_of([(dict(cs.AGG, **{"service.name": "svc-007"}),
                           {"limit": 20})])

    def rows():
        return scores_of([({"service.name": f"svc-00{i}"}, {"limit": 20})
                          for i in range(8)])

    def ingest():
        return cs.red_ingest_batches(blocks, SEED)

    def once(name, make):
        if name not in inputs:
            inputs[name] = make()
        return inputs[name]

    thr = thresholds_tensor(analytics.LATENCY_BUCKETS_S, dev)

    def k8(which):
        sidx, dur, n_keys = once("ingest", ingest)[which]
        s = torch.from_numpy(sidx).to(dev)
        d = torch.from_numpy(dur).to(dev)
        nb1 = thr.numel() + 1
        s64 = s.to(torch.int64)

        def lib():
            return torch.bincount(s64 * nb1 + torch.bucketize(d, thr,
                                                              right=True),
                                  minlength=n_keys * nb1
                                  )[:n_keys * nb1].to(torch.int32)

        r = timed_case(lambda: agg.analytics_count(s, d, thr, n_keys),
                       lambda: agg.analytics_count_plain(s, d, thr, n_keys),
                       lib, s.numel() * 12 + thr.numel() * 8
                       + n_keys * nb1 * 4)
        r.update(rows=int(s.numel()), K=n_keys * nb1)
        return r

    run = {
        "K7 [1, N] red_all": lambda: k7(red_all, keys, K),
        "K7 [1, N] red_svc": lambda: k7(once("red_svc", red_svc), keys, K),
        "K7 K=30,720": lambda: k7(red_all, spread_keys(keys, 1024),
                                  1024 * 30),
        "K7 K=61,440": lambda: k7(red_all, spread_keys(keys, 2048),
                                  2048 * 30),
        "K7 one hot bin": lambda: k7(red_all, torch.full_like(keys, 7), K),
        "K7r [8, N]": lambda: k7(once("rows", rows), keys, K),
        "K8 shared": lambda: k8("shared"),
        "K8 global": lambda: k8("global"),
    }
    for i in range(repeat):
        results = {}
        for name in cases:
            r = run[name]()
            results[name] = r
            print(f"{label} {name}: {json.dumps(r)}", flush=True)
            if not r["exact"]:
                raise AssertionError(f"{label} {name}: the kernel differs "
                                     "from its plain version")
        out["runs"].append(results)
        if i == 0:
            out["cases"] = results
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
                  else CASES, args.repeat)
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
