"""Where the attribution's cost goes on one CUDA card.

    python3 scripts/attribution_cost.py [--blocks 256] [--reps 100]
        [--out FILE]

Over ``chip_smoke.py``'s tag corpus (``--blocks`` blocks of 65,536
traces), three databases with the tag cell's configuration answer the
bench request (``bench_and``): both attribution gates on (the default),
the profiler alone (``search_query_stats_enabled=False``) and both off.
Prints, as one JSON object:

- ``p50_ms``: each database's wall p50 over ``--reps`` interleaved turns;
- ``profile_us``: per request, the host microseconds (``cProfile``'s
  cumulative time over ``--reps`` requests of each database) of the
  attribution's functions and of the fetch, the top functions by own
  time, and the request's total under the profiler;
- ``fetch_us``: the median over 500 calls of a dispatch's output fetch
  of three small device tensors, as the profiler makes it
  (``Dispatch.fetch``) and as a database with profiling off makes it
  (``torch.cat(...).cpu()``), and of a record's open, launch window and
  attach around no launch.

Exits 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the functions whose cumulative time is reported, by (file suffix, name)
WATCH = [
    ("observability/profile.py", "fetch"),
    ("observability/profile.py", "finish"),
    ("observability/profile.py", "_finish"),
    ("observability/profile.py", "dispatch"),
    ("observability/profile.py", "__enter__"),
    ("observability/profile.py", "__exit__"),
    ("observability/profile.py", "compile_check"),
    ("observability/profile.py", "observe_stage"),
    ("observability/profile.py", "sweep"),
    ("search/query_stats.py", "begin"),
    ("search/query_stats.py", "finish"),
    ("search/query_stats.py", "publish"),
    ("search/query_stats.py", "to_dict"),
    ("search/query_stats.py", "on_record"),
    ("search/query_stats.py", "attributed_dispatch"),
    ("search/engine.py", "fetch_scan_out"),
    ("db/tempodb.py", "search"),
    ("db/tempodb.py", "_finalize_query_stats"),
]


def pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def profile_us(db, req, reps: int) -> dict:
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        db.search("smoke", req).response()
    prof.disable()
    st = pstats.Stats(prof)
    watched, own = {}, []
    for (fname, _line, func), (_cc, _nc, tt, ct, _callers) in \
            st.stats.items():
        for suffix, name in WATCH:
            if fname.endswith(suffix) and func == name:
                key = f"{suffix}:{name}"
                watched[key] = watched.get(key, 0.0) + ct / reps * 1e6
        own.append((tt / reps * 1e6, f"{os.path.basename(fname)}:{func}"))
    own.sort(reverse=True)
    return {"watched": {k: round(v, 1) for k, v in sorted(watched.items())},
            "top_own": [[n, round(us, 1)] for us, n in own[:15]],
            "total": round(st.total_tt / reps * 1e6, 1)}


def fetch_us(reps: int = 500) -> dict:
    import torch

    from tempo_tpu_torch.observability import profile

    dev = torch.device("cuda")
    ts = [torch.zeros(2, dtype=torch.int32, device=dev),
          torch.arange(128, dtype=torch.int32, device=dev),
          torch.arange(128, dtype=torch.int32, device=dev)]
    gate = profile.Gate()
    out = {"profiled": [], "plain": [], "open_launch_attach": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        rec = gate.dispatch("single", dev)
        with rec.launch():
            pass
        rec.attach(tuple(ts))
        t1 = time.perf_counter()
        rec.fetch(ts)
        t2 = time.perf_counter()
        torch.cat(ts).cpu()
        t3 = time.perf_counter()
        out["open_launch_attach"].append((t1 - t0) * 1e6)
        out["profiled"].append((t2 - t1) * 1e6)
        out["plain"].append((t3 - t2) * 1e6)
    return {k: round(pct(v, 0.5), 1) for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=256)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("attribution_cost: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.model.types import SearchRequest

    work = tempfile.mkdtemp(prefix="attribution_cost_")
    dbs = {}
    try:
        root = os.path.join(work, "blocks")
        chip_smoke.write_corpus(root, "smoke", args.blocks, 65_536,
                                chip_smoke.ENTRIES_PER_PAGE, args.seed)
        reqs = chip_smoke.requests(args.blocks)
        gates = {"on": {},
                 "profiler": {"search_query_stats_enabled": False},
                 "off": {"search_query_stats_enabled": False,
                         "search_profiling_enabled": False}}
        for name, g in gates.items():
            db = dbs[name] = TempoDB(LocalBackend(root), TempoDBConfig(
                search_max_batch_pages=4096, **g), device="cuda")
            db.poll()
            tags, kw = reqs["exhaustive_bench"]
            db.search("smoke", SearchRequest(tags=dict(tags), **kw))
        tags, kw = reqs["bench_and"]
        req = SearchRequest(tags=dict(tags), **kw)
        names = list(dbs)
        for name in names:
            for _ in range(10):
                dbs[name].search("smoke", req)
        lat = {n: [] for n in names}
        for i in range(args.reps):
            k = i % len(names)
            for name in names[k:] + names[:k]:
                t0 = time.perf_counter()
                dbs[name].search("smoke", req).response()
                lat[name].append((time.perf_counter() - t0) * 1e3)
        report = {"p50_ms": {n: pct(v, 0.5) for n, v in lat.items()},
                  "profile_us": {n: profile_us(dbs[n], req, args.reps)
                                 for n in names},
                  "fetch_us": fetch_us()}
    finally:
        for db in dbs.values():
            db.close()
        shutil.rmtree(work, ignore_errors=True)
    report["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
