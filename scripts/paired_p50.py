"""Paired p50 of the tag cell's bench request on one CUDA card, for two
checkouts of the port: a parent and a change, each in processes of its
own, in the order parent, change, change, parent, over one corpus.

    python3 scripts/paired_p50.py --parent DIR [--change DIR] [--reps 50]
        [--out FILE]

DIR is the root of a checkout (the directory that holds
``tempo_tpu_torch/``); ``--change`` defaults to this script's checkout.
The corpus is ``chip_smoke.py``'s tag corpus at its defaults (256 blocks
of 65,536 traces, ``write_corpus`` and ``requests`` of this checkout's
``chip_smoke.py``), written once to a temporary directory. Both
checkouts' kernels are built first, in parallel, so no process times a
build. Each process then opens a database over the corpus with the tag
cell's configuration (``search_max_batch_pages=4096``), stages every
group with the exhaustive request, and times ``--reps`` warm
``bench_and`` requests; a change's process also opens a database with
both attribution gates off (``search_query_stats_enabled`` and
``search_profiling_enabled``) and interleaves the two request by request.

Prints one JSON line a process, then the card's name and power limit and
a summary line (each side's p50 a process and over its pooled samples);
``--out`` also gets them. Exits 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def child(args) -> int:
    """One timing process over `args.child`'s package."""
    sys.path.insert(0, args.child)
    import torch

    import tempo_tpu_torch
    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.model.types import SearchRequest

    pkg = os.path.dirname(os.path.abspath(tempo_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(args.child):
        raise RuntimeError(f"imported {pkg}, not {args.child}'s package")
    reqs = json.loads(args.requests)
    dbs = {}
    try:
        for name, gates in json.loads(args.gates).items():
            db = TempoDB(LocalBackend(args.corpus), TempoDBConfig(
                search_max_batch_pages=4096, **gates), device="cuda")
            dbs[name] = db
            db.poll()
            tags, kw = reqs["exhaustive_bench"]
            db.search("smoke", SearchRequest(tags=dict(tags), **kw))
        tags, kw = reqs["bench_and"]
        req = SearchRequest(tags=dict(tags), **kw)
        names = list(dbs)
        for name in names:                    # warm
            for _ in range(5):
                dbs[name].search("smoke", req)
        torch.cuda.synchronize()
        lat = {name: [] for name in names}
        traces = {}
        for i in range(args.reps):
            k = i % len(names)
            for name in names[k:] + names[:k]:
                t0 = time.perf_counter()
                resp = dbs[name].search("smoke", req).response()
                lat[name].append((time.perf_counter() - t0) * 1e3)
                traces[name] = [t.trace_id for t in resp.traces]
        if any(t != traces[names[0]] for t in traces.values()):
            raise AssertionError("the databases answered differently")
    finally:
        for db in dbs.values():
            db.close()
    print(json.dumps({"root": args.child, "label": args.label,
                      "p50_ms": {n: pct(v, 0.5) for n, v in lat.items()},
                      "samples_ms": lat}), flush=True)
    return 0


def build(root: str) -> subprocess.Popen:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tempo_tpu_torch.search.kernels import build; "
            "build.build_all()")
    return subprocess.Popen([sys.executable, "-c", code, root])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of the parent checkout")
    ap.add_argument("--change", default=HERE,
                    help="root of the change's checkout")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--label", default="", help=argparse.SUPPRESS)
    ap.add_argument("--corpus", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--requests", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--gates", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args)
    if not args.parent:
        ap.error("--parent is required")

    import torch

    if not torch.cuda.is_available():
        print("paired_p50: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke

    roots = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    builds = [build(r) for r in roots.values()]
    work = tempfile.mkdtemp(prefix="paired_p50_")
    lines = []
    try:
        corpus = os.path.join(work, "blocks")
        blocks, per_block = 256, 65_536
        chip_smoke.write_corpus(corpus, "smoke", blocks, per_block,
                                chip_smoke.ENTRIES_PER_PAGE, args.seed)
        for p in builds:
            if p.wait() != 0:
                raise RuntimeError("a kernel build failed")
        reqs = json.dumps(chip_smoke.requests(blocks))
        gates = {"parent": {"default": {}},
                 "change": {"default": {},
                            "gates_off": {
                                "search_query_stats_enabled": False,
                                "search_profiling_enabled": False}}}
        runs = []
        for label in ("parent", "change", "change", "parent"):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--child", roots[label], "--label", label,
                 "--corpus", corpus, "--requests", reqs,
                 "--gates", json.dumps(gates[label]),
                 "--reps", str(args.reps)],
                check=True, capture_output=True, text=True)
            line = out.stdout.strip().splitlines()[-1]
            lines.append(line)
            print(line, flush=True)
            runs.append(json.loads(line))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    summary: dict = {"card": card, "reps": args.reps}
    for r in runs:
        for db, p50 in r["p50_ms"].items():
            side = summary.setdefault(f"{r['label']}/{db}",
                                      {"p50_ms": [], "samples": []})
            side["p50_ms"].append(p50)
            side["samples"] += r["samples_ms"][db]
    for side in summary.values():
        if isinstance(side, dict):
            side["pooled_p50_ms"] = pct(side.pop("samples"), 0.5)
    lines += [card, json.dumps(summary)]
    print(card)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
