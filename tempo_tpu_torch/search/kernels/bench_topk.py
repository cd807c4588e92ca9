"""Time the top-k kernels K2, K2r and K9 of one checkout of the port on
one CUDA card, beside torch.topk, at the main path's shapes.

  python3 tempo_tpu_torch/search/kernels/bench_topk.py --root DIR \\
      --label NAME [--out FILE]

imports ``tempo_tpu_torch`` from DIR (this checkout, or an unpacked older
commit: the script uses only the wrappers' public calls), builds its
kernels, and prints one JSON object (also appended to FILE): per shape,
the card ms (CUDA events over calls back to back), the device ms
(torch.profiler's kernels, memsets and copies of 20 calls, summed), the
CUDA kernels and memsets the profiler saw per call, the wrapper's host
microseconds (time.perf_counter over 1,000 calls with no synchronise),
torch.topk's card ms over the same scores, and the check that the kernel
equals its plain version exactly. To compare two commits, run both in
one command on one card, in turns (old, new, new, old).

Inputs come from a seed: the score column mimics the tag cell's (64
blocks of 65,536 entries, block b's starts in [b * 600, b * 600 + 600)
seconds after one base second, 1 entry in 50 a match, the rest -1).
K9's lists are K2r outputs of such columns cut into S shards, gathered
as ``[S, 2, Q, k']`` as the exchange gathers them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BASE_S = 1_700_000_000


def tag_column(gen, n: int, match_every: int = 50):
    import torch

    blocks = max(1, n // 65_536)
    per = -(-n // blocks)
    b = torch.arange(n) // per
    start = BASE_S + b * 600 + torch.randint(0, 600, (n,), generator=gen)
    hit = torch.randint(0, match_every, (n,), generator=gen) == 0
    return torch.where(hit, start, torch.full_like(start, -1)).to(
        torch.int32)


def card_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def host_us(fn, reps: int = 1000) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def profile(fn, reps: int = 20) -> dict:
    """Device ms per call and the device events per call, by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_

    fn()
    torch.cuda.synchronize()
    with prof_(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
               acc_events=True) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in p.key_averages() if e.device_type == DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)]
    return {"device_ms": sum(e.self_device_time_total for e in ev)
            / reps / 1e3,
            "per_call": {e.key[:80]: e.count / reps for e in ev},
            "launches_per_call": sum(e.count for e in ev) / reps}


def measure(label: str) -> dict:
    import torch

    from tempo_tpu_torch.search.kernels import dist as dist_k
    from tempo_tpu_torch.search.kernels import topk

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(20261017)
    out = {"label": label, "card": torch.cuda.get_device_name(0)}

    def row(name, fn, plain, lib, reps=200):
        got = fn()
        want = plain()
        torch.cuda.synchronize()
        for g, w in zip(got, want, strict=True):
            if g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"{label} {name}: differs from its "
                                     "plain version")
        r = {"card_ms": card_ms(fn, reps), "library_ms": card_ms(lib, reps),
             "host_us": host_us(fn)}
        r.update(profile(fn))
        r["ratio"] = r["card_ms"] / r["library_ms"]
        out[name] = r
        print(f"{label} {name}: {json.dumps(r)}", flush=True)

    col = tag_column(gen, 4_194_304).to(dev)
    row("K2 n=4194304 k=128", lambda: topk.topk(col, 128),
        lambda: topk.topk_plain(col, 128), lambda: torch.topk(col, 128))
    row("K2 n=4194304 k=1024", lambda: topk.topk(col, 1024),
        lambda: topk.topk_plain(col, 1024), lambda: torch.topk(col, 1024))
    wal = tag_column(gen, 262_144).to(dev)
    row("K2 n=262144 k=128", lambda: topk.topk(wal, 128),
        lambda: topk.topk_plain(wal, 128), lambda: torch.topk(wal, 128))
    rows = torch.stack([tag_column(gen, 4_194_304, m)
                        for m in (50, 20, 100, 10, 200, 5, 400, 2)]).to(dev)
    row("K2r [8, 4194304] k=128", lambda: topk.topk_rows(rows, 128),
        lambda: topk.topk_rows_plain(rows, 128),
        lambda: torch.topk(rows, 128, dim=1), reps=50)
    for S, Q, kp, local in ((1, 1, 128, 1_048_576), (8, 8, 1024, 8192),
                            (4, 1, 128, 4096)):
        sc = tag_column(gen, S * Q * local).reshape(S, Q, local).to(dev)
        parts = [topk.topk_rows(sc[s].contiguous(), kp) for s in range(S)]
        cand = torch.stack([torch.stack(p) for p in parts])  # [S, 2, Q, kp]
        flat = cand[:, 0].permute(1, 0, 2).reshape(Q, S * kp).contiguous()
        if hasattr(dist_k, "shard_topk_gathered"):
            def fn(cand=cand, local=local, kp=kp):
                return dist_k.shard_topk_gathered(cand, local, kp)
        else:   # the exchange's call before the gathered entry existed
            def fn(cand=cand, local=local, kp=kp):
                return dist_k.shard_topk(cand[:, 0], cand[:, 1], local, kp)
        row(f"K9 [{S}, {Q}, {kp}]", fn,
            lambda cand=cand, local=local, kp=kp: dist_k.shard_topk_plain(
                cand[:, 0], cand[:, 1], local, kp),
            lambda flat=flat, kp=kp: torch.topk(flat, kp, dim=1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose tempo_tpu_torch to import")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_topk: no CUDA card", file=sys.stderr)
        return 2
    # this file's own directory must not shadow the checkout's modules
    sys.path = [p for p in sys.path
                if os.path.abspath(p or ".") != os.path.dirname(
                    os.path.abspath(__file__))]
    sys.path.insert(0, os.path.abspath(args.root))
    from tempo_tpu_torch.search.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    res = measure(args.label)
    res["build_s"] = build_s
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
