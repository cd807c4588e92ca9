"""Time the structural kernel K6 of one checkout of the port on one CUDA
card, at the structural cell's shape, against its plain version.

  python3 tempo_tpu_torch/search/kernels/bench_structural.py --root DIR \\
      --label NAME [--out FILE]

imports ``tempo_tpu_torch`` from DIR (this checkout, or an unpacked older
commit: the script stages and compiles through the package's own
``MultiBlockEngine.stage_host``, ``place_batch`` and
``structural.compile_structural``, and calls only the wrapper's public
``structural_mask``), builds its kernels, and prints one JSON object (also
appended to FILE): per plan, the card ms (CUDA events around 20 calls
back to back), the device ms (the median of 20 single calls, each
between two CUDA events with the stream synchronised around it and held
by a spin kernel while the host issues the call), the
bound (the bytes K6's function must move over 3.35 TB/s), the plain
version's ms, and whether the kernel's verdicts equal the plain
version's exactly. To compare two commits, run both in one command on
one card, in turns (old, new, new, old).

The corpus comes from a seed and has the structural cell's shape: 16
blocks of 65,536 traces (1,024 pages of 1,024 entries, C = 8 tag slots),
1-31 spans a trace (~16.8M), Cs = 4 span tag slots, durations and kinds.
The plans are the cell's: the exact desc plan, the exact quantile plan,
and eight plans of one canonical bucket as one Q = 8 launch.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
E = 1024
BLOCKS = 16
TRACES = 65_536
SEED = 20261017
BASE_S = 1_700_000_000
KEYS = {
    "component": [f"comp-{i}" for i in range(4)],
    "host.name": [f"host-{i:04d}" for i in range(2000)],
    "http.method": ["DELETE", "GET", "PATCH", "POST", "PUT"],
    "http.status_code": ["200", "201", "204", "301", "400", "404", "500",
                         "503"],
    "k8s.namespace": [f"ns-{i:02d}" for i in range(16)],
    "name": [f"op-{i:02d}" for i in range(32)],
    "region": ["ap-south-1", "eu-central-1", "eu-west-1", "us-east-1",
               "us-west-1", "us-west-2"],
    "service.name": [f"svc-{i:03d}" for i in range(64)],
}
SPAN_OPS = [f"op-{i}" for i in range(16)]
PLANS = {
    "desc": {"desc": {"anc": {"tag": {"k": "service.name", "v": "svc-001"}},
                      "span": {"kind": "client"}}},
    "quantile": {"quantile": {"of": {"dur": {"min_ms": 0}}, "q": "0.9",
                              "op": ">=", "ms": 500}},
}
BUCKET_PLANS = [
    {"child": {"parent": {"tag": {"k": "service.name", "v": "svc-000"}},
               "child": {"dur": {"min_ms": 500}}}},
    {"desc": {"anc": {"tag": {"k": "service.name", "v": "svc-001"}},
              "span": {"kind": 3}}},
    {"child": {"parent": {"kind": 2}, "child": {"tag": {"k": "name",
                                                        "v": "op-1"}}}},
    {"desc": {"anc": {"dur": {"min_ms": 1500}},
              "span": {"tag": {"k": "service.name", "v": "svc-003"}}}},
    {"child": {"parent": {"tag": {"k": "service.name", "v": "svc-004"}},
               "child": {"kind": 1}}},
    {"desc": {"anc": {"kind": 4}, "span": {"dur": {"min_ms": 1000}}}},
    {"child": {"parent": {"dur": {"max_ms": 10}},
               "child": {"tag": {"k": "name", "v": "op-7"}}}},
    {"desc": {"anc": {"tag": {"k": "service.name", "v": "svc-007"}},
              "span": {"tag": {"k": "name", "v": "op-3"}}}},
]


def make_block(b: int):
    """Block b as ColumnarPages with its span segment: 8 tag slots a
    trace, 1-31 spans a trace (span 0 the root, each later span's parent a
    random earlier span of its trace or, 1 in 20, none), service.name,
    name and http.status_code per span (Cs = 4, the last a pad), 1-2,000
    ms, kind 0-5."""
    import numpy as np

    from tempo_tpu_torch.search.columnar import ColumnarPages

    rng = np.random.default_rng([SEED, b])
    val_dict = sorted({v for vs in KEYS.values() for v in vs}
                      | set(SPAN_OPS))
    vidx = {v: i for i, v in enumerate(val_dict)}
    key_dict = sorted(KEYS)
    P, C, n = TRACES // E, len(key_dict), TRACES
    kv_key = np.broadcast_to(np.arange(C, dtype=np.int32), (P, E, C)).copy()
    kv_val = np.empty((P, E, C), dtype=np.int32)
    for c, k in enumerate(key_dict):
        ids = np.asarray([vidx[v] for v in KEYS[k]], dtype=np.int32)
        kv_val[:, :, c] = ids[rng.integers(0, len(ids), size=(P, E))]
    start = (BASE_S + b * 600 + rng.integers(0, 600, size=(P, E))).astype(
        np.uint32)
    dur = rng.integers(1, 60_000, size=(P, E)).astype(np.uint32)
    end = (start + dur // 1000).astype(np.uint32)
    valid = np.ones((P, E), dtype=bool)
    counts = rng.integers(1, 32, size=n)
    S = int(counts.sum())
    first = np.repeat(np.cumsum(counts) - counts, counts)
    local = np.arange(S) - first
    parent = np.where(local > 0, first + (rng.random(S) * local)
                      .astype(np.int64), -1)
    parent[(local > 0) & (rng.random(S) < 0.05)] = -1
    skk = np.full((S, 4), -1, dtype=np.int32)
    svv = np.full((S, 4), -1, dtype=np.int32)
    for c, k in enumerate(("http.status_code", "name", "service.name")):
        vals = SPAN_OPS if k == "name" else KEYS[k]
        ids = np.asarray([vidx[v] for v in vals], dtype=np.int32)
        skk[:, c] = key_dict.index(k)
        svv[:, c] = ids[rng.integers(0, len(ids), size=S)]
    spans = {"span_trace": np.repeat(np.arange(n, dtype=np.int32), counts),
             "span_parent": parent.astype(np.int32),
             "span_dur": rng.integers(1, 2001, size=S).astype(np.uint32),
             "span_kind": rng.integers(0, 6, size=S).astype(np.int8),
             "span_kv_key": skk, "span_kv_val": svv,
             "entry_span_begin": (np.cumsum(counts) - counts).astype(
                 np.int32).reshape(P, E),
             "entry_span_count": counts.astype(np.int32).reshape(P, E)}
    trace_ids = np.frombuffer(rng.bytes(P * E * 16),
                              dtype=np.uint8).reshape(P, E, 16)
    svc = kv_val[:, :, key_dict.index("service.name")].copy()
    name = kv_val[:, :, key_dict.index("name")]
    return ColumnarPages.from_arrays(
        key_dict, val_dict, kv_key, kv_val, start, end, dur, valid, svc,
        name, trace_ids, spans=spans)


def k6_bytes(d: dict, spans: dict | None, lanes, n_out: int) -> int:
    """The bytes K6's function must move (chip_smoke.py's rule): per real
    span the span columns the lanes' programs read (span_trace always;
    span_block and kv slots for a tag leaf, durations for a dur leaf or a
    quantile, kind for a kind leaf, parents for child/desc), every
    entry's valid flag and span run (begin, count), the page ids, the
    entry columns a trace leaf reads (kv slots, durations), the programs
    and tables, and the verdicts written, one byte per entry and lane."""
    import numpy as np

    sops = set(np.unique(lanes.span_prog[:, :, 0]).tolist())
    tops = set(np.unique(lanes.trace_prog[:, :, 0]).tolist())
    P, E_ = d["entry_valid"].shape
    total = P * E_ + P * 4 + n_out
    total += sum(int(a.nbytes) for a in (
        lanes.span_prog, lanes.trace_prog, lanes.term_keys,
        lanes.val_ranges, lanes.dur_params, lanes.kind_params,
        lanes.agg_params))
    if spans is not None:
        S = int(spans["entry_span_count"].sum())
        per = 4
        if 1 in sops:
            per += 4 + 2 * 4 * int(spans["span_kv_key"].shape[1])
        if 2 in sops or 5 in tops:
            per += 4
        if 3 in sops:
            per += 1
        if sops & {7, 8}:
            per += 4
        total += S * per + P * E_ * 8
    if 1 in tops:
        total += sum(t.numel() * t.element_size()
                     for t in (d["kv_key"], d["kv_val"]))
    if 2 in tops:
        total += d["entry_dur"].numel() * d["entry_dur"].element_size()
        if "entry_dur_res" in d:
            total += d["entry_dur_res"].numel()
    return total


def card_ms(fn, reps: int) -> float:
    """Mean ms a call, CUDA events around `reps` calls back to back."""
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


def event_ms(fn, reps: int = 20) -> float:
    """Median device ms of `reps` single calls, each between two CUDA
    events with the stream synchronised before and after and held by a
    spin kernel while the host issues the call."""
    import torch

    fn()
    out = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        # a spin of ~1 ms holds the stream while the host issues the call,
        # so that t0 fires with the call queued behind it
        torch.cuda._sleep(2_000_000)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1))
    return statistics.median(out)


def measure(label: str) -> dict:
    import torch

    from tempo_tpu_torch.search import ir, structural
    from tempo_tpu_torch.search.kernels import structural as k6
    from tempo_tpu_torch.search.multiblock import (MultiBlockEngine,
                                                   place_batch)

    dev = torch.device("cuda", 0)
    out = {"label": label, "card": torch.cuda.get_device_name(0)}
    t0 = time.perf_counter()
    blocks = [make_block(b) for b in range(BLOCKS)]
    cfg = structural.StructuralConfig(True)
    eng = MultiBlockEngine(dev, structural_cfg=cfg)
    batch = place_batch(eng.stage_host(blocks), dev)
    out["corpus_s"] = time.perf_counter() - t0
    d = batch.device
    out["shape"] = {"pages": batch.n_pages,
                    "spans": int(batch.span_device["entry_span_count"]
                                 .sum()),
                    "max_run": batch.span_max_run}

    def compiled(plan):
        return structural.compile_structural(
            ir.parse(json.dumps(plan)), blocks,
            staged_dicts=batch.staged_dicts, memo=batch.memo)

    bucket = structural.stack_members([compiled(p) for p in BUCKET_PLANS],
                                      cfg.bucket_max_nodes)
    if not isinstance(bucket, structural.BucketedStructural):
        raise AssertionError("the bucket plans did not stack as a bucket")
    lanes_of = {"desc": compiled(PLANS["desc"]).lanes(),
                "quantile": compiled(PLANS["quantile"]).lanes(),
                "bucketed Q=8": bucket.lanes}
    for name, lanes in lanes_of.items():
        args = (d["kv_key"], d["kv_val"], d["entry_dur"], d["entry_valid"],
                d["page_block"], batch.span_device, batch.span_max_run,
                lanes.device(dev), lanes.val_hits, batch.widths,
                d.get("entry_dur_res"))

        def fn(args=args):
            return k6.structural_mask(*args)

        got = fn()
        want = k6.structural_mask_plain(*args)
        torch.cuda.synchronize()
        need = k6_bytes(d, batch.span_device, lanes, got.numel())
        r = {"card_ms": card_ms(fn, 20), "device_ms": event_ms(fn),
             "bound_ms": need / HBM_BYTES_PER_S * 1e3, "bytes": need,
             "plain_ms": card_ms(lambda a=args: k6.structural_mask_plain(
                 *a), 3),
             "exact": bool(got.shape == want.shape
                           and torch.equal(got, want)),
             "verdicts": int(got.sum())}
        out[name] = r
        print(f"{label} {name}: {json.dumps(r)}", flush=True)
        if not r["exact"]:
            raise AssertionError(f"{label} {name}: K6 differs from its "
                                 "plain version")
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
        print("bench_structural: no CUDA card", file=sys.stderr)
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
