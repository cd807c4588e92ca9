#!/usr/bin/env python3
"""Drive the PyTorch port's backend tag search once on one CUDA card.

  python3 chip_smoke.py                  # full size, as a user would call it
  python3 chip_smoke.py --blocks 8 --traces-per-block 8192   # a quick check

What it does, in order, failing (exit code != 0, no result line) on any
error:

1. builds the port's CUDA kernels (tempo_tpu_torch/csrc/*.cu, one nvcc per
   source, started together) for sm_90a;
2. writes a seeded corpus through the port's write path
   (ColumnarPages.from_arrays -> write_search_pages, zlib) into a temporary
   LocalBackend: by default 256 blocks x 65,536 traces = 16.8M traces,
   1,024 entries per page, 8 tags per trace;
3. answers six requests through ``TempoDB.search`` on the card (launch
   counters set to 0 just before, read just after), each once warm and
   then timed, and prints p50/p95 latency and traces/s per request;
4. profiles three of the requests (torch.profiler) for the device time
   per request, and its idle share of the p50 latency;
5. answers the same requests through a second ``TempoDB`` on the CPU
   (the kernels' plain versions) and requires identical responses;
6. on one staged batch of the main path, holds kernel K1 (multi_scan) and
   K2 (topk) against their plain versions on the card — exact equality —
   and times kernel, plain version and, for K2, ``torch.topk``;
7. prints the kernels line, the card's name and power limit, and as the
   last line {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the tempo_tpu package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet

ENTRIES_PER_PAGE = 1024          # the reference's PageGeometry default
BASE_S = 1_700_000_000
BLOCK_SPAN_S = 600              # block b's traces start in [b*600, b*600+600)
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


def requests(blocks: int) -> dict:
    """name -> (tags, other SearchRequest fields). The exhaustive one
    scans every block (no pruning, no early quit) and runs first, so every
    group is staged before the others."""
    mid = BASE_S + (blocks // 2) * BLOCK_SPAN_S
    bench = {"service.name": "svc-007", "http.status_code": "500"}
    return {
        "exhaustive_bench": (dict(bench, **{"x-dbg-exhaustive": ""}),
                             {"limit": 20}),
        "bench_and": (bench, {"limit": 20}),
        "substring": ({"host.name": "host-01"}, {"limit": 20}),
        "duration": ({}, {"min_duration_ms": 59_000,
                          "max_duration_ms": 59_999, "limit": 20}),
        "window": ({}, {"start": mid + 300, "end": mid + 2 * BLOCK_SPAN_S,
                        "limit": 20}),
        "limit_1000": (bench, {"limit": 1000}),
    }


def make_block(seed: int, b: int, n: int, E: int):
    """Block b's columns, from the seed, as the port's ColumnarPages."""
    import numpy as np

    from tempo_tpu_torch.search.columnar import ColumnarPages

    rng = np.random.default_rng([seed, b])
    key_dict = sorted(KEYS)
    val_dict = sorted({v for vs in KEYS.values() for v in vs})
    vidx = {v: i for i, v in enumerate(val_dict)}
    P = -(-n // E)
    C = len(key_dict)
    kv_key = np.broadcast_to(np.arange(C, dtype=np.int32), (P, E, C)).copy()
    kv_val = np.empty((P, E, C), dtype=np.int32)
    for j, k in enumerate(key_dict):
        ids = np.asarray([vidx[v] for v in KEYS[k]], dtype=np.int32)
        kv_val[:, :, j] = ids[rng.integers(0, len(ids), size=(P, E))]
    start = (BASE_S + b * BLOCK_SPAN_S
             + rng.integers(0, BLOCK_SPAN_S, size=(P, E))).astype(np.uint32)
    dur = rng.integers(1, 60_000, size=(P, E)).astype(np.uint32)
    end = (start + dur // 1000).astype(np.uint32)
    valid = (np.arange(P * E) < n).reshape(P, E)
    kv_key[~valid] = -1
    kv_val[~valid] = -1
    start[~valid] = end[~valid] = dur[~valid] = 0
    trace_ids = np.frombuffer(rng.bytes(P * E * 16),
                              dtype=np.uint8).reshape(P, E, 16)
    svc = kv_val[:, :, key_dict.index("service.name")]
    name = kv_val[:, :, key_dict.index("name")]
    return ColumnarPages.from_arrays(key_dict, val_dict, kv_key, kv_val,
                                     start, end, dur, valid, svc, name,
                                     trace_ids)


def write_corpus(root: str, blocks: int, n: int, E: int, seed: int) -> int:
    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.backend.types import BlockMeta
    from tempo_tpu_torch.search.backend_search_block import \
        write_search_pages

    be = LocalBackend(root)

    def one(b):
        pages = make_block(seed, b, n, E)
        meta = BlockMeta(tenant_id="smoke",
                         block_id=f"00000000-0000-4000-8000-{b:012d}",
                         start_time=int(pages.header["min_start_s"]),
                         end_time=int(pages.header["max_end_s"]),
                         total_objects=n)
        return write_search_pages(be, meta, pages, "zlib")["compressed_size"]

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=os.cpu_count() or 4) as ex:
        return sum(ex.map(one, range(blocks)))


def run_queries(db, reqs: dict, reps: int) -> dict:
    """Each request once warm, then `reps` timed runs. Returns per request
    the response of the warm run and the timings."""
    import torch

    from tempo_tpu_torch.model.types import SearchRequest

    out = {}
    for name, (tags, kw) in reqs.items():
        req = SearchRequest(tags=dict(tags), **kw)
        t0 = time.perf_counter()
        resp = db.search("smoke", req).response()
        first_s = time.perf_counter() - t0
        dispatches = db.batcher.last_dispatches
        lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            again = db.search("smoke", req).response()
            if db.device.type == "cuda":
                torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            if again != resp:
                raise AssertionError(f"{name}: repeated search differs")
        out[name] = {"resp": resp, "first_s": first_s, "lat": sorted(lat),
                     "dispatches": dispatches}
    return out


def check_response(name: str, resp, tags: dict, kw: dict, n_total: int):
    """Every returned trace satisfies the request, the order is newest
    first, and the metrics are consistent."""
    m = resp.metrics
    if m.inspected_traces > n_total or m.inspected_traces < 0:
        raise AssertionError(f"{name}: inspected {m.inspected_traces}")
    limit = kw.get("limit") or 20
    if len(resp.traces) > limit:
        raise AssertionError(f"{name}: {len(resp.traces)} > limit {limit}")
    starts = [t.start_time_unix_nano for t in resp.traces]
    if starts != sorted(starts, reverse=True):
        raise AssertionError(f"{name}: results not newest first")
    for t in resp.traces:
        s = t.start_time_unix_nano // 1_000_000_000
        if kw.get("end") and s > kw["end"]:
            raise AssertionError(f"{name}: start {s} after window")
        lo, hi = kw.get("min_duration_ms", 0), kw.get("max_duration_ms", 0)
        if (lo and t.duration_ms < lo) or (hi and t.duration_ms > hi):
            raise AssertionError(f"{name}: duration {t.duration_ms}")
        svc = tags.get("service.name")
        if svc and svc not in t.root_service_name:
            raise AssertionError(f"{name}: root service "
                                 f"{t.root_service_name}")
    if tags.get("x-dbg-exhaustive") is not None and m.inspected_traces \
            != n_total:
        raise AssertionError(f"{name}: exhaustive scan inspected "
                             f"{m.inspected_traces} of {n_total}")


def device_busy(db, reqs: dict, names, reps: int) -> dict:
    """Device time per request from torch.profiler (kernels and copies on
    the card, summed) over `reps` warm runs of each named request. A
    profiler that records no device activity gives None ("not
    measured"), never a number taken from the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tempo_tpu_torch.model.types import SearchRequest

    out = {}
    for name in names:
        tags, kw = reqs[name]
        req = SearchRequest(tags=dict(tags), **kw)
        db.search("smoke", req)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                db.search("smoke", req)
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.key_averages():
            # device-side events only (kernels, copies, sets): a CPU op's
            # self device time counts its kernels a second time
            if e.device_type != DeviceType.CUDA \
                    or getattr(e, "is_user_annotation", False):
                continue
            if e.self_device_time_total > 0:
                by_name[e.key] = e.self_device_time_total / reps / 1e3
        total = sum(by_name.values())
        out[name] = {"device_ms": total if total > 0 else None,
                     "by_kernel_ms": by_name}
    return out


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the current stream (CUDA
    events around `reps` back-to-back calls, after one warm call)."""
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


def sector_bytes(mask, item_bytes: int) -> int:
    """Bytes of the 32-byte memory sectors holding the elements of a
    contiguous tensor of `item_bytes` items (1, 2 or 4: each item lies in
    one sector) where `mask` is true."""
    import torch

    m = mask.reshape(-1)
    per = 32 // item_bytes
    if m.numel() % per:
        m = torch.cat([m, m.new_zeros(per - m.numel() % per)])
    return int(m.reshape(-1, per).any(dim=1).sum()) * 32


def k1_bytes(args, scores) -> int:
    """The bytes K1's function must move on these inputs, counted in the
    sectors this run's data touches: the valid flags and page ids read and
    the scores and counts written, all; each live entry's key slots; the
    value slots whose key a term names, for entries still alive at that
    term, up to the first in range; and for entries that pass the terms,
    the u32 columns their bounds need (duration and window end only when
    the bound excludes some value; start always, for the score)."""
    import torch

    (kv_key, kv_val, start, end, dur, valid, page_block, term_keys,
     val_ranges, n_terms, dur_lo, dur_hi, win_start, win_end) = args
    u32 = 0xFFFFFFFF
    pb = page_block.long()
    safe = pb.clamp(min=0)
    live = valid & (pb >= 0)[:, None]
    alive = live.clone()
    need_val = torch.zeros_like(kv_key, dtype=torch.bool)
    if n_terms:
        kk, vv = kv_key.int(), kv_val.int()
        slot = torch.arange(kk.shape[2], device=kk.device)
        for t in range(n_terms):
            keym = (kk == term_keys[safe, t][:, None, None]) & alive[..., None]
            inr = torch.zeros_like(keym)
            for r in range(val_ranges.shape[2]):
                inr |= ((vv >= val_ranges[safe, t, r, 0][:, None, None])
                        & (vv <= val_ranges[safe, t, r, 1][:, None, None]))
            hit = keym & inr
            first = torch.where(hit.any(-1), hit.int().argmax(-1),
                                kk.shape[2])
            need_val |= keym & (slot <= first[..., None])
            alive &= hit.any(-1)
    n = valid.numel()
    total = n + page_block.numel() * 4 + n * 4 + 8   # valid, pages, out
    total += term_keys.numel() * 4 + val_ranges.numel() * 4
    if n_terms:
        total += sector_bytes(live[..., None].expand_as(kv_key).contiguous(),
                              kv_key.element_size())
        total += sector_bytes(need_val, kv_val.element_size())
    if dur_lo != 0 or dur_hi != u32:
        total += sector_bytes(alive, 4)
        d = dur.long() & u32
        alive &= (d >= dur_lo) & (d <= dur_hi)
    if win_start != 0:
        total += sector_bytes(alive, 4)
        alive &= (end.long() & u32) >= win_start
    total += sector_bytes(alive, 4)
    alive &= (start.long() & u32) <= win_end
    if not torch.equal(alive.reshape(-1), scores >= 0):
        raise AssertionError("k1_bytes: its predicate differs from K1's")
    return total


def kernel_phase(db, reqs: dict, launches: dict) -> list:
    """K1 and K2 against their plain versions on one staged batch of the
    main path (the largest), at the main path's shapes; exact equality."""
    import torch

    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search.engine import resolve_top_k
    from tempo_tpu_torch.search.kernels import scan, topk
    from tempo_tpu_torch.search.multiblock import compile_multi

    cached = max(db.batcher._cache.values(), key=lambda c: c.batch.n_pages)
    batch = cached.batch
    d = batch.device
    tags, kw = reqs["bench_and"]
    req = SearchRequest(tags=dict(tags), **kw)
    mq = compile_multi(list(batch.blocks), req, memo=batch.memo,
                       cache=db.batcher.engine.compile_cache)
    tk = torch.from_numpy(mq.term_keys).to(db.device)
    vr = torch.from_numpy(mq.val_ranges).to(db.device)
    bounds = (mq.dur_lo, min(mq.dur_hi, 0xFFFFFFFF), mq.win_start,
              min(mq.win_end, 0xFFFFFFFF))
    args = (d["kv_key"], d["kv_val"], d["entry_start"], d["entry_end"],
            d["entry_dur"], d["entry_valid"], d["page_block"], tk, vr,
            mq.n_terms, *bounds)
    scores, counts = scan.multi_scan(*args)
    p_scores, p_counts = scan.multi_scan_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(counts, p_counts) or not torch.equal(scores, p_scores):
        raise AssertionError("K1 differs from its plain version: "
                             f"{counts.tolist()} vs {p_counts.tolist()}")
    k1_err = int((scores.long() - p_scores.long()).abs().max())
    k2_err = 0
    k = resolve_top_k(128, req.limit)
    # the main path's k, a limit-1000 request's k, a k past the shared-
    # memory sort (global bitonic stages), and k > N on a short column
    short = scores[:1000].contiguous()
    for col, kk in ((scores, k), (scores, 1024), (scores, 8192),
                    (short, 4096)):
        s, i = topk.topk(col, kk)
        ps, pi = topk.topk_plain(col, kk)
        torch.cuda.synchronize()
        if not (torch.equal(s, ps) and torch.equal(i, pi)):
            raise AssertionError(f"K2 (n={col.numel()}, k={kk}) differs "
                                 "from its plain version")
        ls, _li = torch.topk(col, min(kk, col.numel()))
        if not torch.equal(torch.sort(ls).values, torch.sort(s).values):
            raise AssertionError(f"K2 (n={col.numel()}, k={kk}) scores "
                                 "differ from torch.topk's")
        k2_err = max(k2_err, int((s.long() - ps.long()).abs().max()))

    n = scores.numel()
    k1_need = k1_bytes(args, scores)
    k2_bytes = n * 4 + k * 8                       # scores read, top-k written
    k1_ms = cuda_ms(lambda: scan.multi_scan(*args), 50)
    k1_plain = cuda_ms(lambda: scan.multi_scan_plain(*args), 5)
    k2_ms = cuda_ms(lambda: topk.topk(scores, k), 50)
    k2_plain = cuda_ms(lambda: topk.topk_plain(scores, k), 10)
    k2_lib = cuda_ms(lambda: torch.topk(scores, k), 50)
    shape = {"pages": batch.n_pages, "entries": n,
             "kv_dtypes": [str(d["kv_key"].dtype), str(d["kv_val"].dtype)],
             "C": int(d["kv_key"].shape[2]), "n_terms": mq.n_terms,
             "R": int(mq.val_ranges.shape[2]), "k": k,
             "match_count": int(counts[0]), "inspected": int(counts[1]),
             "bytes_needed": k1_need}
    return [
        {"name": "multi_scan", "route": "cuda",
         "source": "tempo_tpu_torch/csrc/scan.cu",
         "replaces": "tempo_tpu/search/multiblock.py:855",
         "launches": launches["multi_scan"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_need / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None, "shape": shape},
        {"name": "topk", "route": "cuda",
         "source": "tempo_tpu_torch/csrc/topk.cu",
         "replaces": "tempo_tpu/search/engine.py:295",
         "launches": launches["topk"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": k2_lib, "shape": {"n": n, "k": k}},
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=256)
    ap.add_argument("--traces-per-block", type=int, default=65_536)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--report", default=None,
                    help="also write the full report (timings, shapes, "
                         "nvcc/ptxas output) as JSON to this path")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.search.kernels import build, scan, topk

    report: dict = {"args": vars(args)}

    t0 = time.perf_counter()
    build.build_all()
    report["build_s"] = time.perf_counter() - t0
    report["build_log"] = dict(build.BUILD_LOG)
    print(f"build: {report['build_s']:.1f} s "
          f"({', '.join(sorted(build.BUILD_LOG)) or 'cached'})", flush=True)

    n_total = args.blocks * args.traces_per_block
    reqs = requests(args.blocks)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    dbs = []
    try:
        t0 = time.perf_counter()
        nbytes = write_corpus(os.path.join(work, "blocks"), args.blocks,
                              args.traces_per_block, ENTRIES_PER_PAGE,
                              args.seed)
        report["corpus"] = {"blocks": args.blocks, "traces": n_total,
                            "compressed_bytes": nbytes,
                            "write_s": time.perf_counter() - t0}
        print(f"corpus: {args.blocks} blocks, {n_total} traces, "
              f"{nbytes / 1e6:.1f} MB zlib, "
              f"{report['corpus']['write_s']:.1f} s", flush=True)

        cfg = TempoDBConfig(search_max_batch_pages=4096)
        gpu = TempoDB(LocalBackend(os.path.join(work, "blocks")), cfg,
                      device="cuda")
        dbs.append(gpu)
        gpu.poll()
        torch.cuda.reset_peak_memory_stats()
        scan.LAUNCHES.reset()
        topk.LAUNCHES.reset()
        res = run_queries(gpu, reqs, args.reps)       # the main path
        launches = {"multi_scan": scan.LAUNCHES.n, "topk": topk.LAUNCHES.n}
        report["launches"] = launches
        report["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        report["staged_device_bytes"] = gpu.batcher._cache_total
        if launches["multi_scan"] == 0 or launches["topk"] == 0:
            raise AssertionError(f"main path launched no kernel: {launches}")
        lat_report = {}
        for name, r in res.items():
            tags, kw = reqs[name]
            check_response(name, r["resp"], tags, kw, n_total)
            lat = r["lat"]
            p50 = lat[len(lat) // 2]
            p95 = lat[min(len(lat) - 1, int(len(lat) * 0.95))]
            m = r["resp"].metrics
            lat_report[name] = {
                "p50_ms": p50 * 1e3, "p95_ms": p95 * 1e3,
                "first_ms": r["first_s"] * 1e3,
                "traces_per_s": m.inspected_traces / p50 if p50 else None,
                "inspected_traces": m.inspected_traces,
                "inspected_blocks": m.inspected_blocks,
                "skipped_blocks": m.skipped_blocks,
                "results": len(r["resp"].traces),
                "dispatches": r["dispatches"]}
            print(f"search {name}: first {r['first_s'] * 1e3:.2f} ms, "
                  f"p50 {p50 * 1e3:.2f} ms, p95 "
                  f"{p95 * 1e3:.2f} ms, {m.inspected_traces} traces "
                  f"inspected ({m.inspected_traces / p50:.4g} traces/s), "
                  f"{m.inspected_blocks} blocks, {m.skipped_blocks} "
                  f"skipped, {len(r['resp'].traces)} results, "
                  f"{r['dispatches']} dispatches", flush=True)
        report["search"] = lat_report
        print("launches during the searches: " + json.dumps(launches),
              flush=True)

        busy = device_busy(gpu, reqs, ("exhaustive_bench", "bench_and",
                                       "limit_1000"), args.reps)
        report["device_busy"] = busy
        for name, b in busy.items():
            p50 = lat_report[name]["p50_ms"]
            if b["device_ms"] is None:
                print(f"device busy {name}: not measured (the profiler "
                      "recorded no device activity)", flush=True)
                continue
            b["idle_share_of_p50"] = max(0.0, 1 - b["device_ms"] / p50)
            print(f"device busy {name}: {b['device_ms']:.3f} ms per request "
                  f"(profiler) of {p50:.3f} ms p50, idle share "
                  f"{b['idle_share_of_p50']:.2f}", flush=True)

        t0 = time.perf_counter()
        cpu = TempoDB(LocalBackend(os.path.join(work, "blocks")), cfg,
                      device="cpu")
        dbs.append(cpu)
        cpu.poll()
        cres = run_queries(cpu, reqs, 0)
        for name in reqs:
            if cres[name]["resp"] != res[name]["resp"]:
                raise AssertionError(f"{name}: card and CPU responses "
                                     "differ")
        report["cpu_check_s"] = time.perf_counter() - t0
        print(f"cpu check: {len(reqs)} responses identical "
              f"({report['cpu_check_s']:.1f} s)", flush=True)

        kernels = kernel_phase(gpu, reqs, launches)
        report["kernels"] = kernels
    finally:
        for db in dbs:
            db.close()
        shutil.rmtree(work, ignore_errors=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    report["nvidia_smi"] = smi
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": [{k: v for k, v in kr.items()
                                   if k != "shape"} for kr in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
