#!/usr/bin/env python3
"""Drive the PyTorch port's backend tag search once on one CUDA card.

  python3 chip_smoke.py                  # full size, as a user would call it
  python3 chip_smoke.py --blocks 8 --traces-per-block 8192 \\
      --hc-blocks 2 --hc-traces-per-block 131072     # a quick check

What it does, in order, failing (exit code != 0, no result line) on any
error:

1. builds the port's CUDA kernels (tempo_tpu_torch/csrc/*.cu, one nvcc per
   source, started together) for sm_90a;
2. the tag-search cell: writes a seeded corpus through the port's write
   path (ColumnarPages.from_arrays -> write_search_pages, zlib) into a
   temporary LocalBackend, by default 256 blocks x 65,536 traces = 16.8M
   traces, 1,024 entries per page, 8 tags per trace; answers six requests
   through ``TempoDB.search`` on the card (launch counters set to 0 just
   before, read just after), each once warm and then timed; profiles three
   of them (torch.profiler) for device time and idle share; answers them
   again through a ``TempoDB`` on the CPU (the kernels' plain versions)
   and requires identical responses; then holds K1 (multi_scan, range
   mode) and K2 (topk) against their plain versions on the card and times
   them; then K4 (coalesced_scan, range mode) on 8 stacked requests and
   K2r (topk_rows) at k = 128 and 1024, and a fused dispatch against the
   members' solo dispatches; then the concurrent phase (below) with 8
   bench requests and with 8 exhaustive ones, and the bench request alone
   once more;
3. the high-cardinality cell: 10 blocks x 1,048,576 traces, each trace
   with the 8 tags and a ``session.id`` unique across the corpus (~1.05M
   distinct values per block dictionary, so every block stages its
   dictionary for the device probe at the default 50k threshold); answers
   four requests through ``TempoDB.search``, one through
   ``TempoDB.search_block`` and two through ``BackendSearchBlock.search``
   (the single-block engine), each cold then 10 times warm, with launch
   counts per request; profiles three; requires the CPU path's responses;
   then holds K3 (dict_probe), K1 in hit-mask mode and K1s (scan_single)
   against their plain versions on the card and times them; then K4 in
   hit-mask mode on 6 probed and 2 host-compiled requests, with the fused
   dispatch against the solo ones; then the concurrent phase with 8
   exhaustive session-id substrings, and the point lookup alone once
   more;
4. prints the kernels line, the card's name and power limit, and as the
   last line {"ok": true, "device": {...}}.

The concurrent phase: 8 client threads, barrier-started, send one
request each per round, one warm-up round and then ``--rounds`` timed
ones, through a ``TempoDB`` with the default query coalescer and through
a second one over the same blocks with coalescing off
(``search_coalesce_max_queries=1``). Every response must equal the
serial response of the same request. It prints round and request
latencies, launches per kernel and the coalescer's queries per
dispatch.

It imports nothing of JAX and nothing of the tempo_tpu package.
"""

from __future__ import annotations

import argparse
import bisect
import concurrent.futures
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
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
SESSION_KEY = "session.id"      # the high-cardinality cell's ninth tag
POINT_SESSION = 123_456         # the point lookup's session number
BENCH = {"service.name": "svc-007", "http.status_code": "500"}
KERNELS = ("multi_scan", "multi_scan_hits", "scan_single", "topk",
           "dict_probe", "coalesced_scan", "coalesced_scan_hits",
           "topk_rows")
CLIENTS = 8                     # concurrent clients
# the concurrent clients' predicates: one service each, AND status 500
CONCURRENT_TAGS = [{"service.name": f"svc-00{i}", "http.status_code": "500"}
                   for i in range(CLIENTS)]
# the high-cardinality cell's concurrent session.id substrings
HC_SESSIONS = ("77", "123", "404", "5555", "0012", "99", "31", "808")
EXHAUSTIVE = {"x-dbg-exhaustive": ""}


def requests(blocks: int) -> dict:
    """name -> (tags, other SearchRequest fields). The exhaustive one
    scans every block (no pruning, no early quit) and runs first, so every
    group is staged before the others."""
    mid = BASE_S + (blocks // 2) * BLOCK_SPAN_S
    return {
        "exhaustive_bench": (dict(BENCH, **{"x-dbg-exhaustive": ""}),
                             {"limit": 20}),
        "bench_and": (BENCH, {"limit": 20}),
        "substring": ({"host.name": "host-01"}, {"limit": 20}),
        "duration": ({}, {"min_duration_ms": 59_000,
                          "max_duration_ms": 59_999, "limit": 20}),
        "window": ({}, {"start": mid + 300, "end": mid + 2 * BLOCK_SPAN_S,
                        "limit": 20}),
        "limit_1000": (BENCH, {"limit": 1000}),
    }


def hc_requests() -> dict:
    """The high-cardinality cell's batched requests, in the order they
    run: the exhaustive one stages every group."""
    return {
        "hc_exhaustive_77": ({SESSION_KEY: "77", "x-dbg-exhaustive": ""},
                             {"limit": 20}),
        "hc_point": ({SESSION_KEY: f"session-{POINT_SESSION:08d}"},
                     {"limit": 20}),
        "hc_prefix": ({SESSION_KEY: f"session-{POINT_SESSION // 10:07d}"},
                      {"limit": 20}),
        "hc_77_and_svc": ({SESSION_KEY: "77", "service.name": "svc-007"},
                          {"limit": 20}),
    }


def make_block(seed: int, b: int, n: int, E: int, sessions: bool = False):
    """Block b's columns, from the seed, as the port's ColumnarPages. With
    `sessions`, every trace also carries session.id "session-%08d", unique
    across blocks of n traces, in a seeded order."""
    import numpy as np

    from tempo_tpu_torch.search.columnar import ColumnarPages

    rng = np.random.default_rng([seed, b])
    base_vals = sorted({v for vs in KEYS.values() for v in vs})
    key_dict = sorted(list(KEYS) + ([SESSION_KEY] if sessions else []))
    # no base value starts with "session-", so the sessions (zero-padded,
    # numeric order = string order) form one run of the sorted dictionary
    lo = bisect.bisect_left(base_vals, "session-")
    n_sess = n if sessions else 0
    first = b * n
    val_dict = (base_vals[:lo]
                + [f"session-{first + k:08d}" for k in range(n_sess)]
                + base_vals[lo:])
    vidx = {v: (i if i < lo else i + n_sess)
            for i, v in enumerate(base_vals)}
    P = -(-n // E)
    C = len(key_dict)
    kv_key = np.broadcast_to(np.arange(C, dtype=np.int32), (P, E, C)).copy()
    kv_val = np.empty((P, E, C), dtype=np.int32)
    for k in KEYS:
        ids = np.asarray([vidx[v] for v in KEYS[k]], dtype=np.int32)
        kv_val[:, :, key_dict.index(k)] = ids[
            rng.integers(0, len(ids), size=(P, E))]
    start = (BASE_S + b * BLOCK_SPAN_S
             + rng.integers(0, BLOCK_SPAN_S, size=(P, E))).astype(np.uint32)
    dur = rng.integers(1, 60_000, size=(P, E)).astype(np.uint32)
    end = (start + dur // 1000).astype(np.uint32)
    valid = (np.arange(P * E) < n).reshape(P, E)
    if sessions:
        col = np.full(P * E, -1, dtype=np.int32)
        col[:n] = lo + rng.permutation(n).astype(np.int32)
        kv_val[:, :, key_dict.index(SESSION_KEY)] = col.reshape(P, E)
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


def block_id(b: int) -> str:
    return f"00000000-0000-4000-8000-{b:012d}"


def write_corpus(root: str, tenant: str, blocks: int, n: int, E: int,
                 seed: int, sessions: bool = False) -> int:
    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.backend.types import BlockMeta
    from tempo_tpu_torch.search.backend_search_block import \
        write_search_pages

    be = LocalBackend(root)

    def one(b):
        pages = make_block(seed, b, n, E, sessions)
        meta = BlockMeta(tenant_id=tenant, block_id=block_id(b),
                         start_time=int(pages.header["min_start_s"]),
                         end_time=int(pages.header["max_end_s"]),
                         total_objects=n)
        return write_search_pages(be, meta, pages, "zlib")["compressed_size"]

    workers = min(os.cpu_count() or 4, 4 if sessions else 32)
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        return sum(ex.map(one, range(blocks)))


def counters() -> dict:
    from tempo_tpu_torch.search.kernels import probe, scan, topk

    return {"multi_scan": scan.LAUNCHES, "multi_scan_hits": scan.HIT_LAUNCHES,
            "scan_single": scan.SINGLE_LAUNCHES, "topk": topk.LAUNCHES,
            "dict_probe": probe.LAUNCHES,
            "coalesced_scan": scan.COALESCED_LAUNCHES,
            "coalesced_scan_hits": scan.COALESCED_HIT_LAUNCHES,
            "topk_rows": topk.ROW_LAUNCHES}


def reset_counts() -> None:
    for c in counters().values():
        c.reset()


def read_counts() -> dict:
    return {k: c.n for k, c in counters().items()}


def add_counts(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


class GcPauses:
    """Wall time of the interpreter's cyclic garbage collections while
    active (gc.callbacks), which land inside whichever request allocates
    at that moment."""

    def __init__(self):
        self.ms = []
        self._t0 = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms.append((time.perf_counter() - self._t0) * 1e3)
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def drive(call, reps: int, sync: bool) -> dict:
    """One cold call, then `reps` timed warm calls, launch counters set to
    0 just before and read after the cold call and after the last, and
    the collector's pauses during the warm calls."""
    import torch

    reset_counts()
    t0 = time.perf_counter()
    resp = call().response()
    if sync:
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    cold = read_counts()
    lat = []
    with GcPauses() as pauses:
        for _ in range(reps):
            t0 = time.perf_counter()
            again = call().response()
            if sync:
                torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            if again != resp:
                raise AssertionError("repeated search differs")
    return {"resp": resp, "first_s": first_s, "lat": sorted(lat),
            "launches_cold": cold, "launches": read_counts(),
            "gc_ms": pauses.ms}


def run_queries(db, tenant: str, reqs: dict, reps: int) -> dict:
    """Each request once warm, then `reps` timed runs. Returns per request
    the response of the warm run, the timings and the dispatches."""
    from tempo_tpu_torch.model.types import SearchRequest

    out = {}
    for name, (tags, kw) in reqs.items():
        req = SearchRequest(tags=dict(tags), **kw)
        try:
            out[name] = drive(lambda: db.search(tenant, req), reps,
                              db.device.type == "cuda")
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None
        out[name]["dispatches"] = db.batcher.last_dispatches
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


def device_busy(db, tenant: str, reqs: dict, names, reps: int) -> dict:
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
        db.search(tenant, req)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                db.search(tenant, req)
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


def print_busy(busy: dict, lat_report: dict) -> None:
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


def k1_touch(args, val_hits=None, block_group=None) -> dict:
    """What K1's function must read on these inputs, as masks over the
    entries: `live` (whose key slots it reads, when there are terms),
    `need_val` (the value slots whose key a term names, for entries still
    alive at that term, up to the first that passes), `dur`/`end`/`start`
    (the entries whose u32 column it reads: those that passed the terms,
    duration and window end only where the bound excludes some value) and
    `match`; plus `hit_bytes`, the hit-table sectors those value slots
    look up in hit-mask mode. `args` are K1's."""
    import torch

    (kv_key, kv_val, start, end, dur, valid, page_block, term_keys,
     val_ranges, n_terms, dur_lo, dur_hi, win_start, win_end) = args
    u32 = 0xFFFFFFFF
    pb = page_block.long()
    safe = pb.clamp(min=0)
    live = valid & (pb >= 0)[:, None]
    alive = live.clone()
    need_val = torch.zeros_like(kv_key, dtype=torch.bool)
    hit_sectors = 0
    if n_terms:
        kk, vv = kv_key.int(), kv_val.int()
        slot = torch.arange(kk.shape[2], device=kk.device)
        if val_hits is not None:
            G, Tp, Vm = val_hits.shape
            bg = block_group.long()[safe]
            probe_page = (bg >= 0)[:, None, None]
            g_idx = bg.clamp(min=0)[:, None, None].expand_as(vv)
            safe_v = vv.clamp(min=0, max=max(0, Vm - 1)).long()
            touched = torch.zeros(-(-G * Tp * Vm // 32), dtype=torch.bool,
                                  device=kk.device)
        for t in range(n_terms):
            keym = (kk == term_keys[safe, t][:, None, None]) & alive[..., None]
            inr = torch.zeros_like(keym)
            for r in range(val_ranges.shape[2]):
                inr |= ((vv >= val_ranges[safe, t, r, 0][:, None, None])
                        & (vv <= val_ranges[safe, t, r, 1][:, None, None]))
            if val_hits is not None:
                mh = val_hits[g_idx, t, safe_v] & (vv >= 0)
                inr = torch.where(probe_page, mh, inr)
            hit = keym & inr
            first = torch.where(hit.any(-1), hit.int().argmax(-1),
                                kk.shape[2])
            need = keym & (slot <= first[..., None])
            need_val |= need
            if val_hits is not None:
                look = need & probe_page & (vv >= 0)
                flat = (g_idx * Tp + t) * Vm + safe_v
                touched[flat[look] // 32] = True
            alive &= hit.any(-1)
        if val_hits is not None:
            hit_sectors = int(touched.sum()) * 32
    out = {"live": live, "need_val": need_val, "hit_bytes": hit_sectors,
           "terms": bool(n_terms), "dur": None, "end": None}
    if dur_lo != 0 or dur_hi != u32:
        out["dur"] = alive.clone()
        d = dur.long() & u32
        alive &= (d >= dur_lo) & (d <= dur_hi)
    if win_start != 0:
        out["end"] = alive.clone()
        alive &= (end.long() & u32) >= win_start
    out["start"] = alive.clone()
    alive &= (start.long() & u32) <= win_end
    out["match"] = alive
    return out


def touched_bytes(t: dict, kv_key, kv_val) -> int:
    """Sectors of the kv slots and u32 columns a k1_touch result reads,
    plus its hit-table sectors."""
    total = t["hit_bytes"]
    if t["terms"]:
        total += sector_bytes(t["live"][..., None].expand_as(kv_key)
                              .contiguous(), kv_key.element_size())
        total += sector_bytes(t["need_val"], kv_val.element_size())
    for col in ("dur", "end", "start"):
        if t[col] is not None:
            total += sector_bytes(t[col], 4)
    return total


def k1_bytes(args, scores, val_hits=None, block_group=None,
             single: bool = False) -> int:
    """The bytes K1's (or, with `single`, K1s's) function must move on
    these inputs, counted in the sectors this run's data touches: the
    valid flags (and page ids) read and the scores and counts written,
    all; the term tables; and what k1_touch finds. `args` are K1's (K1s's
    are given in K1's form: page_block all 0, tables as row 0)."""
    import torch

    t = k1_touch(args, val_hits, block_group)
    if not torch.equal(t["match"].reshape(-1), scores >= 0):
        raise AssertionError("k1_bytes: its predicate differs from K1's")
    kv_key, kv_val, valid, page_block = args[0], args[1], args[5], args[6]
    n = valid.numel()
    total = n + n * 4 + 8                             # valid, scores, counts
    if not single:
        total += page_block.numel() * 4
    total += args[7].numel() * 4 + args[8].numel() * 4
    if block_group is not None and not single:
        total += block_group.numel() * 4
    return total + touched_bytes(t, kv_key, kv_val)


def k4_bytes(page, tables, scores) -> int:
    """The bytes K4's function must move on these inputs: the valid flags
    and page ids read and the Q score columns and counts written, all;
    the stacked tables; and the union over the real queries of what
    k1_touch finds for each (a pad query, whose duration range is empty,
    reads no page data). `page` are K1's page arrays, `tables` K4's
    per-query inputs."""
    import torch

    tk, vr, ta, dlo, dhi, ws, we, val_hits, bg = tables
    kv_key, kv_val, valid, page_block = page[0], page[1], page[5], page[6]
    Q, n = scores.shape
    u = None
    hit_bytes = 0
    for q in range(Q):
        b = [int(x[q]) & 0xFFFFFFFF for x in (dlo, dhi, ws, we)]
        if b[0] > b[1]:
            if bool((scores[q] >= 0).any()):
                raise AssertionError("k4_bytes: a pad query matched")
            continue
        act = ta[q].nonzero().flatten()
        vh = bgq = None
        if val_hits is not None and val_hits[q] is not None:
            vh, bgq = val_hits[q][:, act], bg[q]
        t = k1_touch((*page, tk[q][:, act], vr[q][:, act], int(act.numel()),
                      *b), vh, bgq)
        if not torch.equal(t["match"].reshape(-1), scores[q] >= 0):
            raise AssertionError(f"k4_bytes: its predicate differs from "
                                 f"K4's for query {q}")
        hit_bytes += t["hit_bytes"]
        if u is None:
            u = t
            continue
        u["terms"] |= t["terms"]
        u["need_val"] |= t["need_val"]
        for col in ("dur", "end", "start"):
            if t[col] is not None:
                u[col] = t[col] if u[col] is None else u[col] | t[col]
    total = n + page_block.numel() * 4 + Q * n * 4 + (Q + 1) * 4
    total += sum(x.numel() * x.element_size()
                 for x in (tk, vr, ta, dlo, dhi, ws, we, bg)
                 if x is not None)
    if val_hits is not None:
        total += Q * 24                               # the address table
    if u is not None:
        u["hit_bytes"] = hit_bytes
        total += touched_bytes(u, kv_key, kv_val)
    return total


def require_equal(what: str, got: tuple, want: tuple) -> int:
    """Exact equality of kernel outputs and their plain versions' on the
    card; returns the largest absolute difference (0)."""
    import torch

    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{what} differs from its plain version")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def kernel_row(name, source, replaces, launches, err, ms, plain_ms,
               bound_bytes, library_ms, shape) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": library_ms, "shape": shape}


def kernel_phase(db, reqs: dict, launches: dict) -> list:
    """K1 (range mode) and K2 against their plain versions on one staged
    batch of the tag-search cell (the largest), at the main path's
    shapes; exact equality."""
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
                       cache=db.batcher.engine.compile_cache,
                       staged_dicts=batch.staged_dicts)
    if mq.val_hits is not None:
        raise AssertionError("the tag-search cell compiled a hit mask")
    tk = torch.from_numpy(mq.term_keys).to(db.device)
    vr = torch.from_numpy(mq.val_ranges).to(db.device)
    bounds = (mq.dur_lo, min(mq.dur_hi, 0xFFFFFFFF), mq.win_start,
              min(mq.win_end, 0xFFFFFFFF))
    args = (d["kv_key"], d["kv_val"], d["entry_start"], d["entry_end"],
            d["entry_dur"], d["entry_valid"], d["page_block"], tk, vr,
            mq.n_terms, *bounds)
    scores, counts = scan.multi_scan(*args)
    k1_err = require_equal("K1", (scores, counts),
                           scan.multi_scan_plain(*args))
    k2_err = 0
    k = resolve_top_k(128, req.limit)
    # the main path's k, a limit-1000 request's k, a k past the shared-
    # memory sort (global bitonic stages), and k > N on a short column
    short = scores[:1000].contiguous()
    for col, kk in ((scores, k), (scores, 1024), (scores, 8192),
                    (short, 4096)):
        s, i = topk.topk(col, kk)
        k2_err = max(k2_err, require_equal(
            f"K2 (n={col.numel()}, k={kk})", (s, i),
            topk.topk_plain(col, kk)))
        ls, _li = torch.topk(col, min(kk, col.numel()))
        if not torch.equal(torch.sort(ls).values, torch.sort(s).values):
            raise AssertionError(f"K2 (n={col.numel()}, k={kk}) scores "
                                 "differ from torch.topk's")

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
        kernel_row("multi_scan", "tempo_tpu_torch/csrc/scan.cu",
                   "tempo_tpu/search/multiblock.py:855", launches, k1_err,
                   k1_ms, k1_plain, k1_need, None, shape),
        kernel_row("topk", "tempo_tpu_torch/csrc/topk.cu",
                   "tempo_tpu/search/engine.py:295", launches, k2_err,
                   k2_ms, k2_plain, k2_bytes, k2_lib, {"n": n, "k": k}),
    ]


def hc_kernel_phase(db, bsb, launches: dict) -> list:
    """K3, K1 in hit-mask mode and K1s against their plain versions on the
    high-cardinality cell's staged data, at the main path's shapes: K3 on
    one staged dictionary with the scattered needle "77", K1 on the
    largest staged group with the exhaustive request's hit masks, K1s on
    the single-block path's block with the bench request."""
    import torch

    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search import dict_probe
    from tempo_tpu_torch.search.kernels import probe, scan
    from tempo_tpu_torch.search.multiblock import compile_multi
    from tempo_tpu_torch.search.pipeline import compile_query

    cached = max(db.batcher._cache.values(), key=lambda c: c.batch.n_pages)
    batch = cached.batch
    d = batch.device

    # K3
    dd = next(iter(batch.staged_dicts.values()))
    needles, lens = dict_probe.needle_tensors([b"77"], db.device)
    p_args = (dd.buf, dd.off, needles, lens)
    hits, any_hits = probe.dict_probe(*p_args)
    k3_err = require_equal("K3", (hits, any_hits),
                           probe.dict_probe_plain(*p_args))
    T, V = hits.shape
    k3_bytes = (dd.buf.numel() + dd.off.numel() * 4 + T * V + T
                + needles.numel() + lens.numel() * 4)
    k3_ms = cuda_ms(lambda: probe.dict_probe(*p_args), 50)
    k3_plain = cuda_ms(lambda: probe.dict_probe_plain(*p_args), 3)
    k3_shape = {"values": V, "dict_bytes": int(dd.buf.numel()), "T": T,
                "needle": "77", "hits": int(hits.sum())}

    # K1, hit-mask mode
    tags, kw = hc_requests()["hc_exhaustive_77"]
    mq = compile_multi(list(batch.blocks), SearchRequest(tags=dict(tags),
                                                         **kw),
                       memo=batch.memo, cache=db.batcher.engine.compile_cache,
                       staged_dicts=batch.staged_dicts)
    if mq.val_hits is None:
        raise AssertionError("the high-cardinality group compiled no hit "
                             "mask")
    bg = torch.from_numpy(mq.block_group).to(db.device)
    args = (d["kv_key"], d["kv_val"], d["entry_start"], d["entry_end"],
            d["entry_dur"], d["entry_valid"], d["page_block"],
            torch.from_numpy(mq.term_keys).to(db.device),
            torch.from_numpy(mq.val_ranges).to(db.device), mq.n_terms,
            mq.dur_lo, min(mq.dur_hi, 0xFFFFFFFF), mq.win_start,
            min(mq.win_end, 0xFFFFFFFF))
    scores, counts = scan.multi_scan(*args, mq.val_hits, bg)
    k1h_err = require_equal("K1 hit-mask mode", (scores, counts),
                            scan.multi_scan_plain(*args, mq.val_hits, bg))
    k1h_bytes = k1_bytes(args, scores, mq.val_hits, bg)
    k1h_ms = cuda_ms(lambda: scan.multi_scan(*args, mq.val_hits, bg), 50)
    k1h_plain = cuda_ms(
        lambda: scan.multi_scan_plain(*args, mq.val_hits, bg), 3)
    k1h_shape = {"pages": batch.n_pages, "entries": scores.numel(),
                 "kv_dtypes": [str(d["kv_key"].dtype),
                               str(d["kv_val"].dtype)],
                 "C": int(d["kv_key"].shape[2]), "n_terms": mq.n_terms,
                 "val_hits": list(mq.val_hits.shape),
                 "match_count": int(counts[0]), "inspected": int(counts[1]),
                 "bytes_needed": k1h_bytes}

    # K1s, on the single-block path's block with the bench request
    sp = bsb.staged()
    engine = bsb.engine()
    cq = compile_query(sp.pages.key_dict, sp.pages.val_dict,
                       SearchRequest(tags=dict(BENCH), limit=20),
                       cache_on=sp.pages, cache=engine.compile_cache,
                       staged_dict=sp.staged_dict)
    if cq.val_hits is None:
        raise AssertionError("the single block compiled no hit mask")
    tk, vr = engine._tables(cq)
    sd = sp.device
    cols = (sd["kv_key"], sd["kv_val"], sd["entry_start"], sd["entry_end"],
            sd["entry_dur"], sd["entry_valid"])
    s_args = (*cols, tk, vr, cq.n_terms, cq.dur_lo,
              min(cq.dur_hi, 0xFFFFFFFF), cq.win_start,
              min(cq.win_end, 0xFFFFFFFF), cq.val_hits)
    s_scores, s_counts = scan.scan_single(*s_args)
    k1s_err = require_equal("K1s", (s_scores, s_counts),
                            scan.scan_single_plain(*s_args))
    P = sd["kv_key"].shape[0]
    as_multi = (*cols, torch.zeros(P, dtype=torch.int32, device=db.device),
                tk[None], vr[None], *s_args[8:13])
    k1s_bytes = k1_bytes(as_multi, s_scores, cq.val_hits[None],
                         torch.zeros(1, dtype=torch.int32, device=db.device),
                         single=True)
    k1s_ms = cuda_ms(lambda: scan.scan_single(*s_args), 50)
    k1s_plain = cuda_ms(lambda: scan.scan_single_plain(*s_args), 3)
    k1s_shape = {"pages": P, "entries": s_scores.numel(),
                 "C": int(sd["kv_key"].shape[2]), "n_terms": cq.n_terms,
                 "val_hits": list(cq.val_hits.shape),
                 "match_count": int(s_counts[0]),
                 "inspected": int(s_counts[1]), "bytes_needed": k1s_bytes}
    return [
        kernel_row("multi_scan_hits", "tempo_tpu_torch/csrc/scan.cu",
                   "tempo_tpu/search/multiblock.py:855", launches, k1h_err,
                   k1h_ms, k1h_plain, k1h_bytes, None, k1h_shape),
        kernel_row("scan_single", "tempo_tpu_torch/csrc/scan.cu",
                   "tempo_tpu/search/engine.py:331", launches, k1s_err,
                   k1s_ms, k1s_plain, k1s_bytes, None, k1s_shape),
        kernel_row("dict_probe", "tempo_tpu_torch/csrc/probe.cu",
                   "tempo_tpu/search/dict_probe.py:283", launches, k3_err,
                   k3_ms, k3_plain, k3_bytes, None, k3_shape),
    ]


def coalesced_phase(db, reqs: list, label: str, launches: dict,
                    with_rows: bool) -> list:
    """K4 against its plain version on the largest staged batch of `db`,
    with `reqs` ((tags, fields) pairs) stacked along the query axis; the
    fused dispatch (K4 + K2r) against each member's solo dispatch (K1 +
    K2), exactly, indices included; with `with_rows`, K2r against its
    plain version at the group's k and at k = 1024 (a limit-1000
    request's), and torch.topk's scores."""
    import numpy as np
    import torch

    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search.engine import (fetch_coalesced_out,
                                               fetch_scan_out, resolve_top_k)
    from tempo_tpu_torch.search.kernels import scan, topk
    from tempo_tpu_torch.search.multiblock import compile_multi, \
        stack_queries

    eng = db.batcher.engine
    batch = max(db.batcher._cache.values(),
                key=lambda c: c.batch.n_pages).batch
    d = batch.device
    mqs = []
    for tags, kw in reqs:
        mq = compile_multi(list(batch.blocks),
                           SearchRequest(tags=dict(tags), **kw),
                           memo=batch.memo, cache=eng.compile_cache,
                           staged_dicts=batch.staged_dicts)
        if mq is None:
            raise AssertionError(f"{label}: a member prunes every block")
        mq.limit = kw.get("limit") or 20
        mqs.append(mq)
    cq = stack_queries(mqs)
    page = (d["kv_key"], d["kv_val"], d["entry_start"], d["entry_end"],
            d["entry_dur"], d["entry_valid"], d["page_block"])
    tables = eng.coalesced_tables(cq)
    scores, counts, inspected = scan.coalesced_scan(*page, *tables)
    err = require_equal(f"K4 ({label})", (scores, counts, inspected),
                        scan.coalesced_scan_plain(*page, *tables))
    k = max(resolve_top_k(eng.top_k, mq.limit) for mq in mqs)
    fc, fins, fs, fi = fetch_coalesced_out(
        eng.coalesced_scan_async(batch, cq, k))
    for qi, mq in enumerate(mqs):
        c, ins, s1, i1 = fetch_scan_out(eng.scan_async(batch, mq))
        kq = len(s1)
        if (int(fc[qi]), fins) != (c, ins) \
                or not np.array_equal(fs[qi][:kq], s1) \
                or not np.array_equal(fi[qi][:kq], i1):
            raise AssertionError(f"{label}: fused member {qi} differs from "
                                 "its solo dispatch")
    need = k4_bytes(page, tables, scores)
    ms = cuda_ms(lambda: scan.coalesced_scan(*page, *tables), 50)
    plain = cuda_ms(lambda: scan.coalesced_scan_plain(*page, *tables), 3)
    Q, n = scores.shape
    hits = cq.val_hits is not None
    shape = {"pages": batch.n_pages, "entries": n, "Q": Q,
             "members": cq.n_queries, "T": cq.n_terms,
             "R": int(cq.val_ranges.shape[3]), "B": int(cq.term_keys.shape[1]),
             "kv_dtypes": [str(d["kv_key"].dtype), str(d["kv_val"].dtype)],
             "C": int(d["kv_key"].shape[2]),
             "probed_members": (sum(h is not None for h in cq.val_hits)
                                if hits else 0),
             "counts": counts.tolist(), "inspected": int(inspected),
             "bytes_needed": need, "fused_equals_solo": True}
    print(f"K4 {label}: Q = {Q} ({cq.n_queries} members), equal to its "
          f"plain version and the fused dispatch to the solo ones; "
          f"{ms:.4f} ms, bound {need / HBM_BYTES_PER_S * 1e3:.4f} ms",
          flush=True)
    rows = [kernel_row("coalesced_scan_hits" if hits else "coalesced_scan",
                       "tempo_tpu_torch/csrc/scan.cu",
                       "tempo_tpu/search/multiblock.py:1028", launches, err,
                       ms, plain, need, None, shape)]
    if not with_rows:
        return rows
    r_err = 0
    for kk in (k, 1024):
        s2, i2 = topk.topk_rows(scores, kk)
        r_err = max(r_err, require_equal(f"K2r (k={kk})", (s2, i2),
                                         topk.topk_rows_plain(scores, kk)))
        ls = torch.topk(scores, kk, dim=1).values
        if not torch.equal(torch.sort(ls, dim=1).values,
                           torch.sort(s2, dim=1).values):
            raise AssertionError(f"K2r (k={kk}) scores differ from "
                                 "torch.topk's")
    r_ms = cuda_ms(lambda: topk.topk_rows(scores, k), 50)
    r_plain = cuda_ms(lambda: topk.topk_rows_plain(scores, k), 5)
    r_lib = cuda_ms(lambda: torch.topk(scores, k, dim=1), 50)
    rows.append(kernel_row("topk_rows", "tempo_tpu_torch/csrc/topk.cu",
                           "tempo_tpu/search/multiblock.py:1084", launches,
                           r_err, r_ms, r_plain, Q * n * 4 + Q * k * 8,
                           r_lib, {"rows": Q, "n": n, "k": k}))
    return rows


def pct(xs: list, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def concurrent_rounds(db, tenant: str, reqs: list, rounds: int,
                      serial: list) -> dict:
    """CLIENTS barrier-started threads, one request each per round: one
    warm-up round, then `rounds` timed ones. Every response must equal
    `serial` (the same requests answered one at a time). Launch counters
    set to 0 just before the first round and read after the last; the
    coalescer's counters over the timed rounds."""
    from tempo_tpu_torch.model.types import SearchRequest

    requests = [SearchRequest(tags=dict(t), **kw) for t, kw in reqs]
    barrier = threading.Barrier(len(requests))

    def one(i):
        barrier.wait(timeout=120)
        t0 = time.perf_counter()
        resp = db.search(tenant, requests[i]).response()
        return time.perf_counter() - t0, resp

    co = db.batcher.coalescer
    walls, lat = [], []
    st0 = None
    reset_counts()
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=len(requests)) as ex:
        for r in range(rounds + 1):
            if r == 1 and co is not None:
                st0 = co.stats()
            t0 = time.perf_counter()
            futs = [ex.submit(one, i) for i in range(len(requests))]
            outs = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
            for i, (_dt, resp) in enumerate(outs):
                if resp != serial[i]:
                    raise AssertionError(f"concurrent request {i} differs "
                                         "from its serial response")
            if r:
                walls.append(wall * 1e3)
                lat += [dt * 1e3 for dt, _ in outs]
    row = {"round_ms": sorted(walls), "lat_ms": sorted(lat),
           "round_p50_ms": pct(walls, 0.5), "round_p95_ms": pct(walls, 0.95),
           "lat_p50_ms": pct(lat, 0.5), "lat_p95_ms": pct(lat, 0.95),
           "launches": read_counts(), "coalesce": None}
    if co is not None:
        st1 = co.stats()
        disp = st1["dispatches"] - st0["dispatches"]
        queries = st1["queries"] - st0["queries"]
        row["coalesce"] = {
            "dispatches": disp, "queries": queries,
            "fused_dispatches": st1["fused_dispatches"]
            - st0["fused_dispatches"],
            "queries_per_dispatch": queries / max(1, disp),
            "pending": st1["pending"], "window_ms": st1["window_ms"]}
    return row


def concurrent_phase(label: str, co_db, serial_db, tenant: str,
                     sets: dict, rounds: int, launches: dict) -> dict:
    """Each set of CLIENTS requests answered serially on `serial_db`, then
    concurrently through `co_db` (the default coalescer) and through
    `serial_db` (coalescing off). Adds the launches to `launches`."""
    from tempo_tpu_torch.model.types import SearchRequest

    out = {}
    for set_name, reqs in sets.items():
        serial = [serial_db.search(tenant, SearchRequest(tags=dict(t), **kw))
                  .response() for t, kw in reqs]
        for db_name, db in (("coalescing", co_db),
                            ("no_coalescing", serial_db)):
            row = concurrent_rounds(db, tenant, reqs, rounds, serial)
            add_counts(launches, row["launches"])
            fused_k4 = (row["launches"]["coalesced_scan"]
                        + row["launches"]["coalesced_scan_hits"])
            if db is serial_db and (fused_k4 or row["launches"]["topk_rows"]):
                raise AssertionError(f"{label} {set_name}: coalescing off "
                                     "but a fused dispatch ran")
            co = row["coalesce"]
            print(f"concurrent {label} {set_name} ({db_name}): round p50 "
                  f"{row['round_p50_ms']:.3f} ms, p95 "
                  f"{row['round_p95_ms']:.3f} ms; request p50 "
                  f"{row['lat_p50_ms']:.3f} ms, p95 {row['lat_p95_ms']:.3f} "
                  f"ms; launches {json.dumps(row['launches'])}; coalescer "
                  f"{json.dumps(co)}", flush=True)
            out[f"{set_name}/{db_name}"] = row
    return out


def solo_again(db, tenant: str, name: str, tags: dict, kw: dict,
               before: dict, reps: int, launches: dict) -> dict:
    """The single-request bench again after the concurrent phase: no peer
    counter or parked query may be left, and its p50 must stay within the
    earlier run's spread plus half a window (a leaked peer counter would
    add a whole window to every solo dispatch)."""
    from tempo_tpu_torch.model.types import SearchRequest

    b = db.batcher
    dbg = b.debug_stats()
    if dbg["peers"] != {"interest": {}, "unplanned": 0} \
            or dbg["coalesce"]["pending"]:
        raise AssertionError(f"{name}: state left by the concurrent "
                             f"phase: {dbg}")
    req = SearchRequest(tags=dict(tags), **kw)
    r = drive(lambda: db.search(tenant, req), reps, True)
    add_counts(launches, r["launches"])
    p50 = r["lat"][len(r["lat"]) // 2] * 1e3
    lo, hi = before["lat"][0] * 1e3, before["lat"][-1] * 1e3
    allowed = hi + b.coalescer.window_s * 1e3 / 2
    row = {"p50_ms": p50, "before_p50_ms":
           before["lat"][len(before["lat"]) // 2] * 1e3,
           "before_spread_ms": [lo, hi], "within_spread": p50 <= hi,
           "launches": r["launches"]}
    print(f"{name} alone after the concurrent phase: p50 {p50:.3f} ms "
          f"(before: p50 {row['before_p50_ms']:.3f} ms, spread "
          f"{lo:.3f}-{hi:.3f} ms); coalescer pending 0, no peer left",
          flush=True)
    if p50 > allowed:
        raise AssertionError(f"{name}: p50 {p50:.3f} ms after the "
                             f"concurrent phase, over {allowed:.3f} ms")
    return row


def latency_row(r: dict, resp) -> dict:
    lat = r["lat"]
    p50 = lat[len(lat) // 2]
    p95 = lat[min(len(lat) - 1, int(len(lat) * 0.95))]
    m = resp.metrics
    return {"p50_ms": p50 * 1e3, "p95_ms": p95 * 1e3,
            "first_ms": r["first_s"] * 1e3,
            "traces_per_s": m.inspected_traces / p50 if p50 else None,
            "inspected_traces": m.inspected_traces,
            "inspected_blocks": m.inspected_blocks,
            "skipped_blocks": m.skipped_blocks,
            "results": len(resp.traces),
            "dispatches": r.get("dispatches"),
            "launches_cold": r["launches_cold"],
            "launches": r["launches"],
            "lat_ms": [x * 1e3 for x in lat],
            "gc_pauses_ms": r["gc_ms"]}


def print_row(name: str, row: dict) -> None:
    print(f"search {name}: first {row['first_ms']:.2f} ms, p50 "
          f"{row['p50_ms']:.2f} ms, p95 {row['p95_ms']:.2f} ms, "
          f"{row['inspected_traces']} traces inspected "
          f"({row['traces_per_s']:.4g} traces/s), "
          f"{row['inspected_blocks']} blocks, {row['skipped_blocks']} "
          f"skipped, {row['results']} results, {row['dispatches']} "
          f"dispatches, launches cold {json.dumps(row['launches_cold'])}, "
          f"in all {json.dumps(row['launches'])}; collector pauses in the "
          f"timed runs {len(row['gc_pauses_ms'])}, longest "
          f"{max(row['gc_pauses_ms'], default=0):.2f} ms", flush=True)


def tag_search_cell(args, work: str, report: dict, dbs: list,
                    launches: dict) -> list:
    """The tag-search cell (step 2 of the module docstring). Returns its
    kernel rows."""
    import torch

    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.model.types import SearchRequest

    n_total = args.blocks * args.traces_per_block
    reqs = requests(args.blocks)
    root = os.path.join(work, "blocks")
    t0 = time.perf_counter()
    nbytes = write_corpus(root, "smoke", args.blocks, args.traces_per_block,
                          ENTRIES_PER_PAGE, args.seed)
    report["corpus"] = {"blocks": args.blocks, "traces": n_total,
                        "compressed_bytes": nbytes,
                        "write_s": time.perf_counter() - t0}
    print(f"corpus: {args.blocks} blocks, {n_total} traces, "
          f"{nbytes / 1e6:.1f} MB zlib, "
          f"{report['corpus']['write_s']:.1f} s", flush=True)

    cfg = TempoDBConfig(search_max_batch_pages=4096)
    gpu = TempoDB(LocalBackend(root), cfg, device="cuda")
    dbs.append(gpu)
    gpu.poll()
    torch.cuda.reset_peak_memory_stats()
    res = run_queries(gpu, "smoke", reqs, args.reps)       # the main path
    path = {}
    for r in res.values():
        add_counts(path, r["launches"])
    report["launches"] = path
    report["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    report["staged_device_bytes"] = gpu.batcher._cache_total
    if path["multi_scan"] == 0 or path["topk"] == 0:
        raise AssertionError(f"main path launched no kernel: {path}")
    if path["dict_probe"] or path["multi_scan_hits"]:
        raise AssertionError(f"the tag-search cell probed: {path}")
    add_counts(launches, path)
    lat_report = {}
    for name, r in res.items():
        tags, kw = reqs[name]
        check_response(name, r["resp"], tags, kw, n_total)
        lat_report[name] = latency_row(r, r["resp"])
        print_row(name, lat_report[name])
    report["search"] = lat_report
    print("launches during the searches: " + json.dumps(path), flush=True)

    busy = device_busy(gpu, "smoke", reqs, ("exhaustive_bench", "bench_and",
                                            "limit_1000"), args.reps)
    report["device_busy"] = busy
    print_busy(busy, lat_report)

    t0 = time.perf_counter()
    cpu = TempoDB(LocalBackend(root), cfg, device="cpu")
    dbs.append(cpu)
    cpu.poll()
    cres = run_queries(cpu, "smoke", reqs, 0)
    for name in reqs:
        if cres[name]["resp"] != res[name]["resp"]:
            raise AssertionError(f"{name}: card and CPU responses differ")
    report["cpu_check_s"] = time.perf_counter() - t0
    print(f"cpu check: {len(reqs)} responses identical "
          f"({report['cpu_check_s']:.1f} s)", flush=True)
    cpu.close()
    dbs.remove(cpu)
    rows = kernel_phase(gpu, reqs, launches)
    rows += coalesced_phase(gpu, [(t, {"limit": 20})
                                  for t in CONCURRENT_TAGS],
                            "range mode, tag search", launches, True)

    serial = TempoDB(LocalBackend(root), TempoDBConfig(
        search_max_batch_pages=4096, search_coalesce_max_queries=1),
        device="cuda")
    dbs.append(serial)
    serial.poll()
    tags, kw = reqs["exhaustive_bench"]
    serial.search("smoke", SearchRequest(tags=dict(tags), **kw))  # stage
    torch.cuda.reset_peak_memory_stats()
    report["concurrent"] = concurrent_phase(
        "tag search", gpu, serial, "smoke",
        {"bench": [(t, {"limit": 20}) for t in CONCURRENT_TAGS],
         "exhaustive": [(dict(t, **EXHAUSTIVE), {"limit": 20})
                        for t in CONCURRENT_TAGS]}, args.rounds, launches)
    report["concurrent_peak_device_bytes"] = torch.cuda.max_memory_allocated()
    require_fusion(report["concurrent"]["exhaustive/coalescing"],
                   "coalesced_scan")
    tags, kw = reqs["bench_and"]
    report["solo_again"] = solo_again(gpu, "smoke", "bench_and", tags, kw,
                                      res["bench_and"], args.reps, launches)
    for db in (gpu, serial):
        db.close()
        dbs.remove(db)
    return rows


def require_fusion(row: dict, kernel: str) -> None:
    """The exhaustive concurrent rounds fused: more than one query per
    dispatch, through K4 in the cell's mode."""
    co = row["coalesce"]
    if co["queries_per_dispatch"] <= 1 or not row["launches"][kernel]:
        raise AssertionError(f"the concurrent exhaustive rounds did not "
                             f"fuse: {co}, launches {row['launches']}")


def hc_paths(db, bsb_of, n_per: int, reps: int, sync: bool) -> dict:
    """The high-cardinality cell's requests through the three entry
    points, in order; the one-block requests go to the block holding the
    point lookup's session (blocks of `n_per` traces). `bsb_of` gives the
    single-block path's BackendSearchBlock. Returns name -> drive()
    result."""
    from tempo_tpu_torch.model.types import SearchBlockRequest, \
        SearchRequest

    out = {}
    for name, (tags, kw) in hc_requests().items():
        req = SearchRequest(tags=dict(tags), **kw)
        out[name] = drive(lambda: db.search("hc", req), reps, sync)
        out[name]["dispatches"] = db.batcher.last_dispatches
    meta = next(m for m in db.blocklist.metas("hc")
                if m.block_id == block_id(POINT_SESSION // n_per))
    point = SearchRequest(tags=dict(hc_requests()["hc_point"][0]), limit=20)
    job = SearchBlockRequest(
        search_req=point, tenant_id="hc", block_id=meta.block_id,
        encoding=meta.encoding, version=meta.version,
        data_encoding=meta.data_encoding, start_time=meta.start_time,
        end_time=meta.end_time)
    out["hc_search_block_point"] = drive(lambda: db.search_block(job), reps,
                                         sync)
    out["hc_search_block_point"]["dispatches"] = db.batcher.last_dispatches
    bsb = bsb_of(meta)
    for name, req in (("single_point", point),
                      ("single_bench", SearchRequest(tags=dict(BENCH),
                                                     limit=20))):
        out[name] = drive(lambda: bsb.search(req), reps, sync)
        out[name]["dispatches"] = 1
    return out


def hc_cell(args, work: str, report: dict, dbs: list, launches: dict
            ) -> list:
    """The high-cardinality cell (step 3 of the module docstring).
    Returns its kernel rows."""
    import torch

    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search.backend_search_block import \
        BackendSearchBlock

    n_per = args.hc_traces_per_block
    n_total = args.hc_blocks * n_per
    root = os.path.join(work, "hc_blocks")
    t0 = time.perf_counter()
    nbytes = write_corpus(root, "hc", args.hc_blocks, n_per,
                          ENTRIES_PER_PAGE, args.seed, sessions=True)
    report["hc_corpus"] = {"blocks": args.hc_blocks, "traces": n_total,
                           "compressed_bytes": nbytes,
                           "write_s": time.perf_counter() - t0}
    print(f"hc corpus: {args.hc_blocks} blocks, {n_total} traces, "
          f"{nbytes / 1e6:.1f} MB zlib, "
          f"{report['hc_corpus']['write_s']:.1f} s", flush=True)

    cfg = TempoDBConfig(search_max_batch_pages=4096)
    be = LocalBackend(root)
    gpu = TempoDB(be, cfg, device="cuda")
    dbs.append(gpu)
    gpu.poll()
    groups = gpu.batcher.plan(gpu._jobs("hc", gpu.blocklist.epoch()))
    report["hc_plan"] = [len(g) for g in groups]
    gc.collect()        # free the tag-search cell's closed databases first
    torch.cuda.reset_peak_memory_stats()
    bsbs = {}

    def bsb_gpu(meta):
        bsbs["gpu"] = BackendSearchBlock(be, meta, device="cuda")
        return bsbs["gpu"]

    res = hc_paths(gpu, bsb_gpu, n_per, args.reps, True)  # the main path
    path = {}
    for r in res.values():
        add_counts(path, r["launches"])
    report["hc_launches"] = path
    report["hc_peak_device_bytes"] = torch.cuda.max_memory_allocated()
    report["hc_staged_device_bytes"] = gpu.batcher._cache_total
    report["hc_staged_dict_bytes"] = gpu.batcher._probe_dict_total
    for name in hc_requests():
        cold = res[name]["launches_cold"]
        if not cold["dict_probe"]:
            raise AssertionError(f"{name}: cold request launched no K3")
    for k in ("multi_scan_hits", "scan_single", "topk", "dict_probe"):
        if not path[k]:
            raise AssertionError(f"high-cardinality path launched no {k}: "
                                 f"{path}")
    if path["multi_scan"]:
        raise AssertionError(f"a probed block took the range mode: {path}")
    add_counts(launches, path)
    lat_report = {}
    expect = {"hc_point": 1, "hc_prefix": 10, "hc_search_block_point": 1,
              "single_point": 1}
    reqs = hc_requests()
    for name, r in res.items():
        tags, kw = reqs.get(name, ({}, {"limit": 20}))
        check_response(name, r["resp"], tags, kw,
                       n_total if name in reqs else n_per)
        if name in expect and len(r["resp"].traces) != expect[name]:
            raise AssertionError(f"{name}: {len(r['resp'].traces)} results, "
                                 f"want {expect[name]}")
        lat_report[name] = latency_row(r, r["resp"])
        print_row(name, lat_report[name])
    report["hc_search"] = lat_report
    print("hc plan (blocks per group): " + json.dumps(report["hc_plan"]) +
          f"; staged {report['hc_staged_device_bytes']} B of which "
          f"dictionaries {report['hc_staged_dict_bytes']} B; launches: "
          + json.dumps(path), flush=True)

    busy = device_busy(gpu, "hc", reqs, ("hc_exhaustive_77", "hc_point",
                                         "hc_77_and_svc"), args.reps)
    report["hc_device_busy"] = busy
    print_busy(busy, lat_report)

    t0 = time.perf_counter()
    cpu = TempoDB(be, cfg, device="cpu")
    dbs.append(cpu)
    cpu.poll()
    cres = hc_paths(cpu, lambda m: BackendSearchBlock(be, m, device="cpu"),
                    n_per, 0, False)
    for name in res:
        if cres[name]["resp"] != res[name]["resp"]:
            raise AssertionError(f"{name}: card and CPU responses differ")
    report["hc_cpu_check_s"] = time.perf_counter() - t0
    print(f"hc cpu check: {len(res)} responses identical "
          f"({report['hc_cpu_check_s']:.1f} s)", flush=True)
    cpu.close()
    dbs.remove(cpu)
    rows = hc_kernel_phase(gpu, bsbs["gpu"], launches)
    rows += coalesced_phase(
        gpu, [(dict(EXHAUSTIVE, **{SESSION_KEY: v}), {"limit": 20})
              for v in HC_SESSIONS[:6]]
        + [({}, {"min_duration_ms": 59_000, "limit": 20}),
           ({}, {"start": BASE_S + 300, "end": BASE_S + 900, "limit": 20})],
        "hit-mask mode, 6 probed + 2 host-compiled", launches, False)

    serial = TempoDB(be, TempoDBConfig(search_max_batch_pages=4096,
                                       search_coalesce_max_queries=1),
                     device="cuda")
    dbs.append(serial)
    serial.poll()
    tags, kw = reqs["hc_exhaustive_77"]
    serial.search("hc", SearchRequest(tags=dict(tags), **kw))     # stage
    torch.cuda.reset_peak_memory_stats()
    report["hc_concurrent"] = concurrent_phase(
        "high cardinality", gpu, serial, "hc",
        {"sessions": [(dict(EXHAUSTIVE, **{SESSION_KEY: v}), {"limit": 20})
                      for v in HC_SESSIONS]}, args.rounds, launches)
    report["hc_concurrent_peak_device_bytes"] = \
        torch.cuda.max_memory_allocated()
    require_fusion(report["hc_concurrent"]["sessions/coalescing"],
                   "coalesced_scan_hits")
    tags, kw = reqs["hc_point"]
    report["hc_solo_again"] = solo_again(gpu, "hc", "hc_point", tags, kw,
                                         res["hc_point"], args.reps,
                                         launches)
    for db in (gpu, serial):
        db.close()
        dbs.remove(db)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=256)
    ap.add_argument("--traces-per-block", type=int, default=65_536)
    ap.add_argument("--hc-blocks", type=int, default=10)
    ap.add_argument("--hc-traces-per-block", type=int, default=1_048_576)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=10,
                    help="timed rounds of the concurrent phases")
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
    from tempo_tpu_torch.search.kernels import build

    report: dict = {"args": vars(args)}

    t0 = time.perf_counter()
    build.build_all()
    report["build_s"] = time.perf_counter() - t0
    report["build_log"] = dict(build.BUILD_LOG)
    print(f"build: {report['build_s']:.1f} s "
          f"({', '.join(sorted(build.BUILD_LOG)) or 'cached'})", flush=True)

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    dbs: list = []
    launches = {k: 0 for k in KERNELS}
    try:
        rows = tag_search_cell(args, work, report, dbs, launches)
        rows += hc_cell(args, work, report, dbs, launches)
    finally:
        for db in dbs:
            db.close()
        shutil.rmtree(work, ignore_errors=True)
    by_name = {r["name"]: r for r in rows}
    kernels = [by_name[k] for k in KERNELS]
    for r in kernels:
        r["launches"] = launches[r["name"]]
        if not r["launches"]:
            raise AssertionError(f"{r['name']} was never launched on the "
                                 "main path")
    report["kernels"] = kernels
    report["launches_all_paths"] = launches

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
