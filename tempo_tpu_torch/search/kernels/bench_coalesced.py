"""Time the coalesced scan kernel K4 of one checkout of the port on one
CUDA card, at the shapes of its rows in PERF.md's kernel table, against
its plain version; and hold the byte model of the scan kernels' bounds
(K1, K1s, K4), which ``chip_smoke.py`` imports from here.

  python3 tempo_tpu_torch/search/kernels/bench_coalesced.py --root DIR \\
      --label NAME [--out FILE]

imports ``tempo_tpu_torch`` from DIR (this checkout, or an unpacked older
commit: the script stages through the package's own
``MultiBlockEngine.stage_host`` and ``place_batch``, compiles members
with ``compile_multi`` and ``stack_queries``, takes
``MultiBlockEngine.coalesced_tables`` and calls only the public
``scan.coalesced_scan``), builds its kernels, and prints one JSON object
(also appended to FILE): per case, the card ms (CUDA events around 20
calls back to back), the device ms (``bench_structural.event_ms``: the
median of 20 single synchronised calls between CUDA events), the bound
(``k4_bytes`` over 3.35 TB/s), the plain version's ms and whether the
kernel's scores, counts and inspected count equal the plain version's
exactly; and the ptxas registers and spills of every ``coalesced_kernel``
build. To compare two commits, run both in one command on one card, in
turns (old, new, new, old).

Corpora, from a seed, with the kernel phases' shapes in ``chip_smoke.py``
(1,024 entries a page): the tag corpus, 64 blocks of 65,536 traces (one
4,096-page group; int8 keys, int16 values, C = 8); the high-cardinality
corpus, 4 blocks of 1,048,576 traces with a unique ``session.id`` each
(int8/int32, C = 9, every dictionary staged for the device probe); the
structural corpus of ``bench_structural.py`` (1,024 pages). Cases: range
mode with Q = 1, 2, 4, 8, 16 and 64 members ``svc-i AND 500`` (Q = 8 is
``chip_smoke.py``'s ``CONCURRENT_TAGS``; T = 2, R = 4), and K1
``multi_scan`` on the first member alone; hit-mask mode with 6 probed
session substrings and 2 members compiled on the host (a duration and a
window, no terms); packed range (u4/u16/u16) and packed word-hit
(u4/u32/u16, C = 10) at Q = 8; verdicts: the 8 bucketed plans of
``bench_structural.py``, K6 first.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
E = 1024
SEED = 20261017
BASE_S = 1_700_000_000
BLOCK_SPAN_S = 600
TAG_BLOCKS, TAG_TRACES = 64, 65_536
HC_BLOCKS, HC_TRACES = 4, 1_048_576
Q_SWEEP = (1, 2, 4, 8, 16, 64)
HC_SESSIONS = ("77", "123", "404", "5555", "0012", "99")
SESSION_KEY = "session.id"


def sector_bytes(mask, item_bytes: float) -> int:
    """Bytes of the 32-byte memory sectors holding the elements of a
    contiguous tensor of `item_bytes` items (0.5 for a u4 code, two to a
    byte; 1, 2 or 4: each item lies in one sector) where `mask` is
    true."""
    import torch

    m = mask.reshape(-1)
    per = int(32 / item_bytes)
    if m.numel() % per:
        m = torch.cat([m, m.new_zeros(per - m.numel() % per)])
    return int(m.reshape(-1, per).any(dim=1).sum()) * 32


def _item(t, w) -> float:
    """Bytes per slot of a kv column of width `w` (None: unpacked)."""
    return 0.5 if w == "u4" else t.element_size()


def k1_touch(args, val_hits=None, block_group=None, widths=None,
             res=None, verdicts=None) -> dict:
    """What K1's function must read on these inputs, as masks over the
    entries: `live` (whose key slots it reads, when there are terms),
    `need_val` (the value slots whose key a term names, for entries still
    alive at that term, up to the first that passes), `dur`/`end`/`start`
    (the entries whose column it reads: those that passed the terms,
    duration and window end only where the bound excludes some value),
    `res` (bucketed durations: the entries whose bucket sits on a bound's
    bucket, which read their residual) and `match`; plus `hit_bytes`, the
    hit-table sectors (bytes or words) those value slots look up in
    hit-mask mode. `args` are K1's; `widths`/`res` the packed layout's;
    `verdicts` K6's (read for every live entry, and only the entries
    they pass go on to the terms)."""
    import torch

    from tempo_tpu_torch.search import packing

    (kv_key, kv_val, start, end, dur, valid, page_block, term_keys,
     val_ranges, n_terms, dur_lo, dur_hi, win_start, win_end) = args
    kw, vw, dw = widths or (None, None, None)
    u32 = 0xFFFFFFFF
    pb = page_block.long()
    safe = pb.clamp(min=0)
    live = valid & (pb >= 0)[:, None]
    alive = live.clone()
    if verdicts is not None:
        alive &= verdicts.reshape(live.shape) != 0
    kk = packing.unpack_ids(kv_key, kw)
    vv = packing.unpack_ids(kv_val, vw)
    need_val = torch.zeros_like(kk, dtype=torch.bool)
    hit_sectors = 0
    if n_terms:
        slot = torch.arange(kk.shape[2], device=kk.device)
        if val_hits is not None:
            words = packing.is_packed_mask(val_hits)
            G, Tp, Wm = val_hits.shape
            bg = block_group.long()[safe]
            probe_page = (bg >= 0)[:, None, None]
            g_idx = bg.clamp(min=0)[:, None, None].expand_as(vv)
            safe_v = vv.clamp(min=0)
            col = (safe_v >> 5 if words else safe_v).clamp(max=Wm - 1)
            per = 8 if words else 32
            touched = torch.zeros(-(-G * Tp * Wm // per), dtype=torch.bool,
                                  device=kk.device)
        for t in range(n_terms):
            keym = (kk == term_keys[safe, t][:, None, None]) & alive[..., None]
            inr = torch.zeros_like(keym)
            for r in range(val_ranges.shape[2]):
                inr |= ((vv >= val_ranges[safe, t, r, 0][:, None, None])
                        & (vv <= val_ranges[safe, t, r, 1][:, None, None]))
            if val_hits is not None:
                mh = packing.mask_select_grouped(val_hits, g_idx, t,
                                                 safe_v) & (vv >= 0)
                inr = torch.where(probe_page, mh, inr)
            hit = keym & inr
            first = torch.where(hit.any(-1), hit.int().argmax(-1),
                                kk.shape[2])
            need = keym & (slot <= first[..., None])
            need_val |= need
            if val_hits is not None:
                look = need & probe_page & (vv >= 0)
                flat = (g_idx * Tp + t) * Wm + col
                touched[flat[look] // per] = True
            alive &= hit.any(-1)
        if val_hits is not None:
            hit_sectors = int(touched.sum()) * 32
    out = {"live": live, "need_val": need_val, "hit_bytes": hit_sectors,
           "terms": bool(n_terms), "dur": None, "end": None, "res": None,
           "C": int(kk.shape[2]),
           "verdicts": None if verdicts is None else live.clone(),
           "key_rows": live if verdicts is None else
           live & (verdicts.reshape(live.shape) != 0)}
    if dur_lo != 0 or dur_hi != u32:
        out["dur"] = alive.clone()
        if dw is not None and dw.startswith("q"):
            s = packing.dur_shift(dw)
            q = dur.long() & 0xFFFF
            out["res"] = alive & ((q == (dur_lo >> s)) | (q == (dur_hi >> s)))
        alive &= packing.duration_ok(dur, res, dur_lo, dur_hi, dw)
    if win_start != 0:
        out["end"] = alive.clone()
        alive &= (end.long() & u32) >= win_start
    out["start"] = alive.clone()
    alive &= (start.long() & u32) <= win_end
    out["match"] = alive
    return out


def touched_bytes(t: dict, kv_key, kv_val, widths=None, res=None) -> int:
    """Sectors of the kv slots and entry columns a k1_touch result reads,
    plus its hit-table sectors, at the layout's item sizes."""
    kw, vw, _dw = widths or (None, None, None)
    total = t["hit_bytes"]
    if t.get("verdicts") is not None:
        total += sector_bytes(t["verdicts"], 1)
    if t["terms"]:
        live = t.get("key_rows", t["live"])
        total += sector_bytes(live[..., None].expand(*live.shape, t["C"])
                              .contiguous(), _item(kv_key, kw))
        total += sector_bytes(t["need_val"], _item(kv_val, vw))
    dur_item = 4 if widths is None else 2
    for col, item in (("dur", dur_item), ("end", 4), ("start", 4)):
        if t[col] is not None:
            total += sector_bytes(t[col], item)
    if t["res"] is not None:
        total += sector_bytes(t["res"], res.element_size())
    return total


def k1_bytes(args, scores, val_hits=None, block_group=None,
             single: bool = False, widths=None, res=None,
             verdicts=None) -> int:
    """The bytes K1's (or, with `single`, K1s's) function must move on
    these inputs, counted in the sectors this run's data touches: the
    valid flags (and page ids) read and the scores and counts written,
    all; the term tables; and what k1_touch finds. `args` are K1's (K1s's
    are given in K1's form: page_block all 0, tables as row 0)."""
    import torch

    t = k1_touch(args, val_hits, block_group, widths, res, verdicts)
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
    return total + touched_bytes(t, kv_key, kv_val, widths, res)


def k4_bytes(page, tables, scores, widths=None, res=None,
             verdicts=None) -> int:
    """The bytes K4's function must move on these inputs: the valid flags
    and page ids read and the Q score columns and counts written, all;
    the stacked tables; and the union over the real queries of what
    k1_touch finds for each (a pad query, whose duration range is empty,
    reads no page data). `page` are K1's page arrays, `tables` K4's
    per-query inputs, `widths`/`res` the packed layout's."""
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
        v = None
        if verdicts is not None:
            v = verdicts[q] if q < verdicts.shape[0] else \
                torch.zeros_like(verdicts[0])
        t = k1_touch((*page, tk[q][:, act], vr[q][:, act], int(act.numel()),
                      *b), vh, bgq, widths, res, v)
        if not torch.equal(t["match"].reshape(-1), scores[q] >= 0):
            raise AssertionError(f"k4_bytes: its predicate differs from "
                                 f"K4's for query {q}")
        hit_bytes += t["hit_bytes"]
        if t["verdicts"] is not None:     # each query reads its own row
            hit_bytes += sector_bytes(t["verdicts"], 1)
            t["verdicts"] = None
        if u is None:
            u = t
            continue
        u["terms"] |= t["terms"]
        u["need_val"] |= t["need_val"]
        u["key_rows"] = u["key_rows"] | t["key_rows"]
        for col in ("dur", "end", "start", "res"):
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
        total += touched_bytes(u, kv_key, kv_val, widths, res)
    return total




# ---------------------------------------------------------------------
# ptxas's report of the builds


def ptxas_usage(log: str) -> dict:
    """{kernel: {"registers", "stack", "spill_stores", "spill_loads"}}
    of the entry functions in nvcc's ``-Xptxas -v`` output, their names
    demangled (``cu++filt`` beside nvcc, else ``c++filt``; mangled when
    neither is found) and stripped of the anonymous namespace."""
    out: dict = {}
    entry = props = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props in out:
            out[props].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry]["registers"] = int(m.group(1))
    names = _demangle(list(out))
    return {names.get(k, k): v for k, v in out.items()}


def _demangle(names: list) -> dict:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    for tool in (os.path.join(os.path.dirname(nvcc), "cu++filt"),
                 shutil.which("cu++filt"), shutil.which("c++filt")):
        if not names or not tool or not os.path.exists(tool):
            continue
        done = subprocess.run([tool], input="\n".join(names), text=True,
                              capture_output=True, timeout=60)
        lines = done.stdout.splitlines()
        if done.returncode == 0 and len(lines) == len(names):
            return {n: _short(d) for n, d in zip(names, lines)}
    return {}


def _short(name: str) -> str:
    """A demangled kernel name without its namespace, return type,
    parameter list and template-value casts:
    ``coalesced_kernel<Ids<signed char>, Ids<short>, 0>``."""
    name = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", name)
    name = name.replace("(int)", "").removeprefix("void ").strip()
    return name[:name.rindex("(")] if "(" in name else name


# the reader of each kv layout in csrc/scan_common.cuh, by unpacked dtype
# or packed width
READERS = {"int8": "Ids<signed char>", "int16": "Ids<short>",
           "int32": "Ids<int>", "u4": "Nibbles",
           "u8": "Codes<unsigned char>", "u16": "Codes<unsigned short>",
           "u32": "Codes<unsigned int>"}


def k4_build(kv_key, kv_val, widths, hit_words=None) -> str:
    """The name of the ``coalesced_kernel`` build a K4 call launches:
    its readers and hit mode (0 ranges, 1 byte, 2 word hit tables;
    `hit_words` None for range mode)."""
    kw, vw = (None, None) if widths is None else widths[:2]
    kr = READERS[kw or str(kv_key.dtype).split(".")[-1]]
    vr = READERS[vw or str(kv_val.dtype).split(".")[-1]]
    hit = 0 if hit_words is None else (2 if hit_words else 1)
    return f"coalesced_kernel<{kr}, {vr}, {hit}>"


def k4_usage(log: str) -> dict:
    """ptxas_usage of K4's builds alone: ``coalesced_kernel`` (the scan)
    and ``coalesced_terms_kernel`` (its term tables)."""
    return {k: v for k, v in ptxas_usage(log).items()
            if "coalesced_kernel" in k or "coalesced_terms_kernel" in k}


# ---------------------------------------------------------------------
# the bench


def make_block(b: int, n: int, sessions: bool):
    """Block b of the tag corpus (``chip_smoke.py``'s eight tags a trace,
    one a kv slot, values seeded), or with `sessions` of the
    high-cardinality corpus (a ninth tag, ``session.id``
    "session-%08d", unique across blocks of n traces), as
    ColumnarPages; n is a multiple of 1,024."""
    import bisect

    import numpy as np

    from tempo_tpu_torch.search.columnar import ColumnarPages
    from tempo_tpu_torch.search.kernels.bench_structural import KEYS

    rng = np.random.default_rng([SEED, b])
    base_vals = sorted({v for vs in KEYS.values() for v in vs})
    key_dict = sorted(list(KEYS) + ([SESSION_KEY] if sessions else []))
    lo = bisect.bisect_left(base_vals, "session-")
    n_sess = n if sessions else 0
    val_dict = (base_vals[:lo]
                + [f"session-{b * n + k:08d}" for k in range(n_sess)]
                + base_vals[lo:])
    vidx = {v: (i if i < lo else i + n_sess)
            for i, v in enumerate(base_vals)}
    P, C = n // E, len(key_dict)
    kv_key = np.broadcast_to(np.arange(C, dtype=np.int32), (P, E, C)).copy()
    kv_val = np.empty((P, E, C), dtype=np.int32)
    for c, k in enumerate(key_dict):
        if k == SESSION_KEY:
            kv_val[:, :, c] = (lo + rng.permutation(n).astype(np.int32)) \
                .reshape(P, E)
            continue
        ids = np.asarray([vidx[v] for v in KEYS[k]], dtype=np.int32)
        kv_val[:, :, c] = ids[rng.integers(0, len(ids), size=(P, E))]
    start = (BASE_S + b * BLOCK_SPAN_S
             + rng.integers(0, BLOCK_SPAN_S, size=(P, E))).astype(np.uint32)
    dur = rng.integers(1, 60_000, size=(P, E)).astype(np.uint32)
    end = (start + dur // 1000).astype(np.uint32)
    trace_ids = np.frombuffer(rng.bytes(P * E * 16),
                              dtype=np.uint8).reshape(P, E, 16)
    svc = kv_val[:, :, key_dict.index("service.name")].copy()
    name = kv_val[:, :, key_dict.index("name")]
    return ColumnarPages.from_arrays(
        key_dict, val_dict, kv_key, kv_val, start, end, dur,
        np.ones((P, E), dtype=bool), svc, name, trace_ids)


def compile_members(eng, batch, reqs: list, plans=None) -> list:
    """MultiQueries of (tags, fields) requests over `batch`, compiled as
    the batcher compiles them; with `plans`, each also carries its
    structural plan."""
    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search import ir, structural
    from tempo_tpu_torch.search.multiblock import compile_multi

    out = []
    for i, (tags, kw) in enumerate(reqs):
        mq = compile_multi(list(batch.blocks),
                           SearchRequest(tags=dict(tags), **kw),
                           memo=batch.memo, cache=eng.compile_cache,
                           staged_dicts=batch.staged_dicts,
                           packed=eng.packed)
        if mq is None:
            raise AssertionError(f"member {tags} prunes every block")
        if plans is not None:
            mq.structural = structural.compile_structural(
                ir.parse(json.dumps(plans[i])), list(batch.blocks),
                staged_dicts=batch.staged_dicts, packed=eng.packed,
                memo=batch.memo)
        out.append(mq)
    return out


def page_of(batch) -> tuple:
    d = batch.device
    return (d["kv_key"], d["kv_val"], d["entry_start"], d["entry_end"],
            d["entry_dur"], d["entry_valid"], d["page_block"])


def k4_case(eng, batch, mqs: list, verdicts=None, bucket=16) -> dict:
    """K4 over the stacked members on `batch`: card, device, bound and
    plain ms, and exactness against the plain version."""
    import torch

    from tempo_tpu_torch.search.kernels import scan
    from tempo_tpu_torch.search.kernels.bench_structural import (card_ms,
                                                                 event_ms)
    from tempo_tpu_torch.search.multiblock import stack_queries

    cq = stack_queries(mqs, bucket)
    page = page_of(batch)
    tables = eng.coalesced_tables(cq)
    layout = (batch.widths, batch.device.get("entry_dur_res"), verdicts)

    def fn():
        return scan.coalesced_scan(*page, *tables, *layout)

    def plain():
        return scan.coalesced_scan_plain(*page, *tables, *layout)

    got, want = fn(), plain()
    torch.cuda.synchronize()
    exact = all(g.shape == w.shape and torch.equal(g, w)
                for g, w in zip(got, want))
    need = k4_bytes(page, tables, got[0], *layout)
    return {"Q": int(got[0].shape[0]), "members": cq.n_queries,
            "card_ms": card_ms(fn, 20), "device_ms": event_ms(fn),
            "bound_ms": need / HBM_BYTES_PER_S * 1e3, "bytes": need,
            "plain_ms": card_ms(plain, 3), "exact": exact,
            "counts": got[1].tolist(), "inspected": int(got[2]),
            "build": k4_build(page[0], page[1], batch.widths,
                              None if cq.val_hits is None else
                              next((int(h.dtype == torch.int32)
                                    for h in cq.val_hits if h is not None),
                                   0))}


def k1_case(eng, batch, mq) -> dict:
    """K1 (``multi_scan``) on one member alone, the yardstick of K4 at
    Q = 1."""
    import torch

    from tempo_tpu_torch.search.kernels import scan
    from tempo_tpu_torch.search.kernels.bench_structural import (card_ms,
                                                                 event_ms)

    dev = batch.device["kv_key"].device
    page = page_of(batch)
    bg = (None if mq.block_group is None
          else torch.from_numpy(mq.block_group).to(dev))
    args = (*page, torch.from_numpy(mq.term_keys).to(dev),
            torch.from_numpy(mq.val_ranges).to(dev), mq.n_terms, mq.dur_lo,
            min(mq.dur_hi, 0xFFFFFFFF), mq.win_start,
            min(mq.win_end, 0xFFFFFFFF))
    extra = (mq.val_hits, bg, batch.widths,
             batch.device.get("entry_dur_res"))

    def fn():
        return scan.multi_scan(*args, *extra)

    got, want = fn(), scan.multi_scan_plain(*args, *extra)
    torch.cuda.synchronize()
    need = k1_bytes(args, got[0], mq.val_hits, bg, widths=batch.widths,
                    res=extra[3])
    return {"card_ms": card_ms(fn, 20), "device_ms": event_ms(fn),
            "bound_ms": need / HBM_BYTES_PER_S * 1e3, "bytes": need,
            "exact": all(torch.equal(g, w) for g, w in zip(got, want))}


def measure(label: str) -> dict:
    import torch

    from tempo_tpu_torch.search import structural
    from tempo_tpu_torch.search.kernels import bench_structural as bs
    from tempo_tpu_torch.search.multiblock import (MultiBlockEngine,
                                                   place_batch,
                                                   stack_queries)

    dev = torch.device("cuda", 0)
    out = {"label": label, "card": torch.cuda.get_device_name(0),
           "cases": {}}

    def record(name, r):
        out["cases"][name] = r
        print(f"{label} {name}: {json.dumps(r)}", flush=True)
        if not r["exact"]:
            raise AssertionError(f"{label} {name}: the kernel differs from "
                                 "its plain version")

    t0 = time.perf_counter()
    tag = [make_block(b, TAG_TRACES, False) for b in range(TAG_BLOCKS)]
    out["corpus_s"] = {"tag": time.perf_counter() - t0}
    for packed in (False, True):
        eng = MultiBlockEngine(dev, packed=packed)
        batch = place_batch(eng.stage_host(tag), dev)
        svc = [({"service.name": f"svc-{i:03d}", "http.status_code": "500"},
                {"limit": 20}) for i in range(max(Q_SWEEP))]
        mqs = compile_members(eng, batch, svc)
        if packed:
            record("packed range Q=8", k4_case(eng, batch, mqs[:8]))
        else:
            record("K1 range (the Q=1 member)", k1_case(eng, batch, mqs[0]))
            for q in Q_SWEEP:
                record(f"range Q={q}", k4_case(eng, batch, mqs[:q]))
        del batch
        torch.cuda.empty_cache()
    del tag

    t0 = time.perf_counter()
    hc = [make_block(b, HC_TRACES, True) for b in range(HC_BLOCKS)]
    out["corpus_s"]["hc"] = time.perf_counter() - t0
    members = ([({SESSION_KEY: v, "x-dbg-exhaustive": ""}, {"limit": 20})
                for v in HC_SESSIONS]
               + [({}, {"min_duration_ms": 59_000, "limit": 20}),
                  ({}, {"start": BASE_S + 300, "end": BASE_S + 900,
                        "limit": 20})])
    for packed in (False, True):
        eng = MultiBlockEngine(dev, packed=packed)
        batch = place_batch(eng.stage_host(hc), dev)
        mqs = compile_members(eng, batch, members)
        if sum(mq.val_hits is not None for mq in mqs) != len(HC_SESSIONS):
            raise AssertionError("the session members did not all probe")
        record(("packed word-hit" if packed else "hit-mask")
               + " Q=8 (6 probed)", k4_case(eng, batch, mqs))
        del batch
        torch.cuda.empty_cache()
    del hc

    t0 = time.perf_counter()
    st = [bs.make_block(b) for b in range(bs.BLOCKS)]
    out["corpus_s"]["structural"] = time.perf_counter() - t0
    cfg = structural.StructuralConfig(True)
    eng = MultiBlockEngine(dev, structural_cfg=cfg)
    batch = place_batch(eng.stage_host(st), dev)
    reqs = [({structural.STRUCTURAL_QUERY_TAG: _plan_tag(p),
              "x-dbg-exhaustive": ""}, {"limit": 20})
            for p in bs.BUCKET_PLANS]
    mqs = compile_members(eng, batch, reqs, bs.BUCKET_PLANS)
    cq = stack_queries(mqs, cfg.bucket_max_nodes)
    verdicts = eng.structural_verdicts(batch, cq.structural.lanes)
    record("verdicts Q=8 (bucketed)",
           k4_case(eng, batch, mqs, verdicts, cfg.bucket_max_nodes))
    return out


def _plan_tag(plan: dict) -> str:
    from tempo_tpu_torch.search import ir

    return ir.quote(ir.to_json(ir.parse(json.dumps(plan))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose tempo_tpu_torch to import")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_coalesced: no CUDA card", file=sys.stderr)
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
    res["ptxas"] = k4_usage(build.BUILD_LOG.get("scan", ""))
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
