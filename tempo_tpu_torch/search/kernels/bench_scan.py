"""Time the scan kernels K1 (``multi_scan``) and K1s (``scan_single``) of
one checkout of the port on one CUDA card, at the shapes of their rows in
PERF.md's kernel table, against their plain versions.

  python3 tempo_tpu_torch/search/kernels/bench_scan.py --root DIR \\
      --label NAME [--out FILE]

imports ``tempo_tpu_torch`` and ``chip_smoke`` (the corpora and requests
of the main path's cells) from DIR (this checkout, or an unpacked older
commit), stages through the package's own ``MultiBlockEngine.stage_host``
/ ``place_batch`` and ``engine.stage``, compiles each request as the
batcher and the single-block path compile it, calls only the public
``scan.multi_scan`` / ``scan.scan_single``, and prints one JSON object
(also appended to FILE): per case, the card ms (CUDA events around 50
calls back to back, as ``chip_smoke.py``'s kernel rows), the device ms
(``bench_structural.event_ms``: the median of 20 single synchronised
calls between CUDA events), the bound (``bench_coalesced.k1_bytes``, the
sectors this run's data touches, over 3.35 TB/s), the plain version's
ms, and whether the kernel's scores and counts equal the plain version's
exactly; then ptxas's registers and spills of every K1/K1s build. To
compare two commits, run both in one command on one card, in turns (old,
new, new, old).

Cases, from ``chip_smoke.py``'s seed (1,024 entries a page):
  - K1 range: the tag corpus (64 blocks x 65,536 traces, one 4,096-page
    group; int8/int16, C = 8), ``svc-007 AND 500`` (T = 2, R = 4);
  - K1 packed range: the same blocks packed (u4/u16/u16);
  - K1 packed q6: the long-duration corpus (64 x 65,536, 1 in 64 up to
    an hour; u4/u16/q6 with a u8 residual), 65,536-131,071 ms;
  - K1 hit-mask: the high-cardinality corpus (4 x 1,048,576 traces with
    a unique session.id; int8/int32, C = 9), ``77`` exhaustive, probed;
  - K1 packed word-hit: the same blocks packed (u4/u32/u16, C = 10);
  - K1s hit-mask and K1s packed: its block 0 alone (1,024 pages),
    ``svc-007 AND 500`` through the device probe;
  - K1 verdicts: the structural corpus (16 x 65,536 traces, 1-31 spans
    each; 1,024 pages), the exact desc plan's K6 verdicts;
  - K1s verdicts: its block 0 alone (64 pages), the same plan.
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
SEED = 20261017
TAG_BLOCKS, TAG_TRACES = 64, 65_536
LONG_BLOCKS, LONG_EVERY = 64, 64
HC_BLOCKS, HC_TRACES = 4, 1_048_576
ST_BLOCKS, ST_TRACES = 16, 65_536


def k1_usage(log: str) -> dict:
    """ptxas_usage of the K1/K1s builds: ``k1_kernel`` (requests with
    terms) and ``k1_cols_kernel`` (without), or an older checkout's
    ``scan_kernel``."""
    from tempo_tpu_torch.search.kernels.bench_coalesced import ptxas_usage

    return {k: v for k, v in ptxas_usage(log).items()
            if k.startswith(("k1_kernel<", "k1_cols_kernel<",
                             "scan_kernel<"))}


def k1_case(fn, plain, need: int) -> dict:
    """A K1/K1s call `fn` against its plain version: card, device, bound
    and plain ms, and exact equality."""
    import torch

    from tempo_tpu_torch.search.kernels.bench_structural import (card_ms,
                                                                 event_ms)

    got, want = fn(), plain()
    torch.cuda.synchronize()
    exact = all(g.shape == w.shape and torch.equal(g, w)
                for g, w in zip(got, want))
    return {"card_ms": card_ms(fn, 50), "device_ms": event_ms(fn),
            "bound_ms": need / HBM_BYTES_PER_S * 1e3, "bytes": need,
            "plain_ms": card_ms(plain, 3), "exact": exact,
            "counts": got[1].tolist()}


def multi_case(batch, mq, verdicts=None) -> dict:
    """K1 over a staged batch with a compiled MultiQuery."""
    import torch

    from tempo_tpu_torch.search.kernels import scan
    from tempo_tpu_torch.search.kernels.bench_coalesced import (k1_bytes,
                                                                page_of)

    dev = batch.device["kv_key"].device
    bg = (None if mq.block_group is None
          else torch.from_numpy(mq.block_group).to(dev))
    args = (*page_of(batch), torch.from_numpy(mq.term_keys).to(dev),
            torch.from_numpy(mq.val_ranges).to(dev), mq.n_terms, mq.dur_lo,
            min(mq.dur_hi, 0xFFFFFFFF), mq.win_start,
            min(mq.win_end, 0xFFFFFFFF))
    res = batch.device.get("entry_dur_res")
    extra = (mq.val_hits, bg, batch.widths, res, verdicts)
    got = scan.multi_scan(*args, *extra)
    need = k1_bytes(args, got[0], mq.val_hits, bg, widths=batch.widths,
                    res=res, verdicts=verdicts)
    out = k1_case(lambda: scan.multi_scan(*args, *extra),
                  lambda: scan.multi_scan_plain(*args, *extra), need)
    out.update(pages=batch.n_pages, widths=batch.widths,
               C=int(batch.device["kv_key"].shape[2]), n_terms=mq.n_terms)
    return out


def single_case(sp, se, cq, verdicts=None) -> dict:
    """K1s over one staged block with a CompiledQuery."""
    import torch

    from tempo_tpu_torch.search.kernels import scan
    from tempo_tpu_torch.search.kernels.bench_coalesced import k1_bytes

    d = sp.device
    dev = d["kv_key"].device
    tk, vr = se._tables(cq)
    cols = (d["kv_key"], d["kv_val"], d["entry_start"], d["entry_end"],
            d["entry_dur"], d["entry_valid"])
    bounds = (cq.dur_lo, min(cq.dur_hi, 0xFFFFFFFF), cq.win_start,
              min(cq.win_end, 0xFFFFFFFF))
    res = d.get("entry_dur_res")
    vh = cq.val_hits if cq.n_terms else None
    s_args = (*cols, tk, vr, cq.n_terms, *bounds, vh, sp.widths, res,
              verdicts)
    got = scan.scan_single(*s_args)
    P = d["kv_key"].shape[0]
    as_multi = (*cols, torch.zeros(P, dtype=torch.int32, device=dev),
                tk[None], vr[None], cq.n_terms, *bounds)
    need = k1_bytes(as_multi, got[0], None if vh is None else vh[None],
                    None if vh is None else
                    torch.zeros(1, dtype=torch.int32, device=dev),
                    single=True, widths=sp.widths, res=res,
                    verdicts=verdicts)
    out = k1_case(lambda: scan.scan_single(*s_args),
                  lambda: scan.scan_single_plain(*s_args), need)
    out.update(pages=P, widths=sp.widths, C=int(d["kv_key"].shape[2]),
               n_terms=cq.n_terms)
    return out


def compile_single(sp, se, tags: dict, kw: dict):
    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search.pipeline import compile_query

    pages = sp.pages
    return compile_query(pages.key_dict, pages.val_dict,
                         SearchRequest(tags=dict(tags), **kw),
                         cache_on=pages, cache=se.compile_cache,
                         staged_dict=sp.staged_dict, packed=se.packed)


def measure(label: str) -> dict:
    import chip_smoke as cs
    import torch

    from tempo_tpu_torch.search import ir, structural
    from tempo_tpu_torch.search.engine import ScanEngine, stage
    from tempo_tpu_torch.search.kernels.bench_coalesced import \
        compile_members
    from tempo_tpu_torch.search.multiblock import (MultiBlockEngine,
                                                   place_batch)

    dev = torch.device("cuda", 0)
    out = {"label": label, "card": torch.cuda.get_device_name(0),
           "cases": {}, "corpus_s": {}}

    def record(name, r):
        out["cases"][name] = r
        print(f"{label} {name}: {json.dumps(r)}", flush=True)
        if not r["exact"]:
            raise AssertionError(f"{label} {name}: the kernel differs from "
                                 "its plain version")

    def corpus(name, blocks, n, **kw):
        t0 = time.perf_counter()
        bl = [cs.make_block(SEED, b, n, E, **kw) for b in range(blocks)]
        out["corpus_s"][name] = time.perf_counter() - t0
        return bl

    def batch_of(blocks, packed, **kw):
        eng = MultiBlockEngine(dev, packed=packed, **kw)
        return eng, place_batch(eng.stage_host(blocks), dev)

    bench = (cs.BENCH, {"limit": 20})
    tag = corpus("tag", TAG_BLOCKS, TAG_TRACES)
    for packed in (False, True):
        eng, batch = batch_of(tag, packed)
        (mq,) = compile_members(eng, batch, [bench])
        record("K1 packed range" if packed else "K1 range",
               multi_case(batch, mq))
        del batch
        torch.cuda.empty_cache()
    del tag

    long = corpus("long", LONG_BLOCKS, TAG_TRACES, long_every=LONG_EVERY)
    eng, batch = batch_of(long, True)
    if not str(batch.widths[2]).startswith("q"):
        raise AssertionError(f"the long-duration batch is {batch.widths}")
    (mq,) = compile_members(eng, batch,
                            [cs.long_requests()["long_65536_131071"]])
    record("K1 packed q6", multi_case(batch, mq))
    del batch, long
    torch.cuda.empty_cache()

    hc = corpus("hc", HC_BLOCKS, HC_TRACES, sessions=True)
    for packed in (False, True):
        eng, batch = batch_of(hc, packed)
        (mq,) = compile_members(eng, batch,
                                [cs.hc_requests()["hc_exhaustive_77"]])
        if mq.val_hits is None:
            raise AssertionError("the hc request compiled no hit mask")
        record("K1 packed word-hit" if packed else "K1 hit-mask",
               multi_case(batch, mq))
        del batch
        torch.cuda.empty_cache()
        sp = stage(hc[0], dev, packed=packed)
        se = ScanEngine(dev, packed=packed)
        cq = compile_single(sp, se, *bench)
        if cq.val_hits is None:
            raise AssertionError("the single block compiled no hit mask")
        record("K1s packed" if packed else "K1s hit-mask",
               single_case(sp, se, cq))
        del sp
        torch.cuda.empty_cache()
    del hc

    st = corpus("structural", ST_BLOCKS, ST_TRACES, spans=True)
    plan = cs.ST_PLANS["desc"]
    eng, batch = batch_of(st, False,
                          structural_cfg=structural.StructuralConfig(True))
    (mq,) = compile_members(eng, batch, [(cs.st_tag(plan, True),
                                          {"limit": 20})], [plan])
    v = eng.structural_verdicts(batch, mq.structural.lanes())[0]
    record("K1 verdicts", multi_case(batch, mq, v))
    del batch, v
    torch.cuda.empty_cache()
    sp = stage(st[0], dev, spans=True)
    se = ScanEngine(dev)
    cq = compile_single(sp, se, cs.st_tag(plan, True), {"limit": 20})
    st1 = structural.compile_structural(ir.parse(json.dumps(plan)), [sp.pages],
                                        packed=False)
    vs = se.structural_verdicts(sp, st1.lanes())[0]
    record("K1s verdicts", single_case(sp, se, cq, vs))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose tempo_tpu_torch and chip_smoke to "
                         "import")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_scan: no CUDA card", file=sys.stderr)
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
    res["ptxas"] = k1_usage(build.BUILD_LOG.get("scan", ""))
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
