"""The offload planner on the port against the reference's.

The reference's ``tests/test_planner.py`` on the port (but its
``/debug/planner`` endpoint and the offline-replay script, which come
with the serving layer): the static threshold stays the floor; with the
planner off the static path is unchanged; both verdicts answer alike on
the single-block, batched, coalesced, distributed single-block and mesh
paths (an in-process exchange, and two gloo ranks), and alike with the
reference; a group plans once; a cold planner seeds itself; the cost
model's arithmetic and its predicted-vs-actual resolution are the
reference's. The corpus is the reference test's, made from a seed, built
by each package. Then the port's deliberate differences: one planner per
database, fed by that database's records alone; a seed that raises on a
device fault; ``compile`` charged only while a kernel library is still
to load.
"""

from __future__ import annotations

import logging
import random
import threading

import numpy as np
import pytest
import torch

from tempo_tpu import tempopb
from tempo_tpu.search import pipeline as ref_pipeline
from tempo_tpu.search import planner as ref_planner
from tempo_tpu.search.batcher import BlockBatcher as RefBatcher
from tempo_tpu.search.batcher import ScanJob as RefJob
from tempo_tpu.search.columnar import ColumnarPages as RefPages
from tempo_tpu.search.columnar import PageGeometry as RefGeometry
from tempo_tpu.search.data import SearchData as RefSearchData
from tempo_tpu.search.engine import ScanEngine as RefScanEngine
from tempo_tpu.search.engine import stage as ref_stage
from tempo_tpu.search.multiblock import MultiBlockEngine as RefEngine
from tempo_tpu.search.multiblock import compile_multi as ref_compile_multi
from tempo_tpu.search.multiblock import stack_blocks as ref_stack_blocks
from tempo_tpu.search.pipeline import compile_query as ref_compile_query

from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.model.types import SearchRequest
from tempo_tpu_torch.observability import metrics as obs
from tempo_tpu_torch.observability import profile
from tempo_tpu_torch.parallel import mesh
from tempo_tpu_torch.parallel import multihost_dryrun as md
from tempo_tpu_torch.parallel.dist_search import DistributedScanEngine
from tempo_tpu_torch.search import dict_probe, planner
from tempo_tpu_torch.search.batcher import BlockBatcher, ScanJob
from tempo_tpu_torch.search.columnar import ColumnarPages, PageGeometry
from tempo_tpu_torch.search.data import SearchData
from tempo_tpu_torch.search.engine import (ScanEngine, fetch_coalesced_out,
                                           fetch_scan_out, stage)
from tempo_tpu_torch.search.kernels import build
from tempo_tpu_torch.search.multiblock import (MultiBlockEngine,
                                               compile_multi,
                                               pack_batch_dicts, stack_host,
                                               stack_queries)
from tempo_tpu_torch.search.pipeline import CompileCache, compile_query

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_state():
    """The reference's compile cache and the port's process planner are
    process-wide: start each test from them empty and off."""
    ref_pipeline._COMPILE_CACHE.clear()
    planner.configure(enabled=False, seed=True, reset=True, device=CPU)
    yield
    planner.configure(enabled=False, seed=True, reset=True)
    planner.PLANNER.device = None
    ref_pipeline._COMPILE_CACHE.clear()


def _planner(target: str | None = None, device=CPU) -> planner.OffloadPlanner:
    """A planner on `device`, on, with no seed; with `target`, fed
    observations under which that side wins every decision."""
    p = planner.OffloadPlanner(enabled=True, seed=False, device=device)
    if target is not None:
        md.force_planner(p, target)
    return p


def _gate(p=None, enabled: bool = True) -> profile.Gate:
    return profile.Gate(enabled=enabled, planner=p)


def _corpus(n, seed, card=300, pkg="port"):
    """The reference test's corpus: a session id of `card` values and a
    service a trace."""
    SD = SearchData if pkg == "port" else RefSearchData
    rng = random.Random(seed)
    out = []
    for i in range(n):
        tid = (seed.to_bytes(2, "big") + i.to_bytes(4, "big")).rjust(16,
                                                                     b"\x00")
        sd = SD(trace_id=tid)
        sd.start_s = 1_600_000_000 + seed * 1_000_000 + i
        sd.end_s = sd.start_s + 5
        sd.dur_ms = rng.randint(1, 30_000)
        sd.kvs = {"session.id": {f"session-{rng.randint(0, card - 1):04d}"},
                  "svc": {rng.choice(["frontend", "cart"])}}
        out.append(sd)
    return out


def _pages(n, seed, card=300, geo=(32, 8)):
    """(port ColumnarPages, reference ColumnarPages) of one corpus."""
    return (ColumnarPages.build(_corpus(n, seed, card), PageGeometry(*geo)),
            RefPages.build(_corpus(n, seed, card, "ref"), RefGeometry(*geo)))


def _blocks(n=3, entries=150, small_tail=True):
    pairs = [_pages(entries, s) for s in range(n)]
    if small_tail:
        pairs.append(_pages(80, 9, card=3))
    return [p for p, _ in pairs], [r for _, r in pairs]


def _req(tags, **kw) -> SearchRequest:
    return SearchRequest(tags=dict(tags), **kw)


def _ref_req(tags, **kw):
    r = tempopb.SearchRequest()
    for k, v in tags.items():
        r.tags[k] = v
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def _rows(metas) -> list:
    return [(m.trace_id, m.start_time_unix_nano) for m in metas]


def _digest(resp) -> tuple:
    """A response of either package: every trace field and the counts."""
    m = resp.metrics
    return ([(t.trace_id, t.start_time_unix_nano, t.duration_ms,
              t.root_service_name, t.root_trace_name) for t in resp.traces],
            m.inspected_traces, m.inspected_blocks, m.skipped_blocks,
            m.inspected_bytes)


def _jobs(blocks, job=ScanJob):
    return [job(key=(f"blk-{i:03d}", 0, p.n_pages), pages_fn=(lambda p=p: p),
                header=dict(p.header), n_pages=p.n_pages,
                n_entries=p.n_entries,
                geometry=(p.header["entries_per_page"],
                          p.header["kv_per_entry"]))
            for i, p in enumerate(blocks)]


# ---------------------------------------------------------------------------
# floor / override semantics


def test_threshold_off_forces_host_even_with_planner_enabled():
    """`search_device_probe_min_vals <= 0` is host-only, planner or not:
    the call sites never reach the planner below the floor."""
    p = _planner("device")
    pages, rpages = _pages(200, 1)
    assert stage(pages, CPU, probe_min_vals=0,
                 profiling=_gate(p)).staged_dict is None
    assert stage(pages, CPU, probe_min_vals=-1,
                 profiling=_gate(p)).staged_dict is None
    assert not stack_host([pages], probe_min_vals=0, planner=p).packed_dicts
    assert p.snapshot()["decisions"] == {"host": 0, "device": 0}

    req = {"session.id": "session-00"}
    on = BlockBatcher(CPU, coalesce_max_queries=1, device_probe_min_vals=0,
                      profiling=_gate(p))
    off = BlockBatcher(CPU, coalesce_max_queries=1, device_probe_min_vals=0)
    try:
        r_on = on.search(_jobs([pages]), _req(req, limit=500)).response()
        r_off = off.search(_jobs([pages]), _req(req, limit=500)).response()
    finally:
        on.close()
        off.close()
    ref = RefBatcher(coalesce_max_queries=1, device_probe_min_vals=0).search(
        _jobs([rpages], RefJob), _ref_req(req, limit=500)).response()
    assert _digest(r_on) == _digest(r_off) == _digest(ref)
    assert p.snapshot()["decisions"] == {"host": 0, "device": 0}


def test_planner_disabled_is_static_path():
    """A planner that is off is today's behaviour: above the threshold the
    dictionary stages and the probe runs on the device, no decision."""
    p = planner.OffloadPlanner(enabled=False, device=CPU)
    pages, _ = _pages(200, 2)
    sp = stage(pages, CPU, probe_min_vals=1, profiling=_gate(p))
    assert sp.staged_dict is not None
    cq = compile_query(pages.key_dict, pages.val_dict,
                       _req({"session.id": "session-00"}, limit=100),
                       staged_dict=sp.staged_dict)
    assert cq.val_hits is not None
    assert p.snapshot()["decisions"] == {"host": 0, "device": 0}


# ---------------------------------------------------------------------------
# answers alike across dispatch paths, both verdicts, and the reference's


def _single_block_result(p, probe_min_vals):
    pages, _ = _pages(300, 3, geo=(64, 8))
    req = _req({"session.id": "session-00"}, limit=1000)
    eng = ScanEngine(CPU, top_k=1024, profiling=_gate(p))
    sp = stage(pages, CPU, probe_min_vals=probe_min_vals,
               profiling=_gate(p))
    cq = compile_query(pages.key_dict, pages.val_dict, req,
                       cache_on=pages, cache=eng.compile_cache,
                       staged_dict=sp.staged_dict)
    count, inspected, scores, idx = eng.scan_staged(sp, cq)
    return count, inspected, _rows(eng.results(sp, cq, scores, idx)), sp, cq


def test_single_block_byte_identical_both_verdicts():
    base = _single_block_result(planner.OffloadPlanner(device=CPU), 0)[:3]
    _, rpages = _pages(300, 3, geo=(64, 8))
    rreq = _ref_req({"session.id": "session-00"}, limit=1000)
    rsp = ref_stage(rpages, probe_min_vals=0)
    rcq = ref_compile_query(rpages.key_dict, rpages.val_dict, rreq)
    reng = RefScanEngine(top_k=1024)
    rc, ri, rs, rx = reng.scan_staged(rsp, rcq)
    assert base == (int(rc), int(ri),
                    _rows(reng.results(rsp, rcq, np.asarray(rs),
                                       np.asarray(rx))))
    for verdict in ("device", "host"):
        count, inspected, res, sp, cq = _single_block_result(
            _planner(verdict), 1)
        if verdict == "device":
            assert sp.staged_dict is not None
            assert cq.val_hits is not None
        else:
            # the stage-time veto kept the dictionary on the host
            assert sp.staged_dict is None
            assert cq.val_hits is None
        assert (count, inspected, res) == base, verdict


def test_compile_time_veto_over_staged_dict():
    """A dictionary already staged can still be probed on the host when
    the model says K3 loses: the staged bytes stay, only the placement
    moves, and the answer does not."""
    pages, _ = _pages(250, 4)
    req = _req({"session.id": "session-01"}, limit=500)
    sp = stage(pages, CPU, probe_min_vals=1)      # staged, planner off
    assert sp.staged_dict is not None
    eng = ScanEngine(CPU, top_k=1024)
    cq_dev = compile_query(pages.key_dict, pages.val_dict, req,
                           staged_dict=sp.staged_dict)
    assert cq_dev.val_hits is not None
    out_dev = eng.scan_staged(sp, cq_dev)

    p = _planner("host")
    cq_host = compile_query(pages.key_dict, pages.val_dict, req,
                            cache_on=pages, cache=CompileCache(_gate(p)),
                            staged_dict=sp.staged_dict)
    assert cq_host.val_hits is None       # vetoed at compile time
    out_host = eng.scan_staged(sp, cq_host)
    assert out_dev[:2] == out_host[:2]
    assert np.array_equal(out_dev[2], out_host[2])
    snap = p.snapshot()
    assert snap["decisions"]["host"] >= 1
    assert any(d["site"] == "compile" and d["target"] == "host"
               for d in snap["recent"])


def _multi_run(eng, batch, blocks, reqs):
    out, mqs = [], []
    for req in reqs:
        mq = compile_multi(list(batch.blocks), req, memo=batch.memo,
                           cache=eng.compile_cache,
                           staged_dicts=batch.staged_dicts)
        c, i, s, x = fetch_scan_out(eng.scan_async(batch, mq))
        out.append((c, i, _rows(eng.results(batch, mq, s, x))))
        mqs.append(mq)
    counts = fetch_coalesced_out(eng.coalesced_scan_async(
        batch, stack_queries(mqs), 1024))[0]
    return out, [int(c) for c in counts[:len(reqs)]]


def _reqs_multi():
    return [{"session.id": v} for v in ("session-001", "session-01")]


def test_multiblock_and_coalesced_byte_identical_both_verdicts():
    blocks, rblocks = _blocks()
    reqs = [_req(t, limit=1000) for t in _reqs_multi()]
    off = MultiBlockEngine(CPU, top_k=1024, device_probe_min_vals=50)
    base, base_counts = _multi_run(
        off, off.place(off.stage_host(blocks)), blocks, reqs)
    assert base_counts == [c for c, _i, _r in base]
    reng = RefEngine(top_k=1024)
    rbatch = ref_stack_blocks(rblocks, pad_to=32, probe_min_vals=50)
    for (c, i, rows), t in zip(base, _reqs_multi()):
        rmq = ref_compile_multi(rblocks, _ref_req(t, limit=1000),
                                cache_on=rbatch)
        rc, ri, rs, rx = reng.scan(rbatch, rmq)
        assert (c, i, rows) == (int(rc), int(ri), _rows(reng.results(
            rbatch, rmq, np.asarray(rs), np.asarray(rx))))
    for verdict in ("device", "host"):
        p = _planner(verdict)
        eng = MultiBlockEngine(CPU, top_k=1024, device_probe_min_vals=50,
                               profiling=_gate(p))
        batch = eng.place(eng.stage_host(blocks))
        assert len(batch.staged_dicts) == (3 if verdict == "device" else 0)
        got, counts = _multi_run(eng, batch, blocks, reqs)
        assert got == base, verdict
        assert counts == base_counts, verdict


def test_mesh_byte_identical_both_verdicts():
    """Over an exchange of 2 ranks in one process, each verdict stages
    (or not) the value-sharded dictionary and answers as one device."""
    blocks, _ = _blocks(n=2, entries=256, small_tail=False)
    req = _req({"session.id": "session-00"}, limit=1000)
    one = MultiBlockEngine(CPU, top_k=1024)
    b1 = one.place(one.stage_host(blocks))
    mq1 = compile_multi(blocks, req, memo=b1.memo, cache=one.compile_cache)
    c1, i1, s1, x1 = fetch_scan_out(one.scan_async(b1, mq1))
    ids = {m.trace_id for m in one.results(b1, mq1, s1, x1)}
    for verdict in ("device", "host"):
        eng = MultiBlockEngine(CPU, top_k=1024, device_probe_min_vals=50,
                               exchange=mesh.LocalExchange(2),
                               profiling=_gate(_planner(verdict)))
        batch = eng.place(eng.stage_host(blocks))
        assert bool(batch.staged_dicts) == (verdict == "device")
        mq = compile_multi(blocks, req, memo=batch.memo,
                           cache=eng.compile_cache,
                           staged_dicts=batch.staged_dicts)
        assert (mq.val_hits is not None) == (verdict == "device")
        c, i, s, x = fetch_scan_out(eng.scan_async(batch, mq))
        assert (c, i) == (c1, i1)
        assert {m.trace_id for m in eng.results(batch, mq, s, x)} == ids


def test_gloo_mesh_byte_identical_both_verdicts(tmp_path):
    """Two gloo ranks, every rank's planner forced to each verdict: the
    answers of the planner off, byte for byte, and the oracle's."""
    reqs = [({"session.id": "s-03-00"}, {"limit": 20}),
            ({"session.id": "-00", "x-dbg-exhaustive": ""}, {"limit": 20}),
            ({"service.name": "frontend"},
             {"min_duration_ms": 100, "limit": 1000})]
    fields = dict(search_device_probe_min_vals=64, search_max_batch_pages=16)
    base = md.run(2, fields, reqs, timeout_s=120,
                  root=str(tmp_path / "off"))
    assert base["decisions"] == [{"host": 0, "device": 0}] * 2
    for verdict in ("device", "host"):
        res = md.run(2, fields, reqs, timeout_s=120,
                     root=str(tmp_path / verdict), planner_force=verdict)
        assert res["responses"] == base["responses"], verdict
        other = "host" if verdict == "device" else "device"
        for d in res["decisions"]:
            assert d[verdict] > 0 and d[other] == 0, (verdict, d)


def test_dist_search_staged_dict_and_identity():
    """The distributed single-block engine stages the dictionary value
    sharded at a threshold (none at its default of 0) and answers as the
    single-device engine on the host route, with either verdict."""
    pages, rpages = _pages(256, 5)
    req = _req({"session.id": "session-00"}, limit=1000)
    ex = mesh.LocalExchange(2)
    assert DistributedScanEngine(ex, CPU).stage(pages).staged_dict is None

    eng = ScanEngine(CPU, top_k=1024)
    sp_h = stage(pages, CPU, probe_min_vals=0)
    out_h = eng.scan_staged(sp_h, compile_query(
        pages.key_dict, pages.val_dict, req))
    reng = RefScanEngine(top_k=1024)
    rsp = ref_stage(rpages, probe_min_vals=0)
    rout = reng.scan_staged(rsp, ref_compile_query(
        rpages.key_dict, rpages.val_dict,
        _ref_req({"session.id": "session-00"}, limit=1000)))
    assert out_h[:2] == (int(rout[0]), int(rout[1]))
    for p in (planner.OffloadPlanner(device=CPU), _planner("device"),
              _planner("host")):
        dist = DistributedScanEngine(ex, CPU, top_k=1024, probe_min_vals=1,
                                     profiling=_gate(p))
        sp = dist.stage(pages)
        device = not p.enabled or p.snapshot()["decisions"]["device"] > 0
        assert (sp.staged_dict is not None) == device
        if device:
            assert sp.staged_dict.exchange is ex
        cq = dist.compile(sp, req)
        assert (cq.val_hits is not None) == device
        out = dist.scan_staged(sp, cq)
        assert out[:2] == out_h[:2]
        assert np.array_equal(np.sort(out[2]), np.sort(out_h[2]))


def test_batcher_concurrent_planner_on_identical():
    """Concurrent coalesced searches with the planner choosing the device
    answer as solo searches with it off."""
    blocks, _ = _blocks(n=2, small_tail=False)
    reqs = [_req({"session.id": f"session-0{i:02d}"[:11]}, limit=200)
            for i in range(4)]
    serial_b = BlockBatcher(CPU, coalesce_max_queries=1,
                            device_probe_min_vals=10)
    co_b = BlockBatcher(CPU, coalesce_window_s=0.05, coalesce_max_queries=4,
                        device_probe_min_vals=10,
                        profiling=_gate(_planner("device")))
    try:
        serial = [_digest(serial_b.search(_jobs(blocks), r).response())
                  for r in reqs]
        co_b.search(_jobs(blocks), reqs[0])      # stage and compile
        barrier = threading.Barrier(len(reqs))
        got = [None] * len(reqs)

        def worker(i):
            barrier.wait()
            got[i] = _digest(co_b.search(_jobs(blocks), reqs[i]).response())

        ts = [threading.Thread(target=worker, args=(i,))
              for i in range(len(reqs))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        serial_b.close()
        co_b.close()
    assert got == serial


# ---------------------------------------------------------------------------
# planning cost: once a group, not once a member or a query


def test_plans_once_per_group_and_memoizes_repeats():
    blocks, _ = _blocks(n=2, small_tail=False)
    p = _planner("device")
    b = BlockBatcher(CPU, coalesce_max_queries=1, device_probe_min_vals=10,
                     profiling=_gate(p))
    try:
        req = _req({"session.id": "session-01"}, limit=100)
        b.search(_jobs(blocks), req)
        first = p.snapshot()["decisions"]
        # 2 distinct dictionaries: one stage and one compile decision each
        assert first["device"] + first["host"] == 4
        b.search(_jobs(blocks), req)   # repeat: staged and compiled
        assert p.snapshot()["decisions"] == first, \
            "a repeated query over a staged group planned again"
    finally:
        b.close()


def test_host_veto_memoized_per_dictionary():
    """Blocks sharing one dictionary get one stage-site decision with a
    host verdict too."""
    p = _planner("host")
    base = _corpus(60, seed=3)
    shared = [ColumnarPages.build(base, PageGeometry(32, 8))
              for _ in range(4)]
    assert pack_batch_dicts(shared, probe_min_vals=5, planner=p) == {}
    assert p.snapshot()["decisions"]["host"] == 1


# ---------------------------------------------------------------------------
# cold start / seeding


def test_cold_process_decides_without_crashing():
    """A cold planner's first decision runs the microbenchmark on its
    device (here the CPU: K3's plain version) and returns finite costs."""
    p = planner.OffloadPlanner(enabled=True, seed=True, device=CPU)
    d = p.decide_probe(n_vals=10_000_000, dict_bytes=160 << 20,
                       resident=False, site="stage")
    assert d.target in ("host", "device")
    assert 0 < d.predicted_host_s < float("inf")
    assert 0 < d.predicted_device_s < float("inf")
    snap = p.snapshot()
    assert snap["seeded"] is True and snap["seed_ms"] is not None
    for kind in planner.SEEDED_KINDS:
        assert snap["cost_model"]["rates"][kind]["observations"] > 0


def test_seed_does_not_double_feed():
    """The seed updates each rate once, directly: its own probe feeds
    nothing on top (the gate of a database with profiling on)."""
    p = planner.OffloadPlanner(enabled=True, seed=True, device=CPU)
    gate = _gate(p)
    pages, _ = _pages(120, 6)
    sp = stage(pages, CPU, probe_min_vals=1, profiling=gate)
    snap = p.snapshot()     # the stage decision seeded the planner
    assert snap["seeded"] is True
    rates = snap["cost_model"]["rates"]
    assert rates["device_probe"]["observations"] == 1
    # h2d: the seed's, the stage's column copy (mode single) and, staged,
    # its dictionary's copy (mode dict_probe)
    assert rates["h2d"]["observations"] == (3 if sp.staged_dict is not None
                                            else 2)


def test_cold_process_does_not_stage_huge_dict_blindly():
    """With a slow observed h2d, a 720 MB dictionary that is not staged
    stays on the host; once staged, the fast device probe wins."""
    p = _planner()
    p.observe("h2d", 1.0, nbytes=50 << 20)
    p.observe("host_probe", 0.35, nbytes=160 << 20)
    p.observe("device_probe", 0.01, nbytes=800 << 20)
    d = p.decide_probe(n_vals=10_000_000, dict_bytes=160 << 20,
                       resident=False, site="stage")
    assert d.target == "host"
    d2 = p.decide_probe(n_vals=10_000_000, dict_bytes=160 << 20,
                        resident=True, staged_bytes=800 << 20,
                        site="compile")
    assert d2.target == "device"
    # the reference's planner decides the same from the same observations
    rp = ref_planner.OffloadPlanner(enabled=True, seed=False)
    rp.observe("h2d", 1.0, nbytes=50 << 20)
    rp.observe("host_probe", 0.35, nbytes=160 << 20)
    rp.observe("device_probe", 0.01, nbytes=800 << 20)
    rp._probe_observed = True     # the port charges no compile on the CPU
    for kw, want in ((dict(resident=False, site="stage"), d),
                     (dict(resident=True, staged_bytes=800 << 20,
                           site="compile"), d2)):
        rd = rp.decide_probe(n_vals=10_000_000, dict_bytes=160 << 20, **kw)
        assert rd.target == want.target
        assert rd.predicted_host_s == pytest.approx(want.predicted_host_s)
        assert rd.predicted_device_s == pytest.approx(
            want.predicted_device_s)


# ---------------------------------------------------------------------------
# calibration: predicted vs actual, the profiler's feed, metrics


def test_predicted_vs_actual_resolution():
    p = _planner("device")
    fp = b"\xaa" * 32
    d = p.decide_probe(n_vals=1000, dict_bytes=10_000, resident=True,
                       staged_bytes=50_000, fp=fp, site="compile")
    assert d.target == "device" and d.actual_s is None
    p.observe("device_probe", d.predicted_probe_s * 2, nbytes=50_000, fp=fp)
    snap = p.snapshot()
    rec = next(r for r in snap["recent"] if r.get("fp") == fp.hex()[:16])
    assert rec["actual_probe_ms"] > 0
    assert abs(rec["abs_rel_error"] - 0.5) < 0.01
    assert snap["mispredict"]["observations"] == 1


def test_compile_record_resolves_compile_inclusive(monkeypatch):
    """On a CUDA planner whose K3 library is not loaded, a decision
    charges the compile; a record whose compile stage measured it
    resolves against the probe and the compile together. (No CUDA is
    touched: the planner has no seed and only reads which libraries are
    loaded.)"""
    monkeypatch.setattr(build, "_libs", {})
    p = _planner("device", device=torch.device("cuda"))
    for _ in range(100):
        p._update("compile", 0.5, 0)
    fp = b"\xbb" * 32
    d = p.decide_probe(n_vals=1000, dict_bytes=10_000, resident=True,
                       staged_bytes=50_000, fp=fp, site="compile")
    assert d.target == "device" and d.inputs["jit_miss"]
    assert d.predicted_compile_s > 0.1
    actual_s = d.predicted_probe_s + d.predicted_compile_s
    assert p.ingest_record({
        "mode": "dict_probe", "stages_ms": {"compile": actual_s * 1e3},
        "attrs": {"probe_bytes": 50_000, "fp": fp.hex()[:16]}}) >= 1
    rec = next(r for r in p.snapshot()["recent"]
               if r.get("fp") == fp.hex()[:16])
    assert rec["abs_rel_error"] < 0.01


def test_compile_is_charged_only_while_a_kernel_library_is_to_load(
        monkeypatch):
    """Deliberate difference: the reference charges a jit compile at each
    unseen shape; the port's kernels take any shape, so a CUDA planner
    charges it only while K3's library (and on a mesh the exchange's) is
    not loaded, and a CPU planner never (the plain versions load none)."""
    monkeypatch.setattr(build, "_libs", {})
    cuda = _planner("device", device=torch.device("cuda"))
    kw = dict(n_vals=1000, dict_bytes=10_000, site="stage")
    assert cuda.decide_probe(**kw).inputs["jit_miss"] is True
    monkeypatch.setattr(build, "_libs", {"probe": object()})
    assert cuda.decide_probe(**kw).inputs["jit_miss"] is False
    assert cuda.decide_probe(n_shards=2, **kw).inputs["jit_miss"] is True
    monkeypatch.setattr(build, "_libs", {"probe": object(),
                                         "dist": object()})
    assert cuda.decide_probe(n_shards=2, **kw).inputs["jit_miss"] is False
    monkeypatch.setattr(build, "_libs", {})
    assert _planner("device").decide_probe(**kw).inputs["jit_miss"] is False


def test_profiler_listener_feeds_device_rate():
    """A finished dict_probe record of the gate feeds its planner's device
    rate and resolves the pending decision."""
    p = _planner("device")
    before = p.snapshot()["cost_model"]["rates"]["device_probe"][
        "observations"]
    pages, _ = _pages(150, 6)
    gate = _gate(p)
    sp = stage(pages, CPU, probe_min_vals=1, profiling=gate)
    cq = compile_query(pages.key_dict, pages.val_dict,
                       _req({"session.id": "session-01"}, limit=20),
                       cache_on=pages, cache=CompileCache(gate),
                       staged_dict=sp.staged_dict)
    assert cq is not None and cq.val_hits is not None
    snap = p.snapshot()
    assert snap["cost_model"]["rates"]["device_probe"]["observations"] \
        > before
    fp = sp.staged_dict.packed.fingerprint.hex()[:16]
    rec = next(r for r in snap["recent"] if r.get("fp") == fp
               and r["site"] == "compile")
    assert rec["target"] == "device" and "actual_probe_ms" in rec


def test_planner_metrics_documented_and_incremented():
    p = _planner("host")
    before = obs.offload_decisions.value(target="host", site="compile")
    p.decide_probe(n_vals=100, dict_bytes=1000, site="compile")
    assert obs.offload_decisions.value(target="host",
                                       site="compile") == before + 1
    assert obs.REGISTRY.get("tempo_search_offload_predict_error_ratio")


def test_scalar_bounds_ride_the_launch():
    """The reference shares memoized device scalars for a query's bounds
    between queries; the port's bounds ride the kernel launch's
    parameters, so a query uploads its term tables alone, and queries of
    equal bounds answer as the reference's."""
    pages, rpages = _pages(50, 7)
    reqs = [({"session.id": "session-00"}, {"limit": 20}),
            ({"svc": "frontend"}, {"limit": 20})]
    eng = ScanEngine(CPU, top_k=64)
    sp = stage(pages, CPU, probe_min_vals=0)
    reng = RefScanEngine(top_k=64)
    rsp = ref_stage(rpages, probe_min_vals=0)
    cqs = []
    for tags, kw in reqs:
        cq = compile_query(pages.key_dict, pages.val_dict, _req(tags, **kw))
        assert len(eng._tables(cq)) == 2
        c, i, _s, _x = eng.scan_staged(sp, cq)
        rc, ri, _rs, _rx = reng.scan_staged(rsp, ref_compile_query(
            rpages.key_dict, rpages.val_dict, _ref_req(tags, **kw)))
        assert (c, i) == (int(rc), int(ri))
        cqs.append(cq)
    assert [(q.dur_lo, q.dur_hi, q.win_start, q.win_end) for q in cqs] == \
        [(0, 0xFFFFFFFF, 0, 0xFFFFFFFF)] * 2


# ---------------------------------------------------------------------------
# the port's deliberate differences


def _db(root, **kw) -> TempoDB:
    db = TempoDB(LocalBackend(str(root / "blocks")), TempoDBConfig(
        search_device_probe_min_vals=64, search_max_batch_pages=16, **kw),
        device="cpu")
    db.poll()
    return db


def test_one_planner_per_database(tmp_path):
    """Each database owns its planner and feeds it its own records alone:
    two databases in one process, one planner on and one off, answer
    alike; a second planner that is on learns nothing from the first's
    searches, and the process planner nothing at all."""
    md.build_corpus(str(tmp_path))
    reqs = [({"session.id": "s-03-00"}, {"limit": 20}),
            ({"service.name": "frontend"}, {"limit": 50}),
            ({"session.id": "-00", "x-dbg-exhaustive": ""}, {"limit": 20})]
    planner.PLANNER.enabled = True
    planner.PLANNER.seed_on_first_use = False
    on = _db(tmp_path, search_offload_planner_enabled=True)
    off = _db(tmp_path)
    idle = _db(tmp_path, search_offload_planner_enabled=True)
    try:
        assert len({id(on.planner), id(off.planner), id(idle.planner),
                    id(planner.PLANNER)}) == 4
        assert on.profiling.planner is on.planner
        assert on.batcher.engine.profiling is on.profiling
        for tags, kw in reqs:
            a = on.search(md.TENANT, _req(tags, **kw))
            b = off.search(md.TENANT, _req(tags, **kw))
            assert md.digest(a) == md.digest(b)
        snap = on.planner.snapshot()
        assert sum(snap["decisions"].values()) > 0
        assert snap["cost_model"]["rates"]["scan"]["observations"] > 0
        assert off.planner.snapshot()["decisions"] == {"host": 0,
                                                       "device": 0}
        quiet = idle.planner.snapshot()
        assert quiet["seeded"] is False
        assert all(r["observations"] == 0
                   for r in quiet["cost_model"]["rates"].values())
        assert all(r["observations"] == 0 for r in planner.PLANNER.snapshot()
                   ["cost_model"]["rates"].values())
    finally:
        for db in (on, off, idle):
            db.close()


def test_the_seed_raises_on_a_device_fault(monkeypatch):
    """Deliberate difference: the reference swallows a failed seed; the
    port's seed runs K3 on the planner's device, and a failure there is a
    device fault that raises."""
    def broken(*a, **kw):
        raise RuntimeError("an illegal memory access was encountered")

    monkeypatch.setattr(dict_probe, "probe_value_hits", broken)
    p = planner.OffloadPlanner(enabled=True, seed=True, device=CPU)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        p.decide_probe(n_vals=10_000, dict_bytes=100_000, site="stage")
    assert p._seeding is False
    # the reference's seed swallows the same failure
    monkeypatch.setattr("tempo_tpu.search.dict_probe.probe_value_hits",
                        broken)
    rp = ref_planner.OffloadPlanner(enabled=True, seed=True)
    assert rp.decide_probe(n_vals=10_000, dict_bytes=100_000,
                           site="stage").target in ("host", "device")


def test_a_planner_without_profiling_warns(tmp_path, caplog):
    """The reference's warning: a planner that is on without the
    profiler cannot calibrate."""
    with caplog.at_level(logging.WARNING, logger="tempo_tpu_torch.db"):
        TempoDB(LocalBackend(str(tmp_path)), TempoDBConfig(
            search_offload_planner_enabled=True,
            search_profiling_enabled=False), device="cpu").close()
        TempoDB(LocalBackend(str(tmp_path)), TempoDBConfig(
            search_offload_planner_enabled=True), device="cpu").close()
    msgs = [r.getMessage() for r in caplog.records
            if "cannot self-calibrate" in r.getMessage()]
    assert len(msgs) == 1


def test_config_fields_and_defaults_are_the_reference():
    from tempo_tpu.db import TempoDBConfig as RefConfig

    for name in ("search_host_cache_bytes", "search_prewarm_on_poll",
                 "host_state_dir", "search_offload_planner_enabled",
                 "search_offload_planner_ewma",
                 "search_offload_planner_ring"):
        assert getattr(TempoDBConfig(), name) == getattr(RefConfig(), name)
    assert "search_compile_cache_dir" not in TempoDBConfig.__dataclass_fields__


def test_the_process_planner_serves_callers_outside_a_database():
    """Engines on a gate without a planner consult the process planner,
    set by ``configure``."""
    p = planner.configure(enabled=True, seed=False, device=CPU)
    md.force_planner(p, "host")
    pages, _ = _pages(200, 8)
    assert stage(pages, CPU, probe_min_vals=1).staged_dict is None
    assert p.snapshot()["decisions"]["host"] == 1
    planner.configure(enabled=False)
    assert stage(pages, CPU, probe_min_vals=1).staged_dict is not None
