"""Structural queries stacked along the query axis, against solo ones.

Same-plan groups (``structural.stack_structural``) and shape-bucketed
groups of mixed plans (``stack_bucketed``) run as one fused dispatch (K6
over the members' lanes, then K4 with ``[Q, P*E]`` verdicts) and must
equal each member's solo dispatch (K6 then K1) exactly, and the host
oracle. The coalescer groups structural queries by the database's gate:
alone at once with stacking off, with same-plan peers with it on, with
same-bucket peers with bucketing too; barrier-started threads through
``TempoDB.search`` equal serial runs. Also K4's verdict rows, the lanes
of a same-plan stack against the reference's stacked tables, and what a
mixed group refuses.
"""

from __future__ import annotations

import dataclasses
import random
import threading

import numpy as np
import pytest
import torch

from tempo_tpu.search import ir as ref_ir
from tempo_tpu.search import structural as ref_structural

from test_torch_structural import (CPU, FIXED, GEO, TENANT, _tags,
                                   _traces, entries, rand_trace, spanless)
from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.model.types import SearchRequest
from tempo_tpu_torch.search import data, ir, structural
from tempo_tpu_torch.search.backend_search_block import write_search_block
from tempo_tpu_torch.search.batcher import QueryCoalescer
from tempo_tpu_torch.search.columnar import ColumnarPages, PageGeometry
from tempo_tpu_torch.search.engine import (fetch_coalesced_out,
                                           fetch_scan_out, resolve_top_k)
from tempo_tpu_torch.search.kernels import scan
from tempo_tpu_torch.search.multiblock import (MultiBlockEngine,
                                               compile_multi, stack_queries)

WAIT_S = 60
ON = structural.StructuralConfig(enabled=True, stack_enabled=True,
                                 bucket_enabled=True)


@pytest.fixture(scope="module")
def staged():
    """One staged batch (port, CPU) of three blocks: two with spans (one
    with parent cycles), one without."""
    blocks = [ColumnarPages.build(entries(300, 40, data, loops=True),
                                  PageGeometry(*GEO)),
              ColumnarPages.build(entries(301, 40, data, urls=100),
                                  PageGeometry(*GEO)),
              ColumnarPages.build(spanless(6, data), PageGeometry(*GEO))]
    eng = MultiBlockEngine(CPU, top_k=256, device_probe_min_vals=64,
                           structural_cfg=ON)
    all_entries = (entries(300, 40, data, loops=True)
                   + entries(301, 40, data, urls=100) + spanless(6, data))
    return eng, eng.place(eng.stage_host(blocks)), all_entries


def _mq(eng, batch, expr, exhaustive=True, limit=200):
    tags = _tags(expr, exhaustive)
    mq = compile_multi(list(batch.blocks), SearchRequest(tags=tags,
                                                         limit=limit),
                       memo=batch.memo, cache=eng.compile_cache,
                       staged_dicts=batch.staged_dicts)
    mq.structural = structural.compile_structural(
        expr, list(batch.blocks), staged_dicts=batch.staged_dicts,
        memo=batch.memo)
    return mq


def _ids(batch, scores, idx) -> set:
    E = GEO[0]
    out = set()
    for s, i in zip(scores.tolist(), idx.tolist()):
        if s < 0:
            break
        p, e = divmod(i, E)
        bi = int(batch.page_block[p])
        out.add(bytes(batch.blocks[bi].trace_ids[p - batch.page_offset[bi],
                                                 e]))
    return out


def _fused_equals_solo(eng, batch, all_entries, exprs):
    mqs = [_mq(eng, batch, e) for e in exprs]
    cq = stack_queries(mqs, ON.bucket_max_nodes)
    k = max(resolve_top_k(eng.top_k, mq.limit) for mq in mqs)
    fc, fins, fs, fi = fetch_coalesced_out(
        eng.coalesced_scan_async(batch, cq, k))
    for qi, (mq, expr) in enumerate(zip(mqs, exprs)):
        c, ins, s1, i1 = fetch_scan_out(eng.scan_async(batch, mq))
        kq = len(s1)
        assert (int(fc[qi]), fins) == (c, ins)
        np.testing.assert_array_equal(fs[qi][:kq], s1)
        np.testing.assert_array_equal(fi[qi][:kq], i1)
        want = {sd.trace_id for sd in all_entries
                if structural.eval_host(expr, sd)}
        assert _ids(batch, s1, i1) == want and c == len(want)
    return cq


def _reparam_span(e, rng):
    if isinstance(e, ir.SpanTag):
        return ir.SpanTag(e.key, rng.choice(["a", "p", "op", "db", ""]))
    if isinstance(e, ir.SpanDur):
        lo = rng.randint(0, 800)
        return ir.SpanDur(lo, lo + rng.randint(0, 800))
    if isinstance(e, ir.SpanKind):
        return ir.SpanKind(rng.randint(0, 5))
    if isinstance(e, (ir.SpanAnd, ir.SpanOr)):
        return type(e)(tuple(_reparam_span(a, rng) for a in e.args))
    if isinstance(e, ir.SpanNot):
        return ir.SpanNot(_reparam_span(e.arg, rng))
    if isinstance(e, ir.ChildOf):
        return ir.ChildOf(_reparam_span(e.parent, rng),
                          _reparam_span(e.child, rng))
    return ir.DescOf(_reparam_span(e.anc, rng), _reparam_span(e.span, rng))


def _reparam(e, rng):
    """The same tree shape with fresh leaf parameters (N dashboards
    running one saved query with different filters)."""
    if isinstance(e, ir.TraceTag):
        return ir.TraceTag(e.key, rng.choice(["a", "prod", "dev", ""]))
    if isinstance(e, ir.TraceDur):
        lo = rng.randint(0, 4000)
        return ir.TraceDur(lo, lo + rng.randint(0, 4000))
    if isinstance(e, ir.Exists):
        return ir.Exists(_reparam_span(e.of, rng))
    if isinstance(e, ir.Count):
        return ir.Count(_reparam_span(e.of, rng), e.op, rng.randint(0, 4))
    if isinstance(e, ir.Quantile):
        return ir.Quantile(_reparam_span(e.of, rng), e.q_num, e.q_den, e.op,
                           rng.randint(0, 900))
    if isinstance(e, (ir.TraceAnd, ir.TraceOr)):
        return type(e)(tuple(_reparam(a, rng) for a in e.args))
    return ir.TraceNot(_reparam(e.arg, rng))


def _plan(e):
    return structural._LeafCollector().lower_trace(e)


def _same_plan_group(seed: int, n: int = 4) -> list:
    """`n` distinct plans' worth of queries sharing one plan descriptor
    (leaf dedup can change a reparametrised tree's plan: those are left
    out)."""
    rng = random.Random(seed)
    while True:
        t = rand_trace(rng)
        group = {ir.to_json(t): t}
        for _ in range(40):
            e = _reparam(t, rng)
            if _plan(e) == _plan(t):
                group.setdefault(ir.to_json(e), e)
            if len(group) == n:
                return list(group.values())


@pytest.mark.parametrize("seed", range(4))
def test_same_plan_stack_equals_solo(staged, seed):
    eng, batch, all_entries = staged
    exprs = _same_plan_group(400 + seed)
    assert len({_plan(e) for e in exprs}) == 1
    cq = _fused_equals_solo(eng, batch, all_entries, exprs)
    assert isinstance(cq.structural, structural.StackedStructural)
    assert cq.structural.lanes.n_lanes == len(exprs)


def _bucket_group(seed: int) -> tuple:
    rng = random.Random(seed)
    by: dict = {}
    for _ in range(300):
        e = rand_trace(rng, depth=rng.randint(1, 2))
        plan = _plan(e)
        bk = structural.canonical_bucket(plan, ON.bucket_max_nodes)
        if bk is None:
            continue
        group = by.setdefault(bk, {})
        group.setdefault(plan, e)
        if len(group) >= 5:
            return bk, list(group.values())
    raise AssertionError("no bucket gathered five plans")


@pytest.mark.parametrize("seed", range(4))
def test_bucketed_stack_equals_solo(staged, seed):
    eng, batch, all_entries = staged
    desc, exprs = _bucket_group(500 + seed)
    cq = _fused_equals_solo(eng, batch, all_entries, exprs)
    assert isinstance(cq.structural, structural.BucketedStructural)
    assert cq.structural.plan == desc
    assert cq.structural.slot_nodes == len(exprs) * (desc[1] + desc[2])


def test_same_plan_lanes_equal_the_references_stack(staged):
    """A same-plan stack's lanes, against the reference's
    ``stack_structural`` tables of the same members (host-compiled)."""
    eng, batch, _all = staged
    exprs = _same_plan_group(600)
    blocks = list(batch.blocks)
    sts = [structural.compile_structural(e, blocks) for e in exprs]
    from tempo_tpu.search.columnar import ColumnarPages as RefPages
    ref_blocks = [RefPages.from_bytes(b.to_bytes()) for b in blocks]
    rsts = [ref_structural.compile_structural(
        ref_ir.parse(ir.to_json(e)), ref_blocks, host_only=True)
        for e in exprs]
    lanes = structural.stack_structural(sts).lanes
    rtables = ref_structural.stack_structural(rsts, 4).tables
    for name, i in (("term_keys", 0), ("val_ranges", 1), ("dur_params", 4),
                    ("kind_params", 5), ("agg_params", 6)):
        if rtables[i] is None:
            continue
        want = np.asarray(rtables[i])[:len(sts)]
        got = getattr(lanes, name)[tuple(slice(0, n) for n in want.shape)]
        assert np.array_equal(got, want), name
    sp, tp = structural._programs(sts[0].plan)
    assert all(np.array_equal(lanes.span_prog[q], sp)
               and np.array_equal(lanes.trace_prog[q], tp)
               for q in range(len(sts)))


def test_mixed_groups_are_refused(staged):
    eng, batch, _all = staged
    a = _mq(eng, batch, ir.parse(FIXED["desc"]))
    b = _mq(eng, batch, ir.parse(FIXED["count"]))
    plain = compile_multi(list(batch.blocks),
                          SearchRequest(tags={"env": "prod"}),
                          memo=batch.memo, cache=eng.compile_cache)
    with pytest.raises(ValueError):
        stack_queries([a, plain])
    big = ir.parse('{"and": [' + ",".join(
        ['{"exists": {"child": {"parent": {"kind": %d}, "child": '
         '{"kind": %d}}}}' % (i % 6, (i + 1) % 6) for i in range(8)]) + ']}')
    c = _mq(eng, batch, big)
    assert structural.canonical_bucket(c.structural.plan, 16) is None
    with pytest.raises(ValueError):
        stack_queries([a, c], 16)
    # a relation plan buckets apart from a relation-free one
    assert structural.canonical_bucket(a.structural.plan, 16)[3] != \
        structural.canonical_bucket(b.structural.plan, 16)[3]
    with pytest.raises(ValueError):
        stack_queries([a, b], 16)


def test_k4_verdict_rows_and_pads():
    """K4's plain version ANDs verdict row q into query q, and a query
    past the rows matches nothing."""
    P, E = 2, 8
    kv = torch.full((P, E, 1), -1, dtype=torch.int32)
    cols = (torch.arange(P * E, dtype=torch.int32).reshape(P, E),
            torch.arange(P * E, dtype=torch.int32).reshape(P, E),
            torch.zeros((P, E), dtype=torch.int32),
            torch.ones((P, E), dtype=torch.bool))
    pb = torch.zeros(P, dtype=torch.int32)
    Q = 4
    tk = torch.full((Q, 1, 1), -1, dtype=torch.int32)
    vr = torch.tensor([1, 0], dtype=torch.int32).repeat(Q, 1, 1, 1, 1)
    act = torch.zeros((Q, 1), dtype=torch.bool)
    z = torch.zeros(Q, dtype=torch.int32)
    u = torch.full((Q,), -1, dtype=torch.int32)
    v = (torch.arange(2 * P * E) % 3 == 0).to(torch.uint8).reshape(2, -1)
    scores, counts, ins = scan.coalesced_scan(
        kv, kv, *cols, pb, tk, vr, act, z, u, z, u, verdicts=v)
    assert counts.tolist() == [int(v[0].sum()), int(v[1].sum()), 0, 0]
    assert int(ins) == P * E
    assert torch.equal(scores[0] >= 0, v[0].bool())
    s1, c1 = scan.multi_scan(kv, kv, *cols, pb, tk[0], vr[0], 0, 0,
                             0xFFFFFFFF, 0, 0xFFFFFFFF,
                             verdicts=v[1].contiguous())
    assert torch.equal(s1, scores[1]) and int(c1[0]) == int(counts[1])


# ---------------------------------------------------------------------------
# the coalescer


def _coalescer_pair(staged, cfg, max_queries):
    eng, batch, all_entries = staged
    eng2 = MultiBlockEngine(CPU, top_k=256, device_probe_min_vals=64,
                            structural_cfg=cfg)
    co = QueryCoalescer(eng2, window_s=60.0, max_queries=max_queries,
                        active_fn=lambda: 2)
    return eng2, batch, co


def _submit_all(co, eng, batch, exprs):
    mqs = [_mq(eng, batch, e) for e in exprs]
    futs = [co.submit(batch, mq, resolve_top_k(eng.top_k, mq.limit))
            for mq in mqs]
    outs = []
    for f, mq in zip(futs, mqs):
        out = f.result(timeout=WAIT_S)
        outs.append(fetch_scan_out(out) if isinstance(out, tuple)
                    else tuple(out))
        want = fetch_scan_out(eng.scan_async(batch, mq))
        kq = len(want[2])
        assert outs[-1][:2] == want[:2]
        np.testing.assert_array_equal(np.asarray(outs[-1][2])[:kq], want[2])
    return outs


def test_stacking_off_dispatches_each_structural_query_alone(staged):
    eng, batch, co = _coalescer_pair(
        staged, structural.StructuralConfig(enabled=True), 4)
    try:
        exprs = _same_plan_group(700)
        _submit_all(co, eng, batch, exprs)
        st = co.stats()
        assert st["dispatches"] == st["queries"] == len(exprs)
        assert st["fused_dispatches"] == 0 and st["pending"] == 0
        assert (st["structural_queries"], st["structural_stacked"],
                st["structural_bucketed"]) == (len(exprs), 0, 0)
    finally:
        co.close()


def test_stacking_on_fuses_same_plan_peers(staged):
    eng, batch, co = _coalescer_pair(
        staged, structural.StructuralConfig(enabled=True,
                                            stack_enabled=True), 4)
    try:
        exprs = _same_plan_group(701)
        _submit_all(co, eng, batch, exprs)
        st = co.stats()
        assert st["fused_dispatches"] == 1 and st["queries"] == 4
        assert (st["structural_stacked"], st["structural_bucketed"]) == (4, 0)
    finally:
        co.close()


def test_bucketing_fuses_mixed_plans_and_keeps_plain_queries_apart(staged):
    eng, batch, co = _coalescer_pair(staged, ON, 5)
    try:
        desc, exprs = _bucket_group(702)
        plain = compile_multi(list(batch.blocks),
                              SearchRequest(tags={"env": "prod"}, limit=50),
                              memo=batch.memo, cache=eng.compile_cache)
        pf = co.submit(batch, plain, 128)
        assert not pf.done()         # waits in its own group
        _submit_all(co, eng, batch, exprs)
        st = co.stats()
        assert st["fused_dispatches"] == 1
        assert st["structural_bucketed"] == len(exprs) == 5
        assert not pf.done()
        co.close()
        assert tuple(fetch_scan_out(pf.result(timeout=WAIT_S)))[:2] == \
            fetch_scan_out(eng.scan_async(batch, plain))[:2]
        assert desc[0] == "bucket"
    finally:
        co.close()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_structural_stack")
    be = LocalBackend(str(root))
    from tempo_tpu_torch.backend.types import BlockMeta

    for b in range(4):
        ents = entries(800 + b, 40, data, loops=b == 0)
        for e in ents:
            e.start_s += 1000 * b
            e.end_s += 1000 * b
        write_search_block(be, BlockMeta(tenant_id=TENANT), ents,
                           geometry=PageGeometry(*GEO))
    return root


def _run_threads(fns):
    out = [None] * len(fns)
    errs = []
    barrier = threading.Barrier(len(fns))

    def one(i):
        try:
            barrier.wait(timeout=WAIT_S)
            out[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 -- reported below
            errs.append(e)

    ts = [threading.Thread(target=one, args=(i,), daemon=True)
          for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=WAIT_S)
        assert not t.is_alive(), "a search thread did not finish"
    if errs:
        raise errs[0]
    return out


@pytest.mark.parametrize("bucket", [False, True])
def test_concurrent_structural_searches_equal_serial(written, bucket):
    """Six barrier-started clients through TempoDB.search: every response
    equals its serial one, and the structural queries fuse."""
    cfg = TempoDBConfig(search_max_batch_pages=64,
                        search_structural_enabled=True,
                        search_structural_stack_enabled=True,
                        search_structural_bucket_enabled=bucket,
                        search_coalesce_window_s=0.2)
    db = TempoDB(LocalBackend(str(written)), cfg, device="cpu")
    db.poll()
    exprs = (_bucket_group(900)[1][:5] if bucket
             else _same_plan_group(901, 5))
    exprs.append(ir.parse(FIXED["quantile"]) if not bucket else exprs[0])
    reqs = [SearchRequest(tags=_tags(e, True), limit=500) for e in exprs]
    try:
        serial = [db.search(TENANT, r).response() for r in reqs]
        fused = 0
        for _ in range(3):
            got = _run_threads([lambda r=r: db.search(TENANT, r).response()
                                for r in reqs])
            for g, w in zip(got, serial):
                assert _traces(g) == _traces(w)
                # the attributed device seconds are a timing
                assert dataclasses.replace(g.metrics, device_seconds=0.0) \
                    == dataclasses.replace(w.metrics, device_seconds=0.0)
            st = db.batcher.coalescer.stats()
            fused = st["structural_stacked"]
            if fused:
                break
        assert fused > 0
        if bucket:
            assert st["structural_bucketed"] > 0
    finally:
        db.close()


def test_id_past_a_lanes_hit_table_clamps_to_its_own_last_entry():
    """K6 reads each lane's own hit table (no stacked copy), so a value
    id past a lane's table reads that table's last entry; the reference
    stacks the members' tables padded with False to the widest, where
    such an id reads False. Real ids are below their dictionary's size,
    so no answer differs (ROADMAP item C)."""
    from tempo_tpu_torch.search.kernels import structural as k6

    kv = torch.full((1, 4, 1), -1, dtype=torch.int32)
    valid = torch.ones((1, 4), dtype=torch.bool)
    spans = {"span_trace": torch.arange(4, dtype=torch.int32),
             "span_parent": torch.full((4,), -1, dtype=torch.int32),
             "span_block": torch.zeros(4, dtype=torch.int32),
             "span_dur": torch.ones(4, dtype=torch.int32),
             "span_kind": torch.zeros(4, dtype=torch.int8),
             "span_kv_key": torch.zeros((4, 1), dtype=torch.int32),
             # value ids 1, 3, 6, 9: the last two past a 4-value table
             "span_kv_val": torch.tensor([[1], [3], [6], [9]],
                                         dtype=torch.int32),
             "entry_span_begin": torch.arange(4, dtype=torch.int32)
             .reshape(1, 4),
             "entry_span_count": torch.ones((1, 4), dtype=torch.int32)}
    Q = 2
    lanes = (torch.tensor([[[1, 0, 0, 0]]] * Q, dtype=torch.int32),
             torch.tensor([[[3, 1, 0, 0], [7, 1, 1, 0]]] * Q,
                          dtype=torch.int32),
             torch.zeros((Q, 1, 1), dtype=torch.int32),
             torch.tensor([1, 0], dtype=torch.int32).repeat(Q, 1, 1, 1, 1),
             torch.zeros((Q, 1, 2), dtype=torch.int32),
             torch.zeros((Q, 1), dtype=torch.int32),
             torch.tensor([[[0, 1, 0]]] * Q, dtype=torch.int32),
             torch.zeros((Q, 1), dtype=torch.int32))
    short = torch.tensor([[[False, False, False, True]]])     # V = 4
    wide = torch.zeros((1, 1, 12), dtype=torch.bool)
    wide[0, 0, 3] = True
    v = k6.structural_mask(kv, kv, torch.zeros((1, 4), dtype=torch.int32),
                           valid, torch.zeros(1, dtype=torch.int32), spans,
                           4, lanes, (short, wide))
    # lane 0: ids 6 and 9 read its last entry (True); padded with False
    # to the widest table, as the reference stacks it, they would not
    assert v.tolist() == [[0, 1, 1, 1], [0, 1, 0, 0]]
