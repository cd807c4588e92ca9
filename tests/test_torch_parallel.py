"""The port's distributed search (parallel/, the B10 chains, K9) against the
port on one device and against the reference's mesh kernels.

Multi-rank arithmetic runs here in one process through ``LocalExchange``
(every rank's local step in turn, the exchange a stack and a sum); the
real collective path runs on a gloo world-1 process group in-process
(``HashStore``); the multi-process gloo jobs are in
``test_torch_multihost.py``. The reference runs on the conftest's 8
virtual CPU devices, its meshes cut to S of them. The corpus is
``multihost_dryrun``'s: 6 blocks x 96 traces, 8 entries per page, span
rows, an error flag and a session id per trace (so each block's value
dictionary clears a probe threshold of 64).

Exactness: the port's distributed answers (counts, inspected, aggregate
histograms, top-k scores and indices) equal its single-device answers
over the same staged layout bit for bit, and its responses equal the
single-device database's and the reference mesh database's. Against the
reference's gathered ``lax.top_k``, K9's contract is equal scores, and
equal index sets outside the entries tied at the boundary score.
"""

from __future__ import annotations

import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tempo_tpu import tempopb
from tempo_tpu.backend.local import LocalBackend as RefLocalBackend
from tempo_tpu.backend.types import BlockMeta as RefBlockMeta
from tempo_tpu.db import TempoDB as RefTempoDB
from tempo_tpu.db import TempoDBConfig as RefTempoDBConfig
from tempo_tpu.parallel.dist_search import \
    DistributedScanEngine as RefDistributedScanEngine
from tempo_tpu.parallel.mesh import make_mesh as ref_make_mesh
from tempo_tpu.search import analytics as ref_analytics
from tempo_tpu.search import dict_probe as ref_dict_probe
from tempo_tpu.search import packing as ref_packing
from tempo_tpu.search import pipeline as ref_pipeline
from tempo_tpu.search import structural as ref_structural
from tempo_tpu.search.backend_search_block import \
    BackendSearchBlock as RefBackendSearchBlock
from tempo_tpu.search.multiblock import \
    MultiBlockEngine as RefMultiBlockEngine
from tempo_tpu.search.multiblock import compile_multi as ref_compile_multi
from tempo_tpu.search.multiblock import stack_queries as ref_stack_queries

from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.model.types import (BlockSearchJob, SearchBlockRequest,
                                         SearchBlocksRequest, SearchRequest)
from tempo_tpu_torch.parallel import mesh
from tempo_tpu_torch.parallel import multihost_dryrun as md
from tempo_tpu_torch.parallel.dist_search import DistributedScanEngine
from tempo_tpu_torch.search import analytics, dict_probe, ir, packing, \
    structural
from tempo_tpu_torch.search.backend_search_block import BackendSearchBlock
from tempo_tpu_torch.search.engine import ScanEngine, fetch_scan_out, stage
from tempo_tpu_torch.search.kernels import dist as dist_k
from tempo_tpu_torch.search.kernels.topk import topk_plain, topk_rows_plain
from tempo_tpu_torch.search.multiblock import (MultiBlockEngine,
                                               compile_multi, place_batch,
                                               stack_host, stack_queries)

CPU = torch.device("cpu")
TENANT = md.TENANT
PROBE_MIN = 64
WORLDS = [1, 2, 3, 4, 8]
DESC = ('{"desc": {"anc": {"tag": {"k": "service.name", "v": "db"}}, '
        '"span": {"kind": "client"}}}')
COUNT = ('{"count": {"of": {"tag": {"k": "name", "v": "op"}}, "op": ">", '
         '"n": 2}}')


def _st(text: str, **kw) -> tuple:
    r = SearchRequest(tags={})
    structural.attach_query(r, ir.parse(text))
    return dict(r.tags), kw


# (tags, other SearchRequest fields): tag, probe (session ids), exhaustive,
# structural, ?agg=red, a limit above the top-k base, a window
REQS = [
    ({"service.name": "frontend"}, {"min_duration_ms": 100, "limit": 1000}),
    ({"session.id": "s-03-00"}, {"limit": 20}),
    ({"session.id": "-00", "x-dbg-exhaustive": ""}, {"limit": 20}),
    _st(DESC, limit=1000),
    _st(COUNT, limit=7),
    ({"x-agg-q": "red"}, {"limit": 1000}),
    ({"service.name": "cart", "x-agg-q": "red"}, {"limit": 5}),
    ({}, {"min_duration_ms": 1, "limit": 300}),
    ({"http.status_code": "500"}, {"start": 1_600_002_010,
                                   "end": 1_600_004_050, "limit": 50}),
]


@pytest.fixture(autouse=True)
def _reference_gates():
    """The reference's structural, packing and analytics gates are
    process-wide (a reference TempoDB sets them when constructed): put
    them back after every test, and start each from an empty compile
    cache."""
    g = ref_structural.STRUCTURAL
    prev = (g.enabled, g.shard_spans, g.remainder_pages,
            ref_packing.PACKING.enabled, ref_analytics.ANALYTICS.enabled)
    ref_pipeline._COMPILE_CACHE.clear()
    yield
    (g.enabled, g.shard_spans, g.remainder_pages,
     ref_packing.PACKING.enabled) = prev[:4]
    ref_analytics.ANALYTICS.configure(enabled=prev[4])
    ref_pipeline._COMPILE_CACHE.clear()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_parallel")
    md.build_corpus(str(root))
    return root


@pytest.fixture(scope="module")
def blocks(corpus):
    """(reference pages, port pages) of every block, by block id."""
    rbe = RefLocalBackend(str(corpus / "blocks"))
    pbe = LocalBackend(str(corpus / "blocks"))
    db = TempoDB(pbe, device="cpu")
    db.poll()
    db.close()
    rp, pp = [], []
    for m in sorted(db.blocklist.metas(TENANT), key=lambda m: m.block_id):
        rm = RefBlockMeta(tenant_id=TENANT, block_id=m.block_id,
                          encoding=m.encoding, version=m.version,
                          data_encoding=m.data_encoding,
                          start_time=m.start_time, end_time=m.end_time)
        rp.append(RefBackendSearchBlock(rbe, rm).pages())
        pp.append(BackendSearchBlock(pbe, m, device="cpu").pages())
    assert len(pp) == md.N_BLOCKS
    return rp, pp


def _cfg(layout: str, **kw) -> dict:
    """TempoDBConfig fields (both packages' names) of a span layout."""
    out = dict(search_device_probe_min_vals=PROBE_MIN,
               search_structural_enabled=True,
               search_analytics_enabled=True, search_max_batch_pages=16)
    if layout in ("shard_spans", "remainder"):
        out["search_structural_shard_spans"] = True
    if layout == "remainder":
        out["search_structural_remainder_pages"] = True
    out.update(kw)
    return out


def _answers(db, reqs=REQS) -> list:
    return [md.digest(db.search(TENANT, SearchRequest(tags=dict(t), **kw)))
            for t, kw in reqs]


def _ref_req(tags, kw):
    r = tempopb.SearchRequest()
    for k, v in tags.items():
        r.tags[k] = v
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def _ref_answers(db, fields: dict, reqs=REQS) -> list:
    out = []
    for tags, kw in reqs:
        g = ref_structural.STRUCTURAL
        g.enabled = True
        g.shard_spans = bool(fields.get("search_structural_shard_spans"))
        g.remainder_pages = bool(
            fields.get("search_structural_remainder_pages"))
        ref_analytics.ANALYTICS.configure(enabled=True)
        resp = db.search(TENANT, _ref_req(tags, kw)).response()
        m = resp.metrics
        out.append({"traces": [[t.trace_id, t.start_time_unix_nano,
                                t.duration_ms, t.root_service_name,
                                t.root_trace_name] for t in resp.traces],
                    "inspected_traces": m.inspected_traces,
                    "inspected_blocks": m.inspected_blocks,
                    "skipped_blocks": m.skipped_blocks,
                    "agg_json": m.agg_json})
    return out


# ---------------------------------------------------------------------------
# K9


def _tie_contract(got_s, got_i, want_s, want_i) -> None:
    """Equal scores; equal index sets outside the boundary score's ties."""
    np.testing.assert_array_equal(got_s, want_s)
    for gs, gi, ws, wi in zip(got_s, got_i, want_s, want_i):
        if not len(gs):
            continue
        edge = gs[-1]
        assert set(gi[gs > edge].tolist()) == set(wi[ws > edge].tolist())


@pytest.mark.parametrize("S", WORLDS)
@pytest.mark.parametrize("Q", [1, 3])
def test_shard_topk_plain_is_k2_over_the_global_column(S, Q):
    rng = np.random.default_rng(100 * S + Q)
    local_n, k = 96, 40
    scores = rng.integers(-1, 12, size=(Q, S * local_n)).astype(np.int32)
    col = torch.from_numpy(scores)
    parts = [topk_rows_plain(col[:, s * local_n:(s + 1) * local_n], k)
             for s in range(S)]
    got_s, got_i = dist_k.shard_topk_plain(
        torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]),
        local_n, k)
    want_s, want_i = topk_rows_plain(col, k)
    assert torch.equal(got_s, want_s) and torch.equal(got_i, want_i)
    # the reference's tail: lax.top_k over the gathered candidates
    all_s = np.concatenate([p[0].numpy() for p in parts], axis=1)
    all_i = np.concatenate([p[1].numpy() + s * local_n
                            for s, p in enumerate(parts)], axis=1)
    rs, pos = jax.lax.top_k(all_s, min(k, all_s.shape[1]))
    ri = np.take_along_axis(all_i, np.asarray(pos), axis=1)
    _tie_contract(got_s.numpy(), got_i.numpy(), np.asarray(rs), ri)


def test_shard_topk_checks_its_inputs():
    s = torch.zeros((2, 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        dist_k.shard_topk(s.long(), s, 4, 2)
    with pytest.raises(ValueError):
        dist_k.shard_topk(s, s, 2**30, 2)
    with pytest.raises(ValueError):
        dist_k.shard_topk(s, s, 4, 0)


@pytest.mark.parametrize("S", range(1, 9))
def test_shard_topk_gathered_equals_plain_on_copies(S):
    """K9's gathered entry over [S, 2, Q, k'] (as the all_gather returns
    it) equals shard_topk_plain on contiguous copies of its halves, and
    the two-tensor form over the strided halves does too; ties within
    and across shards, every list of k' = min(k, local) entries."""
    rng = np.random.default_rng(1000 + S)
    Q, local_n, k = 3, 64, 40
    col = torch.from_numpy(
        rng.integers(-1, 4, size=(Q, S * local_n)).astype(np.int32))
    parts = [topk_rows_plain(col[:, s * local_n:(s + 1) * local_n], k)
             for s in range(S)]
    cand = torch.stack([torch.stack(p) for p in parts])
    assert cand.shape == (S, 2, Q, k)
    want = dist_k.shard_topk_plain(cand[:, 0].contiguous(),
                                   cand[:, 1].contiguous(), local_n, k)
    got = dist_k.shard_topk_gathered(cand, local_n, k)
    two = dist_k.shard_topk(cand[:, 0], cand[:, 1], local_n, k)
    glob = topk_rows_plain(col, k)
    for a, b, c, d in zip(got, want, two, glob):
        assert torch.equal(a, b) and torch.equal(c, b) and torch.equal(d, b)


def test_exchange_merge_over_local_exchange_equals_one_device():
    """exchange_merge through LocalExchange(3): each rank's K2 over its
    third of the column, the summed counts and K9 over the gathered
    candidates equal one device's K2 and count over the whole column."""
    rng = np.random.default_rng(3)
    S, local_n, k = 3, 500, 128
    col = torch.from_numpy(rng.integers(-1, 30, size=S * local_n)
                           .astype(np.int32))
    shards = [col[s * local_n:(s + 1) * local_n] for s in range(S)]

    def step(shard, rank):
        s, i = topk_plain(shard, k)
        return (torch.stack([(shard >= 0).sum()]), s, i)

    outs, red, top_s, top_i = dist_k.exchange_merge(
        mesh.LocalExchange(S), shards, range(S), step, lambda o: o[:1],
        lambda o: torch.stack(o[1:3])[:, None], local_n, k,
        dist_k.MULTI_LAUNCHES)
    assert len(outs) == S and int(red[0]) == int((col >= 0).sum())
    want_s, want_i = topk_plain(col, k)
    assert torch.equal(top_s[0], want_s) and torch.equal(top_i[0], want_i)


def test_shard_topk_gathered_checks_its_inputs():
    """The gathered entry refuses another rank or middle axis, another
    dtype, a k' axis of other than unit stride, k < 1 and global indices
    past 2^31."""
    cand = torch.zeros((2, 2, 1, 4), dtype=torch.int32)
    for bad in (cand[:, 0], torch.zeros((2, 3, 1, 4), dtype=torch.int32),
                cand.long(), torch.zeros((2, 2, 1, 8),
                                         dtype=torch.int32)[..., ::2]):
        with pytest.raises(ValueError):
            dist_k.shard_topk_gathered(bad, 4, 2)
    with pytest.raises(ValueError):
        dist_k.shard_topk_gathered(cand, 4, 0)
    with pytest.raises(ValueError):
        dist_k.shard_topk_gathered(cand, 2**30, 2)
    with pytest.raises(ValueError):     # the two-tensor form, likewise
        dist_k.shard_topk(cand[:, 0], cand[:, 1, :, :3], 4, 2)


# ---------------------------------------------------------------------------
# the span layouts


@pytest.mark.parametrize("S", range(1, 9))
def test_remainder_pad_matches_reference(S):
    g = ref_structural.STRUCTURAL
    on = structural.StructuralConfig(enabled=True, remainder_pages=True)
    for total in range(1, 40):
        g.remainder_pages = True
        assert structural.remainder_pad(on, total, S) == \
            g.remainder_pad(total, S)
        g.remainder_pages = False
        assert structural.remainder_pad(structural.OFF, total, S) is None
        assert g.remainder_pad(total, S) is None


@pytest.mark.parametrize("S", [2, 3, 4, 8])
def test_shard_span_segment_matches_reference(blocks, S):
    _rp, pp = blocks
    E = md.GEOMETRY[0]
    total = sum(b.n_pages for b in pp)
    pad = -(-total // S) * S
    cat = structural.stack_spans(pp, E, pad)
    g = ref_structural.STRUCTURAL
    g.shard_spans = True
    want = g.shard_span_segment(cat, S, pad, E)
    got = structural.shard_span_segment(
        structural.StructuralConfig(enabled=True, shard_spans=True),
        cat, S, pad, E)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].tobytes() == want[name].tobytes(), name
    assert structural.shard_span_segment(structural.OFF, cat, S, pad,
                                         E) is None
    # a page axis that does not split keeps the whole span axis
    assert structural.shard_span_segment(
        structural.StructuralConfig(shard_spans=True), cat, S, pad + 1,
        E) is None or S == 1


# ---------------------------------------------------------------------------
# the value-sharded probe


NEEDLES = [b"s-02-00", b"-001", None, b"", b"zzz", b"s-0"]


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("words", [False, True], ids=["bool", "words"])
def test_value_sharded_probe(blocks, S, words):
    _rp, pp = blocks
    vals = pp[2].val_dict
    V = len(vals)
    pd = dict_probe.pack_device_dict(vals, n_shards=S)
    ex = mesh.LocalExchange(S)
    sd = dict_probe.ShardedDeviceDict(
        packed=pd, exchange=ex,
        shards=tuple(dict_probe.place_device_dict(pd.shard(r), CPU)
                     for r in range(S)))
    hits, any_hits = dict_probe.probe_value_hits(sd, NEEDLES)
    assert pd.vs % 32 == 0 and hits.shape == (len(NEEDLES), S * pd.vs)
    one, one_any = dict_probe.probe_value_hits(
        dict_probe.stage_val_dict(vals, CPU), NEEDLES)
    assert torch.equal(hits[:, :V], one) and torch.equal(any_hits, one_any)
    assert not hits[2].any()
    if words:
        padded = torch.zeros_like(hits)
        padded[:, :V] = one
        got_w = packing.pack_mask_words(hits)
        assert torch.equal(got_w[[0, 1, 2, 4, 5]],
                           packing.pack_mask_words(padded)[[0, 1, 2, 4, 5]])
        hits = packing.unpack_mask_words(got_w, S * pd.vs)
    rdd = ref_dict_probe.stage_val_dict(vals, n_shards=S,
                                        mesh=ref_make_mesh(S))
    rows = [t for t, n in enumerate(NEEDLES) if n is not None]
    rh, rany = ref_dict_probe.probe_value_hits(rdd,
                                               [NEEDLES[t] for t in rows])
    np.testing.assert_array_equal(np.asarray(hits[rows, :V]),
                                  np.asarray(rh)[:, :V])
    np.testing.assert_array_equal(any_hits[rows].numpy(), np.asarray(rany))


# ---------------------------------------------------------------------------
# the batched engine: distributed dispatch == single-device dispatch


def _batches(pp, S, layout):
    """(dist engine, its ShardedBatch, single engine, a BlockBatch of the
    same stacked layout)."""
    cfg = TempoDBConfig(**_cfg(layout)).structural()
    eng = MultiBlockEngine(CPU, device_probe_min_vals=PROBE_MIN,
                           structural_cfg=cfg,
                           exchange=mesh.LocalExchange(S))
    host = eng.stage_host(pp)
    batch = eng.place(host)
    one = MultiBlockEngine(CPU, device_probe_min_vals=PROBE_MIN,
                           structural_cfg=cfg)
    single = place_batch(stack_host(pp, pad_to=batch.n_pages,
                                    probe_min_vals=PROBE_MIN, spans=True),
                         CPU)
    return eng, batch, one, single


def _compile(eng, batch, tags, kw):
    req = SearchRequest(tags=dict(tags), **kw)
    mq = compile_multi(list(batch.blocks), req, memo=batch.memo,
                       cache=eng.compile_cache,
                       staged_dicts=batch.staged_dicts)
    if mq is None:
        return None
    mq.limit = kw.get("limit", 20)
    expr = structural.structural_query(req, eng.structural_cfg)
    if expr is not None:
        mq.structural = structural.compile_structural(
            expr, list(batch.blocks), staged_dicts=batch.staged_dicts,
            memo=batch.memo)
    if analytics.agg_requested(req):
        mq.agg_stage = analytics.stage_for_batch(batch)
    return mq


def _equal_outs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g.long(), w.long())


@pytest.mark.parametrize("layout", ["replicated", "shard_spans",
                                    "remainder"])
@pytest.mark.parametrize("S", WORLDS)
def test_dist_dispatch_equals_single_device(blocks, S, layout):
    _rp, pp = blocks
    eng, batch, one, single = _batches(pp, S, layout)
    assert batch.n_pages % S == 0 and len(batch.shards) == S
    assert batch.span_sharded == (layout != "replicated" and S > 1)
    mqs = []
    for tags, kw in REQS:
        mq = _compile(eng, batch, tags, kw)
        smq = _compile(one, single, tags, kw)
        assert (mq is None) == (smq is None)
        if mq is None:
            continue
        _equal_outs(eng.scan_async(batch, mq), one.scan_async(single, smq))
        if mq.structural is None and mq.agg_stage is None:
            mqs.append((mq, smq))
    # the fused form: plain members, then same-plan structural members
    for members in (mqs[:4], [(_compile(eng, batch, *_st(DESC, limit=9)),
                               _compile(one, single, *_st(DESC, limit=9)))
                              for _ in range(3)]):
        cq = stack_queries([m for m, _s in members])
        scq = stack_queries([s for _m, s in members])
        _equal_outs(eng.coalesced_scan_async(batch, cq, 128),
                    one.coalesced_scan_async(single, scq, 128))
    # the fused form with an aggregate member
    agg = [(_compile(eng, batch, {"x-agg-q": "red"}, {"limit": 9}),
            _compile(one, single, {"x-agg-q": "red"}, {"limit": 9}))] + mqs[:2]
    _equal_outs(
        eng.coalesced_scan_async(batch, stack_queries([m for m, _ in agg]),
                                 128),
        one.coalesced_scan_async(single, stack_queries([s for _, s in agg]),
                                 128))


@pytest.mark.parametrize("S", [2, 4])
def test_dist_dispatch_matches_reference_mesh_kernels(blocks, S):
    rp, pp = blocks
    eng, batch, _one, _single = _batches(pp, S, "replicated")
    ref_eng = RefMultiBlockEngine(mesh=ref_make_mesh(S),
                                  device_probe_min_vals=PROBE_MIN)
    rbatch = ref_eng.stage(rp)
    assert rbatch.n_pages == batch.n_pages
    plain = [(t, kw) for t, kw in REQS
             if not any(k.startswith("x-") and k != "x-dbg-exhaustive"
                        for k in t)]
    rmqs, mqs = [], []
    for tags, kw in plain:
        rmq = ref_compile_multi(list(rbatch.blocks), _ref_req(tags, kw),
                                cache_on=rbatch)
        mq = _compile(eng, batch, tags, kw)
        assert (rmq is None) == (mq is None)
        if mq is None:
            continue
        rmq.limit = mq.limit
        c, i, s, x = fetch_scan_out(eng.scan_async(batch, mq))
        rc, ri, rs, rx = ref_eng.scan(rbatch, rmq)
        assert (c, i) == (int(rc), int(ri))
        _tie_contract(s[None], x[None], np.asarray(rs)[None],
                      np.asarray(rx)[None])
        rmqs.append(rmq)
        mqs.append(mq)
    out = eng.coalesced_scan_async(batch, stack_queries(mqs), 128)
    rout = ref_eng.coalesced_scan_async(rbatch, ref_stack_queries(rmqs), 128)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(rout[0]))
    assert int(out[1]) == int(rout[1])
    _tie_contract(out[2].numpy(), out[3].numpy(), np.asarray(rout[2]),
                  np.asarray(rout[3]))


# ---------------------------------------------------------------------------
# TempoDB end to end over the exchange


def _local_db(corpus, S, fields, **kw):
    db = TempoDB(LocalBackend(str(corpus / "blocks")),
                 TempoDBConfig(**fields, **kw), device="cpu")
    db.batcher.set_exchange(mesh.LocalExchange(S))
    db.poll()
    return db


@pytest.mark.parametrize("layout", ["replicated", "shard_spans",
                                    "remainder"])
@pytest.mark.parametrize("S", WORLDS)
def test_tempodb_over_local_exchange_equals_one_device(corpus, S, layout):
    fields = _cfg(layout)
    one = TempoDB(LocalBackend(str(corpus / "blocks")),
                  TempoDBConfig(**fields), device="cpu")
    one.poll()
    db = _local_db(corpus, S, fields)
    try:
        assert _answers(db) == _answers(one)
        # a staged-cache budget small enough to evict, twice over
        small = _local_db(corpus, S, fields, search_batch_cache_bytes=1)
        assert _answers(small) == _answers(one)
        assert len(small.batcher._cache) == 1
        small.close()
    finally:
        one.close()
        db.close()


@pytest.mark.parametrize("S,layout", [(2, "replicated"), (4, "shard_spans"),
                                      (3, "remainder")])
def test_tempodb_over_local_exchange_matches_reference_mesh(corpus, S,
                                                            layout):
    fields = _cfg(layout)
    db = _local_db(corpus, S, fields)
    ref = RefTempoDB(RefLocalBackend(str(corpus / "blocks")),
                     str(corpus / f"wal-{S}-{layout}"),
                     RefTempoDBConfig(auto_mesh=False, **fields),
                     mesh=ref_make_mesh(S))
    ref.poll()
    try:
        assert _answers(db) == _ref_answers(ref, fields)
    finally:
        db.close()


# ---------------------------------------------------------------------------
# DistributedScanEngine


@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_distributed_scan_engine_equals_scan_engine(blocks, S):
    _rp, pp = blocks
    cfg = structural.StructuralConfig(enabled=True, shard_spans=S % 2 == 0)
    eng = DistributedScanEngine(mesh.LocalExchange(S), CPU,
                                probe_min_vals=PROBE_MIN, structural_cfg=cfg)
    one = ScanEngine(CPU)
    for b in (pp[0], pp[3]):
        sp = eng.stage(b)
        ssp = stage(b, CPU, probe_min_vals=PROBE_MIN, spans=True)
        assert sp.staged_dict is not None
        for tags, kw in REQS:
            req = SearchRequest(tags=dict(tags), **kw)
            cq = eng.compile(sp, req)
            if cq is None or analytics.agg_requested(req):
                continue
            got = eng.scan_staged(sp, cq)
            want = fetch_scan_out(one.scan_staged_async(ssp, cq))
            assert got[:2] == want[:2]
            k = len(got[2])
            assert k == min(len(want[2]), k)
            np.testing.assert_array_equal(got[2], want[2][:k])
            np.testing.assert_array_equal(got[3], want[3][:k])
            assert [m.trace_id for m in eng.results(sp, cq, got[2], got[3])] \
                == [m.trace_id for m in one.results(ssp, cq, want[2],
                                                    want[3])]


def test_distributed_scan_engine_matches_reference(blocks):
    rp, pp = blocks
    ref = RefDistributedScanEngine(ref_make_mesh(4))
    eng = DistributedScanEngine(mesh.LocalExchange(4), CPU)
    for i in (0, 4):
        rsp, sp = ref.stage(rp[i]), eng.stage(pp[i])
        for tags, kw in REQS[:2] + REQS[7:]:
            req = SearchRequest(tags=dict(tags), **kw)
            cq = eng.compile(sp, req)
            rcq = ref_pipeline.compile_query(
                rp[i].key_dict, rp[i].val_dict, _ref_req(tags, kw))
            assert (cq is None) == (rcq is None)
            if cq is None:
                continue
            c, n, s, x = eng.scan_staged(sp, cq)
            rc, rn, rs, rx = ref.scan_staged(rsp, rcq)
            assert (c, n) == (int(rc), int(rn))
            _tie_contract(s[None], x[None], np.asarray(rs)[None],
                          np.asarray(rx)[None])


# ---------------------------------------------------------------------------
# a real process group, gloo at world size 1


@pytest.fixture
def gloo_world1():
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield mesh.make_mesh()
    finally:
        dist.destroy_process_group()


def test_gloo_world1_tempodb_equals_ungrouped(corpus, gloo_world1):
    fields = _cfg("shard_spans")
    be = LocalBackend(str(corpus / "blocks"))
    one = TempoDB(be, TempoDBConfig(**fields), device="cpu")
    db = TempoDB(be, TempoDBConfig(**fields), device="cpu", mesh=gloo_world1)
    one.poll()
    db.poll()
    before = mesh.COLLECTIVES.n
    try:
        assert db.batcher.coalescer is not None     # world 1 keeps it
        assert _answers(db) == _answers(one)
        assert one.mesh is None and one.batcher.engine.exchange is None
        assert mesh.COLLECTIVES.n > before
        metas = sorted(one.blocklist.metas(TENANT), key=lambda m: m.block_id)
        for tags, kw in REQS[:4]:
            sreq = SearchRequest(tags=dict(tags), **kw)
            for m in metas[:2]:
                br = SearchBlockRequest(search_req=sreq, block_id=m.block_id,
                                        tenant_id=TENANT, start_page=1,
                                        pages_to_search=5,
                                        encoding=m.encoding)
                assert md.digest(db.search_block(br)) == \
                    md.digest(one.search_block(br))
            bsr = SearchBlocksRequest(search_req=sreq, tenant_id=TENANT, jobs=[
                BlockSearchJob(block_id=m.block_id, encoding=m.encoding,
                               start_page=0, pages_to_search=0)
                for m in metas])
            assert md.digest(db.search_blocks(bsr)) == \
                md.digest(one.search_blocks(bsr))
    finally:
        one.close()
        db.close()


def test_auto_mesh_resolves_at_the_first_search(corpus, gloo_world1):
    """auto_mesh resolves at the first search and, as the reference's,
    shards only over more than one rank: a world-1 group leaves the
    database on its own device, issuing no collective. (The dryrun's
    ranks shard through auto_mesh at world > 1: test_torch_multihost.)"""
    be = LocalBackend(str(corpus / "blocks"))
    auto = TempoDB(be, TempoDBConfig(), device="cpu")
    off = TempoDB(be, TempoDBConfig(auto_mesh=False), device="cpu")
    before = mesh.COLLECTIVES.n
    for db in (auto, off):
        db.poll()
        assert db.mesh is None and not db._mesh_resolved
        db.search(TENANT, SearchRequest(tags={"service.name": "db"}))
        assert db._mesh_resolved
        assert db.mesh is None and db.batcher.engine.exchange is None
    assert mesh.COLLECTIVES.n == before
    auto.close()
    off.close()


def test_live_tier_stays_unsharded_on_a_mesh(corpus, gloo_world1):
    """The live tier scans on the database's own device, unsharded, as
    the reference's does: a live search on a grouped database issues no
    collective and answers as an ungrouped database's tier."""
    from tempo_tpu_torch.search.data import encode_search_data
    from tempo_tpu_torch.search.results import SearchResults

    be = LocalBackend(str(corpus / "blocks"))
    grp = TempoDB(be, TempoDBConfig(search_live_tier_enabled=True),
                  device="cpu", mesh=gloo_world1)
    one = TempoDB(be, TempoDBConfig(search_live_tier_enabled=True,
                                    auto_mesh=False), device="cpu")
    req = SearchRequest(tags={"service.name": "cart"}, limit=50)
    got = []
    try:
        for db in (grp, one):
            for sd in md.corpus_entries(1)[:40]:
                db.live_tier.absorb(TENANT, sd.trace_id,
                                    encode_search_data(sd))
            before = mesh.COLLECTIVES.n
            res = SearchResults.for_request(req)
            assert db.live_tier.search(TENANT, req, res)
            assert mesh.COLLECTIVES.n == before
            got.append(md.digest(res))
        assert got[0] == got[1] and got[0]["traces"]
    finally:
        grp.close()
        one.close()


def test_a_cuda_database_refuses_a_gloo_group(gloo_world1):
    with pytest.raises(ValueError, match="nccl"):
        mesh.ShardExchange(gloo_world1, torch.device("cuda"))
    ex = mesh.ShardExchange(gloo_world1, CPU)
    assert (ex.world, ex.rank, ex.ranks) == (1, 0, (0,))


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        mesh.make_mesh()


# ---------------------------------------------------------------------------
# the dispatch lock and the coalescer with more than one rank


def test_locked_collective_times_out():
    assert mesh.dispatch_lock.acquire(timeout=5)
    try:
        with pytest.raises(mesh.DispatchLockTimeout):
            with mesh.locked_collective(0.05):
                pass
    finally:
        mesh.dispatch_lock.release()
    with mesh.locked_collective(0.05):
        assert mesh.dispatch_lock.locked()
    assert not mesh.dispatch_lock.locked()


def test_more_than_one_rank_never_coalesces(corpus):
    fields = _cfg("replicated")
    db = _local_db(corpus, 2, fields, search_coalesce_window_s=0.05)
    one = TempoDB(LocalBackend(str(corpus / "blocks")),
                  TempoDBConfig(**fields), device="cpu")
    one.poll()
    try:
        assert db.batcher.coalescer is None
        assert db.batcher.debug_stats()["coalesce"] is None
        reqs = [({"service.name": s, "x-dbg-exhaustive": ""}, {"limit": 20})
                for s in md.SERVICES] * 2
        want = _answers(one, reqs)
        got = [None] * len(reqs)
        barrier = threading.Barrier(len(reqs))

        def client(i):
            barrier.wait(timeout=10)
            got[i] = _answers(db, [reqs[i]])[0]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert got == want
    finally:
        db.close()
        one.close()
