"""The port's ``?agg=red`` aggregates and its analytics count against the
reference's.

Same seeds, same inputs, exact equality throughout (every output is an
integer or a canonical JSON string):

- ``build_agg_stage``: the composite-key column, the service table and
  the key count, on blocks with entries that have no root service, an
  ``error=true`` pair, the value ``untrue`` and durations on every
  ``MS_BUCKETS`` edge and one past it;
- kernel K7's plain version (``kernels.agg``) against the reference's
  ``agg_entry_counts`` through ``jax.jit`` ([K]) and ``jax.vmap``
  ([Q, K]); K8's against ``analytics_count_kernel`` below 2^62 ns and
  against the reference's host count at and past it;
- end to end over one LocalBackend directory the reference wrote (six
  blocks, several groups): ``TempoDB.search``, ``search_block`` and
  ``search_blocks``, a packed database, a structural request, the
  non-agg twin, limit 1 against limit 1000, concurrent agg and plain
  clients against their serial answers, the gate off, and the
  single-block engine.

The reference's gates (``ANALYTICS``, ``STRUCTURAL``, ``PACKING``) are
process-wide: each reference call sets them right before it runs, and an
autouse fixture puts them back after every test.
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu import tempopb
from tempo_tpu.backend.local import LocalBackend as RefLocalBackend
from tempo_tpu.backend.types import BlockMeta as RefBlockMeta
from tempo_tpu.db import TempoDB as RefTempoDB
from tempo_tpu.db import TempoDBConfig as RefTempoDBConfig
from tempo_tpu.modules.generator import \
    LATENCY_BUCKETS_S as REF_LATENCY_BUCKETS_S
from tempo_tpu.search import analytics as ref_analytics
from tempo_tpu.search import data as ref_data
from tempo_tpu.search import packing as ref_packing
from tempo_tpu.search import pipeline as ref_pipeline
from tempo_tpu.search import structural as ref_structural
from tempo_tpu.search.backend_search_block import \
    BackendSearchBlock as RefBackendSearchBlock
from tempo_tpu.search.backend_search_block import \
    write_search_block as ref_write_search_block
from tempo_tpu.search.columnar import ColumnarPages as RefPages
from tempo_tpu.search.columnar import PageGeometry as RefGeometry
from tempo_tpu.search.multiblock import agg_entry_counts

from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.model.types import (BlockSearchJob, SearchBlockRequest,
                                         SearchBlocksRequest, SearchRequest)
from tempo_tpu_torch.search import analytics, batcher, data, ir, structural
from tempo_tpu_torch.search.backend_search_block import BackendSearchBlock
from tempo_tpu_torch.search.columnar import ColumnarPages, PageGeometry
from tempo_tpu_torch.search.engine import fetch_coalesced_out, fetch_scan_out
from tempo_tpu_torch.search.kernels import agg as agg_k
from tempo_tpu_torch.search.multiblock import (MultiBlockEngine,
                                               compile_multi, stack_queries)

TENANT = "t1"
GEO = (16, 8)          # entries per page, kv slot cap
MAX_PAGES = 8          # pages per group: two blocks of four pages a group
N_BLOCKS = 6
N_PER_BLOCK = 60
BASE_S = 1_600_000_000
SVCS = ["api", "db", "auth", "cache", "web"]
OPS = ["op0", "op1", "op2"]
CPU = torch.device("cpu")
_ref_counts = jax.jit(agg_entry_counts, static_argnames=("n_keys",))


def _untimed(resp):
    """A response without its attributed device seconds, a timing that
    differs from run to run (search/query_stats.py)."""
    return dataclasses.replace(resp, metrics=dataclasses.replace(
        resp.metrics, device_seconds=0.0))


@pytest.fixture(autouse=True)
def _reference_gates():
    """Leave the reference's process-wide gates as the test found them."""
    a = ref_analytics.ANALYTICS
    g = ref_structural.STRUCTURAL
    prev = (a.enabled, a.min_rows, g.enabled, ref_packing.PACKING.enabled)
    ref_pipeline._COMPILE_CACHE.clear()
    yield
    a.configure(enabled=prev[0], min_rows=prev[1])
    g.enabled, ref_packing.PACKING.enabled = prev[2], prev[3]
    ref_pipeline._COMPILE_CACHE.clear()


# ---------------------------------------------------------------------------
# inputs, made from a seed for either package


def entries(seed: int, n: int, mod) -> list:
    """`n` traces as `mod.SearchData` (`mod`: either package's data
    module): every odd trace lasts an MS_BUCKETS edge or one past it, 1
    in 9 has no root service (and no service.name), a quarter carry
    error=true, some error=untrue or error=false; 0-3 span rows each."""
    rng = random.Random(seed)
    edges = [e + d for e in analytics.MS_BUCKETS for d in (0, 1)]
    out = []
    for i in range(n):
        sd = mod.SearchData(trace_id=(seed * 100_000 + i).to_bytes(16, "big"))
        sd.start_s = BASE_S + seed * 1000 + i
        sd.end_s = sd.start_s + rng.randint(0, 10)
        sd.dur_ms = (edges[(i // 2) % len(edges)] if i % 2
                     else rng.randint(1, 40_000))
        sd.root_service = "" if i % 9 == 4 else rng.choice(SVCS)
        sd.root_name = rng.choice(OPS)
        sd.kvs = {"env": {"prod" if i % 3 else "dev"},
                  "http.status_code": {rng.choice(["200", "404", "500"])}}
        if sd.root_service:
            sd.kvs["service.name"] = {sd.root_service}
        r = rng.random()
        if r < 0.25:
            sd.kvs["error"] = {"true"}
        elif r < 0.35:
            sd.kvs["error"] = {"untrue"}
        elif r < 0.4:
            sd.kvs["error"] = {"false"}
        for _ in range(rng.randint(0, 3)):
            s = len(sd.spans)
            sd.spans.append(mod.SpanData(
                parent=-1 if s == 0 else rng.randrange(s),
                dur_ms=rng.randint(1, 1000), kind=rng.randint(0, 5),
                kvs={"service.name": {rng.choice(SVCS)},
                     "name": {rng.choice(OPS)}}))
        out.append(sd)
    return out


def _pages_both(seeds):
    return ([RefPages.build(entries(s, N_PER_BLOCK, ref_data),
                            RefGeometry(*GEO)) for s in seeds],
            [ColumnarPages.build(entries(s, N_PER_BLOCK, data),
                                 PageGeometry(*GEO)) for s in seeds])


# ---------------------------------------------------------------------------
# staging, grammar, kernels


def test_agg_stage_matches_reference():
    ref_blocks, port_blocks = _pages_both([1, 2, 3])
    pad = sum(b.n_pages for b in port_blocks) + 3       # pad pages too
    want = ref_analytics.build_agg_stage(ref_blocks, pad, GEO[0])
    got = analytics.build_agg_stage(port_blocks, pad, GEO[0])
    assert got.services == want.services and "" in got.services
    assert got.n_keys == want.n_keys
    np.testing.assert_array_equal(got.host, want.host)
    # the error bit is the exact pair, never a substring: an entry with
    # error=untrue (and none with error=true) keeps bit 0
    b = port_blocks[0]
    kid = b.key_dict.index("error")
    vals = [{b.val_dict[v] for k, v in zip(b.kv_key[p, e], b.kv_val[p, e])
             if k == kid} for p in range(b.n_pages) for e in range(GEO[0])]
    bits = got.host[:b.n_pages].reshape(-1) & 1
    assert {int(x) for x, v in zip(bits, vals) if v == {"true"}} == {1}
    assert {int(x) for x, v in zip(bits, vals) if v == {"untrue"}} == {0}
    counts = np.random.default_rng(5).integers(0, 3, size=got.n_keys)
    assert got.decode(counts) == want.decode(counts)


def test_agg_grammar_and_merge_match_reference():
    req, ref_req = SearchRequest(), tempopb.SearchRequest()
    analytics.attach_agg(req, " RED ")
    ref_analytics.attach_agg(ref_req, " RED ")
    assert dict(req.tags) == dict(ref_req.tags)
    assert analytics.agg_requested(req)
    with pytest.raises(ValueError):
        analytics.attach_agg(req, "p99")
    a = {"api": {"calls": 2, "errors": 1, "hist": [1, 1] + [0] * 13}}
    b = {"api": {"calls": 3, "errors": 0, "hist": [0, 3] + [0] * 13},
         "": {"calls": 1, "errors": 0, "hist": [1] + [0] * 14}}
    got = analytics.merge_agg(analytics.agg_response(json.loads(
        json.dumps(a))), analytics.agg_response(json.loads(json.dumps(b))))
    want = ref_analytics.merge_agg(ref_analytics.agg_response(a),
                                   ref_analytics.agg_response(b))
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert analytics.MS_BUCKETS == ref_analytics.MS_BUCKETS
    assert analytics.LATENCY_BUCKETS_S == REF_LATENCY_BUCKETS_S


def _k7_inputs(Q: int, n_keys: int, seed: int):
    rng = np.random.default_rng(seed)
    P, E = 6, 32
    keys = rng.integers(0, n_keys, size=(P, E)).astype(np.int32)
    keys[0, :3] = [n_keys, -1, n_keys + 5]   # counted nowhere
    mask = rng.random((Q, P, E)) < 0.6
    scores = np.where(mask, rng.integers(0, 2**31 - 1, size=mask.shape),
                      -1).astype(np.int32)
    scores[:, 1, :4] = np.where(mask[:, 1, :4], 0, -1)   # score 0 matches
    return keys, mask, scores


@pytest.mark.parametrize("Q", [1, 3])
def test_k7_plain_matches_agg_entry_counts(Q):
    """[K] against the jit of agg_entry_counts, [Q, K] against its vmap;
    through the wrappers, which take the plain version on the CPU."""
    n_keys = 8 * analytics._NB1Q * 2
    keys, mask, scores = _k7_inputs(Q, n_keys, 40 + Q)
    kj = jnp.asarray(keys)
    if Q == 1:
        want = np.asarray(_ref_counts(jnp.asarray(mask[0]), kj,
                                      n_keys=n_keys))[None]
        got = agg_k.agg_counts(torch.from_numpy(scores[0].reshape(-1)),
                               torch.from_numpy(keys.reshape(-1)),
                               n_keys)[None]
    else:
        want = np.asarray(jax.jit(jax.vmap(
            lambda m: agg_entry_counts(m, kj, n_keys)))(jnp.asarray(mask)))
        got = agg_k.agg_counts_rows(
            torch.from_numpy(scores.reshape(Q, -1)),
            torch.from_numpy(keys.reshape(-1)), n_keys)
    assert got.dtype == torch.int32 and tuple(got.shape) == (Q, n_keys)
    np.testing.assert_array_equal(got.numpy(), want)
    in_range = (keys >= 0) & (keys < n_keys)
    assert got.sum(dim=1).tolist() == \
        [int((mask[q] & in_range).sum()) for q in range(Q)]


def _k8_inputs(seed: int, n: int, n_keys: int, huge: bool):
    rng = np.random.default_rng(seed)
    full = ref_analytics._dur_thresholds_full(REF_LATENCY_BUCKETS_S)
    edge = np.asarray([t + d for t in full for d in (-1, 0, 1)],
                      dtype=np.int64)
    dur = rng.integers(0, 20_000_000_000, size=n, dtype=np.int64)
    dur[:edge.size] = edge
    dur[edge.size] = 0
    dur[edge.size + 1] = (1 << 62) - 1
    if huge:
        dur[-3:] = [1 << 62, (1 << 62) + 12_345, (1 << 63) - 1]
    sidx = rng.integers(0, n_keys, size=n).astype(np.int64)
    sidx[-5:-3] = n_keys           # the reference's pad sentinel
    return sidx, dur


def test_k8_plain_matches_count_kernel():
    """Below 2^62 ns: K8's plain version (through ``dense_counts`` on the
    CPU) equals the reference's jit kernel on its limbed columns, at
    every threshold and one either side of it."""
    thr = ref_analytics._dur_thresholds(REF_LATENCY_BUCKETS_S)
    assert analytics._dur_thresholds(analytics.LATENCY_BUCKETS_S) == thr
    assert analytics._dur_thresholds_full(analytics.LATENCY_BUCKETS_S) == \
        ref_analytics._dur_thresholds_full(REF_LATENCY_BUCKETS_S)
    for n_keys, n in ((8, 700), (64, 2_000)):
        sidx, dur = _k8_inputs(n_keys, n, n_keys, huge=False)
        want = ref_analytics.ANALYTICS._count_device(sidx, dur, n_keys, thr)
        got = analytics.dense_counts(sidx, dur, n_keys, device="cpu")
        np.testing.assert_array_equal(got, want)
        assert got.sum() == int((sidx < n_keys).sum())


def test_k8_exact_past_two_to_the_62_as_the_host_count():
    """At and past 2^62 ns the reference counts on the host; K8 takes
    whole int64 nanoseconds, so its plain version equals that count."""
    sidx, dur = _k8_inputs(9, 900, 16, huge=True)
    want = ref_analytics.ANALYTICS._count(sidx, dur, 16,
                                          REF_LATENCY_BUCKETS_S)
    got = analytics.dense_counts(sidx, dur, 16, device="cpu")
    np.testing.assert_array_equal(got, want)
    nb1 = len(REF_LATENCY_BUCKETS_S) + 1
    assert got.reshape(16, nb1)[:, -1].sum() >= 3     # the +Inf bin


def test_fetch_carries_the_agg_counts_on_one_copy():
    counts = torch.tensor([5, 9], dtype=torch.int32)
    scores = torch.arange(4, dtype=torch.int32)
    idx = scores + 10
    agg = torch.arange(60, dtype=torch.int32)
    c, ins, s, i, a = fetch_scan_out((counts, scores, idx, agg))
    assert (c, ins) == (5, 9) and s.tolist() == [0, 1, 2, 3]
    assert i.tolist() == [10, 11, 12, 13] and a.tolist() == list(range(60))
    rows = torch.arange(120, dtype=torch.int32).reshape(2, 60)
    qc, qins, qs, qi, qa = fetch_coalesced_out(
        (torch.tensor([1, 2, 0, 0], dtype=torch.int32),
         torch.tensor(7, dtype=torch.int32), scores.repeat(4, 1),
         idx.repeat(4, 1), rows))
    assert qc.tolist() == [1, 2, 0, 0] and qins == 7
    assert qs.shape == (4, 4) and qi[3].tolist() == [10, 11, 12, 13]
    np.testing.assert_array_equal(qa, rows.numpy())


def test_fused_agg_rows_equal_solo_dispatches():
    """stack_queries shares the batch's stage; the fused dispatch's K7
    rows equal each member's solo dispatch."""
    _ref_blocks, blocks = _pages_both([4, 5])
    eng = MultiBlockEngine(CPU)
    batch = eng.place(eng.stage_host(blocks))
    stage = analytics.stage_for_batch(batch)
    assert analytics.stage_for_batch(batch) is stage
    mqs = []
    for tags in ({"env": "prod"}, {}, {"service.name": "a"}):
        mq = compile_multi(blocks, SearchRequest(tags=tags), memo=batch.memo)
        mq.agg_stage = stage
        mqs.append(mq)
    cq = stack_queries(mqs)
    assert cq.agg_stage is stage
    *_, fused = fetch_coalesced_out(eng.coalesced_scan_async(batch, cq, 128))
    assert fused.shape == (3, stage.n_keys)
    for qi, mq in enumerate(mqs):
        count, *_x, solo = eng.scan(batch, mq)
        np.testing.assert_array_equal(fused[qi], solo)
        assert int(solo.sum()) == count


# ---------------------------------------------------------------------------
# end to end


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six blocks the reference wrote, each its own hour of traces."""
    root = tmp_path_factory.mktemp("torch_analytics")
    be = RefLocalBackend(str(root / "blocks"))
    for b in range(N_BLOCKS):
        ref_write_search_block(be, RefBlockMeta(tenant_id=TENANT),
                               entries(10 + b, N_PER_BLOCK, ref_data),
                               geometry=RefGeometry(*GEO), encoding="zlib")
    return root


def _pair(root, tmp_path_factory, **cfg):
    cfg.setdefault("search_analytics_enabled", True)
    ref = RefTempoDB(
        RefLocalBackend(str(root / "blocks")),
        str(tmp_path_factory.mktemp("torch_analytics_wal")),
        RefTempoDBConfig(search_max_batch_pages=MAX_PAGES, auto_mesh=False,
                         host_state_dir="", search_structural_enabled=True,
                         **cfg))
    port = TempoDB(LocalBackend(str(root / "blocks")),
                   TempoDBConfig(search_max_batch_pages=MAX_PAGES,
                                 search_structural_enabled=True, **cfg),
                   device="cpu")
    ref.poll()
    port.poll()
    return ref, port


def _reqs(tags: dict, kw: dict, agg: bool = True):
    """The same request for the reference and for the port."""
    r = tempopb.SearchRequest()
    for k, v in tags.items():
        r.tags[k] = v
    for k, v in kw.items():
        setattr(r, k, v)
    p = SearchRequest(tags=dict(tags), **kw)
    if agg:
        ref_analytics.attach_agg(r, "red")
        analytics.attach_agg(p, "red")
    return r, p


def _ref_call(fn, enabled: bool = True, packed: bool = False):
    """A reference call with its process-wide gates set for it."""
    ref_analytics.ANALYTICS.configure(enabled=enabled)
    ref_structural.STRUCTURAL.enabled = True
    ref_packing.PACKING.enabled = packed
    return fn().response()


def _traces(resp) -> list:
    return [(t.trace_id, t.start_time_unix_nano, t.duration_ms,
             t.root_service_name, t.root_trace_name) for t in resp.traces]


def _metrics(m) -> tuple:
    return (m.inspected_traces, m.inspected_blocks, m.skipped_blocks,
            m.inspected_bytes, m.truncated_entries)


def _same(got, want) -> None:
    assert got.metrics.agg_json == want.metrics.agg_json
    assert _traces(got) == _traces(want)
    assert _metrics(got.metrics) == _metrics(want.metrics)


@pytest.fixture(scope="module")
def dbs(corpus, tmp_path_factory):
    ref, port = _pair(corpus, tmp_path_factory)
    # stage every group in both first, so the non-agg twins' early quits
    # scan the same groups
    r, p = _reqs({"x-dbg-exhaustive": ""}, {"limit": 20}, agg=False)
    _same(port.search(TENANT, p).response(),
          _ref_call(lambda: ref.search(TENANT, r)))
    yield ref, port
    port.close()


REQS = {
    "red_all": ({}, {"limit": 20}),
    "env_prod": ({"env": "prod"}, {"limit": 20}),
    "service": ({"service.name": "api"}, {"limit": 5}),
    "status_500_window": ({"http.status_code": "500"},
                          {"start": BASE_S + 12_000,
                           "end": BASE_S + 14_030, "limit": 20}),
    "slow": ({}, {"min_duration_ms": 1000, "max_duration_ms": 16_385,
                  "limit": 20}),
    "error_substring": ({"error": "true"}, {"limit": 20}),
    "exhaustive": ({"x-dbg-exhaustive": "", "env": "dev"}, {"limit": 20}),
    "absent": ({"service.name": "nope"}, {"limit": 20}),
}


@pytest.mark.parametrize("name", list(REQS))
def test_search_agg_matches_reference(dbs, name):
    """agg_json byte-equal, traces and metrics equal; run twice so the
    second pass goes through both packages' memos and staged keys."""
    ref, port = dbs
    tags, kw = REQS[name]
    for _ in range(2):
        r, p = _reqs(tags, kw)
        want = _ref_call(lambda: ref.search(TENANT, r))
        got = port.search(TENANT, p).response()
        _same(got, want)
    if name == "absent":
        assert got.metrics.agg_json == ""
    else:
        agg = json.loads(got.metrics.agg_json)
        assert agg["type"] == "red" and agg["series"]


def test_corpus_spans_groups_and_edge_cases(dbs):
    """Several groups, so merge_agg runs across them; the "" series and
    errors are present."""
    _ref, port = dbs
    groups = port.batcher.plan(port._jobs(TENANT, port.blocklist.epoch())[0])
    assert len(groups) >= 2
    got = port.search(TENANT, _reqs({}, {"limit": 20})[1]).response()
    series = json.loads(got.metrics.agg_json)["series"]
    assert "" in series and sum(s["errors"] for s in series.values()) > 0
    assert sum(s["calls"] for s in series.values()) == \
        got.metrics.inspected_traces == N_BLOCKS * N_PER_BLOCK
    assert port.batcher.debug_stats()["cache"]["agg_bytes"] == sum(
        c.batch.agg_stage.host.nbytes for c in port.batcher._cache.values())


def test_limit_one_and_limit_1000_give_one_aggregate(dbs):
    ref, port = dbs
    out = {}
    for limit in (1, 1000):
        r, p = _reqs({"env": "prod"}, {"limit": limit})
        want = _ref_call(lambda: ref.search(TENANT, r))
        out[limit] = port.search(TENANT, p).response()
        _same(out[limit], want)
    assert len(out[1].traces) == 1
    assert out[1].metrics.agg_json == out[1000].metrics.agg_json != ""


@pytest.mark.parametrize("name", ["env_prod", "service", "absent"])
def test_non_agg_twin_has_no_aggregate(dbs, name):
    """The plain twin of an agg request shares its compiled predicate and
    answers as the reference does, with no agg_json."""
    ref, port = dbs
    tags, kw = REQS[name]
    r, p = _reqs(tags, kw, agg=False)
    got = port.search(TENANT, p).response()
    _same(got, _ref_call(lambda: ref.search(TENANT, r)))
    assert got.metrics.agg_json == ""
    big = dict(kw, limit=1000)
    plain = port.search(TENANT, _reqs(tags, big, agg=False)[1]).response()
    with_agg = port.search(TENANT, _reqs(tags, big)[1]).response()
    assert _traces(plain) == _traces(with_agg)


def _jobs(ref) -> list:
    out = []
    for m in sorted(ref.blocklist.metas(TENANT), key=lambda m: m.block_id):
        for start, count in ((0, 0), (1, 2)):
            out.append(dict(block_id=m.block_id, start_page=start,
                            pages_to_search=count, encoding=m.encoding,
                            version=m.version, data_encoding=m.data_encoding,
                            start_time=m.start_time, end_time=m.end_time))
    return out


@pytest.mark.parametrize("name", ["red_all", "env_prod", "slow"])
def test_search_block_agg_matches_reference(dbs, name):
    ref, port = dbs
    tags, kw = REQS[name]
    for j in _jobs(ref):
        r, p = _reqs(tags, kw)
        rr = tempopb.SearchBlockRequest(tenant_id=TENANT, **j)
        rr.search_req.CopyFrom(r)
        want = _ref_call(lambda: ref.search_block(rr))
        got = port.search_block(SearchBlockRequest(search_req=p,
                                                   tenant_id=TENANT, **j))
        _same(got.response(), want)


@pytest.mark.parametrize("name", ["red_all", "service", "exhaustive"])
def test_search_blocks_agg_matches_reference(dbs, name):
    ref, port = dbs
    tags, kw = REQS[name]
    jobs = _jobs(ref)
    r, p = _reqs(tags, kw)
    rb = tempopb.SearchBlocksRequest(tenant_id=TENANT)
    rb.search_req.CopyFrom(r)
    for j in jobs:
        rb.jobs.add(**j)
    want = _ref_call(lambda: ref.search_blocks(rb))
    got = port.search_blocks(SearchBlocksRequest(
        search_req=p, tenant_id=TENANT,
        jobs=[BlockSearchJob(**j) for j in jobs])).response()
    _same(got, want)
    assert got.metrics.agg_json != ""


def test_packed_database_agg_matches_reference(corpus, tmp_path_factory,
                                               dbs):
    """A packed database answers as the packed reference does, and as the
    unpacked port does."""
    ref, port = _pair(corpus, tmp_path_factory,
                      search_packed_residency=True)
    _ref_u, port_u = dbs
    try:
        for name in ("red_all", "env_prod", "slow", "status_500_window"):
            tags, kw = REQS[name]
            r, p = _reqs(tags, kw)
            want = _ref_call(lambda: ref.search(TENANT, r), packed=True)
            got = port.search(TENANT, p).response()
            _same(got, want)
            assert _untimed(got) == _untimed(
                port_u.search(TENANT, p).response())
        assert all(c.batch.widths is not None
                   for c in port.batcher._cache.values())
    finally:
        port.close()


@pytest.mark.parametrize("plan", [
    {"exists": {"kind": 2}},
    {"child": {"parent": {"tag": {"k": "service.name", "v": "api"}},
               "child": {"dur": {"min_ms": 300}}}},
])
def test_structural_request_agg_matches_reference(dbs, plan):
    """The aggregate counts the entries the structural verdicts pass."""
    ref, port = dbs
    expr = ir.parse(json.dumps(plan))
    tags = {structural.STRUCTURAL_QUERY_TAG: ir.quote(ir.to_json(expr))}
    for kw in ({"limit": 1000}, {"limit": 3}):
        r, p = _reqs(tags, kw)
        want = _ref_call(lambda: ref.search(TENANT, r))
        got = port.search(TENANT, p).response()
        _same(got, want)
    calls = sum(s["calls"] for s in json.loads(
        got.metrics.agg_json)["series"].values())
    assert 0 < calls < N_BLOCKS * N_PER_BLOCK


def test_agg_and_plain_queries_fuse_apart(dbs):
    """The coalescer keys agg members apart from plain ones: with a long
    window, two of each park in two groups and flush as two fused
    dispatches, each all agg or all plain."""
    _ref, port = dbs
    eng = port.batcher.engine
    cached = next(iter(port.batcher._cache.values()))
    blocks = list(cached.batch.blocks)
    stage = analytics.stage_for_batch(cached.batch)
    co = batcher.QueryCoalescer(eng, window_s=60, max_queries=8)
    seen = []
    real = batcher.stack_queries

    def spy(mqs, *a):
        seen.append([mq.agg_stage is not None for mq in mqs])
        return real(mqs, *a)

    batcher.stack_queries = spy
    try:
        futs = []
        for agg, tags in ((True, {"env": "prod"}), (False, {"env": "dev"}),
                          (True, {"env": "dev"}), (False, {})):
            mq = compile_multi(blocks, SearchRequest(tags=tags),
                               memo=cached.batch.memo)
            mq.agg_stage = stage if agg else None
            futs.append((agg, co.submit(cached.batch, mq, 128, peers=4)))
        assert co.stats()["pending"] == 4
        co.close()
    finally:
        batcher.stack_queries = real
    assert sorted(seen) == [[False, False], [True, True]]
    for agg, f in futs:
        assert len(list(f.result())) == (5 if agg else 4)


def test_concurrent_agg_and_plain_clients_equal_serial(corpus,
                                                       tmp_path_factory):
    """Eight barrier-started clients, four asking for an aggregate, with
    coalescing on: every response equals its serial one."""
    port = TempoDB(LocalBackend(str(corpus / "blocks")),
                   TempoDBConfig(search_max_batch_pages=MAX_PAGES,
                                 search_analytics_enabled=True,
                                 search_coalesce_window_s=0.05),
                   device="cpu")
    try:
        port.poll()
        reqs = []
        for i, tags in enumerate(({"env": "prod"}, {"env": "dev"},
                                  {"service.name": "a"}, {})):
            reqs.append(_reqs(dict(tags, **{"x-dbg-exhaustive": ""}),
                              {"limit": 1000})[1])
            reqs.append(_reqs(tags, {"limit": 20 + i}, agg=False)[1])
        port.search(TENANT, reqs[1])         # stage every group
        port.search(TENANT, reqs[0])
        serial = [port.search(TENANT, r).response() for r in reqs]
        out = [None] * len(reqs)
        barrier = threading.Barrier(len(reqs))

        def one(i):
            barrier.wait(timeout=60)
            out[i] = port.search(TENANT, reqs[i]).response()

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert [_untimed(o) for o in out] == [_untimed(s) for s in serial]
        assert all(s.metrics.agg_json for s in serial[::2])
        assert not any(s.metrics.agg_json for s in serial[1::2])
        assert port.batcher.debug_stats()["coalesce"]["pending"] == 0
    finally:
        port.close()


def test_gate_off_ignores_the_tag_and_keeps_no_early_quit(corpus,
                                                          tmp_path_factory,
                                                          dbs):
    """Off, the tag is no term and no aggregate comes back, and the
    request still scans every group, as the reference's TempoDB does;
    two databases in one process keep their own gates."""
    ref, port = _pair(corpus, tmp_path_factory,
                      search_analytics_enabled=False)
    _ref_on, port_on = dbs
    try:
        r, p = _reqs({"x-dbg-exhaustive": ""}, {"limit": 20}, agg=False)
        _same(port.search(TENANT, p).response(),
              _ref_call(lambda: ref.search(TENANT, r), enabled=False))
        for name in ("env_prod", "service"):
            tags, kw = REQS[name]
            r, p = _reqs(tags, kw)
            want = _ref_call(lambda: ref.search(TENANT, r), enabled=False)
            got = port.search(TENANT, p).response()
            _same(got, want)
            assert got.metrics.agg_json == ""
            assert got.metrics.inspected_blocks == \
                port_on.search(TENANT, p).response().metrics.inspected_blocks
            plain = port.search(TENANT, _reqs(tags, kw, agg=False)[1])
            assert plain.metrics.inspected_blocks < \
                got.metrics.inspected_blocks == N_BLOCKS
            assert port_on.search(TENANT, p).response().metrics.agg_json
            assert port.search(TENANT, p).response().metrics.agg_json == ""
        assert all(c.batch.agg_stage is None
                   for c in port.batcher._cache.values())
    finally:
        port.close()


def test_single_block_engine_answers_without_an_aggregate(dbs, corpus):
    """BackendSearchBlock.search takes the tag as the reference's does:
    no term, no agg_json."""
    ref, port = dbs
    be = RefLocalBackend(str(corpus / "blocks"))
    pbe = LocalBackend(str(corpus / "blocks"))
    for m, pm in zip(sorted(ref.blocklist.metas(TENANT),
                            key=lambda m: m.block_id),
                     sorted(port.blocklist.metas(TENANT),
                            key=lambda m: m.block_id)):
        rb = RefBackendSearchBlock(be, m)
        pb = BackendSearchBlock(pbe, pm, device="cpu")
        for name in ("env_prod", "red_all"):
            tags, kw = REQS[name]
            r, p = _reqs(tags, kw)
            want = _ref_call(lambda: rb.search(r))
            got = pb.search(p).response()
            _same(got, want)
            assert got.metrics.agg_json == ""
