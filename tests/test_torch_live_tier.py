"""The port's live tier and WAL-head search block against the reference's.

Same seeded entries, fed to both packages as the same encoded bytes
(the port's codec writes the reference's bytes), exact equality:

- the data layer: ``SearchData.merge``, ``clone_search_data``,
  ``search_data_matches`` and the object framing;
- ``LiveTier``: ``absorb`` then ``search`` for tag, duration, window,
  exhaustive, pruned and structural requests and a limit past the entry
  count (trace metadata and ``inspected_traces``), the decline on
  overflow, ``mark_cut`` and ``drop_tenant``;
- B9: ``hot_scan_plain`` against the reference's ``hot_scan_kernel`` run
  through ``jax.jit`` on a tier-8 stage with 3 live pages whose pages 3-7
  hold valid entries that would match, and the kernel route's live-prefix
  views (run here through the plain K1s/K2/K6) against both;
- ``StreamingSearchBlock``: gate-on search against the reference's, the
  sidecar file both ways (a torn tail and a corrupt entry included), the
  deadline, and the walk against the scan;
- tail subscriptions, per-database gates, concurrent absorb and search,
  and a faulting hot scan that raises and never walks.

The reference's live tier and structural gate are process-wide; an
autouse fixture puts them back after every test.
"""

from __future__ import annotations

import random
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu import tempopb
from tempo_tpu.encoding.v2 import objects as ref_objects
from tempo_tpu.robustness import deadline as ref_deadline
from tempo_tpu.search import data as ref_data
from tempo_tpu.search import engine as ref_engine
from tempo_tpu.search import live_tier as ref_live
from tempo_tpu.search import pipeline as ref_pipeline
from tempo_tpu.search import streaming as ref_streaming
from tempo_tpu.search import structural as ref_structural
from tempo_tpu.search.columnar import ColumnarPages as RefPages
from tempo_tpu.search.columnar import PageGeometry as RefGeometry
from tempo_tpu.search.results import SearchResults as RefResults

from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.backend.types import BlockMeta
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.encoding.v2 import objects
from tempo_tpu_torch.model.types import SearchRequest
from tempo_tpu_torch.robustness import deadline
from tempo_tpu_torch.search import data, ir, live_tier, streaming, structural
from tempo_tpu_torch.search.backend_search_block import write_search_block
from tempo_tpu_torch.search.columnar import ColumnarPages, PageGeometry
from tempo_tpu_torch.search.engine import ScanEngine, stage
from tempo_tpu_torch.search.kernels import live as k_live
from tempo_tpu_torch.search.kernels import scan as k_scan
from tempo_tpu_torch.search.live_tier import LiveTier
from tempo_tpu_torch.search.pipeline import compile_query
from tempo_tpu_torch.search.results import SearchResults

TENANT = "t1"
BASE_S = 1_600_000_000
SVCS = ["api", "db", "auth", "cache", "web"]
OPS = ["op0", "op1", "op2"]
N = 300                 # traces of the live corpus (one page)
CPU = torch.device("cpu")
ST_ON = structural.StructuralConfig(enabled=True)
DESC = '{"desc": {"anc": {"tag": {"k": "service.name", "v": "db"}}, ' \
       '"span": {"kind": 3}}}'


@pytest.fixture(autouse=True)
def _reference_gates():
    """Each test starts with the reference's structural gate on and its
    live tier enabled at the defaults, and leaves both as it found
    them."""
    g = ref_structural.STRUCTURAL
    lt = ref_live.LIVE_TIER
    prev = (g.enabled, lt.enabled, lt.max_entries, lt.max_subscriptions)
    g.enabled = True
    lt.configure(enabled=True)
    ref_pipeline._COMPILE_CACHE.clear()
    yield
    g.enabled = prev[0]
    lt.configure(enabled=prev[1], max_entries=prev[2],
                 max_subscriptions=prev[3])
    ref_pipeline._COMPILE_CACHE.clear()


# ---------------------------------------------------------------------------
# inputs


def _tid(i: int) -> bytes:
    return (7_000_000 + i).to_bytes(16, "big")


def _entry(rng: random.Random, i: int, spans: bool = True) -> data.SearchData:
    sd = data.SearchData(trace_id=_tid(i))
    sd.start_s = BASE_S + i
    sd.end_s = sd.start_s + rng.randint(0, 10)
    sd.dur_ms = rng.randint(1, 5000)
    sd.root_service = rng.choice(SVCS)
    sd.root_name = rng.choice(OPS)
    sd.kvs = {"service.name": {sd.root_service},
              "env": {"prod" if i % 2 else "dev"},
              "http.status_code": {rng.choice(["200", "404", "500"])}}
    for s in range(rng.randint(0, 6) if spans else 0):
        sd.spans.append(data.SpanData(
            parent=-1 if s == 0 or rng.random() < 0.2 else rng.randrange(s),
            dur_ms=rng.randint(1, 1000), kind=rng.randint(0, 5),
            kvs={"service.name": {rng.choice(SVCS)},
                 "name": {rng.choice(OPS)}}))
    return sd


def pushes(seed: int = 0, n: int = N, spans: bool = True) -> list:
    """(trace id, encoded SearchData) push members in arrival order: every
    trace once, and one trace in five a second time later with more tags
    and spans (the merge path)."""
    rng = random.Random(seed)
    out = [(_tid(i), data.encode_search_data(_entry(rng, i, spans)))
           for i in range(n)]
    for i in range(0, n, 5):
        extra = _entry(rng, i, spans)
        extra.root_service = extra.root_name = ""
        extra.start_s -= rng.randint(0, 3)
        extra.kvs = {"late": {f"v{i % 7}"}, "service.name": {"late-svc"}}
        out.append((_tid(i), data.encode_search_data(extra)))
    return out


def _ref_req(tags: dict, kw: dict):
    r = tempopb.SearchRequest()
    for k, v in tags.items():
        r.tags[k] = v
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def _st_tag(src: str) -> dict:
    return {structural.STRUCTURAL_QUERY_TAG:
            ir.quote(ir.to_json(ir.parse(src)))}


def _traces(resp) -> list:
    return sorted((t.trace_id, t.start_time_unix_nano, t.duration_ms,
                   t.root_service_name, t.root_trace_name)
                  for t in resp.traces)


REQUESTS = {
    "tag": ({"service.name": "db"}, {"limit": 20}),
    "tag_and": ({"service.name": "a", "env": "prod"}, {"limit": 50}),
    "merged_tag": ({"late": "v3"}, {"limit": 20}),
    "duration": ({}, {"min_duration_ms": 1000, "max_duration_ms": 2000,
                      "limit": 30}),
    "window": ({}, {"start": BASE_S + 40, "end": BASE_S + 70,
                    "limit": 100}),
    "exhaustive": ({"x-dbg-exhaustive": "", "env": "dev"}, {"limit": 20}),
    "pruned": ({"nonexistent": "zz"}, {"limit": 20}),
    "pruned_value": ({"service.name": "zzz"}, {"limit": 20}),
    "structural_desc": (_st_tag(DESC), {"limit": 20}),
    "structural_exhaustive": (dict(_st_tag(DESC), **{"x-dbg-exhaustive":
                                                      ""}), {"limit": 500}),
    "limit_2000": ({}, {"limit": 2000}),
}


def _port_tier(members, **kw) -> LiveTier:
    kw.setdefault("enabled", True)
    lt = LiveTier(CPU, ST_ON, **kw)
    for tid, raw in members:
        lt.absorb(TENANT, tid, raw)
    return lt


def _ref_tier(members, **kw):
    lt = ref_live.LIVE_TIER
    lt.configure(enabled=True, **kw)
    for tid, raw in members:
        lt.absorb(TENANT, tid, raw)
    return lt


def _search_both(port_lt, ref_lt, tags: dict, kw: dict):
    req = SearchRequest(tags=dict(tags), **kw)
    got = SearchResults.for_request(req)
    g_ok = port_lt.search(TENANT, req, got)
    rreq = _ref_req(tags, kw)
    want = RefResults.for_request(rreq)
    w_ok = ref_lt.search(TENANT, rreq, want)
    return (g_ok, got.response()), (w_ok, want.response())


def _assert_same(got, want):
    (g_ok, g), (w_ok, w) = got, want
    assert g_ok == w_ok
    assert g.metrics.inspected_traces == w.metrics.inspected_traces
    assert _traces(g) == _traces(w)


# ---------------------------------------------------------------------------
# the data layer


def test_merge_and_clone_match_the_reference():
    members = pushes(1, 40)
    port, ref = {}, {}
    for tid, raw in members:
        for store, mod in ((port, data), (ref, ref_data)):
            sd = mod.decode_search_data(raw, tid)
            prev = store.get(tid)
            if prev is None:
                store[tid] = sd
            else:
                merged = mod.clone_search_data(prev)
                merged.merge(sd)
                store[tid] = merged
    for tid in port:
        assert data.encode_search_data(port[tid]) == \
            ref_data.encode_search_data(ref[tid])
        assert port[tid].start_ns == ref[tid].start_ns
    sd = port[_tid(0)]
    c = data.clone_search_data(sd)
    assert c.spans is not sd.spans and all(
        a is b for a, b in zip(c.spans, sd.spans))
    c.kvs["service.name"].add("x")
    assert "x" not in sd.kvs["service.name"]


def test_merge_shifts_parents_and_keeps_cross_batch_parents_unknown():
    a = data.SearchData(spans=[data.SpanData(parent=-1),
                               data.SpanData(parent=0)])
    b = data.SearchData(spans=[data.SpanData(parent=-1),
                               data.SpanData(parent=0),
                               data.SpanData(parent=1)])
    a.merge(b)
    assert [s.parent for s in a.spans] == [-1, 0, -1, 2, 3]


@pytest.mark.parametrize("name", list(REQUESTS))
def test_search_data_matches_matches_the_reference(name):
    tags, kw = REQUESTS[name]
    req, rreq = SearchRequest(tags=dict(tags), **kw), _ref_req(tags, kw)
    n_match = 0
    for tid, raw in pushes(2, 80):
        got = data.search_data_matches(data.decode_search_data(raw, tid),
                                       req, ST_ON)
        assert got == ref_data.search_data_matches(
            ref_data.decode_search_data(raw, tid), rreq)
        n_match += got
    if not name.startswith("pruned"):
        assert n_match


def test_search_data_matches_refuses_a_structural_tag_when_off():
    req = SearchRequest(tags=_st_tag(DESC))
    with pytest.raises(ValueError):
        data.search_data_matches(data.SearchData(), req, structural.OFF)


def test_object_framing_is_the_references_both_ways():
    objs = [(b"\x01" * 16, b"abc"), (b"\x02" * 8, b""), (b"", b"z" * 300)]
    buf = b"".join(objects.marshal_object(i, d) for i, d in objs)
    assert buf == b"".join(ref_objects.marshal_object(i, d)
                           for i, d in objs)
    for cut in (len(buf), len(buf) - 1, len(buf) - 310, 5):
        torn = buf[:cut]
        assert list(objects.unmarshal_objects(
            torn, tolerate_truncation=True)) == list(
            ref_objects.unmarshal_objects(torn, tolerate_truncation=True))
    with pytest.raises(ValueError):
        list(objects.unmarshal_objects(buf[:-1]))


# ---------------------------------------------------------------------------
# LiveTier against the reference's


@pytest.fixture(scope="module")
def members():
    return pushes(0)


@pytest.mark.parametrize("name", list(REQUESTS))
def test_live_search_matches_the_reference(members, name):
    tags, kw = REQUESTS[name]
    port_lt, ref_lt = _port_tier(members), _ref_tier(members)
    got, want = _search_both(port_lt, ref_lt, tags, kw)
    _assert_same(got, want)
    resp = got[1]
    if name.startswith("pruned"):
        assert resp.metrics.inspected_traces == 0 and not resp.traces
    else:
        assert resp.traces and resp.metrics.inspected_traces == N
    if name == "limit_2000":       # k = 2048 past the 1,024-entry stage
        assert len(resp.traces) == N
    rec = port_lt.stage_record(TENANT)
    assert rec.pages.n_pages == 1 and rec.tier == 1
    assert port_lt.stats()['live_tier_scans{result="scan"}'] == 1


def test_repeated_search_rebuilds_only_when_the_epoch_moves(members):
    lt = _port_tier(members)
    req = SearchRequest(tags={"service.name": "db"}, limit=20)
    for _ in range(3):
        lt.search(TENANT, req, SearchResults.for_request(req))
    assert lt.stats()["live_tier_rebuilds"] == 1
    # a structural request stages the span segment on the same build
    sreq = SearchRequest(tags=_st_tag(DESC), limit=20)
    lt.search(TENANT, sreq, SearchResults.for_request(sreq))
    rec = lt.stage_record(TENANT)
    assert lt.stats()["live_tier_rebuilds"] == 1 and rec.spans_staged
    lt.absorb(TENANT, *pushes(9, 1)[0])
    lt.search(TENANT, req, SearchResults.for_request(req))
    assert lt.stats()["live_tier_rebuilds"] == 2
    assert lt.stage_record(TENANT).epoch == rec.epoch + 1


def test_two_pages_and_a_pow2_tier():
    """1,100 traces: two pages, tier 2, against the reference."""
    members = pushes(3, 1100, spans=False)
    port_lt, ref_lt = _port_tier(members), _ref_tier(members)
    for tags, kw in (({"service.name": "db"}, {"limit": 20}),
                     ({"x-dbg-exhaustive": ""}, {"limit": 20}),
                     ({}, {"limit": 2000})):
        _assert_same(*_search_both(port_lt, ref_lt, tags, kw))
    rec = port_lt.stage_record(TENANT)
    assert (rec.pages.n_pages, rec.tier) == (2, 2)


def test_overflow_declines_as_the_reference_does(members):
    port_lt = _port_tier(members[:N], max_entries=N - 1)
    ref_lt = _ref_tier(members[:N], max_entries=N - 1)
    got, want = _search_both(port_lt, ref_lt, {"service.name": "db"},
                             {"limit": 20})
    assert got[0] is False and want[0] is False
    assert got[1].metrics.inspected_traces == 0 and not got[1].traces
    assert port_lt.stats()['live_tier_scans{result="fallback_overflow"}'] \
        == 1
    # at the cap itself the tier still answers
    port_lt.mark_cut(TENANT, [_tid(0)])
    ref_lt.mark_cut(TENANT, [_tid(0)])
    _assert_same(*_search_both(port_lt, ref_lt, {"service.name": "db"},
                               {"limit": 20}))


def test_cut_and_drop_tenant_match_the_reference(members):
    port_lt, ref_lt = _port_tier(members), _ref_tier(members)
    cut = [_tid(i) for i in range(0, N, 2)]
    port_lt.mark_cut(TENANT, cut)
    ref_lt.mark_cut(TENANT, cut)
    for name in ("tag", "exhaustive", "structural_desc", "limit_2000"):
        tags, kw = REQUESTS[name]
        got, want = _search_both(port_lt, ref_lt, tags, kw)
        _assert_same(got, want)
        assert got[1].metrics.inspected_traces == N // 2
    stats = port_lt.stats()
    assert stats['live_tier_evictions{reason="cut"}'] == N // 2
    assert stats[f'live_tier_entries{{tenant="{TENANT}"}}'] == N // 2
    port_lt.drop_tenant(TENANT)
    ref_lt.drop_tenant(TENANT)
    got, want = _search_both(port_lt, ref_lt, {}, {"limit": 20})
    _assert_same(got, want)
    assert got[0] is True and not got[1].traces


def test_gate_off_is_a_noop(members):
    lt = _port_tier(members, enabled=False)
    req = SearchRequest(limit=20)
    res = SearchResults.for_request(req)
    assert lt.search(TENANT, req, res) is False
    assert res.response().metrics.inspected_traces == 0
    assert lt.subscribe(TENANT, req) is None
    assert lt.stats() == {} and lt.stage_record(TENANT) is None


def test_structural_request_with_the_gate_off_is_refused(members):
    lt = LiveTier(CPU, structural.OFF, enabled=True)
    for tid, raw in members[:20]:
        lt.absorb(TENANT, tid, raw)
    req = SearchRequest(tags=_st_tag(DESC), limit=20)
    with pytest.raises(ValueError):
        lt.search(TENANT, req, SearchResults.for_request(req))
    with pytest.raises(ValueError):
        lt.subscribe(TENANT, req)
    assert lt.stage_record(TENANT) is None       # before any work


def test_live_tier_runs_on_cuda_unless_given_the_cpu(tmp_path):
    """The hot scan runs on the database's device, CUDA by default (the
    reference pins it to JAX's CPU backend); without a card the tier
    raises instead of running on the CPU."""
    from tempo_tpu_torch.device import DeviceUnavailable

    if torch.cuda.is_available():
        assert LiveTier().device.type == "cuda"
        return
    with pytest.raises(DeviceUnavailable):
        LiveTier()
    with pytest.raises(DeviceUnavailable):
        TempoDB(LocalBackend(str(tmp_path)),
                TempoDBConfig(search_live_tier_enabled=True))
    assert LiveTier("cpu").engine.device == CPU


def test_corrupt_push_is_dropped():
    lt = LiveTier(CPU, ST_ON, enabled=True)
    lt.absorb(TENANT, _tid(1), b"\x01\x02")
    lt.absorb(TENANT, _tid(2), b"")
    req = SearchRequest(limit=20)
    res = SearchResults.for_request(req)
    assert lt.search(TENANT, req, res)
    assert res.response().metrics.inspected_traces == 0


# ---------------------------------------------------------------------------
# B9 directly


def _stale_stage(structural_req: bool):
    """Both packages' 8-page stages (16 entries a page) of the same
    entries, every page full and valid, and each request compiled on the
    host."""
    rng = random.Random(5)
    sds = [_entry(rng, i) for i in range(128)]
    raws = [data.encode_search_data(sd) for sd in sds]
    port_sds = [data.decode_search_data(r, sd.trace_id)
                for r, sd in zip(raws, sds)]
    ref_sds = [ref_data.decode_search_data(r, sd.trace_id)
               for r, sd in zip(raws, sds)]
    pages = ColumnarPages.build(port_sds, PageGeometry(16, 8))
    rpages = RefPages.build(ref_sds, RefGeometry(16, 8))
    assert pages.n_pages == 8 and pages.entry_valid.all()
    tags = _st_tag(DESC) if structural_req else {"env": "prod"}
    return pages, rpages, tags


@pytest.mark.parametrize("structural_req", [False, True])
@pytest.mark.parametrize("n_pages", [3, 8])
def test_hot_scan_plain_matches_hot_scan_kernel(structural_req, n_pages):
    pages, rpages, tags = _stale_stage(structural_req)
    kw = {"limit": 200}
    engine = ScanEngine(CPU)
    sp = stage(pages, CPU, probe_min_vals=0, spans=structural_req)
    cq = compile_query(pages.key_dict, pages.val_dict,
                       SearchRequest(tags=dict(tags), **kw))
    rreq = _ref_req(tags, kw)
    rcq = ref_pipeline.compile_query(rpages.key_dict, rpages.val_dict, rreq,
                                     cache_on=rpages, host_only=True)
    span_dev = s_tables = plan = None
    if structural_req:
        expr = structural.structural_query(SearchRequest(tags=dict(tags)),
                                           ST_ON)
        cq.structural = structural.compile_structural(expr, [pages])
        rst = ref_structural.compile_structural(
            ref_structural.structural_query(rreq), [rpages],
            cache_on=rpages, host_only=True)
        plan = rst.plan
        s_tables = tuple(None if t is None else jnp.asarray(t)
                         for t in rst.tables())
        span_dev = {k: jnp.asarray(v) for k, v in
                    ref_structural.STRUCTURAL.stage_single(rpages, 8).items()}
    host = ref_engine.pad_page_axis(rpages, 8)
    out = ref_live.hot_scan_kernel(
        *(jnp.asarray(host[k]) for k in ref_engine.DEVICE_ARRAYS),
        jnp.int32(n_pages), jnp.asarray(rcq.term_keys),
        jnp.asarray(rcq.val_ranges), jnp.uint32(rcq.dur_lo),
        jnp.uint32(min(rcq.dur_hi, 0xFFFFFFFF)), jnp.uint32(rcq.win_start),
        jnp.uint32(min(rcq.win_end, 0xFFFFFFFF)), span_dev, s_tables,
        n_terms=rcq.n_terms, top_k=ref_engine.resolve_top_k(128, 200),
        plan=plan, tier=8)
    w_count, w_insp, w_scores, w_idx = ref_engine.fetch_scan_out(out)
    counts, scores, idx = k_live.hot_scan_plain(engine, sp, n_pages, cq)
    assert counts.tolist() == [w_count, w_insp]
    assert w_insp == n_pages * 16 and 0 < w_count < w_insp
    m = int((scores >= 0).sum())
    assert m == w_count and (idx[:m] < n_pages * 16).all()
    assert scores.tolist() == w_scores.tolist()
    assert idx[:m].tolist() == w_idx[:m].tolist()   # starts are distinct
    # the kernel route's live-prefix views (its plain kernels here)
    p_counts, p_scores, p_idx = engine.scan_staged_async(
        k_live.live_prefix(sp, n_pages), cq)
    assert p_counts.tolist() == counts.tolist()
    assert p_scores.tolist() == scores[:p_scores.numel()].tolist()
    assert p_idx.tolist() == idx[:p_idx.numel()].tolist()
    assert p_scores.numel() == min(256, n_pages * 16)


def test_stale_pages_would_match():
    """The stale capacity pages of the B9 test hold matching entries:
    the full stage counts more than its first 3 pages."""
    pages, _, tags = _stale_stage(False)
    engine = ScanEngine(CPU)
    sp = stage(pages, CPU, probe_min_vals=0)
    cq = compile_query(pages.key_dict, pages.val_dict,
                       SearchRequest(tags=dict(tags), limit=20))
    few = k_live.hot_scan_plain(engine, sp, 3, cq)[0].tolist()
    all_ = k_live.hot_scan_plain(engine, sp, 8, cq)[0].tolist()
    assert all_[0] > few[0] and all_[1] == 128


def test_hot_scan_on_the_cpu_counts_no_launch():
    pages, _, tags = _stale_stage(False)
    engine = ScanEngine(CPU)
    sp = stage(pages, CPU, probe_min_vals=0)
    cq = compile_query(pages.key_dict, pages.val_dict,
                       SearchRequest(tags=dict(tags), limit=20))
    k_scan.HOT_LAUNCHES.reset()
    k_live.hot_scan(engine, sp, 3, cq)
    assert k_scan.HOT_LAUNCHES.n == 0


# ---------------------------------------------------------------------------
# StreamingSearchBlock


def _write_ref_block(path, members):
    blk = ref_streaming.StreamingSearchBlock(str(path))
    for tid, raw in members:
        blk.append(tid, ref_data.decode_search_data(raw, tid))
    return blk


def _write_port_block(path, members, live=None):
    blk = streaming.StreamingSearchBlock(str(path), live=live)
    for tid, raw in members:
        blk.append(tid, data.decode_search_data(raw, tid))
    return blk


def _block_search(blk, tags, kw, ref: bool):
    if ref:
        req = _ref_req(tags, kw)
        res = RefResults.for_request(req)
    else:
        req = SearchRequest(tags=dict(tags), **kw)
        res = SearchResults.for_request(req)
    blk.search(req, res)
    return res.response()


@pytest.mark.parametrize("name", ["tag", "merged_tag", "duration", "window",
                                  "exhaustive", "pruned", "structural_desc",
                                  "limit_2000"])
def test_streaming_block_search_matches_the_reference(tmp_path, members,
                                                      name):
    tags, kw = REQUESTS[name]
    live = LiveTier(CPU, ST_ON, enabled=True)
    port = _write_port_block(tmp_path / "p.search", members, live)
    ref = _write_ref_block(tmp_path / "r.search", members)
    got = _block_search(port, tags, kw, False)
    want = _block_search(ref, tags, kw, True)
    assert got.metrics.inspected_traces == want.metrics.inspected_traces
    assert _traces(got) == _traces(want)
    assert [e.trace_id for e in port.entries()] == sorted(port._entries)
    port.close()
    ref.close()
    assert (tmp_path / "p.search").read_bytes() == \
        (tmp_path / "r.search").read_bytes()


def _damage(path, corrupt_at: int):
    """A frame whose payload does not decode after entry `corrupt_at`,
    and a torn frame at the end."""
    buf = path.read_bytes()
    frames = list(objects.unmarshal_objects(buf))
    out = b"".join(objects.marshal_object(i, d)
                   for i, d in frames[:corrupt_at])
    out += objects.marshal_object(_tid(99_999), b"\x01\x02")
    out += b"".join(objects.marshal_object(i, d)
                    for i, d in frames[corrupt_at:])
    whole = len(out)
    out += objects.marshal_object(_tid(99_998), b"x" * 40)[:-7]
    path.write_bytes(out)
    return whole


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_sidecar_replays_both_ways(tmp_path, members, writer):
    path = tmp_path / "wal.search"
    blk = (_write_ref_block if writer == "reference" else _write_port_block)(
        path, members)
    blk.close()
    whole = _damage(path, 17)
    copy = tmp_path / "copy.search"
    copy.write_bytes(path.read_bytes())
    live = LiveTier(CPU, ST_ON, enabled=True)
    port = streaming.StreamingSearchBlock.rescan(str(path), live=live)
    ref = ref_streaming.StreamingSearchBlock.rescan(str(copy))
    assert path.stat().st_size == copy.stat().st_size == whole
    assert len(port) == len(ref) == N
    assert [data.encode_search_data(e) for e in port.entries()] == \
        [ref_data.encode_search_data(e) for e in ref.entries()]
    for name in ("tag", "exhaustive", "structural_desc"):
        tags, kw = REQUESTS[name]
        got = _block_search(port, tags, kw, False)
        want = _block_search(ref, tags, kw, True)
        assert _traces(got) == _traces(want)
        assert got.metrics.inspected_traces == want.metrics.inspected_traces
    # appends after a replay go on in the same file
    port.append(_tid(5_000), data.decode_search_data(members[0][1]))
    port.close()
    ref.close()
    again = ref_streaming.StreamingSearchBlock.rescan(str(path))
    assert len(again) == N + 1
    again.close()


def test_expired_deadline_books_partial_before_any_work(tmp_path, members):
    live = LiveTier(CPU, ST_ON, enabled=True)
    port = _write_port_block(tmp_path / "p.search", members[:50], live)
    ref = _write_ref_block(tmp_path / "r.search", members[:50])
    with deadline.start(1e-6), ref_deadline.start(1e-6):
        time.sleep(0.01)
        assert deadline.expired() and deadline.remaining() < 0
        got = _block_search(port, {}, {"limit": 20}, False)
        want = _block_search(ref, {}, {"limit": 20}, True)
    assert got.metrics.partial and want.metrics.partial
    assert got.metrics.inspected_traces == 0 and not got.traces
    assert port._stage is None            # nothing built
    assert deadline.current() is None
    with deadline.start(0) as dl:
        assert dl is None and not deadline.expired()
    port.close()
    ref.close()


@pytest.mark.parametrize("name", ["tag", "tag_and", "merged_tag",
                                  "duration", "window", "exhaustive",
                                  "structural_exhaustive",
                                  "limit_2000"])
def test_walk_equals_the_scan(tmp_path, members, name):
    """With the gate off the block walks; where the limit covers every
    match the walk's answer is the scan's (a pruned request differs only
    in inspected_traces: the walk visits every entry, as the
    reference's)."""
    tags, kw = REQUESTS[name]
    kw = dict(kw, limit=2000)
    on = _write_port_block(tmp_path / "on.search", members,
                           LiveTier(CPU, ST_ON, enabled=True))
    off = _write_port_block(tmp_path / "off.search", members,
                            LiveTier(CPU, ST_ON, enabled=False))
    got = _block_search(off, tags, kw, False)
    want = _block_search(on, tags, kw, False)
    assert got == want and got.metrics.inspected_traces == N
    assert on._stage is not None and off._stage is None
    on.close()
    off.close()


def test_walk_quits_at_the_limit_and_reads_the_deadline(tmp_path,
                                                       members):
    blk = _write_port_block(tmp_path / "w.search", members)
    got = _block_search(blk, {}, {"limit": 5}, False)
    assert len(got.traces) == 5 and got.metrics.inspected_traces == 5
    calls = []
    real = deadline.expired

    def spy():
        calls.append(1)
        return real()

    try:
        streaming.deadline.expired = spy
        _block_search(blk, {}, {"limit": 1000}, False)
    finally:
        streaming.deadline.expired = real
    assert len(calls) == 1 + (N - 1) // 256      # once, then every 256
    blk.clear()
    assert not (tmp_path / "w.search").exists()


# ---------------------------------------------------------------------------
# tail subscriptions


def test_tail_delivery_matches_the_reference(members):
    port_lt, ref_lt = _port_tier([]), _ref_tier([])
    tags, kw = {"service.name": "db"}, {"limit": 20}
    sub = port_lt.subscribe(TENANT, SearchRequest(tags=dict(tags), **kw))
    rsub = ref_lt.subscribe(TENANT, _ref_req(tags, kw))
    st = port_lt.subscribe(TENANT, SearchRequest(tags=_st_tag(DESC)))
    rst = ref_lt.subscribe(TENANT, _ref_req(_st_tag(DESC), {}))
    assert port_lt.has_subscribers(TENANT)
    for tid, raw in members[:120]:
        port_lt.notify_push(TENANT, tid, raw)
        ref_lt.notify_push(TENANT, tid, raw)
    for s, r in ((sub, rsub), (st, rst)):
        got = [(m.trace_id, m.start_time_unix_nano, m.duration_ms,
                m.root_service_name, m.root_trace_name) for m in s.poll(0)]
        want = [(m.trace_id, m.start_time_unix_nano, m.duration_ms,
                 m.root_service_name, m.root_trace_name) for m in r.poll(0)]
        assert got == want and got
    assert port_lt.stats()[f'live_tail_notifications{{tenant="{TENANT}"}}'] \
        > 0
    port_lt.unsubscribe(sub)
    assert sub.closed and sub.poll(0) == []
    assert port_lt.stats()[f'live_tail_subscriptions{{tenant="{TENANT}"}}'] \
        == 1


def test_tail_cap_and_drop_oldest():
    lt = LiveTier(CPU, ST_ON, enabled=True)
    req = SearchRequest(limit=20)
    subs = [lt.subscribe(TENANT, req, max_queue=2) for _ in range(16)]
    assert all(s is not None for s in subs)
    assert lt.subscribe(TENANT, req) is None             # the 17th
    assert lt.stats()[f'live_tail_dropped{{reason="cap",tenant="{TENANT}"}}'] \
        == 1
    members = pushes(4, 3, spans=False)[:3]
    for tid, raw in members:
        lt.notify_push(TENANT, tid, raw)
    got = subs[0].poll(0)
    assert [m.trace_id for m in got] == [t.hex() for t, _ in members[1:]]
    assert subs[0].dropped == 1
    assert lt.stats()[
        f'live_tail_dropped{{reason="queue",tenant="{TENANT}"}}'] == 16
    subs[1].close()
    assert lt.subscribe(TENANT, req) is not None   # a closed slot frees


def test_tail_poll_waits_for_a_push():
    lt = LiveTier(CPU, ST_ON, enabled=True)
    sub = lt.subscribe(TENANT, SearchRequest())
    tid, raw = pushes(6, 1)[0]
    t = threading.Timer(0.05, lambda: lt.notify_push(TENANT, tid, raw))
    t.start()
    got = sub.poll(5.0)
    t.join(5)
    assert not t.is_alive() and [m.trace_id for m in got] == [tid.hex()]


# ---------------------------------------------------------------------------
# the database's gates, concurrency, faults


def test_two_databases_keep_their_gates(tmp_path, members):
    be = LocalBackend(str(tmp_path / "blocks"))
    on = TempoDB(be, TempoDBConfig(search_live_tier_enabled=True,
                                   search_live_tier_max_entries=100,
                                   search_live_tail_max_subscriptions=3,
                                   search_structural_enabled=True),
                 device="cpu")
    off = TempoDB(be, TempoDBConfig(), device="cpu")
    try:
        assert on.live_tier.enabled and not off.live_tier.enabled
        assert on.live_tier.max_entries == 100
        assert on.live_tier.max_subscriptions == 3
        assert on.live_tier.structural_cfg.enabled
        assert not off.live_tier.structural_cfg.enabled
        assert (off.cfg.search_live_tier_max_entries,
                off.cfg.search_live_tail_max_subscriptions) == (4096, 16)
        for tid, raw in members[:50]:
            on.live_tier.absorb(TENANT, tid, raw)
            off.live_tier.absorb(TENANT, tid, raw)
        req = SearchRequest(tags=_st_tag(DESC), limit=20)
        assert on.live_tier.search(TENANT, req,
                                   SearchResults.for_request(req))
        assert not off.live_tier.search(TENANT, req,
                                        SearchResults.for_request(req))
        # poll tells the enabled tier which blocks became visible
        meta = BlockMeta(tenant_id=TENANT,
                         block_id="00000000-0000-4000-8000-000000000001")
        write_search_block(be, meta, [data.decode_search_data(raw, tid)
                                      for tid, raw in members[:10]])
        on.poll()
        off.poll()
        assert on.live_tier.poll_visible(TENANT, meta.block_id)
        assert not on.live_tier.poll_visible(TENANT, "other")
        assert not off.live_tier.poll_visible(TENANT, meta.block_id)
    finally:
        on.close()
        off.close()


def test_concurrent_absorb_cut_and_search_stay_in_the_entry_set():
    """Absorbing, cutting and searching threads on one tenant: every
    result is a pushed trace with its own metadata (a search never renders
    one epoch's pages from another's indices)."""
    members = pushes(7, 600, spans=False)[:600]   # each trace once
    meta = {tid.hex(): streaming._meta_from_sd(data.decode_search_data(
        raw, tid)) for tid, raw in members}
    lt = LiveTier(CPU, ST_ON, enabled=True)
    stop = threading.Event()
    errors: list = []

    def absorb(part):
        for tid, raw in part:
            lt.absorb(TENANT, tid, raw)

    def cut():
        while not stop.is_set():
            lt.mark_cut(TENANT, [tid for tid, _ in members[:40]])
            time.sleep(0.001)

    def search():
        req = SearchRequest(tags={"env": "prod"}, limit=50)
        while not stop.is_set():
            res = SearchResults.for_request(req)
            try:
                lt.search(TENANT, req, res)
                resp = res.response()
                assert resp.metrics.inspected_traces <= len(members)
                for m in resp.traces:
                    assert m == meta[m.trace_id], m
            except AssertionError as e:   # reported after the join
                errors.append(e)
                return

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = ([threading.Thread(target=absorb, args=(members[i::4],))
                    for i in range(4)]
                   + [threading.Thread(target=cut)]
                   + [threading.Thread(target=search) for _ in range(4)])
        for t in threads:
            t.start()
        for t in threads[:4]:
            t.join(30)
        stop.set()
        for t in threads[4:]:
            t.join(30)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert lt.stats()['live_tier_scans{result="scan"}'] > 0


def test_a_faulting_hot_scan_raises_and_never_walks(tmp_path, members,
                                                    monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    walked = []
    real = streaming.search_data_matches
    monkeypatch.setattr(live_tier, "hot_scan", boom)
    monkeypatch.setattr(streaming, "search_data_matches",
                        lambda *a: walked.append(1) or real(*a))
    lt = _port_tier(members)
    req = SearchRequest(tags={"service.name": "db"}, limit=20)
    with pytest.raises(RuntimeError, match="illegal memory"):
        lt.search(TENANT, req, SearchResults.for_request(req))
    blk = _write_port_block(tmp_path / "f.search", members[:30], lt)
    with pytest.raises(RuntimeError, match="illegal memory"):
        blk.search(req, SearchResults.for_request(req))
    assert not walked
    assert 'live_tier_scans{result="scan"}' not in lt.stats()
    blk.close()
