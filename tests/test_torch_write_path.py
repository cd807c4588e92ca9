"""The port's write path and fallback scan against the reference's.

Inputs are seeded OTLP pushes (``tests/torch_otlp.py``): traces split
over pushes and services, 8-byte ids, spans ending before they start,
traces with no parentless span or no ended span, tags past the byte
budget, int, bool and double attributes, error spans.

- ``regroup_extract`` equals the reference's
  ``Distributor._regroup_extract`` (the pure-Python walk): the same
  serialized traces, the same SearchData and the same encoded bytes, with
  the structural gate off and on (span rows); ``push_items`` equals the
  items the reference's push builds.
- ``extract_search_data``, ``collect_span_rows``, ``matches``,
  ``trace_search_metadata`` and ``sort_trace`` equal the reference's.
- ``complete_block`` and ``write_block_direct`` write byte-identical data,
  index, bloom, search container and meta.json for ``none`` and ``zlib``.
- Search over a tenant whose blocks have and lack search containers
  equals the reference's (``search``, ``search_block``,
  ``search_blocks``): results, order and metrics, through the fallback
  scan, with structural requests too.
- End to end on the CPU: pushes, WAL, a crash and its replay,
  ``complete_block``, ``poll``, ``search`` and ``find_trace_by_id``, each
  step in both packages.
"""

from __future__ import annotations

import dataclasses
import os

import pytest

from tempo_tpu import tempopb as ref_tempopb
from tempo_tpu.backend.local import LocalBackend as RefLocalBackend
from tempo_tpu.db import TempoDB as RefTempoDB
from tempo_tpu.db import TempoDBConfig as RefTempoDBConfig
from tempo_tpu.model.matches import matches as ref_match
from tempo_tpu.model.matches import trace_range_ns as ref_trace_range_ns
from tempo_tpu.model.matches import \
    trace_search_metadata as ref_trace_search_metadata
from tempo_tpu.model.codec import segment_codec_for as ref_segment_codec_for
from tempo_tpu.model.sort import sort_trace as ref_sort_trace
from tempo_tpu.modules.distributor import Distributor as RefDistributor
from tempo_tpu.search import data as ref_data
from tempo_tpu.search import structural as ref_structural
from tempo_tpu.search.columnar import PageGeometry as RefPageGeometry
from tempo_tpu.search.streaming import \
    StreamingSearchBlock as RefStreamingSearchBlock
from tempo_tpu.wal import WAL as RefWAL

from tempo_tpu_torch import tempopb
from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.encoding import compression
from tempo_tpu_torch.model import (matches, sort_trace,
                                   trace_search_metadata)
from tempo_tpu_torch.model.types import (BlockSearchJob, SearchBlockRequest,
                                         SearchBlocksRequest, SearchMetrics,
                                         SearchRequest)
from tempo_tpu_torch.modules.distributor import (push_items, regroup_by_trace,
                                                 regroup_extract)
from tempo_tpu_torch.ops import native
from tempo_tpu_torch.search import data
from tempo_tpu_torch.search import ir
from tempo_tpu_torch.search.columnar import PageGeometry
from tempo_tpu_torch.search.streaming import StreamingSearchBlock
from tempo_tpu_torch.search.structural import StructuralConfig
from tempo_tpu_torch.wal import WAL

from tests.torch_otlp import BASE_S, make_pushes

TENANT = "t1"
SEED = 20261018
ST_ON = StructuralConfig(enabled=True)


@pytest.fixture(autouse=True)
def _reference_structural_gate():
    """The reference's structural gate is process-wide: each test leaves
    it as it found it."""
    g = ref_structural.STRUCTURAL
    prev = (g.enabled, g.max_spans, g.max_span_kvs, g.stack_enabled,
            g.bucket_enabled)
    yield
    (g.enabled, g.max_spans, g.max_span_kvs, g.stack_enabled,
     g.bucket_enabled) = prev


@pytest.fixture(scope="module")
def pushes():
    return make_pushes(SEED, 240, n_pushes=4)[0]


@pytest.fixture(scope="module")
def traces(pushes):
    """Every trace whole: the regroup of all pushes at once."""
    return regroup_by_trace([b for p in pushes for b in p])[0]


def _sd(sd) -> tuple:
    return (bytes(sd.trace_id), sd.start_s, sd.end_s, sd.dur_ms,
            sd.root_service, sd.root_name,
            {k: set(v) for k, v in sd.kvs.items()},
            [(sp.parent, sp.dur_ms, sp.kind,
              {k: set(v) for k, v in sp.kvs.items()}) for sp in sd.spans])


def _ref_items(batches, max_bytes: int, spans: bool) -> list:
    """The items the reference's push builds (its Python walk,
    ``Distributor._push_batches``)."""
    by_trace, _n, sds = RefDistributor._regroup_extract(batches, max_bytes)
    codec = ref_segment_codec_for("v2")
    out = []
    for tid, trace in by_trace.items():
        sd = sds[tid]
        if spans:
            sd.spans = ref_data.collect_span_rows(trace)
        out.append((tid, sd.start_s, sd.end_s,
                    codec.prepare_for_write(trace, sd.start_s, sd.end_s),
                    ref_data.encode_search_data(sd)))
    return out


def test_pushes_hold_every_edge_case(pushes, traces):
    """The seeded input holds what the other tests are meant to cover."""
    sds = [data.extract_search_data(t, tr) for t, tr in traces.items()]
    full = [data.extract_search_data(t, tr, max_bytes=1 << 30)
            for t, tr in traces.items()]
    assert any(len(t) == 16 and t[:8] == b"\0" * 8 for t in traces)
    assert any(sd.dur_ms == 0 and sd.end_s and sd.end_s < sd.start_s
               for sd in sds)                               # clamped
    assert any(sd.end_s == 0 for sd in sds)                 # no span ended
    assert any(len(a.kvs) < len(b.kvs) for a, b in zip(sds, full))
    assert any("error" in sd.kvs for sd in sds)
    assert sum(len(p) for p in pushes) > len(pushes) * len(
        {"svc-a", "svc-b", "svc-c", "frontend"})             # repeated
    rootless = [tr for tr in traces.values()
                if all(sp.parent_span_id for b in tr.batches
                       for ss in b.scope_spans for sp in ss.spans)]
    assert rootless
    split = sum(1 for tid in traces if sum(
        tid in regroup_by_trace(p)[0] for p in pushes) > 1)
    assert split >= 20


@pytest.mark.parametrize("max_bytes", [data.DEFAULT_MAX_SEARCH_BYTES, 300])
@pytest.mark.parametrize("gate", ["off", "on"])
def test_regroup_extract_equals_the_reference(pushes, max_bytes, gate):
    cfg = StructuralConfig(enabled=gate == "on")
    for batches in pushes:
        want_tr, want_n, want_sd = RefDistributor._regroup_extract(
            batches, max_bytes)
        got_tr, got_n, got_sd = regroup_extract(batches, max_bytes)
        assert got_n == want_n
        assert list(got_tr) == list(want_tr) == list(got_sd)
        for tid in want_tr:
            assert got_tr[tid].SerializeToString() == \
                want_tr[tid].SerializeToString()
            assert _sd(got_sd[tid]) == _sd(want_sd[tid])
            assert data.encode_search_data(got_sd[tid]) == \
                ref_data.encode_search_data(want_sd[tid])
        items, n = push_items(batches, max_bytes, cfg)
        assert n == want_n
        assert items == _ref_items(batches, max_bytes, gate == "on")
        assert any(len(sd) > 12 for *_, sd in items)


def test_regroup_by_trace_equals_the_reference(pushes):
    for batches in pushes:
        want, want_n = RefDistributor.regroup_by_trace(batches)
        got, got_n = regroup_by_trace(batches)
        assert got_n == want_n and list(got) == list(want)
        for tid in want:
            assert got[tid].SerializeToString() == \
                want[tid].SerializeToString()


def test_invalid_trace_ids_raise_as_the_reference():
    for tid in (b"", b"\x01" * 17):
        rs = tempopb.ResourceSpans()
        rs.scope_spans.add().spans.add().trace_id = tid
        for fn in (lambda b: regroup_extract(b, 100),
                   lambda b: RefDistributor._regroup_extract(b, 100),
                   regroup_by_trace, RefDistributor.regroup_by_trace):
            with pytest.raises(ValueError):
                fn([rs])


@pytest.mark.parametrize("spans", [False, True])
@pytest.mark.parametrize("max_bytes", [data.DEFAULT_MAX_SEARCH_BYTES, 200])
def test_extract_search_data_equals_the_reference(traces, max_bytes, spans):
    for tid, tr in traces.items():
        want = ref_data.extract_search_data(tid, tr, max_bytes, spans=spans)
        got = data.extract_search_data(tid, tr, max_bytes, spans=spans)
        assert _sd(got) == _sd(want)
        assert data.encode_search_data(got) == \
            ref_data.encode_search_data(want)
        rng = ref_trace_range_ns(tr)
        assert _sd(data.extract_search_data(tid, tr, max_bytes,
                                            range_ns=rng, spans=spans)) \
            == _sd(want)


@pytest.mark.parametrize("max_spans,max_kvs", [(512, 16), (3, 2), (1, 1),
                                               (4, 0)])
def test_collect_span_rows_equals_the_reference(traces, max_spans, max_kvs):
    for tr in traces.values():
        got = data.collect_span_rows(tr, max_spans, max_kvs)
        want = ref_data.collect_span_rows(tr, max_spans, max_kvs)
        assert [_sd(dataclasses.replace(data.SearchData(), spans=got))] == \
            [_sd(dataclasses.replace(data.SearchData(), spans=[
                data.SpanData(sp.parent, sp.dur_ms, sp.kind, sp.kvs)
                for sp in want]))]


def _st_tag(expr) -> dict:
    return {"x-structural-q": ir.quote(ir.to_json(expr))}


def _requests() -> dict:
    """(tags, keyword fields) by name: tag kinds, durations, windows,
    in-band tags and structural trees."""
    def req(tags=None, **kw):
        return dict(tags or {}), kw

    child = ir.ChildOf(ir.SpanTag("service.name", "svc-a"),
                       ir.SpanTag("http.method", "GET"))
    return {
        "service": req({"service.name": "svc-b"}),
        "service_substring": req({"service.name": "svc"}),
        "int_attr": req({"http.status_code": "500"}),
        "int_attr_substring": req({"http.status_code": "50"}),
        "bool_attr": req({"cache.hit": "true"}),
        "double_attr": req({"ratio": "0.125"}),
        "name": req({"name": "op-3"}),
        "error": req({"error": "true"}),
        "budget_attr": req({"attr.3": "x"}),
        "resource_int": req({"pid": "101"}),
        "empty_value": req({"http.method": ""}),
        "absent": req({"no.such": "x"}),
        "two_tags": req({"service.name": "svc-a", "http.method": "POST"}),
        "min_dur": req(min_duration_ms=20_000),
        "max_dur": req(max_duration_ms=3_000),
        "dur_range": req(min_duration_ms=1, max_duration_ms=25_000),
        "window": req(start=BASE_S + 1200, end=BASE_S + 2400),
        "window_start": req(start=BASE_S + 3000),
        "window_end": req(end=BASE_S + 600),
        "exhaustive_tag": req({"x-dbg-exhaustive": "", "error": "true"}),
        "agg_tag": req({"x-agg-q": "red", "cache.hit": "false"}),
        "limit_5": req({"http.method": "GET"}, limit=5),
        "st_child": req(_st_tag(ir.Exists(child))),
        "st_count": req(_st_tag(ir.Count(ir.SpanTag("error", ""), ">=", 1))),
        "st_dur": req(_st_tag(ir.TraceAnd((
            ir.TraceDur(0, 20_000),
            ir.Exists(ir.SpanDur(5_000, 40_000)))))),
        "st_quantile": req(_st_tag(ir.Quantile(
            ir.SpanTag("name", "op"), 1, 2, ">=", 10_000))),
        "st_with_tags": req(dict(_st_tag(ir.Exists(ir.SpanKind(2))),
                                 **{"service.name": "svc"}),
                            min_duration_ms=1),
    }


def _ref_req(tags, kw):
    r = ref_tempopb.SearchRequest()
    for k, v in tags.items():
        r.tags[k] = v
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def _meta(m) -> tuple:
    return (m.trace_id, m.root_service_name, m.root_trace_name,
            m.start_time_unix_nano, m.duration_ms)


@pytest.mark.parametrize("name", list(_requests()))
def test_matches_and_metadata_equal_the_reference(traces, name):
    ref_structural.STRUCTURAL.enabled = True
    tags, kw = _requests()[name]
    req, rreq = SearchRequest(tags=dict(tags), **kw), _ref_req(tags, kw)
    hits = 0
    for tid, tr in traces.items():
        got = matches(tr, req, ST_ON)
        assert got == ref_match(tr, rreq), tid.hex()
        hits += got
        assert _meta(trace_search_metadata(tid, tr)) == \
            _meta(ref_trace_search_metadata(tid, tr))
    # an int attribute matches its whole decimal string only, in the
    # proto matcher of both packages
    assert (hits == 0) == (name in ("absent", "int_attr_substring")), name


def test_matches_structural_caps_follow_the_database_config(traces):
    """The structural branch reads its span caps from the config it is
    given, as the reference reads them from its gate."""
    g = ref_structural.STRUCTURAL
    g.enabled, g.max_spans, g.max_span_kvs = True, 2, 2
    tags, kw = _requests()["st_child"]
    cfg = StructuralConfig(enabled=True, max_spans=2, max_span_kvs=2)
    req, rreq = SearchRequest(tags=dict(tags), **kw), _ref_req(tags, kw)
    got = [matches(tr, req, cfg) for tr in traces.values()]
    assert got == [ref_match(tr, rreq) for tr in traces.values()]
    assert got != [matches(tr, req, ST_ON) for tr in traces.values()]
    with pytest.raises(ValueError, match="structural"):
        matches(next(iter(traces.values())), req, StructuralConfig())


def test_sort_trace_equals_the_reference(traces):
    for tr in traces.values():
        a, b = tempopb.Trace(), tempopb.Trace()
        a.CopyFrom(tr)
        b.CopyFrom(tr)
        assert sort_trace(a) is a
        assert a.SerializeToString() == ref_sort_trace(b).SerializeToString()


# ---------------------------------------------------------------------------
# blocks: complete_block and write_block_direct, byte for byte

def _bid(b: int) -> str:
    return f"00000000-0000-4000-8000-{b:012d}"


def _cfgs(enc: str, gate: bool = False):
    """The same write and search settings for either package: small pages
    and flushes (several data pages, streamed appends) and a small search
    page geometry (several container pages)."""
    kw = dict(block_encoding=enc, search_encoding=enc, wal_encoding=enc,
              block_page_size=2048, complete_flush_bytes=4096,
              search_structural_enabled=gate, pool_workers=1)
    ref = RefTempoDBConfig(search_geometry=RefPageGeometry(16, 8),
                           auto_mesh=False, host_state_dir="", **kw)
    port = TempoDBConfig(search_geometry=PageGeometry(16, 8), **kw)
    return ref, port


def _files(root: str, block_id: str) -> dict:
    d = os.path.join(root, TENANT, block_id)
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _head(pkg: str, wal, bid: str, items, sidecar: str):
    """A head block of `items` and its search sidecar, as an ingester
    fills them."""
    blk = wal.new_block(TENANT, block_id=bid)
    dec = ref_data.decode_search_data if pkg == "ref" else \
        data.decode_search_data
    ssb = (RefStreamingSearchBlock if pkg == "ref"
           else StreamingSearchBlock)(sidecar)
    for tid, s, e, seg, sd in items:
        blk.append(tid, seg, s, e)
        ssb.append(tid, dec(sd, tid))
    return blk, ssb


@pytest.mark.parametrize("gate", [False, True], ids=["plain", "spans"])
@pytest.mark.parametrize("enc", ["none", "zlib"])
def test_complete_block_writes_the_reference_bytes(tmp_path, pushes, enc,
                                                   gate):
    """The same pushes through each package's WAL and search sidecar, then
    complete_block: every object of the block, meta.json included, is
    byte-identical; so is a block completed without entries."""
    cfg = ST_ON if gate else StructuralConfig()
    items = [it for p in pushes for it in push_items(p, structural_cfg=cfg)[0]]
    rcfg, pcfg = _cfgs(enc, gate)
    roots = {}
    for pkg in ("ref", "port"):
        root = str(tmp_path / pkg / "blocks")
        wal_dir = str(tmp_path / pkg / "wal")
        if pkg == "ref":
            db = RefTempoDB(RefLocalBackend(root), wal_dir, rcfg)
        else:
            db = TempoDB(LocalBackend(root), pcfg, device="cpu",
                         wal_dir=wal_dir)
        blk, ssb = _head(pkg, db.wal, _bid(1), items,
                         os.path.join(wal_dir, "head.search"))
        meta = db.complete_block(blk, ssb.entries())
        blk2, _ = _head(pkg, db.wal, _bid(2), items[:40],
                        os.path.join(wal_dir, "head2.search"))
        bare = db.complete_block(blk2)
        assert meta.block_id == _bid(1) and bare.block_id == _bid(2)
        assert meta.search_pages > 1 and meta.total_records > 1
        assert [m.block_id for m in db.blocklist.metas(TENANT)] == \
            [_bid(1), _bid(2)]
        roots[pkg] = root
        if pkg == "port":
            db.close()
    for b in (1, 2):
        want, got = _files(roots["ref"], _bid(b)), _files(roots["port"],
                                                          _bid(b))
        assert list(got) == list(want)
        for name in want:
            assert got[name] == want[name], (b, name)
    assert "search" not in _files(roots["port"], _bid(2))
    assert "search" in _files(roots["port"], _bid(1))


@pytest.mark.parametrize("enc", ["none", "zlib"])
def test_write_block_direct_writes_the_reference_bytes(tmp_path, pushes,
                                                       enc):
    """write_block_direct from the same (id, object, start, end) records
    and entries: the same bytes under a new block id in each package."""
    items = [it for p in pushes for it in push_items(p)[0]]
    wal = WAL(str(tmp_path / "w"), "none")
    blk, ssb = _head("port", wal, _bid(3), items,
                     str(tmp_path / "w" / "h.search"))
    codec = ref_segment_codec_for("v2")
    objects = [(t, o) + tuple(codec.fast_range(o)) for t, o in blk.iterator()]
    entries = ssb.entries()
    rcfg, pcfg = _cfgs(enc)
    ref = RefTempoDB(RefLocalBackend(str(tmp_path / "ref")),
                     str(tmp_path / "rw"), rcfg)
    port = TempoDB(LocalBackend(str(tmp_path / "port")), pcfg, device="cpu")
    try:
        rm = ref.write_block_direct(TENANT, iter(objects), [
            ref_data.decode_search_data(data.encode_search_data(e),
                                        e.trace_id) for e in entries])
        pm = port.write_block_direct(TENANT, iter(objects), entries)
    finally:
        port.close()
    assert rm.block_id != pm.block_id
    want = _files(str(tmp_path / "ref"), rm.block_id)
    got = _files(str(tmp_path / "port"), pm.block_id)
    assert list(got) == list(want)
    got["meta.json"] = got["meta.json"].replace(pm.block_id.encode(),
                                                rm.block_id.encode())
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("what", ["block", "search"])
def test_an_unusable_codec_raises_at_the_first_write(tmp_path, pushes,
                                                     monkeypatch, what):
    """On a host without libzstd and zstandard, zstd (and, without the host
    library's codecs, snappy) raises before anything is written; no codec
    is swapped for another."""
    items = [it for it in push_items(pushes[0])[0]]
    objects = [(t, seg, s, e) for t, s, e, seg, _ in
               sorted(items, key=lambda it: it[0])
               if sum(1 for x in items if x[0] == t) == 1]
    entries = [data.decode_search_data(it[4], it[0]) for it in items]
    root = tmp_path / "b"
    kw = ({"block_encoding": "zlib"} if what == "search"
          else {"search_encoding": "zlib"})
    db = TempoDB(LocalBackend(str(root)), TempoDBConfig(**kw), device="cpu")
    try:
        monkeypatch.setattr(compression, "_zstd", None)
        monkeypatch.setattr(native, "codecs", lambda: ())
        with pytest.raises(ValueError, match="zstd"):
            db.write_block_direct(TENANT, objects, entries)
        db.cfg.block_encoding = db.cfg.search_encoding = "snappy"
        with pytest.raises(ValueError, match="snappy"):
            db.write_block_direct(TENANT, objects, entries)
    finally:
        db.close()
    assert not os.path.exists(root / TENANT) or not os.listdir(root / TENANT)
    assert db.blocklist.metas(TENANT) == []


# ---------------------------------------------------------------------------
# search over a tenant with and without search containers

N_BLOCKS = 6
BARE = (1, 4)     # the blocks completed without a search container


def _mixed_tenant(root: str, pushes) -> None:
    """Six blocks written by the port's write path (the reference writes
    the same bytes): each push's traces split into blocks, blocks 1 and 4
    without a search container, every entry with span rows."""
    _, pcfg = _cfgs("zlib", True)
    db = TempoDB(LocalBackend(root), pcfg, device="cpu",
                 wal_dir=root + "-wal")
    items = [it for p in pushes for it in push_items(p,
                                                     structural_cfg=ST_ON)[0]]
    per = -(-len(items) // N_BLOCKS)
    try:
        for b in range(N_BLOCKS):
            part = items[b * per:(b + 1) * per]
            blk, ssb = _head("port", db.wal, _bid(10 + b), part,
                             os.path.join(root + "-wal", f"{b}.search"))
            db.complete_block(blk, None if b in BARE else ssb.entries())
            blk.clear()
            ssb.clear()
    finally:
        db.close()


@pytest.fixture(scope="module")
def mixed(tmp_path_factory, pushes):
    root = str(tmp_path_factory.mktemp("mixed") / "blocks")
    _mixed_tenant(root, pushes)
    g = ref_structural.STRUCTURAL
    prev = (g.enabled, g.max_spans, g.max_span_kvs)
    rcfg, pcfg = _cfgs("zlib", True)
    ref = RefTempoDB(RefLocalBackend(root), root + "-refwal", rcfg)
    port = TempoDB(LocalBackend(root), pcfg, device="cpu")
    ref.poll()
    port.poll()
    assert len(port.blocklist.metas(TENANT)) == N_BLOCKS
    # stage every group in both packages first (early-quit result sets
    # depend on which groups are staged)
    tags, kw = {"x-dbg-exhaustive": ""}, {}
    ref.search(TENANT, _ref_req(tags, kw))
    port.search(TENANT, SearchRequest(tags=dict(tags)))
    yield ref, port
    port.close()
    g.enabled, g.max_spans, g.max_span_kvs = prev


def _traces(resp) -> list:
    return [_meta(t) for t in resp.traces]


def _metrics(m) -> tuple:
    return (m.inspected_traces, m.inspected_blocks, m.skipped_blocks,
            m.inspected_bytes)


def _search_requests() -> dict:
    out = {k: v for k, v in _requests().items()
           if k not in ("agg_tag",)}
    out["exhaustive"] = ({"x-dbg-exhaustive": ""}, {"limit": 1000})
    out["skip_bare_window"] = ({"x-dbg-exhaustive": ""},
                               {"start": BASE_S + 10**6, "limit": 50})
    out["default_limit"] = ({}, {})
    return out


@pytest.mark.parametrize("name", list(_search_requests()))
def test_search_over_mixed_blocks_equals_the_reference(mixed, name):
    ref_structural.STRUCTURAL.enabled = True
    ref, port = mixed
    tags, kw = _search_requests()[name]
    for _ in range(2):
        want = ref.search(TENANT, _ref_req(tags, kw)).response()
        got = port.search(TENANT, SearchRequest(tags=dict(tags), **kw)
                          ).response()
        assert _traces(got) == _traces(want)
        assert _metrics(got.metrics) == _metrics(want.metrics)
    if name == "exhaustive":
        assert got.metrics.inspected_blocks == N_BLOCKS
        assert got.metrics.inspected_traces > 200


def test_search_uses_the_fallback_scan_for_bare_blocks(mixed):
    _, port = mixed
    jobs, fallback = port._jobs(TENANT, port.blocklist.epoch())
    assert sorted(m.block_id for m in fallback) == [_bid(10 + b)
                                                    for b in BARE]
    assert len(jobs) == N_BLOCKS - len(BARE)


@pytest.mark.parametrize("name", ["service", "exhaustive", "window",
                                  "st_child", "limit_5", "skip_bare_window"])
def test_search_block_over_mixed_blocks_equals_the_reference(mixed, name):
    ref_structural.STRUCTURAL.enabled = True
    ref, port = mixed
    tags, kw = _search_requests()[name]
    for m in port.blocklist.metas(TENANT):
        for start, count in ((0, 0), (1, 1)):
            fields = dict(tenant_id=TENANT, block_id=m.block_id,
                          start_page=start, pages_to_search=count,
                          encoding=m.encoding, version=m.version,
                          data_encoding=m.data_encoding,
                          start_time=m.start_time, end_time=m.end_time)
            rreq = ref_tempopb.SearchBlockRequest(**fields)
            rreq.search_req.CopyFrom(_ref_req(tags, kw))
            want = ref.search_block(rreq).response()
            got = port.search_block(SearchBlockRequest(
                search_req=SearchRequest(tags=dict(tags), **kw),
                **fields)).response()
            assert _traces(got) == _traces(want), (m.block_id, start)
            assert _metrics(got.metrics) == _metrics(want.metrics)


@pytest.mark.parametrize("name", ["service", "exhaustive", "window",
                                  "st_count", "default_limit",
                                  "skip_bare_window"])
def test_search_blocks_over_mixed_blocks_equals_the_reference(mixed, name):
    ref_structural.STRUCTURAL.enabled = True
    ref, port = mixed
    tags, kw = _search_requests()[name]
    jobs = [dict(block_id=m.block_id, start_page=s, pages_to_search=c,
                 encoding=m.encoding, version=m.version,
                 data_encoding=m.data_encoding, start_time=m.start_time,
                 end_time=m.end_time)
            for m in port.blocklist.metas(TENANT) for s, c in ((0, 2), (2, 0))]
    rb = ref_tempopb.SearchBlocksRequest(tenant_id=TENANT)
    rb.search_req.CopyFrom(_ref_req(tags, kw))
    for j in jobs:
        rb.jobs.add(**j)
    pb = SearchBlocksRequest(search_req=SearchRequest(tags=dict(tags), **kw),
                             tenant_id=TENANT,
                             jobs=[BlockSearchJob(**j) for j in jobs])
    for _ in range(2):
        want = ref.search_blocks(rb).response()
        got = port.search_blocks(pb).response()
        assert _traces(got) == _traces(want)
        assert _metrics(got.metrics) == _metrics(want.metrics)


def test_container_less_blocks_refuse_a_structural_request_with_the_gate_off(
        tmp_path, pushes):
    root = str(tmp_path / "blocks")
    _mixed_tenant(root, pushes[:1])
    db = TempoDB(LocalBackend(root), device="cpu")
    try:
        db.poll()
        tags, kw = _requests()["st_child"]
        req = SearchRequest(tags=dict(tags), **kw)
        m = next(m for m in db.blocklist.metas(TENANT)
                 if m.block_id == _bid(10 + BARE[0]))
        with pytest.raises(ValueError, match="structural"):
            db.search(TENANT, req)
        with pytest.raises(ValueError, match="structural"):
            db.search_block(SearchBlockRequest(
                search_req=req, tenant_id=TENANT, block_id=m.block_id,
                encoding=m.encoding, start_page=3))
        assert db.search(TENANT, SearchRequest(
            tags={"x-dbg-exhaustive": ""})).metrics.inspected_blocks == \
            N_BLOCKS
    finally:
        db.close()


# ---------------------------------------------------------------------------
# end to end

def _flow(pkg: str, root: str, wal_dir: str, pushes) -> dict:
    """Pushes into head blocks of two pushes each; the last head is
    dropped without a close (a crash) and replayed; every head completed,
    the last without a container; then poll and search."""
    rcfg, pcfg = _cfgs("zlib")
    if pkg == "ref":
        db = RefTempoDB(RefLocalBackend(root), wal_dir, rcfg)
        ssb_cls, dec = RefStreamingSearchBlock, ref_data.decode_search_data
    else:
        db = TempoDB(LocalBackend(root), pcfg, device="cpu", wal_dir=wal_dir)
        ssb_cls, dec = StreamingSearchBlock, data.decode_search_data
    out: dict = {"db": db, "finds": {}}
    heads = []
    for h in range(2):
        blk = db.wal.new_block(TENANT, block_id=_bid(20 + h))
        ssb = ssb_cls(blk.path + ".search")
        for batches in pushes[2 * h:2 * h + 2]:
            if pkg == "ref":
                items = _ref_items(batches, data.DEFAULT_MAX_SEARCH_BYTES,
                                   False)
            else:
                items = push_items(batches)[0]
            for tid, s, e, seg, sd in items:
                blk.append(tid, seg, s, e)
                ssb.append(tid, dec(sd, tid))
        heads.append((blk, ssb))
        for t, _ in blk.iterator():
            out["finds"].setdefault(t, []).append(blk.find(t))
    # the crash: the second head's objects dropped without a close
    blk, ssb = heads.pop()
    path = blk.path
    del blk, ssb
    wal = (RefWAL if pkg == "ref" else WAL)(wal_dir, encoding="zlib")
    replayed, removed = wal.replay_all()
    assert removed == []
    again = next(b for b in replayed if b.path == path)
    for b in replayed:
        if b is not again:
            b.close()
    heads.append((again, ssb_cls.rescan(path + ".search")))
    out["replayed"] = list(again.iterator())
    out["entries"] = [data.encode_search_data(e) if pkg == "port"
                      else ref_data.encode_search_data(e)
                      for e in heads[1][1].entries()]
    db.complete_block(heads[0][0], heads[0][1].entries())
    db.complete_block(heads[1][0])
    for blk, ssb in heads:
        blk.clear()
        ssb.clear()
    db.poll()
    return out


def test_pushes_to_search_end_to_end_equal_the_reference(tmp_path, pushes):
    g = ref_structural.STRUCTURAL
    got = _flow("port", str(tmp_path / "p"), str(tmp_path / "pw"), pushes)
    want = _flow("ref", str(tmp_path / "r"), str(tmp_path / "rw"), pushes)
    g.enabled = False
    port, ref = got["db"], want["db"]
    try:
        assert got["replayed"] == want["replayed"]
        assert got["entries"] == want["entries"]
        assert got["finds"] == want["finds"]
        assert got["replayed"] == [(t, got["finds"][t][-1])
                                   for t, _ in got["replayed"]]
        for b in (0, 1):
            assert _files(str(tmp_path / "p"), _bid(20 + b)) == \
                _files(str(tmp_path / "r"), _bid(20 + b))
        for name in ("exhaustive", "service", "min_dur", "window",
                     "default_limit", "error"):
            tags, kw = _search_requests()[name]
            w = ref.search(TENANT, _ref_req(tags, kw)).response()
            r = port.search(TENANT, SearchRequest(tags=dict(tags), **kw)
                            ).response()
            assert _traces(r) == _traces(w)
            assert _metrics(r.metrics) == _metrics(w.metrics)
        resp = port.search(TENANT, SearchRequest(
            tags={"x-dbg-exhaustive": ""}, limit=10_000)).response()
        assert len(resp.traces) == len(got["finds"])
        both = 0
        for t in resp.traces:
            tid = bytes.fromhex(t.trace_id)
            found = port.find_trace_by_id(TENANT, tid)
            assert found == ref.find_trace_by_id(TENANT, tid)
            # a trace in both heads (split over pushes 1 and 2) is combined
            # from both blocks
            if len(got["finds"][tid]) == 1:
                assert found == (got["finds"][tid][0], 0)
            both += len(got["finds"][tid]) > 1
        assert both > 0
    finally:
        port.close()


def test_chip_smoke_ingest_cell_rehearses_on_the_cpu(tmp_path):
    """``chip_smoke.ingest_cell`` at a small size on the CPU: pushes,
    WAL, crash replay, completion with and without containers, poll, the
    searches against an independent count, and every result opened."""
    import argparse

    import chip_smoke

    args = argparse.Namespace(ingest_blocks=4, ingest_traces_per_block=512,
                              ingest_bare_traces=128, ingest_push_spans=1024,
                              seed=20261017, reps=2)
    report, dbs = {}, []
    launches = {k: 0 for k in chip_smoke.KERNELS}
    try:
        rows = chip_smoke.ingest_cell(args, str(tmp_path), report, dbs,
                                      launches, device="cpu")
    finally:
        for db in dbs:
            db.close()
    out = report["ingest"]
    assert rows == [] and not any(launches.values())   # no card here
    assert out["traces"] == 4 * 512 + 128
    assert out["exhaustive_matches"] == out["host_matches"] > 0
    assert out["replay"]["objects"] > 0 and out["opened"] > 0
    assert out["split_traces"] > 0 and out["skewed_traces"] > 0
    assert len(out["warm"]["lat_ms"]) == 2


def test_search_and_write_modules_import_no_protobuf():
    """Protobuf comes in where a trace proto is walked, not with the
    modules: a search-only process needs none."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import tempo_tpu_torch.db, tempo_tpu_torch.search\n"
            "import tempo_tpu_torch.model, tempo_tpu_torch.wal\n"
            "import tempo_tpu_torch.modules.distributor\n"
            "sys.exit(1 if 'google.protobuf' in sys.modules else 0)\n")
    r = subprocess.run([sys.executable, "-c", code],
                       cwd=os.path.dirname(os.path.dirname(__file__)),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_fallback_scan_books_the_reference_query_stats(mixed):
    """The port's SearchMetrics carry the reference's fields, and its
    fallback scan books what the reference's does: each bare block's data
    bytes as the query's host bytes, the block as inspected, one
    ``tempo_search_fallback_scans_total`` a block and the
    ``fallback_scan`` host stage."""
    import json

    from tempo_tpu.observability import metrics as ref_obs

    from tempo_tpu_torch.observability import metrics as obs

    ref_fields = set(ref_tempopb.SearchMetrics.DESCRIPTOR.fields_by_name)
    port_fields = {f.name for f in dataclasses.fields(SearchMetrics)}
    assert {"inspected_traces", "inspected_bytes", "inspected_blocks",
            "skipped_blocks", "device_seconds", "inspected_bytes_device",
            "query_stats_json"} <= ref_fields & port_fields
    ref_structural.STRUCTURAL.enabled = True
    ref, port = mixed
    tags, kw = _search_requests()["exhaustive"]
    before = (ref_obs.fallback_scans.value(tenant=TENANT),
              obs.fallback_scans.value(tenant=TENANT))
    rr = _ref_req(tags, kw)
    rr.explain = True
    want = ref.search(TENANT, rr).response()
    got = port.search(TENANT, SearchRequest(tags=dict(tags), explain=True,
                                            **kw)).response()
    after = (ref_obs.fallback_scans.value(tenant=TENANT),
             obs.fallback_scans.value(tenant=TENANT))
    assert after[1] - before[1] == after[0] - before[0] == len(BARE)
    dw = json.loads(want.metrics.query_stats_json)
    dg = json.loads(got.metrics.query_stats_json)
    assert dg["bytes_inspected"] == dw["bytes_inspected"]
    assert dg["bytes_inspected"]["host"] > 0
    assert dg["blocks_inspected"] == dw["blocks_inspected"] == N_BLOCKS
    assert "fallback_scan" in dg["stages_ms"]
    assert got.metrics.inspected_bytes_device == \
        want.metrics.inspected_bytes_device
    assert got.metrics.inspected_bytes == want.metrics.inspected_bytes


def test_distributor_module_holds_the_walk_and_no_service():
    from tempo_tpu_torch.modules import distributor

    assert callable(distributor.regroup_extract)
    assert not hasattr(distributor, "Distributor")
    assert hasattr(RefDistributor, "push_batches")
