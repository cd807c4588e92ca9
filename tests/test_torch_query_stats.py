"""Per-query attribution on the port against the reference's.

One corpus, written by the reference (4 blocks of 128-1,024 traces with
search containers and span rows, and one block of 64 traces without a
container), answers the same requests with ``explain`` through the
reference's ``TempoDB`` (JAX on the CPU) and the port's
``TempoDB(device="cpu")``. The fields of ``query_stats_json`` that do
not measure time must be equal: the key set, blocks inspected and
skipped (with the reasons), bytes by placement, dispatches, fused
dispatches, staged bytes, the query summary, the host probe's count and
bytes, the structural plan's nodes (id, op, detail, est_bytes) and, after
a warm run, the cache events. Then the reference's own query-stats tests
on the port (apportion, the 8-way coalesced and stacked structural
conservation with the reference's member weights, the noop contract, the
slow-query log and counters, nested attribution), a hypothesis property
of ``apportion`` under the built-in ``sum``, and the port's deliberate
differences (the per-database gates, the compile stage), and the cache
events over an evicting budget, host-RAM tier included.
"""

from __future__ import annotations

import json
import logging
import math
import random
import threading
import time

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

from tempo_tpu import tempopb
from tempo_tpu.backend.local import LocalBackend as RefLocalBackend
from tempo_tpu.db import TempoDB as RefTempoDB
from tempo_tpu.db import TempoDBConfig as RefTempoDBConfig
from tempo_tpu.model import segment_codec_for as ref_segment_codec_for
from tempo_tpu.observability.profile import PROFILER as REF_PROFILER
from tempo_tpu.parallel.mesh import make_mesh as ref_make_mesh
from tempo_tpu.search import analytics as ref_analytics
from tempo_tpu.search import ir as ref_ir
from tempo_tpu.search import packing as ref_packing
from tempo_tpu.search import pipeline as ref_pipeline
from tempo_tpu.search import query_stats as ref_query_stats
from tempo_tpu.search import structural as ref_structural
from tempo_tpu.search.columnar import ColumnarPages as RefColumnarPages
from tempo_tpu.search.columnar import PageGeometry as RefPageGeometry
from tempo_tpu.search.data import SearchData as RefSearchData
from tempo_tpu.search.data import SpanData as RefSpanData
from tempo_tpu.search.data import extract_search_data as ref_extract
from tempo_tpu.search.multiblock import MultiBlockEngine as RefEngine
from tempo_tpu.search.multiblock import compile_multi as ref_compile_multi
from tempo_tpu.utils.test_data import make_trace

from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.backend.types import BlockMeta
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.model.types import (BlockSearchJob, SearchBlockRequest,
                                         SearchBlocksRequest, SearchRequest)
from tempo_tpu_torch.observability import metrics as obs
from tempo_tpu_torch.observability import profile
from tempo_tpu_torch.parallel import mesh
from tempo_tpu_torch.parallel import multihost_dryrun as md
from tempo_tpu_torch.parallel.dist_search import DistributedScanEngine
from tempo_tpu_torch.search import ir, query_stats, structural
from tempo_tpu_torch.search.backend_search_block import (BackendSearchBlock,
                                                         write_search_block)
from tempo_tpu_torch.search.batcher import (BlockBatcher, QueryCoalescer,
                                            ScanJob, _table_weight)
from tempo_tpu_torch.search.columnar import ColumnarPages, PageGeometry
from tempo_tpu_torch.search.data import SearchData, SpanData
from tempo_tpu_torch.search.engine import resolve_top_k
from tempo_tpu_torch.search.multiblock import MultiBlockEngine, compile_multi
from tempo_tpu_torch.search.pipeline import compile_query

CPU = torch.device("cpu")
TENANT = "acme"
BLOCK_TRACES = (128, 256, 512, 1024)   # blocks with a search container
BARE_TRACES = 64                       # the block without one
GEOMETRY = (32, 8)                     # entries per page, kv slots
MAX_PAGES = 8                          # pages a group: several groups
WAIT_S = 60
PLAN = ('{"exists": {"and": [{"tag": {"k": "component", "v": "db"}}, '
        '{"dur": {"min_ms": 200}}]}}')
# the fields of query_stats_json that do not measure time
FIELDS = ("blocks_inspected", "skipped_blocks", "bytes_inspected",
          "dispatches", "fused_dispatches", "staged_bytes", "query")


@pytest.fixture(autouse=True)
def _fresh_state():
    """The registries are process-wide: empty them around each test, and
    put back the reference's process-wide gates (a reference TempoDB sets
    them when constructed) and its compile cache."""
    g = ref_structural.STRUCTURAL
    prev = (g.enabled, g.stack_enabled, ref_packing.PACKING.enabled,
            ref_analytics.ANALYTICS.enabled)
    query_stats.configure(slow_s=10.0)
    ref_query_stats.configure(enabled=True, slow_s=10.0)
    for qsm in (query_stats, ref_query_stats):
        qsm.REGISTRY.reset()
    ref_pipeline._COMPILE_CACHE.clear()
    yield
    g.enabled, g.stack_enabled, ref_packing.PACKING.enabled = prev[:3]
    ref_analytics.ANALYTICS.configure(enabled=prev[3])
    query_stats.configure(slow_s=10.0)
    ref_query_stats.configure(enabled=True, slow_s=10.0)
    for qsm in (query_stats, ref_query_stats):
        qsm.REGISTRY.reset()
    ref_pipeline._COMPILE_CACHE.clear()


# ---------------------------------------------------------------------------
# the corpus and the two databases


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The reference's write path: 4 blocks with containers (span rows
    included) and one without, zlib."""
    root = tmp_path_factory.mktemp("query_stats")
    db = RefTempoDB(RefLocalBackend(str(root / "blocks")), str(root / "wal"),
                    RefTempoDBConfig(block_encoding="zlib",
                                     search_encoding="zlib",
                                     search_geometry=RefPageGeometry(
                                         *GEOMETRY)))
    sc = ref_segment_codec_for("v2")
    rng = random.Random(20261018)
    for b, n in enumerate(BLOCK_TRACES + (BARE_TRACES,)):
        blk = db.wal.new_block(TENANT)
        entries = {}
        for i in range(n):
            tid = rng.randbytes(16)
            tr = make_trace(tid, seed=b * 10_000 + i)
            sd = ref_extract(tid, tr, spans=True)
            blk.append(tid, sc.prepare_for_write(tr, sd.start_s, sd.end_s),
                       sd.start_s, sd.end_s)
            entries[tid] = sd
        db.complete_block(blk, None if n == BARE_TRACES else
                          [entries[t] for t in sorted(entries)])
        blk.clear()
    return root


def _fields(**kw) -> dict:
    return dict(block_encoding="zlib", search_encoding="zlib",
                search_max_batch_pages=MAX_PAGES, **kw)


def _pair(root, tag: str, stage_all: bool = True, **kw):
    """A reference and a port database over the corpus, with the same
    config fields (the reference's gates follow it; the reference on one
    device: the test process has 8 virtual CPU devices). With `stage_all`,
    an exhaustive request stages every group in both first: which groups
    an early-quitting request scans depends on what is staged."""
    ref = RefTempoDB(RefLocalBackend(str(root / "blocks")),
                     str(root / f"ref-wal-{tag}"),
                     RefTempoDBConfig(search_geometry=RefPageGeometry(
                         *GEOMETRY), auto_mesh=False, **_fields(**kw)))
    port = TempoDB(LocalBackend(str(root / "blocks")),
                   TempoDBConfig(search_geometry=PageGeometry(*GEOMETRY),
                                 **_fields(**kw)), device="cpu")
    ref.poll()
    port.poll()
    # the reference's compile cache is process-wide, the port's per
    # engine: start the reference's empty with the pair
    ref_pipeline._COMPILE_CACHE.clear()
    if stage_all:
        tags, kw = {"x-dbg-exhaustive": ""}, {"limit": 1}
        ref.search(TENANT, _ref_req(tags, kw))
        port.search(TENANT, _port_req(tags, kw))
    return ref, port


def _plan_tags(pkg_structural, pkg_ir, req) -> None:
    pkg_structural.attach_query(req, pkg_ir.parse(PLAN))


def _requests(structural_on: bool = False, agg: bool = False) -> dict:
    out = {
        "tag": ({"service.name": "cart"}, {"limit": 10}),
        "tag_exhaustive": ({"service.name": "cart", "x-dbg-exhaustive": ""},
                           {"limit": 20}),
        "substring": ({"http.status_code": "50"}, {"limit": 2000}),
        "time_range": ({}, {"start": 2_000_000_000, "end": 2_000_000_100}),
        "duration": ({}, {"min_duration_ms": 100_000_000}),
        "dict": ({"service.name": "no-such-service"}, {}),
        "window_and_tag": ({"component": "http"},
                           {"start": 1_600_000_000,
                            "end": 1_600_003_600, "limit": 3000}),
    }
    if structural_on:
        out["structural"] = ("plan", {"limit": 3000})
    if agg:
        out["agg"] = ({"x-agg-q": "red"}, {"limit": 3000})
        out["agg_tag"] = ({"x-agg-q": "red", "service.name": "auth"},
                          {"limit": 5})
    return out


def _ref_req(tags, kw) -> tempopb.SearchRequest:
    r = tempopb.SearchRequest()
    if tags == "plan":
        _plan_tags(ref_structural, ref_ir, r)
    else:
        for k, v in tags.items():
            r.tags[k] = v
    for k, v in kw.items():
        setattr(r, k, v)
    r.explain = True
    return r


def _port_req(tags, kw) -> SearchRequest:
    r = SearchRequest(explain=True, **kw)
    if tags == "plan":
        _plan_tags(structural, ir, r)
    else:
        r.tags = dict(tags)
    return r


def _nodes(d: dict) -> list:
    return [{k: n.get(k) for k in ("id", "op", "detail", "est_bytes")}
            for n in (d.get("structural") or {}).get("nodes", [])]


def _same_stats(want: dict, got: dict, cache: bool) -> None:
    """The reference's explain dict against the port's, in every field
    that does not measure time."""
    assert sorted(got) == sorted(want)
    for k in FIELDS:
        assert got.get(k) == want.get(k), k
    hp_w, hp_g = want.get("host_probe") or {}, got.get("host_probe") or {}
    assert (hp_g.get("count"), hp_g.get("bytes")) == \
        (hp_w.get("count"), hp_w.get("bytes"))
    assert _nodes(got) == _nodes(want)
    if cache:
        assert got["cache"] == want["cache"]


def _compare(ref_fn, port_fn, reqs: dict) -> dict:
    """Each request twice through both packages (compiling, then from the
    memo): equal stats (the cache events only the second time) and equal
    answers. Returns the port's second explain dicts."""
    out = {}
    for name, (tags, kw) in reqs.items():
        for warm in (False, True):
            r = ref_fn(_ref_req(tags, kw)).response()
            p = port_fn(_port_req(tags, kw)).response()
            assert p.metrics.inspected_blocks == r.metrics.inspected_blocks
            assert p.metrics.skipped_blocks == r.metrics.skipped_blocks
            assert p.metrics.inspected_bytes == r.metrics.inspected_bytes
            assert p.metrics.inspected_bytes_device == \
                r.metrics.inspected_bytes_device, name
            assert p.metrics.agg_json == r.metrics.agg_json
            want = json.loads(r.metrics.query_stats_json)
            got = json.loads(p.metrics.query_stats_json)
            try:
                _same_stats(want, got, cache=warm)
            except AssertionError as e:
                raise AssertionError(f"{name} (warm={warm}): {e}\n"
                                     f"reference {want}\nport {got}") from e
            assert p.metrics.device_seconds == pytest.approx(
                got["device_seconds"])
        out[name] = got
    return out


@pytest.mark.parametrize("cfg", ["plain", "structural_agg", "packed"])
def test_search_books_the_reference_stats(corpus, cfg):
    kw = {"plain": {},
          "structural_agg": dict(search_structural_enabled=True,
                                 search_analytics_enabled=True),
          "packed": dict(search_packed_residency=True)}[cfg]
    ref, port = _pair(corpus, cfg, **kw)
    try:
        got = _compare(lambda r: ref.search(TENANT, r),
                       lambda r: port.search(TENANT, r),
                       _requests(structural_on=cfg == "structural_agg",
                                 agg=cfg == "structural_agg"))
    finally:
        port.close()
    assert got["time_range"]["skipped_blocks"] == {
        "time_range": len(BLOCK_TRACES) + 1}
    assert got["duration"]["skipped_blocks"] == {"duration":
                                                 len(BLOCK_TRACES)}
    assert got["dict"]["skipped_blocks"] == {"dict": len(BLOCK_TRACES)}
    # the exhaustive request reaches the block without a container: its
    # bytes are host bytes, the fallback scan a host stage
    ex = got["tag_exhaustive"]
    assert ex["bytes_inspected"]["host"] > 0
    assert "fallback_scan" in ex["stages_ms"]
    assert ex["device_seconds"] > 0 and ex["dispatches"] >= 2
    assert ex["cache"] == {"hbm_hit": ex["dispatches"]}
    if cfg == "packed":
        sb = ex["staged_bytes"]
        assert sb["physical"] < sb["logical"]
    if cfg == "structural_agg":
        nodes = got["structural"]["structural"]["nodes"]
        assert [n["op"] for n in nodes] == ["exists", "span.and",
                                            "span.tag", "span.dur"]
        assert sum(n["device_ms"] for n in nodes) == pytest.approx(
            got["structural"]["device_stages_ms"]["execute"], abs=1e-5)


def _jobs_of(port) -> list:
    return [m for m in port.blocklist.metas(TENANT)]


def test_search_block_and_search_blocks_book_the_reference_stats(corpus):
    ref, port = _pair(corpus, "jobs")
    metas = sorted(_jobs_of(port), key=lambda m: m.block_id)
    try:
        for m in metas:
            def ref_block(req, m=m):
                r = tempopb.SearchBlockRequest()
                r.search_req.CopyFrom(req)
                r.block_id, r.tenant_id = m.block_id, TENANT
                r.encoding, r.version = m.encoding, m.version
                r.data_encoding = m.data_encoding
                r.start_time, r.end_time = m.start_time, m.end_time
                return ref.search_block(r)

            def port_block(req, m=m):
                return port.search_block(SearchBlockRequest(
                    search_req=req, block_id=m.block_id, tenant_id=TENANT,
                    encoding=m.encoding, version=m.version,
                    data_encoding=m.data_encoding,
                    start_time=m.start_time, end_time=m.end_time))

            _compare(ref_block, port_block,
                     {k: v for k, v in _requests().items()
                      if k in ("tag_exhaustive", "time_range", "dict")})

        def ref_blocks(req):
            r = tempopb.SearchBlocksRequest()
            r.tenant_id = TENANT
            r.search_req.CopyFrom(req)
            for m in metas:
                j = r.jobs.add()
                j.block_id, j.encoding, j.version = (m.block_id, m.encoding,
                                                     m.version)
                j.data_encoding = m.data_encoding
                j.start_time, j.end_time = m.start_time, m.end_time
            return ref.search_blocks(r)

        def port_blocks(req):
            return port.search_blocks(SearchBlocksRequest(
                search_req=req, tenant_id=TENANT,
                jobs=[BlockSearchJob(block_id=m.block_id,
                                     encoding=m.encoding, version=m.version,
                                     data_encoding=m.data_encoding,
                                     start_time=m.start_time,
                                     end_time=m.end_time) for m in metas]))

        got = _compare(ref_blocks, port_blocks, _requests())
    finally:
        port.close()
    assert got["time_range"]["skipped_blocks"] == {
        "time_range": len(BLOCK_TRACES) + 1}


def test_the_fallback_scan_books_host_bytes_and_its_counter(corpus):
    """The block without a container is searched from its trace objects:
    host bytes, one inspected block, one fallback_scans count, as the
    reference books them."""
    from tempo_tpu.observability import metrics as ref_obs

    ref, port = _pair(corpus, "fallback")
    try:
        before = (obs.fallback_scans.value(tenant=TENANT),
                  ref_obs.fallback_scans.value(tenant=TENANT))
        tags, kw = ({"x-dbg-exhaustive": ""}, {"limit": 5000})
        r = ref.search(TENANT, _ref_req(tags, kw)).response()
        p = port.search(TENANT, _port_req(tags, kw)).response()
        after = (obs.fallback_scans.value(tenant=TENANT),
                 ref_obs.fallback_scans.value(tenant=TENANT))
    finally:
        port.close()
    assert after[0] - before[0] == after[1] - before[1] == 1
    dr = json.loads(r.metrics.query_stats_json)
    dp = json.loads(p.metrics.query_stats_json)
    assert dp["bytes_inspected"] == dr["bytes_inspected"]
    assert dp["bytes_inspected"]["host"] > 0
    assert dp["blocks_inspected"] == dr["blocks_inspected"] == \
        len(BLOCK_TRACES) + 1
    assert p.metrics.inspected_bytes == r.metrics.inspected_bytes


def test_a_cold_search_books_the_reference_dispatches_and_staging(corpus):
    """A fresh pair, the first request each: the cold cache events
    (hbm_miss_cold a group, then hits) and the dispatch counts equal."""
    ref, port = _pair(corpus, "cold", stage_all=False)
    REF_PROFILER.reset()        # forget the shapes earlier tests compiled
    try:
        tags, kw = ({"component": "grpc", "x-dbg-exhaustive": ""}, {})
        r = ref.search(TENANT, _ref_req(tags, kw)).response()
        p = port.search(TENANT, _port_req(tags, kw)).response()
    finally:
        port.close()
    dr = json.loads(r.metrics.query_stats_json)
    dp = json.loads(p.metrics.query_stats_json)
    _same_stats(dr, dp, cache=True)
    assert set(dp["cache"]) == {"hbm_miss_cold"}
    # deliberate difference: the reference's first dispatch of a shape
    # books a jit compile; the port's plain versions load no kernel
    assert "compile" in dr["device_stages_ms"]
    assert "compile" not in dp["device_stages_ms"]
    assert set(dp["device_stages_ms"]) == {"build", "execute", "d2h"}


def test_cache_events_without_a_host_tier(corpus):
    """With a budget of one small batch, groups evict and re-stage. Both
    packages re-stage an evicted group from their host-RAM tier
    (hbm_miss_host_hit), so the cache events equal the reference's, cold
    round and warm round. (The name is from the slice before the port's
    host tier, when every re-stage was cold.)"""
    ref, port = _pair(corpus, "evict", stage_all=False,
                      search_batch_cache_bytes=20_000)
    try:
        tags, kw = ({"x-dbg-exhaustive": ""}, {"limit": 5000})
        for _ in range(2):
            r = ref.search(TENANT, _ref_req(tags, kw)).response()
            p = port.search(TENANT, _port_req(tags, kw)).response()
            dr = json.loads(r.metrics.query_stats_json)
            dp = json.loads(p.metrics.query_stats_json)
            _same_stats(dr, dp, cache=True)
        stats = port.batcher.debug_stats()
    finally:
        port.close()
    assert dr["cache"].get("hbm_miss_host_hit", 0) > 0
    assert dp["cache"] == dr["cache"]
    # the device budget holds fewer batches than the host tier, which
    # holds every group
    assert stats["cache"]["bytes"] <= 20_000
    assert stats["host_cache"]["batches"] > stats["cache"]["batches"]
    assert stats["host_cache"]["bytes"] <= stats["host_cache"]["budget_bytes"]


def test_stats_off_creates_no_record_and_answers_alike(corpus):
    """Two databases in one process: the gate is per database. With it
    off, no QueryStats is created, the metrics carry no device seconds,
    and the response is the one with it on, field for field."""
    on = TempoDB(LocalBackend(str(corpus / "blocks")),
                 TempoDBConfig(**_fields()), device="cpu")
    off = TempoDB(LocalBackend(str(corpus / "blocks")),
                  TempoDBConfig(search_query_stats_enabled=False,
                                **_fields()), device="cpu")
    made = []
    orig = query_stats.QueryStats.__init__

    def counting(self, *a, **kw):
        made.append(self)
        orig(self, *a, **kw)

    try:
        on.poll()
        off.poll()
        query_stats.QueryStats.__init__ = counting
        for tags, kw in _requests().values():
            a = on.search(TENANT, _port_req(tags, kw)).response()
            n_on = len(made)
            b = off.search(TENANT, _port_req(tags, kw)).response()
            assert len(made) == n_on        # the off database made none
            assert b.traces == a.traces
            assert (b.metrics.inspected_traces, b.metrics.inspected_blocks,
                    b.metrics.skipped_blocks, b.metrics.inspected_bytes) == \
                (a.metrics.inspected_traces, a.metrics.inspected_blocks,
                 a.metrics.skipped_blocks, a.metrics.inspected_bytes)
            assert b.metrics.device_seconds == 0.0
            # deliberate difference: the device bytes ride the response
            # with stats off too (the reference's are 0 then)
            assert b.metrics.inspected_bytes_device == \
                a.metrics.inspected_bytes_device
            assert b.metrics.query_stats_json == ""
            assert json.loads(a.metrics.query_stats_json)["tenant"] == TENANT
    finally:
        query_stats.QueryStats.__init__ = orig
        on.close()
        off.close()
    assert made


def test_profiling_off_bills_wall_time_as_execute(corpus):
    """A database with profiling off opens no record; its searches still
    book device seconds, from the dispatches' wall time (the reference's
    fallback), and the profiler's ring sees none of them."""
    db = TempoDB(LocalBackend(str(corpus / "blocks")),
                 TempoDBConfig(search_profiling_enabled=False, **_fields()),
                 device="cpu")
    seen = []
    profile.PROFILER.add_listener(seen.append)
    try:
        db.poll()
        tags, kw = _requests()["tag_exhaustive"]
        d = json.loads(db.search(TENANT, _port_req(tags, kw)).response()
                       .metrics.query_stats_json)
    finally:
        profile.PROFILER.remove_listener(seen.append)
        db.close()
    assert not seen
    assert set(d["device_stages_ms"]) == {"execute"}
    assert d["device_seconds"] > 0 and d["dispatches"] >= 1


# ---------------------------------------------------------------------------
# the mesh: a two-rank gloo job against the reference's two-device mesh


def test_two_rank_gloo_mesh_books_the_reference_stats(tmp_path):
    reqs = [({"service.name": "frontend"},
             {"min_duration_ms": 100, "limit": 1000, "explain": True}),
            ({"session.id": "s-04-00"}, {"limit": 1000, "explain": True}),
            ({}, {"start": 2_000_000_000, "end": 2_000_000_100,
                  "explain": True})]
    fields = dict(search_device_probe_min_vals=64, search_max_batch_pages=16)
    res = md.run(2, fields, reqs, timeout_s=120, root=str(tmp_path))
    assert res["world"] == 2
    ref = RefTempoDB(RefLocalBackend(str(tmp_path / "blocks")),
                     str(tmp_path / "ref-wal"),
                     RefTempoDBConfig(auto_mesh=False, **fields),
                     mesh=ref_make_mesh(2))
    ref.poll()
    for i, (tags, kw) in enumerate(reqs):
        ref_pipeline._COMPILE_CACHE.clear()
        r = ref.search(md.TENANT, _ref_req(tags, {
            k: v for k, v in kw.items() if k != "explain"})).response()
        want = json.loads(r.metrics.query_stats_json)
        for rank_stats in res["stats"]:
            got = rank_stats[i]
            _same_stats(want, got, cache=False)
            if got["dispatches"]:
                assert got["device_stages_ms"]
            # the collective lock's wait and the staged bytes are booked
            # as the reference books them (its compile is a jit's)
            assert set(got["device_stages_ms"]) == \
                set(want["device_stages_ms"]) - {"compile"}
            assert ("lock_wait" in got["device_stages_ms"]) == \
                bool(got["dispatches"])
            assert bool(got["h2d_bytes"]) == bool(want["h2d_bytes"])
    # both tag requests dispatched on every rank (the second through the
    # mesh probe: every dictionary staged at threshold 64)
    assert all(st[0]["dispatches"] and st[1]["dispatches"]
               for st in res["stats"])


# ---------------------------------------------------------------------------
# the reference's own tests of the module, on the port


def _corpus(n=200, seed=0, pkg="port"):
    """The reference's test corpus (tests/test_coalesce.py _corpus): unique
    start seconds, six services, a few tags."""
    SD = SearchData if pkg == "port" else RefSearchData
    rng = random.Random(seed)
    out = []
    for i in range(n):
        tid = (seed.to_bytes(2, "big") + i.to_bytes(4, "big")).rjust(16,
                                                                     b"\0")
        sd = SD(trace_id=tid)
        sd.start_s = 1_600_000_000 + seed * 1_000_000 + i
        sd.end_s = sd.start_s + 5
        sd.dur_ms = rng.randint(1, 30_000)
        sd.root_service = f"svc-{rng.randrange(6)}"
        sd.root_name = f"op-{rng.randrange(4)}"
        sd.kvs = {"service.name": {sd.root_service},
                  "http.status_code": {rng.choice(["200", "404", "500"])},
                  "region": {rng.choice(["us", "eu", "ap"])}}
        out.append(sd)
    return out


def _blocks(n=3, entries=128):
    return [ColumnarPages.build(_corpus(entries, seed=s), PageGeometry(32, 8))
            for s in range(n)]


def _jobs(blocks):
    return [ScanJob(key=(f"blk-{i:03d}", 0, p.n_pages),
                    pages_fn=(lambda p=p: p), header=dict(p.header),
                    n_pages=p.n_pages, n_entries=p.n_entries,
                    geometry=(p.header["entries_per_page"],
                              p.header["kv_per_entry"]))
            for i, p in enumerate(blocks)]


def _req(tags=None, **kw) -> SearchRequest:
    return SearchRequest(tags=dict(tags or {}), **kw)


def _with_stats(batcher, jobs, req, tenant="t1"):
    qs = query_stats.begin(tenant, req)
    with query_stats.activate(qs):
        results = batcher.search(jobs, req)
    return results, qs, qs.finish()


def test_apportion_conserves_totals_exactly():
    totals = {"execute": 0.123456789, "compile": 3.14159, "h2d": 1e-9}
    for weights in ([1, 1, 1, 1], [5, 1, 3], [7], [1000, 1, 1, 1, 1, 1]):
        shares = query_stats.apportion(totals, weights)
        assert len(shares) == len(weights)
        for stage, total in totals.items():
            assert sum(s[stage] for s in shares) == total    # exact


def test_apportion_weights_proportional():
    shares = query_stats.apportion({"execute": 1.0}, [3, 1])
    assert abs(shares[0]["execute"] - 0.75) < 1e-12
    assert abs(shares[1]["execute"] - 0.25) < 1e-12


def test_the_reference_formula_fails_where_the_port_conserves():
    """The reference's left-fold remainder does not sum back under
    Python 3.12's compensated sum on this case; the port's does."""
    totals = {"execute": 0.123456789}
    weights = [1000, 1, 1, 1, 1, 1]
    ref = ref_query_stats.apportion(totals, weights)
    port = query_stats.apportion(totals, weights)
    assert sum(s["execute"] for s in port) == 0.123456789
    assert sum(s["execute"] for s in ref) != 0.123456789


@settings(max_examples=400, deadline=None)
@given(total=hs.one_of(hs.floats(min_value=0.0, max_value=1e6,
                                 allow_nan=False, allow_infinity=False),
                       hs.sampled_from([1e-9, 0.123456789, 3.14159, 1e-300,
                                        5e-324, 2.0 ** 40])),
       weights=hs.lists(hs.integers(min_value=1, max_value=10**6),
                        min_size=1, max_size=64))
def test_apportion_property(total, weights):
    """Exact under the built-in sum in any order, never negative, each
    share within 1e-12 of its proportion (relative to the total)."""
    shares = [s["x"] for s in query_stats.apportion({"x": total}, weights)]
    assert sum(shares) == total
    assert sum(reversed(shares)) == total
    assert math.fsum(shares) == total
    assert all(s >= 0 for s in shares)
    W = sum(weights)
    for s, w in zip(shares, weights):
        assert abs(s - total * w / W) <= 1e-12 * max(total, 1e-300) \
            + len(weights) * math.ulp(total)


def test_apportion_with_zero_weights_splits_evenly():
    shares = query_stats.apportion({"x": 1.0}, [0, 0])
    assert [s["x"] for s in shares] == [0.5, 0.5]


def test_batched_path_populates_metrics_and_stats():
    batcher = BlockBatcher(CPU, profiling=profile.ON)
    try:
        req = _req({"service.name": "svc-1"}, limit=500)
        results, qs, d = _with_stats(batcher, _jobs(_blocks()), req)
    finally:
        batcher.close()
    m = results.metrics
    assert m.inspected_blocks > 0 and m.inspected_traces > 0
    assert d["blocks_inspected"] == m.inspected_blocks
    assert d["device_seconds"] > 0 and d["dispatches"] >= 1
    assert d["stages_ms"]
    assert "hbm_miss_cold" in d["cache"] or "hbm_hit" in d["cache"]


def test_single_block_path_populates_metrics(tmp_path):
    be = LocalBackend(str(tmp_path))
    meta = BlockMeta(tenant_id="t1")
    write_search_block(be, meta, _corpus(64, seed=1), encoding="zlib")
    bsb = BackendSearchBlock(be, meta, device="cpu",
                             profiling=profile.ON)
    req = _req({"service.name": "svc-1"}, limit=100)
    qs = query_stats.begin("t1", req)
    with query_stats.activate(qs):
        results = bsb.search(req)
    d = qs.finish()
    m = results.metrics
    assert m.inspected_blocks == 1 and m.inspected_traces > 0
    assert m.inspected_bytes > 0
    assert d["bytes_inspected"]["device"] == m.inspected_bytes
    assert d["device_seconds"] > 0 and d["dispatches"] == 1
    qs2 = query_stats.begin("t1", req)
    with query_stats.activate(qs2):
        r2 = bsb.search(_req({"service.name": "nope-xyz"}, limit=10))
    assert r2.metrics.skipped_blocks == 1
    assert qs2.finish()["skipped_blocks"] == {"dict": 1}


def test_skip_reasons_time_range_duration_and_dict():
    batcher = BlockBatcher(CPU, profiling=profile.ON)
    jobs = _jobs(_blocks(3, 64))
    try:
        for req, want in (
                (_req({}, limit=10, start=2_000_000_000, end=2_000_000_100),
                 {"time_range": len(jobs)}),
                (_req({}, limit=10, min_duration_ms=10_000_000),
                 {"duration": len(jobs)}),
                (_req({"service.name": "no-such-service"}, limit=10),
                 {"dict": len(jobs)})):
            results, _qs, d = _with_stats(batcher, jobs, req)
            assert results.metrics.skipped_blocks == len(jobs)
            assert d["skipped_blocks"] == want
    finally:
        batcher.close()


def test_mesh_path_populates_metrics():
    batcher = BlockBatcher(CPU, profiling=profile.ON)
    batcher.set_exchange(mesh.LocalExchange(2))
    try:
        req = _req({"service.name": "svc-2"}, limit=500)
        results, _qs, d = _with_stats(batcher, _jobs(_blocks(2)), req)
    finally:
        batcher.close()
    assert results.metrics.inspected_blocks > 0
    assert results.metrics.inspected_traces > 0
    assert d["device_seconds"] > 0 and d["device_stages_ms"]
    assert profile.PROFILER.snapshot()["aggregates"]["mesh"]["execute"]


def test_dist_engine_attributes_to_active_stats():
    pages = ColumnarPages.build(_corpus(128, seed=3), PageGeometry(32, 8))
    eng = DistributedScanEngine(mesh.LocalExchange(2), CPU, top_k=64)
    cq = compile_query(pages.key_dict, pages.val_dict,
                       _req({"service.name": "svc-1"}, limit=20))
    qs = query_stats.begin("t1", None)
    with query_stats.activate(qs):
        # nested: the engine attributes itself, the outer context bills
        # nothing twice
        with query_stats.attributed_dispatch(qs):
            _count, inspected, _s, _i = eng.scan(pages, cq)
    assert inspected > 0
    assert qs.device_seconds > 0 and qs.dispatches == 1


def _fused(engine, batch, mqs, stats, k, structural_plans=False):
    """Submit 8 queries from 8 threads (each under its own stats) to a
    coalescer that flushes at 8: one fused dispatch. Returns the
    coalescer and the finished records it produced."""
    co = QueryCoalescer(engine, window_s=60.0, max_queries=8,
                        active_fn=lambda: 8)
    caught: list = []
    profile.PROFILER.add_listener(caught.append)
    futs: list = []
    lock = threading.Lock()

    def submit(i):
        with query_stats.activate(stats[i]):
            if structural_plans:
                stats[i].add_structural(mqs[i].structural)
            f = co.submit(batch, mqs[i], k[i], peers=8)
            with lock:
                futs.append(f)

    try:
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for f in futs:
            list(f.result(timeout=WAIT_S))     # each member fetches
    finally:
        profile.PROFILER.remove_listener(caught.append)
        co.close()
    return co, [rd for rd in caught if rd.get("mode") == "coalesced"]


def _ref_weight(mq) -> int:
    """The reference coalescer's weight of a member (_attribute's
    table_rows)."""
    w = max(1, int(mq.term_keys.size))
    st = getattr(mq, "structural", None)
    if st is not None:
        w += st.weight()
    return w


def test_conservation_8way_coalesced():
    """8 concurrent queries fuse into one dispatch; each stage's shares
    sum exactly to the record's total, and the members' weights are the
    reference's for the same members."""
    blocks = _blocks(2, 128)
    eng = MultiBlockEngine(CPU, top_k=64, profiling=profile.ON)
    batch = eng.place(eng.stage_host(blocks))
    reqs = [_req({"service.name": f"svc-{i % 6}"}, limit=10 + i)
            for i in range(8)]
    mqs = [compile_multi(blocks, r) for r in reqs]
    ref_blocks = [RefColumnarPages.build(_corpus(128, seed=s, pkg="ref"),
                                         RefPageGeometry(32, 8))
                  for s in range(2)]
    ref_mqs = []
    for i in range(8):
        r = tempopb.SearchRequest()
        r.tags["service.name"] = f"svc-{i % 6}"
        r.limit = 10 + i
        ref_mqs.append(ref_compile_multi(ref_blocks, r))
    assert [_table_weight(m) for m in mqs] == [_ref_weight(m)
                                               for m in ref_mqs]
    stats = [query_stats.QueryStats(f"t{i % 3}") for i in range(8)]
    # the shares are booked with the raw record stages: catch them
    raw = []
    orig = QueryCoalescer._attribute

    def spy(stats_, weights, totals, h2d):
        raw.append((dict(totals), h2d, list(weights)))
        orig(stats_, weights, totals, h2d)

    QueryCoalescer._attribute = staticmethod(spy)
    try:
        co, fused = _fused(eng, batch, mqs, stats,
                           [resolve_top_k(64, m.limit) for m in mqs])
    finally:
        QueryCoalescer._attribute = staticmethod(orig)
    assert co.fused == 1 and co.queries == 8 and len(fused) == 1
    assert len(raw) == 1
    totals, h2d, weights = raw[0]
    assert weights == [_table_weight(m) for m in mqs]
    for stage, total in totals.items():
        assert sum(qs.device_stages.get(stage, 0.0) for qs in stats) \
            == total, stage
    assert sum(qs.h2d_bytes for qs in stats) == h2d
    assert h2d == fused[0]["h2d_bytes"]
    assert {k: round(v * 1e3, 3) for k, v in totals.items()} == \
        fused[0]["stages_ms"]
    for qs in stats:
        assert qs.fused_dispatches == 1 and qs.coalesced_with == 7
        assert qs.device_seconds > 0


def _structural_corpus(pkg: str):
    SD, SpD = ((SearchData, SpanData) if pkg == "port"
               else (RefSearchData, RefSpanData))
    rng = random.Random(7)
    entries = []
    for i in range(128):
        sd = SD(trace_id=i.to_bytes(16, "big"), start_s=1, end_s=5,
                dur_ms=rng.randint(1, 2000),
                kvs={"service.name": {f"svc-{i % 6}"}})
        for j in range(rng.randint(1, 6)):
            sd.spans.append(SpD(
                parent=(-1 if j == 0 else rng.randrange(j)),
                dur_ms=rng.randint(1, 900), kind=rng.randint(0, 5),
                kvs={"service.name": {f"svc-{rng.randint(0, 5)}"}}))
        entries.append(sd)
    return entries


def _plan(i: int) -> str:
    return ('{"child": {"parent": {"tag": {"k": "service.name", '
            '"v": "svc-%d"}}, "child": {"dur": {"min_ms": %d}}}}'
            % (i % 6, 50 * (i + 1)))


def test_conservation_8way_stacked_structural():
    """A fused same-plan structural dispatch splits its stages over the
    members with the structural tables in the weights (the reference's
    weights for the same members), conserving each stage exactly; each
    member's explain tree apportions its own execute share."""
    blocks = [ColumnarPages.build(_structural_corpus("port"),
                                  PageGeometry(64, 8))]
    cfg = structural.StructuralConfig(enabled=True, stack_enabled=True)
    eng = MultiBlockEngine(CPU, top_k=64, structural_cfg=cfg,
                           profiling=profile.ON)
    batch = eng.place(eng.stage_host(blocks))
    mqs = []
    for i in range(8):
        expr = ir.parse(_plan(i))
        req = SearchRequest(limit=64)
        structural.attach_query(req, expr)
        mq = compile_multi(blocks, req)
        mq.structural = structural.compile_structural(
            expr, blocks, entry_kv_slots=8)
        mqs.append(mq)
    g = ref_structural.STRUCTURAL
    g.enabled = True
    ref_blocks = [RefColumnarPages.build(_structural_corpus("ref"),
                                         RefPageGeometry(64, 8))]
    ref_eng = RefEngine(top_k=64)
    ref_batch = ref_eng.stage(ref_blocks)
    ref_w = []
    for i in range(8):
        expr = ref_ir.parse(_plan(i))
        r = tempopb.SearchRequest()
        r.limit = 64
        ref_structural.attach_query(r, expr)
        mq = ref_compile_multi(ref_blocks, r, cache_on=ref_batch)
        mq.structural = ref_structural.compile_structural(
            expr, ref_blocks, cache_on=ref_batch, entry_kv_slots=8)
        ref_w.append(_ref_weight(mq))
        assert mq.structural.node_bytes == mqs[i].structural.node_bytes
        assert mq.structural.node_info == mqs[i].structural.node_info
    assert [_table_weight(m) for m in mqs] == ref_w
    stats = [query_stats.QueryStats(f"t{i % 3}") for i in range(8)]
    co, fused = _fused(eng, batch, mqs, stats,
                       [resolve_top_k(64, m.limit) for m in mqs],
                       structural_plans=True)
    assert co.fused == 1 and co.queries == 8 and co.structural_stacked == 8
    assert len(fused) == 1
    for stage in fused[0]["stages_ms"]:
        got = sum(qs.device_stages[stage] for qs in stats)
        assert got * 1e3 == pytest.approx(fused[0]["stages_ms"][stage],
                                          abs=1e-3)
    for qs in stats:
        d = qs.to_dict()
        nodes = d["structural"]["nodes"]
        assert {n["op"] for n in nodes} >= {"child"}
        assert sum(n["device_ms"] for n in nodes) == pytest.approx(
            qs.device_stages["execute"] * 1e3, abs=1e-3)


def test_concurrent_batcher_searches_all_report_stats():
    batcher = BlockBatcher(CPU, profiling=profile.ON,
                           coalesce_window_s=0.05,
                           coalesce_max_queries=8)
    jobs = _jobs(_blocks(2, 128))
    barrier = threading.Barrier(8)
    out: list = [None] * 8

    def run(i):
        req = _req({"service.name": f"svc-{i % 6}"}, limit=20)
        qs = query_stats.begin(f"tenant-{i % 2}", req)
        barrier.wait()
        with query_stats.activate(qs):
            res = batcher.search(jobs, req)
        out[i] = (res, qs.finish())

    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
    finally:
        batcher.close()
    for res, d in out:
        assert res.metrics.inspected_blocks > 0
        assert res.metrics.inspected_traces > 0
        assert d["device_seconds"] > 0 and d["dispatches"] >= 1
    snap = query_stats.REGISTRY.snapshot()
    assert snap["tenants"]["tenant-0"]["queries"] == 4
    assert snap["tenants"]["tenant-1"]["queries"] == 4
    assert snap["tenants"]["tenant-0"]["device_seconds"] > 0


def test_an_early_quit_still_books_its_abandoned_dispatch():
    """A search that quits at its limit with a dispatch still in flight
    drops its outputs unfetched; the dispatch's record finishes all the
    same and is billed to the query, so every record conserves."""
    batcher = BlockBatcher(CPU, profiling=profile.ON, max_batch_pages=2,
                           pipeline_depth=4,
                           coalesce_max_queries=1)
    jobs = _jobs(_blocks(4, 128))
    seen: list = []
    profile.PROFILER.add_listener(seen.append)
    try:
        req = _req({}, limit=1)
        qs = query_stats.begin("t1", req)
        with query_stats.activate(qs):
            batcher.search(jobs, req)
        d = qs.finish()
    finally:
        profile.PROFILER.remove_listener(seen.append)
        batcher.close()
    batched = [rd for rd in seen if rd["mode"] == "batched"]
    assert batcher.last_dispatches > 1
    assert len(batched) == batcher.last_dispatches == d["dispatches"]


def test_disabled_is_a_true_noop_and_answers_alike():
    batcher = BlockBatcher(CPU, profiling=profile.ON)
    jobs = _jobs(_blocks(2, 128))
    req = _req({"service.name": "svc-1"}, limit=50)
    try:
        assert query_stats.begin("t1", req, enabled=False) is None
        r_off = batcher.search(jobs, req).response()
        published = query_stats.REGISTRY._published
        qs = query_stats.begin("t1", req)
        with query_stats.activate(qs):
            r_on = batcher.search(jobs, req).response()
        qs.finish()
    finally:
        batcher.close()
    assert r_off.traces == r_on.traces
    assert r_off.metrics == r_on.metrics
    assert query_stats.REGISTRY._published == published + 1


def test_explain_rides_the_search_response(corpus):
    _ref, port = _pair(corpus, "explain")
    try:
        req = SearchRequest(limit=100, explain=True)
        resp = port.search(TENANT, req).response()
        resp2 = port.search(TENANT, SearchRequest(limit=100)).response()
    finally:
        port.close()
    assert resp.metrics.device_seconds > 0
    assert resp.metrics.inspected_bytes_device > 0
    d = json.loads(resp.metrics.query_stats_json)
    assert d["tenant"] == TENANT and d["scope"] == "exec"
    assert d["device_seconds"] > 0
    assert d["blocks_inspected"] == resp.metrics.inspected_blocks
    # without explain the JSON stays off, the accounting fields ride
    assert resp2.metrics.device_seconds > 0
    assert not resp2.metrics.query_stats_json


def test_registry_snapshot_ranks_and_aggregates():
    for i, (dev, b) in enumerate(((0.3, 10), (0.1, 100), (0.2, 1))):
        qs = query_stats.QueryStats("t" + str(i % 2))
        qs.add_device_stages({"execute": dev})
        qs.add_inspected(blocks=1, nbytes=b)
        qs.finish()
    snap = query_stats.REGISTRY.snapshot()
    assert [d["device_seconds"] for d in snap["top_by_device_seconds"]] \
        == [0.3, 0.2, 0.1]
    assert [d["bytes_inspected"]["device"]
            for d in snap["top_by_bytes"]] == [100, 10, 1]
    assert snap["tenants"]["t0"]["queries"] == 2
    assert snap["published"] == 3 and len(snap["recent"]) == 3


def test_a_late_share_reaches_the_tenant_bill():
    before = obs.query_device_seconds.value(tenant="late")
    qs = query_stats.QueryStats("late")
    qs.add_device_stages({"execute": 0.25})
    qs.finish()
    qs.add_device_stages({"execute": 0.5})     # after it was published
    assert obs.query_device_seconds.value(tenant="late") == \
        pytest.approx(before + 0.75)
    assert query_stats.REGISTRY.snapshot()["tenants"]["late"][
        "device_seconds"] == pytest.approx(0.75)


def test_merge_child_and_absorb_metrics_sum_the_reference_way():
    child = query_stats.QueryStats("t")
    child.add_device_stages({"execute": 0.002})
    child.add_inspected(blocks=2, nbytes=100)
    child.add_skip("dict", 3)
    child.add_host_probe(0.001, 50)
    d = child.to_dict()
    for mod in (query_stats, ref_query_stats):
        req = mod.QueryStats("t", scope="request")
        req.merge_child(d)
        req.merge_child(d)
        out = req.to_dict()
        assert out["subqueries"] == 2 and out["blocks_inspected"] == 4
        assert out["skipped_blocks"] == {"dict": 6}
        assert out["host_probe"]["bytes"] == 100
    m = SearchRequest()    # any object with the metrics' fields
    m.inspected_blocks, m.inspected_bytes = 3, 30
    m.inspected_bytes_device, m.device_seconds, m.skipped_blocks = 20, 0.5, 1
    qs = query_stats.QueryStats("t", scope="request")
    qs.absorb_metrics(m)
    assert (qs.bytes_device, qs.bytes_host, qs.device_seconds,
            qs.skipped) == (20, 10, 0.5, {"all": 1})


def test_query_summary_unquotes_the_structural_tag():
    r = SearchRequest(limit=5, start=10, end=70,
                      tags={"service.name": "a"})
    structural.attach_query(r, ir.parse(PLAN))
    rr = tempopb.SearchRequest()
    rr.limit, rr.start, rr.end = 5, 10, 70
    rr.tags["service.name"] = "a"
    ref_structural.attach_query(rr, ref_ir.parse(PLAN))
    assert query_stats.query_summary(r) == ref_query_stats.query_summary(rr)
    assert query_stats.query_summary(r)["window_s"] == 60


def test_slow_query_log_emits_one_json_line(caplog):
    query_stats.configure(slow_s=0.0001)
    qs = query_stats.QueryStats("noisy-tenant")
    qs.add_device_stages({"execute": 0.5})
    time.sleep(0.002)
    with caplog.at_level(logging.WARNING,
                         logger="tempo_tpu_torch.slowquery"):
        qs.finish()
    lines = [r.getMessage() for r in caplog.records
             if r.name == "tempo_tpu_torch.slowquery"]
    assert len(lines) == 1
    doc = json.loads(lines[0])
    assert doc["msg"] == "slow query" and doc["tenant"] == "noisy-tenant"
    assert doc["device_seconds"] == 0.5
    assert obs.slow_queries.value(tenant="noisy-tenant") >= 1


def test_slow_query_log_rate_limited(caplog):
    query_stats.configure(slow_s=0.0001)
    with caplog.at_level(logging.WARNING,
                         logger="tempo_tpu_torch.slowquery"):
        for _ in range(50):
            qs = query_stats.QueryStats("flood")
            time.sleep(0.0002)
            qs.finish()
    lines = [r for r in caplog.records
             if r.name == "tempo_tpu_torch.slowquery"]
    assert len(lines) <= 6
    assert obs.slow_queries.value(tenant="flood") >= 50


def test_per_tenant_counters_accumulate():
    before_dev = obs.query_device_seconds.value(tenant="bill-me")
    before_b = obs.query_bytes_inspected.value(tenant="bill-me",
                                               placement="device")
    qs = query_stats.QueryStats("bill-me")
    qs.add_device_stages({"execute": 0.25, "h2d": 0.05})
    qs.add_inspected(blocks=2, nbytes=1 << 20, placement="device")
    qs.add_inspected(nbytes=1 << 10, placement="host")
    qs.finish()
    assert obs.query_device_seconds.value(tenant="bill-me") == \
        pytest.approx(before_dev + 0.30)
    assert obs.query_bytes_inspected.value(
        tenant="bill-me", placement="device") == before_b + (1 << 20)
    assert obs.query_bytes_inspected.value(
        tenant="bill-me", placement="host") >= 1 << 10


def test_request_scope_does_not_book_tenant_counters():
    before = obs.query_device_seconds.value(tenant="front-only")
    qs = query_stats.QueryStats("front-only", scope="request")
    qs.add_device_stages({"execute": 1.0})
    qs.finish()
    assert obs.query_device_seconds.value(tenant="front-only") == before
    assert any(e["tenant"] == "front-only"
               for e in query_stats.REGISTRY.snapshot()["recent"])


def test_nested_attribution_bills_once():
    qs = query_stats.QueryStats("t1")
    with query_stats.attributed_dispatch(qs, CPU):
        with query_stats.attributed_dispatch(qs, CPU):
            time.sleep(0.005)
    assert qs.dispatches == 1
    with query_stats.attributed_dispatch(qs, CPU):
        time.sleep(0.001)
    assert qs.dispatches == 2


def test_slow_counter_books_once_per_query_per_process(caplog):
    query_stats.configure(slow_s=0.0001)
    before = obs.slow_queries.value(tenant="scoped")
    with caplog.at_level(logging.WARNING,
                         logger="tempo_tpu_torch.slowquery"):
        with query_stats.fronted():
            for _ in range(4):
                qs = query_stats.QueryStats("scoped")
                time.sleep(0.001)
                qs.finish()
        qreq = query_stats.QueryStats("scoped", scope="request")
        time.sleep(0.001)
        qreq.finish()
    assert obs.slow_queries.value(tenant="scoped") == before + 1
    lines = [r for r in caplog.records
             if r.name == "tempo_tpu_torch.slowquery"]
    assert len(lines) == 1
    qs2 = query_stats.QueryStats("scoped")
    time.sleep(0.001)
    qs2.finish()
    assert obs.slow_queries.value(tenant="scoped") == before + 2


def test_slow_log_limiter_is_per_tenant():
    query_stats.configure(slow_s=0.0001)
    lim = query_stats.REGISTRY._limiter
    for _ in range(50):
        lim.allow("flood-a")
    assert not lim.allow("flood-a")
    assert lim.allow("quiet-b")


def test_fronted_exec_suppresses_slow_log_line(caplog):
    query_stats.configure(slow_s=0.0001)
    before = obs.slow_queries.value(tenant="one-line")
    with caplog.at_level(logging.WARNING,
                         logger="tempo_tpu_torch.slowquery"):
        with query_stats.fronted():
            qs = query_stats.QueryStats("one-line")
            time.sleep(0.001)
            qs.finish()
        qs2 = query_stats.QueryStats("one-line", scope="request")
        time.sleep(0.001)
        qs2.finish()
    lines = [r for r in caplog.records
             if r.name == "tempo_tpu_torch.slowquery"]
    assert len(lines) == 1
    assert json.loads(lines[0].getMessage())["scope"] == "request"
    assert obs.slow_queries.value(tenant="one-line") == before + 1


def test_the_metrics_labels_equal_the_reference_for_one_search(corpus):
    """The families both packages book for one search carry the same
    label names."""
    from tempo_tpu.observability import metrics as ref_obs

    ref, port = _pair(corpus, "labels")
    try:
        tags, kw = _requests()["tag_exhaustive"]
        ref.search(TENANT, _ref_req(tags, kw))
        port.search(TENANT, _port_req(tags, kw))
    finally:
        port.close()
    for name in ("tempo_search_dispatch_stage_seconds",
                 "tempo_search_jit_cache_events_total",
                 "tempo_search_query_device_seconds_total",
                 "tempo_search_query_bytes_inspected_total",
                 "tempo_search_query_stage_seconds",
                 "tempo_search_fallback_scans_total"):
        pm, rm = obs.REGISTRY.get(name), ref_obs.REGISTRY.get(name)
        port_keys = {tuple(k for k, _v in key) for key in
                     (pm._counts if pm.kind == "histogram" else pm._series)}
        ref_keys = {tuple(k for k, _v in key) for key in
                    (rm._counts if rm.kind == "histogram" else rm._series)}
        assert port_keys and port_keys <= ref_keys, name


# ---------------------------------------------------------------------------
# process settings, default gates, and no host-clock device time on a card


def test_a_database_sets_none_of_the_process_settings(tmp_path):
    """The slow-query threshold and the two rings are the process's: a
    database built afterwards with its defaults leaves them as set."""
    old = (query_stats.REGISTRY.slow_s, query_stats.REGISTRY._ring.maxlen,
           profile.PROFILER._ring.maxlen)
    try:
        query_stats.configure(slow_s=3.5, ring_size=7)
        profile.configure(ring_size=5)
        db = TempoDB(LocalBackend(str(tmp_path)), TempoDBConfig(),
                     device="cpu")
        db.close()
        assert (query_stats.REGISTRY.slow_s,
                query_stats.REGISTRY._ring.maxlen,
                profile.PROFILER._ring.maxlen) == (3.5, 7, 5)
    finally:
        query_stats.configure(slow_s=old[0], ring_size=old[1])
        profile.configure(ring_size=old[2])
    names = set(TempoDBConfig.__dataclass_fields__)
    assert {"search_query_stats_enabled", "search_profiling_enabled",
            "search_profiling_fence"} <= names
    assert not names & {"search_profiling_ring", "search_query_stats_ring",
                        "search_slow_query_log_s"}


def test_engines_default_to_the_off_gate(tmp_path):
    """Every engine's default gate is the one default, off; a database
    hands its own gate down."""
    batcher = BlockBatcher(CPU)
    try:
        assert batcher.engine.profiling is profile.OFF
    finally:
        batcher.close()
    meta = BlockMeta(tenant_id=TENANT, block_id="b")
    assert BackendSearchBlock(LocalBackend(str(tmp_path)), meta,
                              device="cpu").profiling is profile.OFF
    assert DistributedScanEngine(mesh.LocalExchange(2),
                                 CPU).profiling is profile.OFF
    assert MultiBlockEngine(CPU).profiling is profile.OFF
    db = TempoDB(LocalBackend(str(tmp_path)), TempoDBConfig(), device="cpu")
    try:
        assert db.batcher.engine.profiling is db.profiling
        assert db.profiling.enabled and db.profiling is not profile.ON
    finally:
        db.close()


@pytest.mark.parametrize("device,booked", [
    (CPU, True), ("cpu", True), (torch.device("cuda"), False), (None, False)])
def test_attributed_dispatch_books_wall_time_on_the_cpu_only(device, booked):
    """With no record opened (profiling off), the body's wall time is the
    device's only where the plain versions run synchronously: on a CUDA
    device the host's time to issue launches is not device time, and
    nothing is booked."""
    qs = query_stats.QueryStats("wall")
    with query_stats.attributed_dispatch(qs, device):
        time.sleep(0.002)
    if booked:
        assert qs.device_stages["execute"] >= 0.002 and qs.dispatches == 1
    else:
        assert qs.device_stages == {} and qs.dispatches == 0
        assert qs.to_dict()["device_seconds"] == 0


class _StubEngine:
    """An engine whose launches open no record (profiling off)."""

    structural_cfg = structural.OFF

    def __init__(self, device):
        self.device = device

    def scan_async(self, batch, mq):
        time.sleep(0.002)
        return (torch.zeros(2),)


@pytest.mark.parametrize("device,booked", [
    (CPU, True), (torch.device("cuda"), False)])
def test_the_coalescer_books_no_wall_time_on_a_cuda_device(device, booked):
    import concurrent.futures
    from types import SimpleNamespace

    import numpy as np

    from tempo_tpu_torch.search.batcher import _PendingCoalesce

    coal = QueryCoalescer(_StubEngine(device), max_queries=8)
    grp = _PendingCoalesce(batch=None, gen=0)
    qs = query_stats.QueryStats("coalesced")
    mq = SimpleNamespace(structural=None, term_keys=np.zeros(3))
    grp.items.append((mq, 20, concurrent.futures.Future(), qs))
    outs = coal._dispatch(grp)
    assert len(outs) == 1 and coal.dispatches == 1
    if booked:
        assert qs.device_stages["execute"] >= 0.002 and qs.dispatches == 1
    else:
        assert qs.device_stages == {} and qs.dispatches == 0


def test_a_record_the_reaper_lost_raises_at_the_next_settle():
    """A detached record whose events the reaper cannot read leaves its
    dispatch without its share: the next query to settle raises."""

    class Ev:
        def __init__(self, done):
            self.done = done

        def query(self):
            return self.done

        def synchronize(self):
            self.done = True

        def elapsed_time(self, other):
            raise RuntimeError("event not recorded")

    rec = profile.Dispatch(profile.PROFILER, "dict_probe", CPU)
    rec._ev = (Ev(True), Ev(False))
    qs = query_stats.QueryStats("lost")
    qs.track(rec)
    rec.detach()
    lost = profile.PROFILER.lost
    try:
        qs.settle()                       # pending: to the reaper
        for _ in range(300):
            if profile.PROFILER.lost > lost:
                break
            time.sleep(0.01)
        assert profile.PROFILER.lost == lost + 1 and not rec.finished
        with pytest.raises(RuntimeError, match="lost"):
            query_stats.QueryStats("next").finish()
        query_stats.QueryStats("after").finish()     # raised once
    finally:
        with profile.PROFILER._lock:
            profile.PROFILER._detached = [
                r for r in profile.PROFILER._detached if r is not rec]
            profile.PROFILER._lost_errors = []
