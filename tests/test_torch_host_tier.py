"""The staged cache's host-RAM tier, prewarm and restartable host state on
the port against the reference's.

The reference's ``tests/test_db.py`` tests of the host tier, prewarm and
the header snapshot, on the port, over blocks the reference's write path
wrote (its WAL, ``complete_block``): an evicted batch re-stages from the
host tier with no backend read; the tier keeps its budget; prewarm
stages before the first query; a restarted database plans without
reading a header; a torn snapshot is ignored; host state can be turned
off. Each compared with the reference over the same blocks. Then what
the port adds: a dispatch of any route leaves the host tier's arrays
unchanged (on the CPU a placed batch aliases them); a prewarm racing a
query stages each group once; the throwaway dispatches run once a batch
layout and book no query stats; the reference's snapshot loads in the
port.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time

import numpy as np
import pytest

from tempo_tpu.backend.local import LocalBackend as RefLocalBackend
from tempo_tpu.db import TempoDB as RefTempoDB
from tempo_tpu.db import TempoDBConfig as RefTempoDBConfig
from tempo_tpu.model import segment_codec_for as ref_segment_codec_for
from tempo_tpu.observability import metrics as ref_obs
from tempo_tpu.search import extract_search_data as ref_extract
from tempo_tpu.search import pipeline as ref_pipeline
from tempo_tpu.utils.test_data import make_trace

from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.backend.types import NAME_SEARCH_HEADER
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.model.types import SearchRequest
from tempo_tpu_torch.observability import metrics as obs
from tempo_tpu_torch.parallel import multihost_dryrun as md
from tempo_tpu_torch.search import ir, query_stats, structural
from tempo_tpu_torch.search.analytics import attach_agg

from tests.test_search import _mk_req


@pytest.fixture(autouse=True)
def _fresh_state():
    ref_pipeline._COMPILE_CACHE.clear()
    yield
    ref_pipeline._COMPILE_CACHE.clear()


def _ingest(db, tenant, n, seed_base=0) -> None:
    """The reference's write path: n traces through its WAL and search
    extraction into one completed block (``tests/test_db.py``)."""
    import random

    blk = db.wal.new_block(tenant)
    sc = ref_segment_codec_for("v2")
    rng = random.Random(seed_base)
    entries = {}
    for i in range(n):
        tid = rng.randbytes(16)
        tr = make_trace(tid, seed=seed_base + i)
        sd = ref_extract(tid, tr)
        blk.append(tid, sc.prepare_for_write(tr, sd.start_s, sd.end_s),
                   sd.start_s, sd.end_s)
        entries[tid] = sd
    db.complete_block(blk, [entries[t] for t in sorted(entries)])
    blk.clear()


def _write(tmp_path, blocks: int, n: int = 4, step: int = 50):
    writer = RefTempoDB(RefLocalBackend(str(tmp_path / "blocks")),
                        str(tmp_path / "ref-writer-wal"),
                        RefTempoDBConfig(host_state_dir=""))
    for b in range(blocks):
        _ingest(writer, "t1", n, seed_base=b * step)


def _ref_db(tmp_path, tag: str = "ref", **cfg) -> RefTempoDB:
    cfg.setdefault("host_state_dir", "")
    return RefTempoDB(RefLocalBackend(str(tmp_path / "blocks")),
                      str(tmp_path / f"{tag}-wal"), RefTempoDBConfig(**cfg))


def _port_db(tmp_path, wal_dir=None, **cfg) -> TempoDB:
    return TempoDB(LocalBackend(str(tmp_path / "blocks")),
                   TempoDBConfig(**cfg), device="cpu",
                   wal_dir=None if wal_dir is None else str(wal_dir))


def _all(limit=10_000, **kw) -> tuple:
    return SearchRequest(tags={}, limit=limit, **kw), _mk_req({}, limit=limit)


def _ids(resp) -> set:
    return {t.trace_id for t in resp.traces}


def _count_reads(backend) -> list:
    reads = []
    real = backend.read

    def counting(*a, **kw):
        reads.append(a[2] if len(a) > 2 else kw.get("name"))
        return real(*a, **kw)

    backend.read = counting
    return reads


def _evict_hbm(batcher) -> None:
    """Empty the device tier, keep the host tier."""
    with batcher._lock:
        batcher._cache.clear()
        batcher._cache_total = batcher._cache_logical = 0
        batcher._probe_dict_total = 0


def test_host_tier_survives_hbm_eviction(tmp_path):
    """A batch the device tier evicted re-stages from the host tier (one
    host-to-device copy), with no read of the backend, and answers as
    before, as the reference's does."""
    _write(tmp_path, 3)
    db, ref = _port_db(tmp_path), _ref_db(tmp_path)
    try:
        for d in (db, ref):
            d.poll()
        req, rreq = _all()
        r1 = db.search("t1", req).response()
        rr1 = ref.search("t1", rreq).response()
        assert _ids(r1) == _ids(rr1) and len(r1.traces) == 12
        assert db.batcher._host_total > 0
        reads, rreads = _count_reads(db.backend), _count_reads(ref.backend)
        _evict_hbm(db.batcher)
        _evict_hbm(ref.batcher)
        h0 = obs.batch_cache_events.value(result="host_hit")
        rh0 = ref_obs.batch_cache_events.value(result="host_hit")
        r2 = db.search("t1", req).response()
        rr2 = ref.search("t1", rreq).response()
        assert obs.batch_cache_events.value(result="host_hit") - h0 == \
            ref_obs.batch_cache_events.value(result="host_hit") - rh0 > 0
        assert reads == [] and rreads == []
        assert _ids(r2) == _ids(r1) == _ids(rr2)
        assert r2.metrics.inspected_traces == r1.metrics.inspected_traces \
            == rr2.metrics.inspected_traces
    finally:
        db.close()


def test_host_tier_budget_evicts(tmp_path):
    """The host tier keeps its byte budget: below any batch, at most one
    entry (it keeps one), as the reference's; each eviction counted."""
    _write(tmp_path, 4)
    db, ref = _port_db(tmp_path), _ref_db(tmp_path)
    try:
        for d in (db, ref):
            d.poll()
            d.batcher.max_batch_pages = 1     # one group a block
            d.batcher.host_cache_bytes = 1    # below any batch
        req, rreq = _all()
        e0 = obs.batch_cache_events.value(result="host_evict")
        r = db.search("t1", req).response()
        rr = ref.search("t1", rreq).response()
        assert _ids(r) == _ids(rr)
        assert len(db.batcher._host_cache) <= 1
        assert len(ref.batcher._host_cache) <= 1
        assert obs.batch_cache_events.value(result="host_evict") - e0 == 3
        stats = db.batcher.debug_stats()["host_cache"]
        assert set(stats) == set(ref.batcher.debug_stats()["host_cache"])
        assert stats["batches"] == 1 and stats["budget_bytes"] == 1
        assert db.batcher._host_total == \
            sum(h.nbytes for h in db.batcher._host_cache.values())
    finally:
        db.close()


def test_prewarm_stages_before_first_query(tmp_path):
    """prewarm stages every group (and makes its throwaway dispatches), so
    the first query hits the staged cache, as the reference's."""
    _write(tmp_path, 3, step=40)
    db, ref = _port_db(tmp_path), _ref_db(tmp_path)
    try:
        for d in (db, ref):
            d.poll()
        staged = db.prewarm(["t1"], background=False)
        assert staged >= 1
        assert staged == ref.prewarm(["t1"], background=False)
        h0 = obs.batch_cache_events.value(result="hit")
        req, rreq = _all(explain=True)
        r = db.search("t1", req).response()
        assert len(r.traces) == 12
        assert _ids(r) == _ids(ref.search("t1", rreq).response())
        assert obs.batch_cache_events.value(result="hit") > h0
        cache = json.loads(r.metrics.query_stats_json)["cache"]
        assert set(cache) == {"hbm_hit"}
    finally:
        db.close()


def test_prewarm_on_poll_runs_in_the_background(tmp_path):
    """With ``search_prewarm_on_poll`` a poll starts a background prewarm;
    the next poll cancels it and starts another; close stops it."""
    _write(tmp_path, 3)
    db = _port_db(tmp_path, search_prewarm_on_poll=True)
    try:
        db.poll()
        first = db._prewarm_thread
        assert isinstance(first, threading.Thread)
        first.join(60)
        req, _ = _all(explain=True)
        cache = json.loads(db.search("t1", req).response()
                           .metrics.query_stats_json)["cache"]
        assert set(cache) == {"hbm_hit"}
        db.poll()
        assert db._prewarm_thread is not first
    finally:
        db.close()
    assert not db._prewarm_thread.is_alive()
    assert db._prewarm_stop.is_set()


def test_a_stopped_prewarm_stages_nothing(tmp_path):
    _write(tmp_path, 2)
    db = _port_db(tmp_path)
    try:
        db.poll()
        jobs, _ = db._jobs("t1", db.blocklist.epoch())
        stop = threading.Event()
        stop.set()
        assert db.batcher.prewarm(db.batcher.plan(jobs), stop=stop) == 0
        assert not db.batcher._cache and not db.batcher._host_cache
    finally:
        db.close()


def test_header_snapshot_restart_skips_backend_reads(tmp_path):
    """A restarted database on the same WAL directory loads the header
    snapshot: its first query's planning reads no header."""
    _write(tmp_path, 1, n=6)
    wal = tmp_path / "port-wal"
    db = _port_db(tmp_path, wal_dir=wal)
    req, _ = _all(limit=10)
    try:
        db.poll()
        db.search("t1", req)
        db.save_host_state()
    finally:
        db.close()
    assert (wal / "host-state" / "search-headers.json.gz").exists()
    db2 = _port_db(tmp_path, wal_dir=wal)
    reads = _count_reads(db2.backend)
    try:
        db2.poll()
        assert db2.search("t1", req).metrics.inspected_blocks >= 1
    finally:
        db2.close()
    assert NAME_SEARCH_HEADER not in reads, \
        "the restart read block headers despite the snapshot"


def test_the_reference_snapshot_loads_in_the_port(tmp_path):
    """Both packages write one format: the reference's snapshot, read by
    the port through ``host_state_dir``, plans with no header read."""
    _write(tmp_path, 2, n=5)
    ref = _ref_db(tmp_path, host_state_dir=None)
    ref.poll()
    ref.search("t1", _mk_req({}, limit=10))
    ref.save_host_state()
    state = tmp_path / "ref-wal" / "host-state"
    db = _port_db(tmp_path, host_state_dir=str(state))
    reads = _count_reads(db.backend)
    try:
        db.poll()
        r = db.search("t1", _all(limit=100)[0]).response()
    finally:
        db.close()
    assert NAME_SEARCH_HEADER not in reads
    assert len(r.traces) == 10


def test_header_snapshot_corrupt_is_ignored(tmp_path):
    _write(tmp_path, 1, n=3)
    wal = tmp_path / "port-wal"
    snap = wal / "host-state" / "search-headers.json.gz"
    snap.parent.mkdir(parents=True)
    snap.write_bytes(b"\x1f\x8bgarbage-not-gzip")
    db = _port_db(tmp_path, wal_dir=wal)     # must not raise
    try:
        db.poll()
        assert db.search("t1", _all(limit=10)[0]).metrics \
            .inspected_blocks >= 1
    finally:
        db.close()


def test_host_state_opt_out(tmp_path):
    _write(tmp_path, 1, n=2)
    wal = tmp_path / "port-wal"
    db = _port_db(tmp_path, wal_dir=wal, host_state_dir="")
    try:
        db.poll()
    finally:
        db.close()
    assert not (wal / "host-state").exists()
    # without a WAL directory there is no default place for it
    db = _port_db(tmp_path)
    try:
        db.poll()
        assert db._snapshot_path() is None
    finally:
        db.close()


def test_invalidate_drops_both_tiers(tmp_path):
    _write(tmp_path, 2)
    db = _port_db(tmp_path)
    try:
        db.poll()
        db.search("t1", _all()[0])
        assert db.batcher._cache and db.batcher._host_cache
        db.batcher.invalidate(set())
        assert not db.batcher._cache and not db.batcher._host_cache
        assert db.batcher._host_total == db.batcher._host_logical == 0
        assert db.batcher._cache_total == 0
    finally:
        db.close()


# ---------------------------------------------------------------------------
# what the port adds


DESC = ('{"desc": {"anc": {"tag": {"k": "service.name", "v": "db"}}, '
        '"span": {"kind": "client"}}}')


def _md_requests() -> list:
    """Every route: tag (ranges), the probe (hit masks), exhaustive, a
    structural plan, an aggregate and its tag twin."""
    plan = SearchRequest(tags={}, limit=1000)
    structural.attach_query(plan, ir.parse(DESC))
    agg = SearchRequest(tags={"service.name": "cart"}, limit=5)
    attach_agg(agg, "red")
    return [SearchRequest(tags={"service.name": "frontend"},
                          min_duration_ms=100, limit=1000),
            SearchRequest(tags={"session.id": "s-03-00"}, limit=20),
            SearchRequest(tags={"session.id": "-00", "x-dbg-exhaustive": ""},
                          limit=20),
            plan, agg]


def _host_digest(batcher) -> dict:
    """sha256 of every array the host tier holds, by group."""
    out = {}
    with batcher._lock:
        items = list(batcher._host_cache.items())
    for key, host in items:
        h = hashlib.sha256()
        arrays = list(host.cat.values()) + list((host.span_cat or {})
                                                .values())
        for pd in host.packed_dicts.values():
            arrays += [pd.buf, pd.off]
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        out[key] = h.hexdigest()
    return out


@pytest.mark.parametrize("packed", [False, True])
def test_a_dispatch_leaves_the_host_tier_unchanged(tmp_path, packed):
    """On the CPU a placed batch may alias its host batch's arrays: no
    route's dispatch (tag, probe, exhaustive, structural, ?agg=, and
    fused) may write into them. A device budget of one byte re-stages
    every group from the host tier between dispatches."""
    md.build_corpus(str(tmp_path))
    db = TempoDB(LocalBackend(str(tmp_path / "blocks")), TempoDBConfig(
        search_device_probe_min_vals=64, search_max_batch_pages=16,
        search_structural_enabled=True, search_analytics_enabled=True,
        search_packed_residency=packed, search_batch_cache_bytes=1,
        search_coalesce_window_s=0.05), device="cpu")
    try:
        db.poll()
        reqs = _md_requests()
        first = [md.digest(db.search(md.TENANT, r)) for r in reqs]
        before = _host_digest(db.batcher)
        assert len(before) > 1
        again = [md.digest(db.search(md.TENANT, r)) for r in reqs]
        # the fused route: concurrent searches over one staged batch
        barrier = threading.Barrier(4)
        got = [None] * 4

        def one(i):
            barrier.wait(30)
            got[i] = md.digest(db.search(md.TENANT, reqs[i % 2]))

        ts = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        after = _host_digest(db.batcher)
    finally:
        db.close()
    assert again == first
    assert got == [first[i % 2] for i in range(4)]
    assert after == before


def test_prewarm_racing_a_query_stages_each_group_once(tmp_path):
    """A background prewarm and a query stage through the same
    ``_staged``: racing on a group, they stage it once."""
    md.build_corpus(str(tmp_path))
    db = TempoDB(LocalBackend(str(tmp_path / "blocks")), TempoDBConfig(
        search_max_batch_pages=16), device="cpu")
    stacked: list = []
    real = db.batcher.engine.stage_host

    def slow_stage_host(blocks):
        stacked.append(tuple(id(b) for b in blocks))
        time.sleep(0.05)              # widen the race
        return real(blocks)

    db.batcher.engine.stage_host = slow_stage_host
    plain = TempoDB(LocalBackend(str(tmp_path / "blocks")),
                    TempoDBConfig(search_max_batch_pages=16), device="cpu")
    try:
        db.poll()
        plain.poll()
        n_groups = len(db.batcher.plan(db._jobs(md.TENANT,
                                                db.blocklist.epoch())[0]))
        want = md.digest(plain.search(md.TENANT, _md_requests()[2]))
        t = db.prewarm([md.TENANT])
        got = md.digest(db.search(md.TENANT, _md_requests()[2]))
        t.join(60)
    finally:
        db.close()
        plain.close()
    assert want["inspected_blocks"] > 0
    assert got == want
    assert len(stacked) == len(set(stacked)) == n_groups


def test_warm_compile_dispatches_once_a_layout_and_books_no_stats(
        tmp_path):
    """The throwaway dispatches: term counts 0 and 2, once a batch layout
    (every group of the corpus has one), in no query's stats."""
    md.build_corpus(str(tmp_path))
    db = TempoDB(LocalBackend(str(tmp_path / "blocks")), TempoDBConfig(
        search_max_batch_pages=16), device="cpu")
    calls = []
    real = db.batcher.engine.scan_async

    def counting(batch, mq):
        calls.append(mq.n_terms)
        return real(batch, mq)

    db.batcher.engine.scan_async = counting
    query_stats.REGISTRY.reset()
    try:
        db.poll()
        staged = db.prewarm([md.TENANT], background=False)
        assert staged > 1
        assert sorted(calls) == [0, 2] * (len(db.batcher._warmed))
        assert len(db.batcher._warmed) == 1
        assert query_stats.REGISTRY.snapshot()["recent"] == []
        again = db.prewarm([md.TENANT], background=False)
    finally:
        db.close()
    assert again == 0 and len(calls) == 2
