"""High-cardinality tag search through the device-probe route, end to end,
against the reference.

The reference writes search blocks into a LocalBackend directory: most
carry a per-trace ``session.id`` that is unique across the corpus (a
value dictionary of hundreds of values), a few carry only low-cardinality
tags. Both packages lower ``search_device_probe_min_vals`` to 64 — the
reference's own setting, which keeps its meaning (None = 50k, <= 0 =
host only) — so the session blocks stage their dictionaries and probe on
the device at test size while the small ones keep the range path, and
one batch mixes both. The reference runs on JAX's CPU backend, the port
on the CPU with the kernels' plain versions.

Compared exactly, for ``TempoDB.search``, ``TempoDB.search_block`` and
``BackendSearchBlock.search``: the result trace sets with start,
duration and root names, their order, and inspected traces, blocks and
bytes, skipped blocks and truncated entries. Spies on the kernel
wrappers show that the port took the probe (K3), K1's hit-mask mode and
K1s where it should, and skipped K3 for a needle longer than 64 bytes.
"""

from __future__ import annotations

import gc
import weakref

import numpy as np
import pytest

from tempo_tpu import tempopb
from tempo_tpu.backend.local import LocalBackend as RefLocalBackend
from tempo_tpu.backend.types import BlockMeta as RefBlockMeta
from tempo_tpu.db import TempoDB as RefTempoDB
from tempo_tpu.db import TempoDBConfig as RefTempoDBConfig
from tempo_tpu.search.backend_search_block import \
    BackendSearchBlock as RefBackendSearchBlock
from tempo_tpu.search.backend_search_block import \
    write_search_block as ref_write_search_block
from tempo_tpu.search.columnar import PageGeometry as RefPageGeometry
from tempo_tpu.search.data import SearchData as RefSearchData

from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.model.types import SearchBlockRequest, SearchRequest
from tempo_tpu_torch.search import batcher as port_batcher
from tempo_tpu_torch.search import engine as port_engine
from tempo_tpu_torch.search import multiblock as port_multiblock
from tempo_tpu_torch.search.analytics import attach_agg
from tempo_tpu_torch.search.backend_search_block import BackendSearchBlock
from tempo_tpu_torch.search.kernels import probe as probe_k

TENANT = "t1"
E = 32            # entries per page
MAX_PAGES = 16    # pages per group: several blocks, and both routes, a group
PROBE_MIN = 64
BASE_S = 1_700_000_000
SERVICES = [f"svc-{i:02d}" for i in range(12)]
LONG_URL = "/api/v1/" + "segment/" * 8 + "end"   # 75 bytes


def _block_entries(rng, b: int, n: int, first_session: int,
                   sessions: bool) -> list:
    out = []
    for j in range(n):
        start = BASE_S + b * 1800 + int(rng.integers(0, 1800))
        dur_ms = int(rng.integers(1, 30_000))
        sd = RefSearchData(
            trace_id=rng.bytes(16), start_s=start,
            end_s=start + dur_ms // 1000, dur_ms=dur_ms,
            root_service=SERVICES[int(rng.integers(len(SERVICES)))],
            root_name=f"op-{int(rng.integers(4))}")
        sd.kvs = {
            "service.name": {sd.root_service},
            "http.status_code": {["200", "404", "500"][
                int(rng.integers(3))]},
            "region": {["us-east-1", "us-west-2", "eu-west-1"][
                int(rng.integers(3))]},
            "name": {sd.root_name},
            # five keys on every trace: both kinds of block get C = 8 and
            # share a geometry bucket, so groups mix them
            "host.name": {f"host-{int(rng.integers(8))}"},
        }
        if sessions:
            sd.kvs["session.id"] = {f"session-{first_session + j:07d}"}
            if j % 37 == 0:
                sd.kvs["http.url"] = {LONG_URL + f"?n={j}"}
        out.append(sd)
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """14 blocks written by the reference: 9 with unique session ids, 5
    with low-cardinality tags only. Block b's id sorts b-th, so group
    planning (jobs in block-id order) is the same in every run."""
    root = tmp_path_factory.mktemp("torch_highcard")
    be = RefLocalBackend(str(root / "blocks"))
    rng = np.random.default_rng(20261018)
    geometry = RefPageGeometry(entries_per_page=E, kv_per_entry=8)
    first = 0
    for b in range(14):
        n = int(rng.integers(90, 200))
        entries = _block_entries(rng, b, n, first, sessions=b % 3 != 1)
        first += n
        meta = RefBlockMeta(tenant_id=TENANT,
                            block_id=f"00000000-0000-4000-8000-{b:012d}")
        ref_write_search_block(be, meta, entries, geometry=geometry,
                               encoding="zlib")
    return root


def _requests():
    def req(tags=None, **kw):
        return tags or {}, kw

    ex = {"x-dbg-exhaustive": ""}
    return {
        "exhaustive_scattered": req(dict(ex, **{"session.id": "77"}),
                                    limit=50),
        "point": req({"session.id": "session-0000123"}),
        "prefix": req({"session.id": "session-000123"}),
        "scattered_and_service": req({"session.id": "77",
                                      "service.name": "svc-07"}),
        "mixed_routes_service": req({"service.name": "svc-1"}, limit=40),
        "mixed_routes_region": req({"region": "west",
                                    "http.status_code": "5"}),
        "no_session_hits": req({"session.id": "zzz"}),
        "long_needle_host_route": req({"http.url": LONG_URL[:65]}),
        "absent_key": req({"no.such": "x"}),
        "absent_key_exhaustive": req(dict(ex, **{"no.such": "",
                                                 "service.name": "svc-0"})),
        "window_duration": req({"session.id": "1"},
                               start=BASE_S + 3 * 1800 + 300,
                               end=BASE_S + 8 * 1800, min_duration_ms=5_000),
    }


PROBED = {"exhaustive_scattered", "point", "prefix", "scattered_and_service",
          "mixed_routes_service", "mixed_routes_region", "no_session_hits",
          "absent_key_exhaustive", "window_duration"}


def _ref_req(tags, kw):
    r = tempopb.SearchRequest()
    for k, v in tags.items():
        r.tags[k] = v
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def _traces(resp) -> list:
    return [(t.trace_id, t.start_time_unix_nano, t.duration_ms,
             t.root_service_name, t.root_trace_name) for t in resp.traces]


def _metrics(m) -> tuple:
    return (m.inspected_traces, m.inspected_blocks, m.skipped_blocks,
            m.inspected_bytes, m.truncated_entries)


def _assert_same(got, want):
    assert _traces(got) == _traces(want)
    assert _metrics(got.metrics) == _metrics(want.metrics)


class _Spy:
    """Counts calls of the kernel wrappers on the port's paths: K3, K1 in
    each mode, K1s in each mode."""

    def __init__(self, monkeypatch):
        self.n = {"probe": 0, "multi_hits": 0, "multi_ranges": 0,
                  "single_hits": 0, "single_ranges": 0}
        real_probe = probe_k.dict_probe
        real_multi = port_multiblock.multi_scan
        real_single = port_engine.scan_single

        def probe(*a):
            self.n["probe"] += 1
            return real_probe(*a)

        def multi(*a):
            self.n["multi_hits" if a[14] is not None
                   else "multi_ranges"] += 1
            return real_multi(*a)

        def single(*a):
            self.n["single_hits" if a[13] is not None
                   else "single_ranges"] += 1
            return real_single(*a)

        monkeypatch.setattr(probe_k, "dict_probe", probe)
        monkeypatch.setattr(port_multiblock, "multi_scan", multi)
        monkeypatch.setattr(port_engine, "scan_single", single)


@pytest.fixture
def spy(monkeypatch):
    return _Spy(monkeypatch)


@pytest.fixture(scope="module")
def dbs(corpus, tmp_path_factory):
    wal = tmp_path_factory.mktemp("torch_highcard_wal")
    ref = RefTempoDB(
        RefLocalBackend(str(corpus / "blocks")), str(wal),
        RefTempoDBConfig(search_max_batch_pages=MAX_PAGES, auto_mesh=False,
                         host_state_dir="",
                         search_device_probe_min_vals=PROBE_MIN))
    port = TempoDB(LocalBackend(str(corpus / "blocks")),
                   TempoDBConfig(search_max_batch_pages=MAX_PAGES,
                                 search_device_probe_min_vals=PROBE_MIN),
                   device="cpu")
    ref.poll()
    port.poll()
    # stage every group in both first, so early quits scan the same groups
    tags, kw = _requests()["exhaustive_scattered"]
    _assert_same(port.search(TENANT, SearchRequest(tags=dict(tags), **kw))
                 .response(),
                 ref.search(TENANT, _ref_req(tags, kw)).response())
    yield ref, port
    port.close()


def test_corpus_mixes_probed_and_range_blocks(dbs):
    """Staged batches hold session dictionaries (>= 64 values) and not the
    small ones, and some group holds both kinds."""
    _ref, port = dbs
    mixed = False
    for cached in port.batcher._cache.values():
        batch = cached.batch
        big = [len(b.val_dict) >= PROBE_MIN for b in batch.blocks]
        assert len(batch.staged_dicts) == sum(big)
        mixed |= any(big) and not all(big)
    assert mixed
    assert port.batcher._probe_dict_total == sum(
        c.batch.dict_nbytes for c in port.batcher._cache.values()) > 0


@pytest.mark.parametrize("name", list(_requests()))
def test_search_matches_reference(dbs, spy, name):
    """TempoDB.search, run twice: the first compiles (cold), the second
    runs from the compile cache, which hides the probe."""
    ref, port = dbs
    tags, kw = _requests()[name]
    port.batcher.engine.compile_cache = type(
        port.batcher.engine.compile_cache)()
    for c in port.batcher._cache.values():
        c.query_cache.clear()
    for rep in range(2):
        want = ref.search(TENANT, _ref_req(tags, kw)).response()
        got = port.search(TENANT, SearchRequest(tags=dict(tags), **kw)
                          ).response()
        _assert_same(got, want)
        if rep == 0:
            cold = dict(spy.n)
    if name in PROBED:
        assert cold["probe"] > 0
        assert spy.n["probe"] == cold["probe"]       # none on the repeat
        if got.traces:
            assert spy.n["multi_hits"] > 0
    else:
        assert spy.n["probe"] == 0
        assert spy.n["multi_hits"] == 0


def _jobs(ref):
    out = []
    for m in sorted(ref.blocklist.metas(TENANT), key=lambda m: m.block_id):
        for start, count in ((0, 0), (0, 2), (2, 0)):
            out.append(dict(tenant_id=TENANT, block_id=m.block_id,
                            start_page=start, pages_to_search=count,
                            encoding=m.encoding, version=m.version,
                            data_encoding=m.data_encoding,
                            start_time=m.start_time, end_time=m.end_time))
    return out


@pytest.mark.parametrize("name", ["point", "prefix", "scattered_and_service",
                                  "mixed_routes_region",
                                  "long_needle_host_route",
                                  "absent_key_exhaustive"])
def test_search_block_matches_reference(dbs, spy, name):
    """The one-job request over whole blocks and page ranges."""
    ref, port = dbs
    tags, kw = _requests()[name]
    for j in _jobs(ref):
        rr = tempopb.SearchBlockRequest(**j)
        rr.search_req.CopyFrom(_ref_req(tags, kw))
        want = ref.search_block(rr).response()
        got = port.search_block(SearchBlockRequest(
            search_req=SearchRequest(tags=dict(tags), **kw), **j)).response()
        _assert_same(got, want)


@pytest.fixture(scope="module")
def blocks(dbs, corpus):
    ref, port = dbs
    be = RefLocalBackend(str(corpus / "blocks"))
    pbe = LocalBackend(str(corpus / "blocks"))
    out = []
    for m, pm in zip(sorted(ref.blocklist.metas(TENANT),
                            key=lambda m: m.block_id),
                     sorted(port.blocklist.metas(TENANT),
                            key=lambda m: m.block_id)):
        out.append((RefBackendSearchBlock(be, m, probe_min_vals=PROBE_MIN),
                    BackendSearchBlock(pbe, pm, probe_min_vals=PROBE_MIN,
                                       device="cpu")))
    return out


@pytest.mark.parametrize("name", list(_requests()))
def test_backend_search_block_matches_reference(blocks, spy, name):
    """The single-block engine on every block: session blocks probe and
    scan through K1s's hit-mask mode, the small ones through its ranges."""
    tags, kw = _requests()[name]
    for rb, pb in blocks:
        want = rb.search(_ref_req(tags, kw)).response()
        got = pb.search(SearchRequest(tags=dict(tags), **kw)).response()
        _assert_same(got, want)
    if name in PROBED:
        assert spy.n["probe"] > 0
    if name in ("exhaustive_scattered", "absent_key_exhaustive"):
        assert spy.n["single_hits"] > 0 and spy.n["single_ranges"] > 0
    if name == "long_needle_host_route":
        assert spy.n["probe"] == 0 and spy.n["single_hits"] == 0


def test_single_block_stages_dictionary_by_threshold(blocks):
    for _rb, pb in blocks:
        sp = pb.staged()
        big = len(sp.pages.val_dict) >= PROBE_MIN
        assert (sp.staged_dict is not None) == big
        if big:
            assert sp.staged_dict.n_vals == len(sp.pages.val_dict)


def test_probe_threshold_zero_keeps_every_probe_on_the_host(corpus, spy):
    """search_device_probe_min_vals <= 0: no dictionary is staged and no
    probe runs, with the same answer."""
    port = TempoDB(LocalBackend(str(corpus / "blocks")),
                   TempoDBConfig(search_max_batch_pages=MAX_PAGES,
                                 search_device_probe_min_vals=0),
                   device="cpu")
    probed = TempoDB(LocalBackend(str(corpus / "blocks")),
                     TempoDBConfig(search_max_batch_pages=MAX_PAGES,
                                   search_device_probe_min_vals=PROBE_MIN),
                     device="cpu")
    try:
        port.poll()
        probed.poll()
        tags, kw = _requests()["exhaustive_scattered"]
        req = SearchRequest(tags=dict(tags), **kw)
        got = port.search(TENANT, req).response()
        assert spy.n["probe"] == 0
        assert all(not c.batch.staged_dicts
                   for c in port.batcher._cache.values())
        _assert_same(got, probed.search(TENANT, req).response())
        assert spy.n["probe"] > 0
    finally:
        port.close()
        probed.close()


def test_evicted_batch_frees_its_dictionaries(corpus):
    """With a budget of about one batch, staging the next group evicts the
    last; once the search is done nothing holds the evicted batches'
    staged dictionaries or ?agg= keys any more (the staging lookahead and
    the coalescer keep no reference to a batch once its outputs are
    handed over), and the budget accounting holds them. The group that
    stays resident is the first in plan order, which holds block 0, a
    session block: its dictionary stays staged."""
    port = TempoDB(LocalBackend(str(corpus / "blocks")),
                   TempoDBConfig(search_max_batch_pages=MAX_PAGES,
                                 search_device_probe_min_vals=PROBE_MIN,
                                 search_batch_cache_bytes=1,
                                 search_analytics_enabled=True),
                   device="cpu")
    real_stage = port_batcher.stage_for_batch
    try:
        port.poll()
        seen, seen_agg = [], []
        real = port.batcher._staged

        def staged(group):
            entry = real(group)
            seen.extend(weakref.ref(d)
                        for d in entry.batch.staged_dicts.values())
            return entry

        def stage_for_batch(batch):
            st = real_stage(batch)
            seen_agg.extend((weakref.ref(st),
                             weakref.ref(st.device(port.device))))
            return st

        port.batcher._staged = staged
        port_batcher.stage_for_batch = stage_for_batch
        tags, kw = _requests()["exhaustive_scattered"]
        req = SearchRequest(tags=dict(tags), **kw)
        attach_agg(req, "red")
        assert port.search(TENANT, req).response().metrics.agg_json
        gc.collect()
        assert len(port.batcher._cache) == 1
        resident = {id(d) for c in port.batcher._cache.values()
                    for d in c.batch.staged_dicts.values()}
        alive = [r() for r in seen if r() is not None]
        assert len(seen) > len(alive) > 0
        assert {id(d) for d in alive} == resident
        st = next(iter(port.batcher._cache.values())).batch.agg_stage
        alive_agg = {id(r()) for r in seen_agg if r() is not None}
        assert len(seen_agg) > 2
        assert alive_agg == {id(st), id(st.device(port.device))}
        assert port.batcher._probe_dict_total == sum(
            c.batch.dict_nbytes for c in port.batcher._cache.values())
        assert port.batcher._cache_total == sum(
            c.nbytes for c in port.batcher._cache.values())
    finally:
        port_batcher.stage_for_batch = real_stage
        port.close()
