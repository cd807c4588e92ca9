"""The port's TempoDB.search against the reference's, end to end.

The reference writes tens of search blocks (zlib) into a LocalBackend
directory; the reference's ``TempoDB.search`` (JAX on the CPU, single
device, gates at their defaults) and the port's ``TempoDB(...,
device="cpu").search`` (the kernels' plain versions) then answer the same
requests over that directory. Everything compared is an integer or a
string, so every comparison is exact: the result trace sets with their
start, duration and root names, and inspected traces/blocks/bytes,
skipped blocks and truncated entries. A small ``search_max_batch_pages``
gives several groups per query, so group planning, the pipelined drain
and the early quit at the limit all run.
"""

from __future__ import annotations

import numpy as np
import pytest

from tempo_tpu import tempopb
from tempo_tpu.backend.local import LocalBackend as RefLocalBackend
from tempo_tpu.backend.types import BlockMeta as RefBlockMeta
from tempo_tpu.db import TempoDB as RefTempoDB
from tempo_tpu.db import TempoDBConfig as RefTempoDBConfig
from tempo_tpu.search.backend_search_block import \
    write_search_block as ref_write_search_block
from tempo_tpu.search.columnar import PageGeometry as RefPageGeometry
from tempo_tpu.search.data import SearchData as RefSearchData

from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.model.types import SearchRequest

TENANT = "t1"
E = 64          # entries per page: small pages, several pages per block
MAX_PAGES = 16  # pages per group: several groups per query
BASE_S = 1_700_000_000
SERVICES = [f"svc-{i:02d}" for i in range(16)]
STATUSES = ["200", "404", "500"]
REGIONS = ["us-east-1", "us-west-2", "eu-west-1", "ap-south-1"]
OPS = ["GET /", "POST /api", "db.query", "cache.get"]


def _block_entries(rng, b: int, n: int) -> list:
    """`n` traces of block `b`; block b's traces start within hour b, so
    window queries prune whole blocks by their header."""
    out = []
    hosts = 40 if b % 3 == 0 else 400   # some groups narrow kv_val to int16
    for _ in range(n):
        start = BASE_S + b * 3600 + int(rng.integers(0, 3600))
        dur_ms = int(rng.integers(1, 60_000))
        sd = RefSearchData(
            trace_id=rng.bytes(16), start_s=start,
            end_s=start + dur_ms // 1000, dur_ms=dur_ms,
            root_service=SERVICES[int(rng.integers(len(SERVICES)))],
            root_name=OPS[int(rng.integers(len(OPS)))])
        sd.kvs = {
            "service.name": {sd.root_service},
            "http.status_code": {STATUSES[int(rng.integers(3))]},
            "region": {REGIONS[int(rng.integers(4))]},
            "name": {sd.root_name},
            "host.name": {f"host-{int(rng.integers(hosts)):04d}"},
        }
        out.append(sd)
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A backend directory of 36 blocks written by the reference."""
    root = tmp_path_factory.mktemp("torch_search")
    be = RefLocalBackend(str(root / "blocks"))
    rng = np.random.default_rng(20261017)
    geometry = RefPageGeometry(entries_per_page=E, kv_per_entry=8)
    for b in range(36):
        entries = _block_entries(rng, b, int(rng.integers(100, 300)))
        if b == 7:
            # one trace carrying 33k distinct values: the value dictionary
            # outgrows int16, so this block's group stages int32 kv_val
            # (and the entry is truncated to C slots, which is counted)
            entries[0].kvs["http.url"] = {f"/u/{i}" for i in range(33_000)}
        meta = RefBlockMeta(tenant_id=TENANT)
        ref_write_search_block(be, meta, entries, geometry=geometry,
                               encoding="zlib")
    return root


def _requests():
    def req(tags=None, **kw):
        return tags or {}, kw

    return {
        "tag_and": req({"service.name": "svc-07",
                        "http.status_code": "500"}),
        "substring": req({"region": "west"}),
        "substring_host": req({"host.name": "-01"}),
        "duration": req(min_duration_ms=20_000, max_duration_ms=40_000),
        "window": req(start=BASE_S + 5 * 3600 + 600,
                      end=BASE_S + 9 * 3600),
        "window_and_tag": req({"service.name": "svc-1"},
                              start=BASE_S + 20 * 3600,
                              end=BASE_S + 30 * 3600, limit=50),
        "absent_tag": req({"no.such.tag": "x"}),
        "absent_value": req({"service.name": "svc-99"}),
        "large_limit": req(min_duration_ms=1, limit=300),
        "exhaustive": req({"x-dbg-exhaustive": "", "http.status_code": "4"},
                          limit=40),
        "url_tag": req({"http.url": "/u/3210"}),
    }


def _ref_req(tags, kw):
    r = tempopb.SearchRequest()
    for k, v in tags.items():
        r.tags[k] = v
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def _traces(resp) -> set:
    return {(t.trace_id, t.start_time_unix_nano, t.duration_ms,
             t.root_service_name, t.root_trace_name) for t in resp.traces}


def _metrics(m) -> tuple:
    return (m.inspected_traces, m.inspected_blocks, m.skipped_blocks,
            m.inspected_bytes, m.truncated_entries)


@pytest.fixture(scope="module")
def dbs(corpus, tmp_path_factory):
    wal = tmp_path_factory.mktemp("torch_search_wal")
    ref = RefTempoDB(
        RefLocalBackend(str(corpus / "blocks")), str(wal),
        RefTempoDBConfig(search_max_batch_pages=MAX_PAGES, auto_mesh=False,
                         host_state_dir=""))
    port = TempoDB(LocalBackend(str(corpus / "blocks")),
                   TempoDBConfig(search_max_batch_pages=MAX_PAGES),
                   device="cpu")
    ref.poll()
    port.poll()
    # stage every group in both packages first: with all groups resident,
    # each later query scans them in plan order, so which groups an early
    # quit leaves unscanned does not depend on how far a background
    # staging lookahead got
    tags, kw = _requests()["exhaustive"]
    assert _traces(ref.search(TENANT, _ref_req(tags, kw)).response()) == \
        _traces(port.search(TENANT, SearchRequest(tags=dict(tags), **kw))
                .response())
    yield ref, port
    port.close()


@pytest.mark.parametrize("name", list(_requests()))
def test_search_matches_reference(dbs, name):
    """Exact agreement of trace sets and metrics, run twice so the second
    pass goes through both packages' staged caches and memos."""
    ref, port = dbs
    tags, kw = _requests()[name]
    for _ in range(2):
        want = ref.search(TENANT, _ref_req(tags, kw)).response()
        got = port.search(TENANT, SearchRequest(tags=dict(tags), **kw)
                          ).response()
        assert _traces(got) == _traces(want)
        assert [t.trace_id for t in got.traces] == \
            [t.trace_id for t in want.traces]
        assert _metrics(got.metrics) == _metrics(want.metrics)


def test_search_exercises_groups_and_early_quit(dbs):
    """The corpus spans several groups, and a default-limit query stops
    before scanning all of them."""
    _ref, port = dbs
    epoch = port.blocklist.epoch()
    jobs = port._jobs(TENANT, epoch)
    groups = port.batcher.plan(jobs)
    assert len(groups) >= 4
    res = port.search(TENANT, SearchRequest(tags={"region": "us"}))
    assert res.n_results >= 20
    assert res.metrics.inspected_blocks < len(jobs)
    assert port.batcher.last_dispatches < len(groups)


def _jobs(ref):
    """Two page-range jobs per block: pages [0, 2) and [2, end)."""
    jobs = []
    for m in ref.blocklist.metas(TENANT):
        for start, count in ((0, 2), (2, 0)):
            jobs.append(dict(block_id=m.block_id, start_page=start,
                             pages_to_search=count, encoding=m.encoding,
                             version=m.version,
                             data_encoding=m.data_encoding,
                             start_time=m.start_time, end_time=m.end_time))
    return jobs


def _search_blocks_both(ref, port, tags, kw):
    from tempo_tpu_torch.model.types import BlockSearchJob, \
        SearchBlocksRequest

    jobs = _jobs(ref)
    rb = tempopb.SearchBlocksRequest(tenant_id=TENANT)
    rb.search_req.CopyFrom(_ref_req(tags, kw))
    for j in jobs:
        rb.jobs.add(**j)
    pb = SearchBlocksRequest(search_req=SearchRequest(tags=dict(tags), **kw),
                             tenant_id=TENANT,
                             jobs=[BlockSearchJob(**j) for j in jobs])
    return ref.search_blocks(rb).response(), port.search_blocks(pb).response()


@pytest.fixture(scope="module")
def dbs_blocks(dbs):
    """The same databases with every page-range group staged in both."""
    ref, port = dbs
    want, got = _search_blocks_both(ref, port, *_requests()["exhaustive"])
    assert _traces(got) == _traces(want)
    return ref, port


@pytest.mark.parametrize("name", ["tag_and", "window", "large_limit",
                                  "exhaustive", "absent_tag"])
def test_search_blocks_matches_reference(dbs_blocks, name):
    """The job-list entry point over page-range jobs (sliced containers)
    agrees exactly with the reference's."""
    ref, port = dbs_blocks
    want, got = _search_blocks_both(ref, port, *_requests()[name])
    assert [t.trace_id for t in got.traces] == \
        [t.trace_id for t in want.traces]
    assert _traces(got) == _traces(want)
    assert _metrics(got.metrics) == _metrics(want.metrics)
