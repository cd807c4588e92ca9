"""The port's multi-process wiring (parallel/multihost.py) and its gloo
dryrun (parallel/multihost_dryrun.py) against the reference.

The dryrun jobs spawn rank processes that join one gloo group over
loopback, each drive ``TempoDB.search`` over one corpus, ``auto_mesh``
sharding it over every rank (``make_mesh()``), and stage only their page
shard; every job joins with a timeout
(a hung collective fails in seconds). Their common answer must equal the
reference ``TempoDB`` on a mesh of as many of the conftest's virtual CPU
devices, response by response: trace sets with start, duration and root
names, inspected traces and blocks, skipped blocks and the ?agg=red JSON.
"""

from __future__ import annotations

import socket

import pytest
import torch.distributed as dist

from tempo_tpu import tempopb
from tempo_tpu.backend.local import LocalBackend as RefLocalBackend
from tempo_tpu.db import TempoDB as RefTempoDB
from tempo_tpu.db import TempoDBConfig as RefTempoDBConfig
from tempo_tpu.parallel import multihost as ref_multihost
from tempo_tpu.parallel.mesh import make_mesh as ref_make_mesh
from tempo_tpu.search import analytics as ref_analytics
from tempo_tpu.search import packing as ref_packing
from tempo_tpu.search import pipeline as ref_pipeline
from tempo_tpu.search import structural as ref_structural

from tempo_tpu_torch.model.types import SearchRequest
from tempo_tpu_torch.parallel import multihost
from tempo_tpu_torch.parallel import multihost_dryrun as md
from tempo_tpu_torch.search import ir, structural

ENV = ("TEMPO_COORDINATOR", "TEMPO_NUM_PROCESSES", "TEMPO_PROCESS_ID")
JOB_TIMEOUT_S = 90


@pytest.fixture(autouse=True)
def _reference_gates():
    g = ref_structural.STRUCTURAL
    prev = (g.enabled, g.shard_spans, g.remainder_pages,
            ref_packing.PACKING.enabled, ref_analytics.ANALYTICS.enabled)
    ref_pipeline._COMPILE_CACHE.clear()
    yield
    (g.enabled, g.shard_spans, g.remainder_pages,
     ref_packing.PACKING.enabled) = prev[:4]
    ref_analytics.ANALYTICS.configure(enabled=prev[4])
    ref_pipeline._COMPILE_CACHE.clear()


def test_init_distributed_without_a_coordinator(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert multihost.init_distributed() is False
    assert multihost.init_distributed(num_processes=4, process_id=1) is False
    assert not dist.is_initialized()
    assert not multihost.is_multiprocess() and multihost.process_index() == 0


def test_init_distributed_reads_the_env_fallbacks(monkeypatch):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("TEMPO_COORDINATOR", f"127.0.0.1:{port}")
    monkeypatch.setenv("TEMPO_NUM_PROCESSES", "1")
    monkeypatch.setenv("TEMPO_PROCESS_ID", "0")
    assert not dist.is_initialized()
    # YAML substitution hands strings, an empty one for an unset key
    assert multihost.init_distributed(num_processes="", process_id="",
                                      cpu_devices_per_host="1") is True
    try:
        assert dist.get_backend() == "gloo"
        assert (dist.get_world_size(), dist.get_rank()) == (1, 0)
        assert not multihost.is_multiprocess()
        assert multihost.process_index() == 0
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("env", [{}, {"TEMPO_NUM_PROCESSES": "1"},
                                 {"TEMPO_NUM_PROCESSES": "4",
                                  "TEMPO_PROCESS_ID": "2"},
                                 {"TEMPO_NUM_PROCESSES": "3"},
                                 {"TEMPO_NUM_PROCESSES": "",
                                  "TEMPO_PROCESS_ID": ""}])
def test_ownership_members_matches_reference(monkeypatch, env):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert multihost.ownership_members() == \
        ref_multihost.ownership_members()


def _st(text: str, **kw) -> tuple:
    r = SearchRequest(tags={})
    structural.attach_query(r, ir.parse(text))
    return dict(r.tags), kw


REQS = [
    ({"service.name": "frontend"}, {"min_duration_ms": 100, "limit": 1000}),
    ({"session.id": "s-04-00"}, {"limit": 1000}),
    ({"session.id": "-001", "x-dbg-exhaustive": ""}, {"limit": 20}),
    _st('{"desc": {"anc": {"tag": {"k": "service.name", "v": "db"}}, '
        '"span": {"kind": "client"}}}', limit=1000),
    _st('{"quantile": {"of": {"dur": {"min_ms": 1}}, "q": "0.9", '
        '"op": ">=", "ms": 500}}', limit=8),
    ({"x-agg-q": "red"}, {"limit": 1000}),
    ({"service.name": "cart", "x-agg-q": "red"}, {"limit": 5}),
    ({}, {"min_duration_ms": 1, "limit": 300}),        # above top_k 128
]


def _ref_answers(root, S: int, fields: dict) -> list:
    g = ref_structural.STRUCTURAL
    ref = RefTempoDB(RefLocalBackend(str(root / "blocks")),
                     str(root / "ref-wal"),
                     RefTempoDBConfig(auto_mesh=False, **fields),
                     mesh=ref_make_mesh(S))
    ref.poll()
    out = []
    for tags, kw in REQS:
        g.enabled = True
        g.shard_spans = bool(fields.get("search_structural_shard_spans"))
        g.remainder_pages = bool(
            fields.get("search_structural_remainder_pages"))
        ref_analytics.ANALYTICS.configure(enabled=True)
        r = tempopb.SearchRequest()
        for k, v in tags.items():
            r.tags[k] = v
        for k, v in kw.items():
            setattr(r, k, v)
        resp = ref.search(md.TENANT, r).response()
        m = resp.metrics
        out.append({"traces": [[t.trace_id, t.start_time_unix_nano,
                                t.duration_ms, t.root_service_name,
                                t.root_trace_name] for t in resp.traces],
                    "inspected_traces": m.inspected_traces,
                    "inspected_blocks": m.inspected_blocks,
                    "skipped_blocks": m.skipped_blocks,
                    "agg_json": m.agg_json})
    return out


@pytest.mark.parametrize("S,layout", [(4, {}),
                                      (3, {"search_structural_shard_spans":
                                           True,
                                           "search_structural_remainder_pages":
                                           True})],
                         ids=["4-ranks", "3-ranks-sharded-spans"])
def test_gloo_job_equals_reference_mesh(tmp_path, S, layout):
    # the probe threshold lowered so every block's dictionary probes; a
    # cache budget of one small batch, so groups evict and restage
    fields = dict(search_device_probe_min_vals=64,
                  search_structural_enabled=True,
                  search_analytics_enabled=True, search_max_batch_pages=16,
                  search_batch_cache_bytes=20_000, **layout)
    res = md.run(S, fields, REQS, timeout_s=JOB_TIMEOUT_S, root=str(tmp_path))
    assert res["world"] == S
    assert res["responses"] == _ref_answers(tmp_path, S, fields)
    assert len(res["responses"][7]["traces"]) == 300
    assert res["responses"][5]["agg_json"]


def test_a_job_past_its_timeout_is_killed(tmp_path):
    """Ranks still running at the deadline (here: still importing) are
    killed and the run raises, instead of waiting on them."""
    with pytest.raises(TimeoutError):
        md.run(2, {}, md.default_requests(), timeout_s=0.5,
               root=str(tmp_path))
