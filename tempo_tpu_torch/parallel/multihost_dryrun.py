"""Localhost multi-process dryrun of the distributed serving path.

Counterpart of the reference's ``parallel/multihost_dryrun.py``: N rank
processes join one gloo process group over loopback (``multihost.
init_distributed`` with ``cpu_devices_per_host=1``), each builds a
``TempoDB`` on the CPU over one shared ``LocalBackend`` corpus, which
``auto_mesh`` shards over every rank (``make_mesh()``) at its first
search, and drives ``TempoDB.search``; every rank stages
only its page shard of each batch, and the launcher asserts that every
rank's answers are identical and agree with the host oracle
(``search.data.search_data_matches``). The corpus is written with the
port's ``write_search_block``.

  python -m tempo_tpu_torch.parallel.multihost_dryrun        # 2 ranks

``run`` takes the ranks, a TempoDBConfig's fields and the requests, so a
test can drive probe, structural, aggregate and eviction paths, and may
force every offload-planner verdict to one side (``planner_force``); it joins
every worker with a timeout and kills them all when one runs out, so a
hung collective fails the run instead of waiting.
"""

from __future__ import annotations

import json
import os
import random
import socket
import subprocess
import sys
import tempfile
import time

TENANT = "t1"
N_BLOCKS = 6
TRACES_PER_BLOCK = 96
GEOMETRY = (8, 8)                  # entries per page, kv slots
SERVICES = ("frontend", "checkout", "cart", "db")


def corpus_entries(block: int) -> list:
    """Block `block`'s traces, from its seed (96, 91 or 86 of them, so
    some blocks end in a partly filled page): tags, a session id unique
    in the corpus (a dictionary large enough for the device probe at a
    lowered threshold), an error flag on some, and 0-5 span rows each."""
    from ..search.data import SearchData, SpanData

    rng = random.Random(block)
    out = []
    for i in range(TRACES_PER_BLOCK - 5 * (block % 3)):
        sd = SearchData(trace_id=rng.randbytes(16))
        sd.start_s = 1_600_000_000 + block * 1000 + i
        sd.end_s = sd.start_s + 5
        sd.dur_ms = rng.randint(1, 10_000)
        sd.root_service = rng.choice(SERVICES)
        sd.root_name = "GET /"
        sd.kvs = {"service.name": {sd.root_service},
                  "http.status_code": {str(rng.choice([200, 500]))},
                  "session.id": {f"s-{block:02d}-{i:04d}"}}
        if rng.random() < 0.2:
            sd.kvs["error"] = {"true"}
        for s in range(rng.randint(0, 5)):
            sd.spans.append(SpanData(
                parent=-1 if s == 0 else rng.randrange(s),
                dur_ms=rng.randint(1, 2000), kind=rng.randint(0, 5),
                kvs={"service.name": {rng.choice(SERVICES)},
                     "name": {rng.choice(("op0", "op1", "op2"))}}))
        out.append(sd)
    return out


def build_corpus(root: str) -> None:
    """Write the blocks into `root`/blocks."""
    from ..backend.local import LocalBackend
    from ..backend.types import BlockMeta
    from ..search.backend_search_block import write_search_block
    from ..search.columnar import PageGeometry

    be = LocalBackend(os.path.join(root, "blocks"))
    for b in range(N_BLOCKS):
        meta = BlockMeta(tenant_id=TENANT,
                         block_id=f"00000000-0000-4000-8000-{b:012d}")
        write_search_block(be, meta, corpus_entries(b),
                           geometry=PageGeometry(*GEOMETRY))


def default_requests() -> list:
    """(tags, other SearchRequest fields) pairs: a tag query that never
    quits early."""
    return [({"service.name": "frontend"},
             {"min_duration_ms": 100, "limit": 1000})]


def oracle(cfg_fields: dict, tags: dict, kw: dict) -> list:
    """The trace ids, hex, the host predicate accepts over the corpus."""
    from ..db import TempoDBConfig
    from ..model.types import SearchRequest
    from ..search.data import search_data_matches

    cfg = TempoDBConfig(**cfg_fields).structural()
    req = SearchRequest(tags=dict(tags), **kw)
    return sorted(sd.trace_id.hex() for b in range(N_BLOCKS)
                  for sd in corpus_entries(b)
                  if search_data_matches(sd, req, cfg))


def digest(results) -> dict:
    """A response's content in JSON types."""
    resp = results.response()
    m = resp.metrics
    return {"traces": [[t.trace_id, t.start_time_unix_nano, t.duration_ms,
                        t.root_service_name, t.root_trace_name]
                       for t in resp.traces],
            "inspected_traces": m.inspected_traces,
            "inspected_blocks": m.inspected_blocks,
            "skipped_blocks": m.skipped_blocks,
            "agg_json": m.agg_json}


def force_planner(planner, target: str) -> None:
    """Feed `planner` observations under which `target` ("host" or
    "device") wins every probe decision, with no seed: every rank then
    takes one verdict whatever its own timings."""
    planner.enabled = True
    planner.seed_on_first_use = False
    slow, fast = 10.0, 1e-7
    planner.observe("host_probe", slow if target == "device" else fast,
                    nbytes=1024)
    planner.observe("device_probe", fast if target == "device" else slow,
                    nbytes=1024)
    planner.observe("h2d", fast, nbytes=1024)
    planner.observe("pack", fast, nbytes=1024)
    for k in ("dispatch", "compile", "collective"):
        planner._update(k, fast, 0)


def worker_main(process_id: int, num_processes: int, port: int,
                root: str) -> None:
    """One rank: join the group, answer the spec's requests through
    TempoDB.search (auto_mesh shards over every rank), dump the digests
    and the world the database sharded over (1: it did not)."""
    from .multihost import init_distributed

    if not init_distributed(coordinator=f"127.0.0.1:{port}",
                            num_processes=num_processes,
                            process_id=process_id, cpu_devices_per_host=1):
        raise RuntimeError("no coordinator")
    import torch.distributed as dist

    from ..backend.local import LocalBackend
    from ..db import TempoDB, TempoDBConfig
    from ..model.types import SearchRequest

    with open(os.path.join(root, "spec.json")) as f:
        spec = json.load(f)
    db = TempoDB(LocalBackend(os.path.join(root, "blocks")),
                 TempoDBConfig(**spec["cfg"]), device="cpu")
    if spec.get("planner_force"):
        force_planner(db.planner, spec["planner_force"])
    try:
        db.poll()
        answers = [db.search(TENANT, SearchRequest(tags=dict(tags), **kw))
                   for tags, kw in spec["requests"]]
        # the query stats of a request with explain: each rank's own
        stats = [json.loads(a.metrics.query_stats_json)
                 if a.metrics.query_stats_json else None for a in answers]
        out = {"process_id": process_id,
               "world": 1 if db.mesh is None else db.mesh.size(),
               "responses": [digest(a) for a in answers], "stats": stats,
               "decisions": db.planner.snapshot(0)["decisions"]}
    finally:
        db.close()
    with open(os.path.join(root, f"digest-{process_id}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(n_processes: int = 2, cfg: dict | None = None,
        requests: list | None = None, timeout_s: float = 120.0,
        root: str | None = None, planner_force: str | None = None) -> dict:
    """Build the corpus (under `root`, or a temporary directory), spawn
    the rank processes, wait at most `timeout_s` for all of them (then
    kill them all and raise), and check that every rank answered alike
    and that every request whose limit covers its matches returned
    exactly the oracle's traces. Returns {"world", "responses",
    "stats"}: the common answer, one digest per request, and each rank's
    query stats per request (those of a request with ``explain``), and
    each rank's planner decisions by target. `planner_force` ("host" or
    "device"): every rank's planner on, forced to that verdict
    (``force_planner``)."""
    cfg = dict(cfg or {})
    requests = requests or default_requests()
    with tempfile.TemporaryDirectory() as tmp:
        root = root or tmp
        build_corpus(root)
        with open(os.path.join(root, "spec.json"), "w") as f:
            json.dump({"cfg": cfg, "requests": requests,
                       "planner_force": planner_force}, f)
        port = _free_port()
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tempo_tpu_torch.parallel.multihost_dryrun",
             "--worker", str(pid), str(n_processes), str(port), root],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=pkg_root)
            for pid in range(n_processes)]
        deadline = time.monotonic() + timeout_s
        outs = []
        try:
            for p in procs:
                left = max(0.1, deadline - time.monotonic())
                out, _ = p.communicate(timeout=left)
                outs.append(out.decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.communicate()
            raise TimeoutError(
                f"dryrun ranks still running after {timeout_s:.0f} s "
                "(a collective hang?); killed") from None
        for p, out in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"rank failed rc={p.returncode}:\n{out[-4000:]}")
        digests = []
        for pid in range(n_processes):
            with open(os.path.join(root, f"digest-{pid}.json")) as f:
                digests.append(json.load(f))
    base = digests[0]["responses"]
    for d in digests[1:]:
        if d["responses"] != base:
            raise AssertionError(
                f"rank {d['process_id']} answered differently from rank 0")
    if digests[0]["world"] != n_processes:
        raise AssertionError(f"mesh of {digests[0]['world']} ranks, "
                             f"{n_processes} launched")
    for (tags, kw), got in zip(requests, base):
        want = oracle(cfg, tags, kw)
        if len(want) <= kw.get("limit", 20):
            ids = sorted(t[0] for t in got["traces"])
            if ids != want:
                raise AssertionError(
                    f"{tags} {kw}: {len(ids)} traces, oracle {len(want)}")
    return {"world": n_processes, "responses": base,
            "stats": [d["stats"] for d in digests],
            "decisions": [d["decisions"] for d in digests]}


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                    sys.argv[5])
    else:
        res = run()
        print(f"dryrun: {len(res['responses'][0]['traces'])} matches, "
              f"identical across {res['world']} ranks -- OK")
