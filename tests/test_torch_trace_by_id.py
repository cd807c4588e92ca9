"""The port's TempoDB.find_trace_by_id against the reference's.

A corpus of several blocks (the reference's ``make_trace`` objects, in
v1 or v2 encoding), written by either package's ``StreamingBlock`` into
one LocalBackend directory: traces split across 2 and across 3 blocks
with duplicate span ids among their partials, 8-byte ids, a block whose
index has a corrupt page, a block whose data object is gone, and a block
with no objects. The reference's ``TempoDB`` and the port's
``TempoDB(device="cpu")`` then look up every id and a set of absent ones.

- With ``pool_workers=1`` both walk the blocklist in order, so the
  combined objects must be byte-identical.
- With the default pool the partials combine in the order the threads
  finish, in both packages; there the decoded traces must be equal as
  sets of (resource, scope, span), with equal v2 header ranges.
- The failed-block count must be equal everywhere.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

from tempo_tpu import tempopb
from tempo_tpu.backend.local import LocalBackend as RefLocalBackend
from tempo_tpu.backend.types import BlockMeta as RefBlockMeta
from tempo_tpu.db import TempoDB as RefTempoDB
from tempo_tpu.db import TempoDBConfig as RefTempoDBConfig
from tempo_tpu.encoding.v2.streaming_block import \
    StreamingBlock as RefStreamingBlock
from tempo_tpu.model.codec import codec_for as ref_codec_for
from tempo_tpu.utils.test_data import make_trace

from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.backend.types import BlockMeta
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.encoding.v2.streaming_block import StreamingBlock
from tempo_tpu_torch.model.codec import codec_for
from tempo_tpu_torch.utils.ids import pad_trace_id

TENANT = "t1"
BASE_S = 1_700_000_000
BLOCKS = 6           # blocks of whole traces and partials
PER_BLOCK = 30       # whole traces a block
CORRUPT = 6          # the block whose index has a corrupt page
GONE = 7             # the block whose data object is deleted
EMPTY = 8            # the block with no objects


def _bid(b: int) -> str:
    return f"00000000-0000-4000-8000-{b:012d}"


def _corpus(seed: int):
    """{block: [(id, trace, start, end)]}, the split ids {id: blocks}, and
    the ids of whole traces."""
    rng = np.random.default_rng(seed)
    blocks = {b: [] for b in range(EMPTY + 1)}
    whole, split = [], {}

    def tid_of(i):
        return rng.bytes(8 if i % 9 == 0 else 16)

    i = 0
    for b in list(range(BLOCKS)) + [CORRUPT, GONE]:
        for _ in range(PER_BLOCK):
            tid = tid_of(i)
            t = make_trace(tid, seed=i, batches=1 + i % 3, spans_per_batch=2)
            start = BASE_S + b * 600 + int(rng.integers(0, 600))
            blocks[b].append((tid, t, start, start + int(rng.integers(0, 60))))
            whole.append(tid)
            i += 1
    # partials: 3 batches of one trace over 2 or 3 blocks; every partial
    # after the first repeats a span of the first, so which copy the
    # combine keeps depends on the order it gets the partials in
    for j in range(24):
        tid = tid_of(i)
        full = make_trace(tid, seed=i, batches=3, spans_per_batch=3)
        ways = 2 if j % 2 else 3
        if j == 0:
            where = [0, CORRUPT, 3]           # one partial in the bad block
        elif j == 1:
            where = [GONE, 2]
        else:
            where = sorted(rng.choice(BLOCKS, size=ways, replace=False)
                           .tolist())
        groups = [[0, 1], [2]] if ways == 2 else [[0], [1], [2]]
        start = BASE_S + int(rng.integers(0, 600 * BLOCKS))
        for k, (b, g) in enumerate(zip(where, groups)):
            t = tempopb.Trace()
            for bi in g:
                t.batches.append(full.batches[bi])
            if k:   # the same span under the same resource and scope
                dup = t.batches.add()
                dup.resource.CopyFrom(full.batches[0].resource)
                ss = dup.scope_spans.add()
                ss.scope.CopyFrom(full.batches[0].scope_spans[0].scope)
                ss.spans.append(full.batches[0].scope_spans[0].spans[1])
            blocks[b].append((tid, t, start + k, start + 10 + k))
        split[tid] = where
        i += 1
    return blocks, split, whole


def _write(root: str, writer: str, enc: str, blocks: dict) -> None:
    codec = ref_codec_for(enc)
    for b, items in blocks.items():
        items = sorted(items, key=lambda x: pad_trace_id(x[0]))
        if writer == "ref":
            be = RefLocalBackend(root)
            sb = RefStreamingBlock(
                RefBlockMeta(tenant_id=TENANT, block_id=_bid(b),
                             encoding="zlib", data_encoding=enc),
                page_size=1024, records_per_index_page=2, backend=be,
                flush_size=4096)
        else:
            be = LocalBackend(root)
            sb = StreamingBlock(
                BlockMeta(tenant_id=TENANT, block_id=_bid(b),
                          encoding="zlib", data_encoding=enc),
                page_size=1024, records_per_index_page=2, backend=be,
                flush_size=4096)
        for tid, t, s, e in items:
            sb.add_object(tid, codec.marshal(t, s, e), s, e)
        sb.complete(be)
    d = os.path.join(root, TENANT)
    path = os.path.join(d, _bid(CORRUPT), "index")
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[-5] ^= 0xFF                     # a byte of the last page's records
    with open(path, "wb") as f:
        f.write(bytes(data))
    os.unlink(os.path.join(d, _bid(GONE), "data"))


@pytest.fixture(scope="module", params=[("ref", "v1"), ("ref", "v2"),
                                        ("port", "v2")],
                ids=["ref-v1", "ref-v2", "port-v2"])
def corpus(request, tmp_path_factory):
    writer, enc = request.param
    root = tmp_path_factory.mktemp(f"tbi_{writer}_{enc}")
    blocks, split, whole = _corpus(20261018)
    _write(str(root / "blocks"), writer, enc, blocks)
    return {"root": str(root / "blocks"), "enc": enc, "split": split,
            "whole": whole, "blocks": blocks, "wal": str(root / "wal")}


def _dbs(corpus, workers: int):
    ref = RefTempoDB(RefLocalBackend(corpus["root"]),
                     corpus["wal"] + f"-{workers}",
                     RefTempoDBConfig(pool_workers=workers, auto_mesh=False,
                                      host_state_dir=""))
    port = TempoDB(LocalBackend(corpus["root"]),
                   TempoDBConfig(pool_workers=workers), device="cpu")
    ref.poll()
    port.poll()
    assert [m.block_id for m in port.blocklist.metas(TENANT)] == \
        [m.block_id for m in ref.blocklist.metas(TENANT)]
    assert len(port.blocklist.metas(TENANT)) == EMPTY + 1
    return ref, port


def _keys(corpus) -> list:
    """Every written id by each of its spellings, and absent ids."""
    rng = np.random.default_rng(7)
    keys = []
    for tid in corpus["whole"] + list(corpus["split"]):
        keys.append(tid)
        if len(tid) == 8:
            keys.append(pad_trace_id(tid))
    return keys + [rng.bytes(16) for _ in range(100)] + [rng.bytes(8)]


def _span_set(t) -> set:
    return {(b.resource.SerializeToString(), ss.scope.SerializeToString(),
             s.SerializeToString())
            for b in t.batches for ss in b.scope_spans for s in ss.spans}


def _decoded(obj: bytes, enc: str):
    c = codec_for(enc)
    return _span_set(c.prepare_for_read(obj)), c.fast_range(obj)


def test_one_worker_is_byte_identical_to_the_reference(corpus):
    ref, port = _dbs(corpus, 1)
    try:
        failed = combined = 0
        for key in _keys(corpus):
            got = port.find_trace_by_id(TENANT, key)
            want = ref.find_trace_by_id(TENANT, key)
            assert got == want, key.hex()
            failed += got[1]
        for tid, where in corpus["split"].items():
            obj, n_failed = port.find_trace_by_id(TENANT, tid)
            trace = codec_for(corpus["enc"]).prepare_for_read(obj)
            # every partial that could be read, its duplicate span once
            readable = [b for b in where if b not in (CORRUPT, GONE)]
            want = set()
            for b in readable:
                want |= _span_set(next(t for t_id, t, _, _ in
                                       corpus["blocks"][b] if t_id == tid))
            assert _span_set(trace) == want, tid.hex()
            span_ids = [sp.span_id for bt in trace.batches
                        for ss in bt.scope_spans for sp in ss.spans]
            assert len(span_ids) == len(set(span_ids)) == len(want)
            assert n_failed >= len(where) - len(readable)
            if len(readable) > 1:
                combined += 1
        assert failed > 0 and combined >= 20
    finally:
        port.close()


def test_default_pool_gives_the_reference_traces(corpus):
    ref, port = _dbs(corpus, 50)
    try:
        for key in list(corpus["split"]) + _keys(corpus)[::4]:
            got, got_failed = port.find_trace_by_id(TENANT, key)
            want, want_failed = ref.find_trace_by_id(TENANT, key)
            assert got_failed == want_failed
            assert (got is None) == (want is None)
            if got is not None:
                assert _decoded(got, corpus["enc"]) == \
                    _decoded(want, corpus["enc"])
    finally:
        port.close()


@pytest.mark.parametrize("lo,hi", [(1, 3), (0, 0), (4, 8), (2, 2),
                                   (None, 2), (5, None)])
def test_block_range_equals_the_reference(corpus, lo, hi):
    ref, port = _dbs(corpus, 1)
    start = "" if lo is None else _bid(lo)
    end = "" if hi is None else _bid(hi)
    try:
        for key in _keys(corpus)[::12]:
            assert port.find_trace_by_id(TENANT, key, start, end) == \
                ref.find_trace_by_id(TENANT, key, start, end)
    finally:
        port.close()
    metas = [m for m in port.blocklist.metas(TENANT)
             if TempoDB._include_block(m, start, end)]
    assert len(metas) == (hi if hi is not None else EMPTY) - (lo or 0) + 1


def test_include_block_time_window_equals_the_reference(corpus):
    ref, port = _dbs(corpus, 1)
    port.close()
    for s, e in ((0, 0), (BASE_S + 700, 0), (0, BASE_S + 1300),
                 (BASE_S + 1300, BASE_S + 1900), (BASE_S + 10**6, 0)):
        for pm, rm in zip(port.blocklist.metas(TENANT),
                          ref.blocklist.metas(TENANT)):
            assert TempoDB._include_block(pm, "", "", s, e) == \
                RefTempoDB._include_block(rm, "", "", s, e)


def test_failed_blocks_do_not_fail_the_call(corpus):
    """Ids of the corrupt-index block and of the block without its data
    object: each such block counts as failed, as in the reference, and a
    partial in a good block still comes back."""
    ref, port = _dbs(corpus, 1)
    try:
        bad = [tid for tid, where in corpus["split"].items()
               if CORRUPT in where or GONE in where]
        assert len(bad) == 2
        for tid in bad:
            obj, failed = port.find_trace_by_id(TENANT, tid)
            assert failed == 1 and obj is not None
            assert (obj, failed) == ref.find_trace_by_id(TENANT, tid)
    finally:
        port.close()


def test_zero_object_block_alone(tmp_path):
    root = str(tmp_path / "blocks")
    meta = BlockMeta(tenant_id=TENANT, block_id=_bid(0), encoding="zlib")
    StreamingBlock(meta).complete(LocalBackend(root))
    port = TempoDB(LocalBackend(root), device="cpu")
    ref = RefTempoDB(RefLocalBackend(root), str(tmp_path / "wal"),
                     RefTempoDBConfig(auto_mesh=False, host_state_dir=""))
    try:
        port.poll()
        ref.poll()
        assert dataclasses.asdict(port.blocklist.metas(TENANT)[0]) == \
            dataclasses.asdict(ref.blocklist.metas(TENANT)[0])
        for key in (b"\x01" * 16, b"\x02" * 8):
            assert port.find_trace_by_id(TENANT, key) == (None, 0) == \
                ref.find_trace_by_id(TENANT, key)
        assert port.find_trace_by_id("nobody", b"\x01" * 16) == (None, 0)
    finally:
        port.close()


def test_chip_smoke_cell_rehearses_on_the_cpu(tmp_path):
    """``chip_smoke.trace_by_id_cell`` at a small size on the CPU: its
    corpus (template objects checked against the proto's bytes), the
    search, the lookups of every result, present, partial and absent
    ids, and its figures."""
    import argparse

    import chip_smoke

    args = argparse.Namespace(tbi_blocks=4, tbi_traces_per_block=512,
                              seed=20261017, reps=2)
    report, dbs = {}, []
    launches = {k: 0 for k in chip_smoke.KERNELS}
    try:
        rows = chip_smoke.trace_by_id_cell(args, str(tmp_path), report, dbs,
                                           launches, device="cpu")
    finally:
        for db in dbs:
            db.close()
    out = report["trace_by_id"]
    assert rows == [] and not any(launches.values())   # no card here
    assert out["opened"] > 0 and out["present"] == 1024
    assert out["partials"] > 0 and out["partials_checked"] > 0
    assert out["absent"] == 1024
    assert 0 < out["absent_bloom_passes"] < out["absent_block_tests"] // 20
    for name in ("hit", "miss", "partial", "xxh64_page",
                 "index_reader_page"):
        assert len(out[name]["lat_ms"]) == 2
    assert out["index_page_bytes"] == 1024 * 28
