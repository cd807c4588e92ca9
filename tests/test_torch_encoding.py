"""The port's trace-object formats against the reference's, byte for byte.

Hashes (XXH64, FNV-1a), trace id helpers, the v1/v2 object codecs and
span-id combine, the block index and the sharded bloom, the streaming
block writer and the block reader. Every input is made from a numpy seed
(or by hypothesis); every comparison is exact: equal bytes, equal ints,
equal None.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import xxhash
from hypothesis import given, settings
from hypothesis import strategies as st

from tempo_tpu.backend.local import LocalBackend as RefLocalBackend
from tempo_tpu.backend.types import BlockMeta as RefBlockMeta
from tempo_tpu.encoding.v2 import bloom as ref_bloom
from tempo_tpu.encoding.v2 import index as ref_index
from tempo_tpu.encoding.v2.backend_block import BackendBlock as RefBackendBlock
from tempo_tpu.encoding.v2.streaming_block import \
    StreamingBlock as RefStreamingBlock
from tempo_tpu.model import codec as ref_codec
from tempo_tpu.utils import hashing as ref_hashing
from tempo_tpu.utils import ids as ref_ids
from tempo_tpu.utils.test_data import make_trace

from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.backend.raw import DoesNotExist
from tempo_tpu_torch.backend.types import (NAME_DATA, NAME_INDEX, BlockMeta,
                                           bloom_name)
from tempo_tpu_torch.encoding.compression import decompress
from tempo_tpu_torch.encoding.v2 import bloom, index
from tempo_tpu_torch.encoding.v2.backend_block import BackendBlock
from tempo_tpu_torch.encoding.v2.streaming_block import StreamingBlock
from tempo_tpu_torch.model import codec
from tempo_tpu_torch.model.combine import combine_trace_protos
from tempo_tpu_torch.utils import hashing, ids
from tempo_tpu_torch.utils.xxh64 import xxh64, xxh64_16

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SEED2 = 0x9E3779B97F4A7C15
TENANT = "t1"


# ---------------------------------------------------------------- hashes

@pytest.mark.parametrize("seed", [0, SEED2])
def test_xxh64_equals_xxhash_for_lengths_0_to_100(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    for n in range(101):
        data = rng.bytes(n)
        assert xxh64(data, seed) == xxhash.xxh64_intdigest(data, seed=seed)


@settings(max_examples=300, deadline=None)
@given(data=st.binary(max_size=300),
       seed=st.integers(min_value=0, max_value=(1 << 64) - 1))
def test_xxh64_equals_xxhash_property(data, seed):
    assert xxh64(data, seed) == xxhash.xxh64_intdigest(data, seed=seed)


@pytest.mark.parametrize("seed", [0, SEED2])
def test_xxh64_16_equals_the_scalar_path(seed):
    rng = np.random.default_rng(17)
    arr = np.frombuffer(rng.bytes(10_000 * 16),
                        dtype=np.uint8).reshape(-1, 16)
    got = xxh64_16(arr, seed)
    assert got.dtype == np.uint64
    assert [int(v) for v in got] == [xxh64(bytes(r), seed) for r in arr]
    with pytest.raises(ValueError):
        xxh64_16(arr[:, :8], seed)


def test_fnv1a_32_and_batch_equal_the_reference():
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 8, 16, 33):
        for _ in range(20):
            data = rng.bytes(n)
            assert hashing.fnv1a_32(data) == ref_hashing.fnv1a_32(data)
    arr = np.frombuffer(rng.bytes(4096 * 16), dtype=np.uint8).reshape(-1, 16)
    got = hashing.fnv1a_32_batch(arr)
    assert got.dtype == np.uint32
    assert np.array_equal(got, ref_hashing.fnv1a_32_batch(arr))
    assert [int(v) for v in got[:50]] == [hashing.fnv1a_32(bytes(r))
                                          for r in arr[:50]]


def test_trace_id_helpers_equal_the_reference():
    rng = np.random.default_rng(5)
    for n in (1, 8, 15, 16, 20):
        tid = rng.bytes(n)
        assert ids.pad_trace_id(tid) == ref_ids.pad_trace_id(tid)
        assert ids.trace_id_to_hex(tid) == ref_ids.trace_id_to_hex(tid)
    for s in ("abc", " 0A1b ", "f" * 32, "00" * 8 + "1" * 16):
        assert ids.hex_to_trace_id(s) == ref_ids.hex_to_trace_id(s)
    for bad in (b"", b"x" * 17):
        with pytest.raises(ValueError):
            ids.validate_trace_id(bad)
        with pytest.raises(ValueError):
            ref_ids.validate_trace_id(bad)
    with pytest.raises(ValueError):
        ids.hex_to_trace_id("ab" * 17)


# ---------------------------------------------------------------- codecs

@pytest.mark.parametrize("enc", ["v1", "v2"])
def test_codec_bytes_equal_the_reference(enc):
    rng = np.random.default_rng(11)
    port, ref = codec.codec_for(enc), ref_codec.codec_for(enc)
    for i in range(20):
        tid = rng.bytes(16)
        t = make_trace(tid, seed=i, batches=1 + i % 3, spans_per_batch=2)
        start = int(rng.integers(0, 1 << 33))   # past 32 bits: masked
        end = start + int(rng.integers(0, 100))
        obj = port.marshal(t, start, end)
        assert obj == ref.marshal(t, start, end)
        assert port.fast_range(obj) == ref.fast_range(obj)
        assert port.prepare_for_read(obj) == ref.prepare_for_read(obj)
        assert port.trace_bytes(obj) == ref.trace_bytes(obj)
    if enc == "v2":
        assert port.fast_range(port.marshal(t, 1 << 32, (1 << 32) + 5)) \
            == (0, 5)
        with pytest.raises(codec.DecodeError):
            port.fast_range(b"123")
        with pytest.raises(codec.DecodeError):
            port.prepare_for_read(b"1234567")
    with pytest.raises(ValueError):
        codec.codec_for("v3")


@pytest.mark.parametrize("enc", ["v1", "v2"])
def test_combine_equals_the_reference(enc):
    """Partials of one trace, with duplicated spans, combine to the
    reference's bytes in every order given."""
    rng = np.random.default_rng(12)
    port, ref = codec.codec_for(enc), ref_codec.codec_for(enc)
    tid = rng.bytes(16)
    full = make_trace(tid, seed=3, batches=3, spans_per_batch=3)
    parts = []
    for b in range(3):
        t = type(full)()
        t.batches.append(full.batches[b])
        if b:   # a duplicate of a span another partial holds
            t.batches[0].scope_spans[0].spans.append(
                full.batches[0].scope_spans[0].spans[1])
        parts.append(port.marshal(t, 100 + b, 200 - b))
    for order in ([0, 1, 2], [2, 0, 1], [1, 2], [0], []):
        objs = [parts[i] for i in order]
        got = port.combine(*objs)
        assert got == ref.combine(*objs)
    merged = combine_trace_protos([port.prepare_for_read(p) for p in parts])
    spans = [s.span_id for b in merged.batches for ss in b.scope_spans
             for s in ss.spans]
    assert len(spans) == len(set(spans)) == 9
    segs = [codec.segment_codec_for(enc).prepare_for_write(
        port.prepare_for_read(p), 100 + i, 150) for i, p in enumerate(parts)]
    assert codec.segment_codec_for(enc).to_object(segs) == \
        ref_codec.segment_codec_for(enc).to_object(segs)


# ---------------------------------------------------------------- index

def test_index_pages_equal_the_reference_and_find_agrees():
    rng = np.random.default_rng(21)
    keys = sorted(rng.bytes(16) for _ in range(300))
    recs = [index.Record(k, 1000 * i, 100 + i) for i, k in enumerate(keys)]
    rrecs = [ref_index.Record(k, 1000 * i, 100 + i)
             for i, k in enumerate(keys)]
    for per_page in (1, 7, 64, 1024):
        data = index.IndexWriter(per_page).write(recs)
        assert data == ref_index.IndexWriter(per_page).write(rrecs)
        r, p = ref_index.IndexReader(data), index.IndexReader(data)
        assert len(p) == len(r) == 300
        assert np.array_equal(p.ids, r.ids)
        assert np.array_equal(p.starts, r.starts)
        assert np.array_equal(p.lengths, r.lengths)
        probes = keys + [rng.bytes(16) for _ in range(300)] + [
            b"\x00" * 16, b"\xff" * 16, keys[5][:8], keys[-1][8:]]
        for k in probes:
            assert p.find_index(k) == r.find_index(k)
    assert len(index.IndexReader(b"")) == 0
    assert index.IndexReader(b"").find_index(keys[0]) is None
    # a record is its 16-byte id, then its start and length, little-endian
    assert recs[3].pack() == keys[3] + (3000).to_bytes(8, "little") + \
        (103).to_bytes(4, "little")


@pytest.mark.parametrize("cut", ["checksum", "header", "body"])
def test_index_corruption_raises_in_both(cut):
    rng = np.random.default_rng(22)
    keys = sorted(rng.bytes(16) for _ in range(20))
    data = bytearray(index.IndexWriter(8).write(
        [index.Record(k, i, 1) for i, k in enumerate(keys)]))
    if cut == "checksum":
        data[12 + 8 * 28 + 12 + 5] ^= 1      # a byte of page 2's records
    elif cut == "header":           # pages of 8, 8 and 4 records
        data = data[:2 * (12 + 8 * 28) + 5]
    else:
        data = data[:-3]
    with pytest.raises(index.IndexCorruptError):
        index.IndexReader(bytes(data))
    with pytest.raises(ref_index.IndexCorruptError):
        ref_index.IndexReader(bytes(data))


# ---------------------------------------------------------------- bloom

@pytest.mark.parametrize("shards,per_shard", [(1, 50), (3, 3000), (5, 900)])
def test_bloom_bits_equal_the_reference(shards, per_shard):
    rng = np.random.default_rng(31)
    keys = [rng.bytes(16) for _ in range(shards * per_shard)]
    p = bloom.ShardedBloom(shards, 0.01, per_shard)
    r = ref_bloom.ShardedBloom(shards, 0.01, per_shard)
    p.add_many(keys)
    r.add_many(keys)
    assert (p.m, p.k, p.shard_size_bytes()) == (r.m, r.k,
                                                 r.shard_size_bytes())
    for s in range(shards):
        assert p.marshal_shard(s) == r.marshal_shard(s)
    # one at a time, and ids that are not 16 bytes, give the same bits
    p1 = bloom.ShardedBloom(shards, 0.01, per_shard)
    r1 = ref_bloom.ShardedBloom(shards, 0.01, per_shard)
    odd = keys[:40] + [rng.bytes(8) for _ in range(40)]
    p1.add_many(odd)
    for k in odd:
        r1.add(k)
    for s in range(shards):
        assert p1.marshal_shard(s) == r1.marshal_shard(s)
    for k in keys[:200] + [rng.bytes(16) for _ in range(2000)]:
        shard = bloom.ShardedBloom.shard_for(k, shards)
        blob = p.marshal_shard(shard)
        assert bloom.ShardedBloom.test_marshalled(blob, k) == \
            ref_bloom.ShardedBloom.test_marshalled(blob, k)
        assert p.test(k) == r.test(k)
    with pytest.raises(ValueError):
        bloom.ShardedBloom.test_marshalled(p.marshal_shard(0)[:-8], keys[0])


# ---------------------------------------------------------------- blocks

def _objects(seed: int, n: int, short_every: int = 0) -> list:
    """n (id, object, start, end) in ascending padded-id order; with
    `short_every`, every such id is an 8-byte one."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tid = rng.bytes(8 if short_every and i % short_every == 0 else 16)
        obj = rng.bytes(int(rng.integers(1, 600)))
        start = 1_700_000_000 + int(rng.integers(0, 3600))
        out.append((tid, obj, start, start + int(rng.integers(0, 90))))
    return sorted(out, key=lambda o: ids.pad_trace_id(o[0]))


def _write(pkg: str, root: str, block_id: str, objs, enc: str,
           page_size: int, per_index_page: int, stream: bool):
    if pkg == "ref":
        be = RefLocalBackend(root)
        meta = RefBlockMeta(tenant_id=TENANT, block_id=block_id,
                            encoding=enc)
        sb = RefStreamingBlock(meta, page_size=page_size,
                               records_per_index_page=per_index_page,
                               backend=be if stream else None,
                               flush_size=8192)
    else:
        be = LocalBackend(root)
        meta = BlockMeta(tenant_id=TENANT, block_id=block_id, encoding=enc)
        sb = StreamingBlock(meta, page_size=page_size,
                            records_per_index_page=per_index_page,
                            backend=be if stream else None, flush_size=8192)
    for tid, obj, s, e in objs:
        sb.add_object(tid, obj, s, e)
    return be, sb.complete(be)


def _files(root: str, block_id: str) -> dict:
    d = os.path.join(root, TENANT, block_id)
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("stream", [False, True], ids=["buffered", "append"])
@pytest.mark.parametrize("page_size", [512, 4096, 1 << 20])
@pytest.mark.parametrize("enc", ["zlib", "none"])
def test_writer_bytes_equal_the_reference(tmp_path, enc, page_size, stream):
    """data, index, every bloom-N and meta.json byte-identical; several
    index pages (3 records a page); 8-byte ids among the 16-byte ones."""
    objs = _objects(41, 900, short_every=7)
    rb, rm = _write("ref", str(tmp_path / "ref"), "blk", objs, enc,
                    page_size, 3, stream)
    pb, pm = _write("port", str(tmp_path / "port"), "blk", objs, enc,
                    page_size, 3, stream)
    want = _files(str(tmp_path / "ref"), "blk")
    got = _files(str(tmp_path / "port"), "blk")
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    assert dataclasses.asdict(pm) == dataclasses.asdict(rm)
    assert dataclasses.asdict(BlockMeta.from_json(got["meta.json"])) == \
        dataclasses.asdict(RefBlockMeta.from_json(want["meta.json"]))
    if page_size == 512:
        assert pm.total_records > 3 * 3     # several index pages
    assert pm.bloom_shard_count == sum(n.startswith("bloom-") for n in got)


def test_writer_gzip_pages_equal_after_decompression(tmp_path):
    objs = _objects(42, 600)
    _, rm = _write("ref", str(tmp_path / "ref"), "blk", objs, "gzip", 2048,
                   4, True)
    _, pm = _write("port", str(tmp_path / "port"), "blk", objs, "gzip", 2048,
                   4, True)
    want = _files(str(tmp_path / "ref"), "blk")
    got = _files(str(tmp_path / "port"), "blk")
    ri, pi = ref_index.IndexReader(want["index"]), index.IndexReader(
        got["index"])
    assert np.array_equal(pi.ids, ri.ids) and len(pi) == pm.total_records
    pages = []
    for files, ix in ((want, ri), (got, pi)):
        pages.append([decompress(files["data"][int(s):int(s) + int(n)],
                                 "gzip")
                      for s, n in zip(ix.starts, ix.lengths)])
    assert pages[0] == pages[1] and len(pages[0]) > 3
    for name in want:
        if name.startswith("bloom-"):
            assert got[name] == want[name]
    assert pm.total_objects == rm.total_objects == 600


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("enc", ["zlib", "none", "gzip"])
def test_blocks_read_across_packages(tmp_path, writer, enc):
    """Every id of a block either package wrote reads back through both
    readers as the written bytes, 8-byte ids by both spellings."""
    objs = _objects(43, 700, short_every=5)
    root = str(tmp_path / writer)
    _write(writer, root, "blk", objs, enc, 2048, 4, True)
    meta_json = LocalBackend(root).read(TENANT, "blk", "meta.json")
    port = BackendBlock(LocalBackend(root), BlockMeta.from_json(meta_json))
    ref = RefBackendBlock(RefLocalBackend(root),
                          RefBlockMeta.from_json(meta_json))
    for tid, obj, _, _ in objs:
        spellings = {tid, ids.pad_trace_id(tid)}
        if len(tid) == 8:
            assert len(spellings) == 2
        for key in spellings:
            assert port.find_by_id(key) == obj
            assert ref.find_by_id(key) == obj
    assert list(port.iter_objects()) == list(ref.iter_objects())
    assert list(port.iter_objects(2, 3)) == list(ref.iter_objects(2, 3))
    assert port.bytes_in_pages(1, 4) == ref.bytes_in_pages(1, 4)
    assert port.bytes_in_pages(0) == port.meta.size
    assert [port.read_page(i) for i in range(3)] == \
        [ref.read_page(i) for i in range(3)]


def test_absent_ids_are_none_on_both_sides_with_equal_bloom_passes(tmp_path):
    """20,000 absent ids: None from both readers, and the same ids pass
    each block's bloom; the false positives go on to the index and a page
    read and still answer None."""
    objs = _objects(44, 4000)
    root = str(tmp_path / "b")
    _write("ref", root, "blk", objs, "zlib", 4096, 16, True)
    be = LocalBackend(root)
    meta = BlockMeta.from_json(be.read(TENANT, "blk", "meta.json"))
    port = BackendBlock(be, meta)
    ref = RefBackendBlock(RefLocalBackend(root), RefBlockMeta.from_json(
        be.read(TENANT, "blk", "meta.json")))
    present = {ids.pad_trace_id(o[0]) for o in objs}
    rng = np.random.default_rng(45)
    absent = [k for k in (rng.bytes(16) for _ in range(20_000))
              if k not in present]
    assert len(absent) == 20_000
    blobs = [be.read(TENANT, "blk", bloom_name(s))
             for s in range(meta.bloom_shard_count)]
    passed = {"port": 0, "ref": 0}
    for k in absent:
        blob = blobs[bloom.ShardedBloom.shard_for(k, meta.bloom_shard_count)]
        passed["port"] += bloom.ShardedBloom.test_marshalled(blob, k)
        passed["ref"] += ref_bloom.ShardedBloom.test_marshalled(blob, k)
        assert port.find_by_id(k) is None
        assert ref.find_by_id(k) is None
    assert passed["port"] == passed["ref"] > 0


def test_writer_refuses_ids_out_of_order_as_the_reference(tmp_path):
    for sb in (StreamingBlock(BlockMeta(tenant_id=TENANT, encoding="none")),
               RefStreamingBlock(RefBlockMeta(tenant_id=TENANT,
                                              encoding="none"))):
        sb.add_object(b"\x02" * 16, b"a")
        sb.add_object(b"\x02" * 16, b"b")        # equal ids pass
        with pytest.raises(ValueError):
            sb.add_object(b"\x01" * 16, b"c")
        # an 8-byte id pads to a smaller key than any 16-byte one here
        with pytest.raises(ValueError):
            sb.add_object(b"\xff" * 8, b"d")


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_abort_leaves_no_objects_behind(tmp_path, pkg):
    objs = _objects(46, 400)
    if pkg == "port":
        be, mk, sb_cls = LocalBackend(str(tmp_path / "b")), BlockMeta, \
            StreamingBlock
    else:
        be, mk, sb_cls = RefLocalBackend(str(tmp_path / "b")), \
            RefBlockMeta, RefStreamingBlock

    def objects(block_id):
        d = tmp_path / "b" / TENANT / block_id
        return sorted(os.listdir(d)) if d.exists() else []

    # mid-stream: an append part is out, no meta yet
    sb = sb_cls(mk(tenant_id=TENANT, block_id="mid", encoding="none"),
                page_size=512, backend=be, flush_size=2048)
    for tid, obj, s, e in objs:
        sb.add_object(tid, obj, s, e)
    assert len(objects("mid")) == 1       # the append's temp file
    sb.abort()
    assert objects("mid") == []
    # after complete: meta.json first, then every object it wrote
    sb = sb_cls(mk(tenant_id=TENANT, block_id="done", encoding="zlib"),
                page_size=512, backend=be, flush_size=2048)
    for tid, obj, s, e in objs:
        sb.add_object(tid, obj, s, e)
    sb.complete()
    assert "meta.json" in objects("done")
    sb.abort()
    assert objects("done") == []
    assert not (tmp_path / "b" / TENANT / "done").exists()


def test_zero_object_block_reads_as_empty(tmp_path):
    root = str(tmp_path / "b")
    _, rm = _write("ref", str(tmp_path / "r"), "blk", [], "zlib", 512, 4,
                   False)
    _, pm = _write("port", root, "blk", [], "zlib", 512, 4, False)
    assert dataclasses.asdict(pm) == dataclasses.asdict(rm)
    assert _files(root, "blk") == _files(str(tmp_path / "r"), "blk")
    blk = BackendBlock(LocalBackend(root), pm)
    assert blk.find_by_id(b"\x01" * 16) is None
    assert list(blk.iter_objects()) == [] and blk.bytes_in_pages(0) == 0


def test_local_backend_range_reads_appends_and_deletes(tmp_path):
    """The port's and the reference's LocalBackend agree on range reads,
    appended objects and deletes, over one directory."""
    root = str(tmp_path / "b")
    port, ref = LocalBackend(root), RefLocalBackend(root)
    tr = port.append(TENANT, "blk", NAME_DATA, None, b"hello ")
    tr = port.append(TENANT, "blk", NAME_DATA, tr, b"world")
    with pytest.raises(DoesNotExist):
        port.read(TENANT, "blk", NAME_DATA)     # invisible until closed
    port.close_append(TENANT, "blk", NAME_DATA, tr)
    assert ref.read(TENANT, "blk", NAME_DATA) == b"hello world"
    assert port.read_range(TENANT, "blk", NAME_DATA, 6, 5) == \
        ref.read_range(TENANT, "blk", NAME_DATA, 6, 5) == b"world"
    tr = ref.append(TENANT, "blk", NAME_INDEX, None, b"x")
    ref.close_append(TENANT, "blk", NAME_INDEX, tr)
    assert port.read(TENANT, "blk", NAME_INDEX) == b"x"
    tr = port.append(TENANT, "blk", "bloom-0", None, b"y")
    port.abort_append(TENANT, "blk", "bloom-0", tr)
    assert sorted(os.listdir(os.path.join(root, TENANT, "blk"))) == \
        [NAME_DATA, NAME_INDEX]
    port.delete(TENANT, "blk", NAME_DATA)
    with pytest.raises(DoesNotExist):
        port.delete(TENANT, "blk", NAME_DATA)
    with pytest.raises(DoesNotExist):
        port.read_range(TENANT, "blk", NAME_DATA, 0, 1)
    port.delete(TENANT, "blk", NAME_INDEX)
    assert not os.path.exists(os.path.join(root, TENANT, "blk"))
    # the in-memory default of a backend without native appends
    tr = super(LocalBackend, port).append(TENANT, "b2", NAME_DATA, None,
                                          b"ab")
    tr = super(LocalBackend, port).append(TENANT, "b2", NAME_DATA, tr, b"c")
    super(LocalBackend, port).close_append(TENANT, "b2", NAME_DATA, tr)
    assert zlib.crc32(port.read(TENANT, "b2", NAME_DATA)) == \
        zlib.crc32(b"abc")


@pytest.mark.parametrize("order", ["port_first", "reference_first"])
def test_tempopb_imports_beside_the_reference(order):
    """Both packages' generated modules register the same files in the
    default descriptor pool, in either import order, and name one Trace
    class; the port's import loads no tempo_tpu module."""
    first, second = (("tempo_tpu_torch.tempopb", "tempo_tpu.tempopb")
                     if order == "port_first"
                     else ("tempo_tpu.tempopb", "tempo_tpu_torch.tempopb"))
    code = (
        "import importlib, sys\n"
        f"a = importlib.import_module({first!r})\n"
        "ref_loaded = sorted(m for m in sys.modules\n"
        "                    if m.startswith('tempo_tpu.'))\n"
        f"b = importlib.import_module({second!r})\n"
        "assert a.Trace is b.Trace and a.Span is b.Span\n"
        "t = a.Trace()\n"
        "t.batches.add().scope_spans.add().spans.add().name = 'x'\n"
        "assert b.Trace.FromString(t.SerializeToString()) == t\n"
        "print(ref_loaded)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    if order == "port_first":
        assert r.stdout.strip() == "[]"
