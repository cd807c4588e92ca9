"""The port's host library (``tempo_tpu_torch/ops/native.py`` over
``csrc/host/tempotpu.cc``) against the reference's ``tempo_tpu.ops.native``
and against the port's own plain versions.

Each test builds the port's library at its first use (``g++``; the tests
skip where no C++ compiler is on PATH). Covered: the codecs' round trips
and their bytes read by the other package both ways (zstd, lz4, snappy and
``s2``, with the same u64 length framing); XXH64 against the plain Python
one and the ``xxhash`` wheel; CRC32C against the reference's Python table
CRC; the substring scan against numpy and the reference's scan; and the
ingest walker's items against the port's Python walk and the reference's,
gate off and on, over the budget cut, 8-byte ids, split traces, double
values, thousands of scopes, hostile bytes, an invalid trace id, and
``schema_url`` and unknown fields, where the reference's own walker writes
other bytes (pinned here as a reference behaviour).
"""

from __future__ import annotations

import random
import shutil
import struct

import numpy as np
import pytest
import xxhash
from hypothesis import given, settings
from hypothesis import strategies as st

from tempo_tpu.api.kafka import _crc32c_py
from tempo_tpu.encoding.v2 import compression as ref_compression
from tempo_tpu.model.codec import segment_codec_for as ref_segment_codec_for
from tempo_tpu.modules.distributor import Distributor as RefDistributor
from tempo_tpu.ops import native as ref_native
from tempo_tpu.search import data as ref_data
from tempo_tpu.search import pipeline as ref_pipeline

from tempo_tpu_torch import tempopb
from tempo_tpu_torch.encoding import compression
from tempo_tpu_torch.modules import distributor
from tempo_tpu_torch.modules.distributor import push_items, push_items_plain
from tempo_tpu_torch.ops import native
from tempo_tpu_torch.search import pipeline
from tempo_tpu_torch.search.data import (_any_value_str, decode_search_data)
from tempo_tpu_torch.search.structural import OFF, StructuralConfig
from tempo_tpu_torch.utils.xxh64 import xxh64, xxh64_plain

from tests.torch_otlp import make_pushes

ON = StructuralConfig(enabled=True)


@pytest.fixture(autouse=True)
def _compiler():
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler on PATH: the host library cannot be "
                    "built")


@pytest.fixture(scope="module")
def pushes():
    return make_pushes(20261019, 300, n_pushes=4)[0]


def _ref_items(batches, max_bytes: int, spans: bool, max_spans=512,
               max_kvs=16) -> list:
    """The items the reference's push builds from its Python walk."""
    by_trace, _n, sds = RefDistributor._regroup_extract(batches, max_bytes)
    codec = ref_segment_codec_for("v2")
    out = []
    for tid, trace in by_trace.items():
        sd = sds[tid]
        if spans:
            sd.spans = ref_data.collect_span_rows(trace, max_spans, max_kvs)
        out.append((tid, sd.start_s, sd.end_s,
                    codec.prepare_for_write(trace, sd.start_s, sd.end_s),
                    ref_data.encode_search_data(sd)))
    return out


def _walks_agree(batches, max_bytes=5 << 10, cfg=OFF) -> list:
    """push_items (the native walker) equals push_items_plain and the
    reference's Python walk, item for item and byte for byte."""
    before = distributor.NATIVE_WALKS.n
    got, n = push_items(batches, max_bytes, cfg)
    assert distributor.NATIVE_WALKS.n == before + 1
    plain, n_plain = push_items_plain(batches, max_bytes, cfg)
    assert n == n_plain == sum(len(ss.spans) for b in batches
                               for ss in b.scope_spans)
    assert got == plain
    assert got == _ref_items(batches, max_bytes, cfg.enabled,
                             cfg.max_spans, cfg.max_span_kvs)
    return got


# ------------------------------------------------------------------ build

def test_library_builds_into_the_port_build_dir():
    lib = native.lib()
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libtempotpu-") and path.exists()
    assert path.with_suffix(".log").read_text() == native.BUILD_LOG
    assert lib is native.lib()
    assert native.SOURCE.name == "tempotpu.cc"
    assert "snappy" in native.codecs()


def test_a_failed_build_raises_with_the_compilers_log(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="bad.cc") as e:
        native.build()
    assert "error" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))


# ----------------------------------------------------------------- codecs

def _inputs():
    rng = np.random.default_rng(19)
    out = []
    for n in (0, 1, 3, 14, 15, 16, 61, 100, 4096, 65535, 65536, 65537,
              300_000):
        out.append(rng.bytes(n))
        out.append(bytes(rng.integers(0, 4, size=n, dtype=np.uint8)))
        out.append((b"service.name=svc-007 http.method=GET " * (n // 37 + 1)
                    )[:n])
    return out


INPUTS = _inputs()


@pytest.mark.parametrize("enc", ["zstd", "lz4", "snappy", "s2"])
def test_codecs_round_trip_and_cross_decode_both_ways(enc):
    for raw in INPUTS:
        mine = compression.compress(raw, enc)
        theirs = ref_compression.compress(raw, enc)
        assert compression.decompress(mine, enc) == raw
        assert compression.decompress(theirs, enc) == raw
        assert ref_compression.decompress(mine, enc) == raw
        if enc == "zstd" or enc == "lz4":   # the same host libraries
            assert mine == theirs
        else:                               # the framing: a u64 length
            assert mine[:8] == theirs[:8] == struct.pack("<Q", len(raw))


@settings(max_examples=200, deadline=None)
@given(raw=st.binary(max_size=3000), rep=st.integers(1, 40))
def test_snappy_property_against_the_reference(raw, rep):
    data = raw * rep
    mine = native.snappy_compress(data)
    assert ref_native.snappy_decompress(mine) == data
    assert native.snappy_decompress(ref_native.snappy_compress(data)) == data
    assert len(mine) <= 8 + 32 + len(data) + len(data) // 6


def _ref_snappy(blob: bytes):
    try:
        return ref_native.snappy_decompress(blob)
    except RuntimeError:
        return None


def _port_snappy(blob: bytes):
    try:
        return native.snappy_decompress(blob)
    except RuntimeError:
        return None


@settings(max_examples=300, deadline=None)
@given(body=st.binary(max_size=200), n=st.integers(0, 400))
def test_snappy_hostile_bytes_decode_as_the_reference(body, n):
    """Arbitrary bytes behind a length prefix: the port decodes exactly
    what libsnappy decodes, to the same bytes, and raises otherwise."""
    blob = struct.pack("<Q", n) + body
    assert _port_snappy(blob) == _ref_snappy(blob)


def test_corrupt_frames_raise():
    good = native.snappy_compress(b"abcabcabcabcabcabc" * 100)
    for blob in (good[:-3], good[:8] + b"\xff" * 20,
                 struct.pack("<Q", 10) + b"\x0a\x08abc"):
        with pytest.raises(RuntimeError):
            native.snappy_decompress(blob)
    with pytest.raises(RuntimeError):
        native.lz4_decompress(struct.pack("<Q", 100) + b"\xff" * 30)
    with pytest.raises(RuntimeError, match="not a zstd frame"):
        native.zstd_decompress(b"definitely not zstd")


def test_zstd_frames_without_a_size_and_concatenated():
    import zstandard

    raw = INPUTS[-1] * 3
    cobj = zstandard.ZstdCompressor().compressobj()
    streamed = cobj.compress(raw) + cobj.flush()
    assert native.lib().tt_zstd_content_size(streamed, len(streamed)) == -2
    assert native.zstd_decompress(streamed) == raw
    two = native.zstd_compress(raw[:1000]) + native.zstd_compress(raw[1000:])
    assert native.zstd_decompress(two) == raw


def test_codecs_name_what_loaded_and_a_missing_one_raises(monkeypatch):
    assert set(native.codecs()) <= {"zstd", "lz4", "snappy"}
    assert set(native.codecs()) == {"zstd", "lz4", "snappy"}   # this host
    for enc in ("zstd", "lz4", "snappy", "s2", "none", "gzip", "zlib"):
        assert compression.usable(enc)
    assert not compression.usable("brotli")
    monkeypatch.setattr(native, "codecs", lambda: ("snappy",))
    monkeypatch.setattr(compression, "_zstd", None)
    assert not compression.usable("lz4") and not compression.usable("zstd")
    for enc in ("lz4", "zstd"):
        with pytest.raises(RuntimeError, match=enc):
            compression.compress(b"x", enc)
        with pytest.raises(RuntimeError, match=enc):
            compression.decompress(b"x", enc)
    assert compression.decompress(compression.compress(b"xy", "s2"),
                                  "snappy") == b"xy"


def test_a_codec_library_the_host_lacks_raises_by_name(monkeypatch):
    """The C side's answer for a codec whose library did not load."""
    lib = native.lib()

    class NoZstd:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def tt_zstd_content_size(data, n):
            return -5

        @staticmethod
        def tt_lz4_compress(*a):
            return -5

    monkeypatch.setattr(native, "lib", lambda: NoZstd())
    with pytest.raises(native.CodecUnavailable, match="zstd"):
        native.zstd_decompress(b"\x28\xb5\x2f\xfd")
    with pytest.raises(native.CodecUnavailable, match="lz4"):
        native.lz4_compress(b"abc")


# ----------------------------------------------------------------- hashes

@settings(max_examples=300, deadline=None)
@given(data=st.binary(max_size=400),
       seed=st.integers(min_value=0, max_value=(1 << 64) - 1))
def test_xxhash64_equals_the_plain_version_and_the_wheel(data, seed):
    want = xxhash.xxh64_intdigest(data, seed=seed)
    assert native.xxhash64(data, seed) == want
    assert xxh64(data, seed) == want
    assert xxh64_plain(data, seed) == want
    assert ref_native.xxhash64(data, seed) == want


def test_xxh64_takes_any_bytes_like():
    data = bytes(range(256)) * 5
    want = xxh64_plain(data, 3)
    assert xxh64(bytearray(data), 3) == xxh64(memoryview(data), 3) == want


@settings(max_examples=300, deadline=None)
@given(data=st.binary(max_size=400), crc=st.integers(0, 0xFFFFFFFF))
def test_crc32c_equals_the_reference_table_crc(data, crc):
    assert native.crc32c(data, crc) == _crc32c_py(data, crc)
    assert native.crc32c(data, crc) == ref_native.crc32c(data, crc)


def test_crc32c_known_answer():
    assert native.crc32c(b"123456789") == 0xE3069283


# ----------------------------------------------------------- substr scan

_ALPHA = st.text(alphabet="abé€𝄞-0", max_size=6)


@settings(max_examples=300, deadline=None)
@given(vals=st.lists(_ALPHA, max_size=40), needle=_ALPHA)
def test_substr_scan_equals_numpy_and_the_reference(vals, needle):
    """UTF-8 values, empty ones among them, end to end: a match that
    straddles two values is no match; the empty needle matches all."""
    buf, offsets = pipeline.pack_val_dict(vals)
    want = pipeline.substring_value_ids_plain(vals, needle)
    got = native.substr_scan(buf, offsets, needle.encode("utf-8"))
    assert got.dtype == np.int32 and got.tolist() == want.tolist()
    assert ref_native.substr_scan(buf, offsets,
                                  needle.encode("utf-8")).tolist() == \
        want.tolist()


def test_substr_scan_straddles_and_grows_its_output():
    vals = ["ab", "cab", "c", "", "abc"] * 3000
    buf, offsets = pipeline.pack_val_dict(vals)
    assert native.substr_scan(buf, offsets, b"bc").tolist() == \
        [i for i, v in enumerate(vals) if "bc" in v]
    every = native.substr_scan(buf, offsets, b"")
    assert every.tolist() == list(range(len(vals)))   # past the first cap
    with pytest.raises(ValueError):
        native.substr_scan(buf[:-1], offsets, b"a")


def test_substring_value_ids_takes_the_scan_from_the_threshold(monkeypatch):
    rng = random.Random(5)
    vals = sorted({f"session-{rng.randrange(10**9)}-é" for _ in range(3000)})
    for needle in ("12", "é", "-9", "zz", ""):
        want = pipeline.substring_value_ids_plain(vals, needle)
        assert pipeline.substring_value_ids(vals, needle).tolist() == \
            want.tolist()
        assert ref_pipeline.substring_value_ids(vals, needle).tolist() == \
            want.tolist()
    calls = []
    monkeypatch.setattr(native, "substr_scan",
                        lambda *a: calls.append(a) or np.zeros(0, np.int32))
    pipeline.substring_value_ids(vals, "12")
    assert not calls                      # below the threshold: numpy
    monkeypatch.setattr(pipeline, "NATIVE_SCAN_THRESHOLD", 1000)
    pipeline.substring_value_ids(vals, "12")
    pipeline.substring_value_ids(vals, "34")
    assert len(calls) == 2 and calls[0][0] is calls[1][0]   # packed once


# ----------------------------------------------------------------- walker

@pytest.mark.parametrize("cfg", [OFF, ON,
                                 StructuralConfig(enabled=True, max_spans=3,
                                                  max_span_kvs=2)],
                         ids=["gate_off", "gate_on", "gate_on_capped"])
@pytest.mark.parametrize("max_bytes", [5 << 10, 300, 0])
def test_walker_items_equal_both_python_walks(pushes, cfg, max_bytes):
    """Over every push of the seeded input (8-byte ids, traces split over
    pushes, repeated resources, the budget cut at 300 bytes and at 0,
    skewed and missing ends, doubles, schema_url on every batch)."""
    for batches in pushes:
        _walks_agree(batches, max_bytes, cfg)


def test_split_traces_rejoin_as_in_the_python_walk(pushes):
    """A trace split over pushes gives an item in each, whose segments
    together decode to the trace's spans."""
    seen: dict = {}
    for batches in pushes:
        for tid, *_rest in _walks_agree(batches):
            seen[tid] = seen.get(tid, 0) + 1
    assert max(seen.values()) >= 2
    assert any(len(t.rstrip(b"\0")) <= 8 or t[:8] == bytes(8) for t in seen)


def _batch(svc="s", scope="lib", n_spans=1, tid=b"T" * 16, **rs_kw):
    b = tempopb.ResourceSpans(**rs_kw)
    kv = b.resource.attributes.add()
    kv.key = "service.name"
    kv.value.string_value = svc
    ss = b.scope_spans.add()
    ss.scope.name = scope
    for i in range(n_spans):
        sp = ss.spans.add(trace_id=tid, span_id=(i + 1).to_bytes(8, "big"),
                          name=f"op{i}", start_time_unix_nano=10**9 + i,
                          end_time_unix_nano=2 * 10**9 + i)
        if i:
            sp.parent_span_id = (1).to_bytes(8, "big")
    return b


def test_double_values_format_as_python_repr():
    rng = random.Random(0)
    vals = [2e5, 1e7, 1e15, 1e16, 1e-4, 1e-5, 1.5, 2.0, 0.1, -3.25e17,
            9999999999999998.0, -0.0, 0.0, 1.5e-5, float("inf"),
            float("-inf"), float("nan")]
    vals += [rng.uniform(-1e20, 1e20) for _ in range(150)]
    vals += [rng.uniform(-1e-6, 1e-6) for _ in range(100)]
    batches = []
    for v in vals:
        b = _batch()
        kv = b.resource.attributes.add()
        kv.key = "d"
        kv.value.double_value = v
        batches.append(b)
        items, _ = push_items([b], 1 << 30)
        got = decode_search_data(items[0][4], b"T" * 16).kvs.get("d")
        assert got == {_any_value_str(kv.value)}, (v, got)
    _walks_agree(batches, 1 << 30, ON)


def test_thousands_of_scopes_one_trace():
    b = _batch(n_spans=0)
    del b.scope_spans[:]
    for i in range(2300):
        ss = b.scope_spans.add()
        ss.scope.name = f"lib-{i % 7}"
        ss.spans.add(trace_id=b"T" * 16, span_id=i.to_bytes(8, "little"),
                     name=f"op{i}", start_time_unix_nano=1,
                     end_time_unix_nano=2 + i)
    items = _walks_agree([b, _batch()], 1 << 20, ON)
    assert len(items) == 1


def test_schema_url_and_unknown_fields_follow_the_python_walk():
    """A pushed ResourceSpans and ScopeSpans with schema_url, and unknown
    fields at both levels: the port's walker writes resource, scope_spans,
    schema_url (and scope, spans, schema_url) and drops the unknown ones,
    as protobuf does for the Python walk. A batch without a resource and a
    scope without a scope message get empty ones, as there too."""
    a = _batch(schema_url="https://opentelemetry.io/schemas/1.21.0")
    a.scope_spans[0].schema_url = "https://example.com/scope/1"
    raw = a.SerializeToString() + b"\x22\x02hi" + b"\xa8\x1f\x07"
    with_unknown = tempopb.ResourceSpans.FromString(raw)
    ss_raw = with_unknown.scope_spans[0].SerializeToString() + b"\x2a\x01z"
    with_unknown.scope_spans[0].ParseFromString(ss_raw)
    assert with_unknown.SerializeToString() != a.SerializeToString()
    bare = tempopb.ResourceSpans()
    bare.scope_spans.add().spans.add(trace_id=b"U" * 16, name="x",
                                     start_time_unix_nano=1,
                                     end_time_unix_nano=5)
    for batches in ([a], [with_unknown], [bare], [a, with_unknown, bare]):
        for cfg in (OFF, ON):
            items = _walks_agree(batches, 5 << 10, cfg)
    seg = items[0][3]
    tr = tempopb.Trace.FromString(seg[8:])
    assert tr.batches[0].schema_url == a.schema_url
    assert tr.batches[0].scope_spans[0].schema_url == \
        a.scope_spans[0].schema_url


def test_reference_walker_writes_schema_url_before_the_spans():
    """A reference behaviour, not fixed in tempo_tpu: its walker copies a
    batch's and a scope's other fields in input order, so schema_url (3)
    lands before scope_spans (2) and spans (2), and unknown fields pass
    through. The same spans, other bytes, and the same search data."""
    a = _batch(schema_url="https://opentelemetry.io/schemas/1.21.0")
    a.scope_spans[0].schema_url = "https://example.com/scope/1"
    blobs = [a.SerializeToString()]
    _, ref_items, _ = ref_native.ingest_regroup(blobs, 5 << 10)
    _, port_items, _ = native.ingest_regroup(blobs, 5 << 10)
    ref_seg, port_seg = ref_items[0][3], port_items[0][3]
    assert len(ref_seg) == len(port_seg) and ref_seg != port_seg
    assert ref_items[0][4] == port_items[0][4]
    assert tempopb.Trace.FromString(ref_seg[8:]) == \
        tempopb.Trace.FromString(port_seg[8:])
    unknown = tempopb.ResourceSpans.FromString(blobs[0] + b"\x22\x02hi")
    _, ref_items, _ = ref_native.ingest_regroup(
        [unknown.SerializeToString()], 5 << 10)
    assert len(ref_items[0][3]) == len(port_seg) + 4


def test_summaries_equal_the_references(pushes):
    for batches in pushes:
        blobs = [b.SerializeToString() for b in batches]
        for spans in (False, True):
            got = native.ingest_regroup(blobs, 5 << 10, spans=spans)
            want = ref_native.ingest_regroup(blobs, 5 << 10, spans=spans)
            assert got[0] == want[0] and got[2] == want[2]
            assert len(got[2]) > 8


def test_invalid_trace_ids_raise_the_python_walks_error():
    for tid in (b"", b"x" * 17):
        b = _batch(tid=tid)
        with pytest.raises(native.InvalidTraceId):
            native.ingest_regroup([b.SerializeToString()], 100)
        before = distributor.NATIVE_WALKS.n
        with pytest.raises(ValueError, match="invalid trace id") as e:
            push_items([_batch(), b])
        with pytest.raises(ValueError) as e_plain:
            push_items_plain([_batch(), b])
        assert type(e.value) is type(e_plain.value) is ValueError
        assert str(e.value) == str(e_plain.value)
        assert distributor.NATIVE_WALKS.n == before


@pytest.mark.parametrize("blob", [
    b"\x0a",                                   # a tag and no length
    b"\x12\xff\xff\xff\xff\xff\xff\xff\xff\xff\x01",   # a 2^64 length
    b"\x12\x05\x12\x03\x0a\x01",               # a span cut short
    b"\x0f" + b"\x00" * 10,                    # wire type 7
    b"\x12\x0b\x12\x09\x39\x01\x02\x03",       # a fixed64 cut short
])
def test_hostile_bytes_give_a_clean_error(blob):
    with pytest.raises(RuntimeError, match="tt_ingest_regroup2"):
        native.ingest_regroup([blob], 100)
    src = struct.pack("<I", 100) + b"\x0a\x00"   # a record past the end
    fn = native.lib().tt_ingest_regroup2
    import ctypes

    dst = ctypes.create_string_buffer(64)
    assert fn(src, len(src), 100, 0, 0, 0, dst, 64) == -2


def test_empty_push_and_output_growth():
    assert native.ingest_regroup([], 100) == (0, [], struct.pack("<II", 0, 0))
    big = _batch(n_spans=2000)
    for sp in big.scope_spans[0].spans:
        sp.trace_id = sp.span_id * 2
    items = _walks_agree([big], 1 << 20, ON)
    assert len(items) == 2000
