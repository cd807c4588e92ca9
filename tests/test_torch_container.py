"""The port's host-side formats against the reference's, byte for byte.

From the same per-trace search data (made from a seed with numpy), the
port's ColumnarPages container must equal the reference's exactly, each
must decode the other's bytes, and query compilation must give equal term
tables. Also the search-data wire codec, ``ColumnarPages.from_arrays``
over the reference's columns, the block files ``write_search_block``
writes, and the codecs. All comparisons are exact.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from tempo_tpu import tempopb
from tempo_tpu.backend.local import LocalBackend as RefLocalBackend
from tempo_tpu.backend.types import BlockMeta as RefBlockMeta
from tempo_tpu.encoding.v2 import compression as ref_compression
from tempo_tpu.search import data as ref_data
from tempo_tpu.search.backend_search_block import \
    write_search_block as ref_write_search_block
from tempo_tpu.search.columnar import ColumnarPages as RefPages
from tempo_tpu.search.columnar import PageGeometry as RefGeometry
from tempo_tpu.search.pipeline import compile_query as ref_compile_query
from tempo_tpu.search.pipeline import ids_to_ranges as ref_ids_to_ranges

from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.backend.types import BlockMeta
from tempo_tpu_torch.encoding import compression
from tempo_tpu_torch.search import data
from tempo_tpu_torch.search.backend_search_block import write_search_block
from tempo_tpu_torch.search.columnar import ColumnarPages, PageGeometry
from tempo_tpu_torch.search.pipeline import CompileCache, compile_query, \
    ids_to_ranges
from tempo_tpu_torch.model.types import SearchRequest


def _entries(seed: int, n: int, mod):
    """`n` traces as `mod.SearchData` (the reference's or the port's)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        start = 1_700_000_000 + int(rng.integers(0, 10_000))
        dur = int(rng.integers(0, 90_000))
        kvs = {
            "service.name": {f"svc-{int(rng.integers(12)):02d}"},
            "http.status_code": {str(int(rng.choice([200, 404, 500])))},
            "name": {f"op-{int(rng.integers(30))}",
                     f"op-{int(rng.integers(30))}"},
        }
        if i % 5 == 0:
            kvs["region"] = {"us-east-1", "eu-west-1", "ap-süd-1"}
        if i % 17 == 0:   # wider than the slot cap: truncated entries
            kvs["x.tag"] = {f"v{j}" for j in range(12)}
        out.append(mod.SearchData(
            trace_id=rng.bytes(16 if i % 7 else 8), start_s=start,
            end_s=start + dur // 1000, dur_ms=dur,
            root_service=next(iter(kvs["service.name"])),
            root_name="" if i % 11 == 0 else sorted(kvs["name"])[0],
            kvs=kvs))
    return out


@pytest.mark.parametrize("n,E,cap", [(1, 1024, 64), (300, 64, 8),
                                     (1500, 128, 16), (0, 32, 4)])
def test_container_bytes_identical(n, E, cap):
    ref = RefPages.build(_entries(n, n, ref_data), RefGeometry(E, cap))
    port = ColumnarPages.build(_entries(n, n, data), PageGeometry(E, cap))
    ref_b = ref.to_bytes()
    assert port.to_bytes() == ref_b
    assert port.header == ref.header
    # each package decodes the other's bytes to the same container
    for got, want in ((ColumnarPages.from_bytes(ref_b), ref),
                      (RefPages.from_bytes(port.to_bytes()), port)):
        assert got.header == RefPages.from_bytes(ref_b).header
        assert (got.key_dict, got.val_dict) == (want.key_dict, want.val_dict)
        for name, _ in ColumnarPages._ARRAYS:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))


def test_from_arrays_matches_build():
    ref = RefPages.build(_entries(3, 700, ref_data), RefGeometry(128, 8))
    port = ColumnarPages.from_arrays(
        ref.key_dict, ref.val_dict, ref.kv_key, ref.kv_val, ref.entry_start,
        ref.entry_end, ref.entry_dur, ref.entry_valid, ref.entry_root_svc,
        ref.entry_root_name, ref.trace_ids,
        truncated_entries=ref.header["truncated_entries"])
    assert port.header == ref.header
    assert port.to_bytes() == ref.to_bytes()


def test_slice_pages_matches_reference():
    blob = RefPages.build(_entries(4, 500, ref_data),
                          RefGeometry(64, 8)).to_bytes()
    ref, port = RefPages.from_bytes(blob), ColumnarPages.from_bytes(blob)
    a, b = ref.slice_pages(2, 3), port.slice_pages(2, 3)
    assert a.header == b.header
    assert a.to_bytes() == b.to_bytes()


def test_search_data_codec_identical():
    for ref_sd, sd in zip(_entries(5, 60, ref_data), _entries(5, 60, data)):
        blob = ref_data.encode_search_data(ref_sd)
        assert data.encode_search_data(sd) == blob
        back = data.decode_search_data(blob, trace_id=sd.trace_id)
        assert back == sd


_REQS = [
    ({"service.name": "svc-03"}, {}),
    ({"service.name": "svc-0", "http.status_code": "5"}, {}),
    ({"name": "op-1"}, {"min_duration_ms": 100, "limit": 7}),
    ({"region": "-"}, {"start": 1_700_001_000, "end": 1_700_002_000}),
    ({"region": "süd"}, {}),
    ({"service.name": ""}, {}),
    ({"no.such.key": "x"}, {}),
    ({"service.name": "zzz"}, {}),
    ({"x-dbg-exhaustive": "", "no.such.key": "x", "name": "op-2"}, {}),
    ({}, {"max_duration_ms": 5_000}),
]


@pytest.mark.parametrize("i", range(len(_REQS)))
def test_compile_query_tables_identical(i):
    tags, kw = _REQS[i]
    pages = RefPages.build(_entries(6, 400, ref_data), RefGeometry(64, 8))
    rreq = tempopb.SearchRequest()
    for k, v in tags.items():
        rreq.tags[k] = v
    for k, v in kw.items():
        setattr(rreq, k, v)
    want = ref_compile_query(pages.key_dict, pages.val_dict, rreq)
    cache = CompileCache()
    port_pages = ColumnarPages.from_bytes(pages.to_bytes())
    for _ in range(2):   # second pass is a compile-cache hit
        got = compile_query(port_pages.key_dict, port_pages.val_dict,
                            SearchRequest(tags=dict(tags), **kw),
                            cache_on=port_pages, cache=cache)
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got.term_keys, want.term_keys)
        np.testing.assert_array_equal(got.val_ranges, want.val_ranges)
        assert (got.dur_lo, got.dur_hi, got.win_start, got.win_end,
                got.limit) == (want.dur_lo, want.dur_hi, want.win_start,
                               want.win_end, want.limit)


def test_ids_to_ranges_identical():
    rng = np.random.default_rng(9)
    for _ in range(20):
        ids = np.unique(rng.integers(0, 200, size=int(rng.integers(0, 60))))
        ids = ids.astype(np.int32)
        np.testing.assert_array_equal(ids_to_ranges(ids),
                                      ref_ids_to_ranges(ids))


def test_reserved_tags_are_refused():
    """The ?agg= tag is answered now: it is no tag term, so a request
    carrying it compiles as its plain twin does. The structural tag is
    refused only where the database's structural gate is off (it is not
    a tag term either way)."""
    from tempo_tpu_torch.search import ir
    from tempo_tpu_torch.search.structural import StructuralConfig, \
        structural_query

    pages = ColumnarPages.build(_entries(7, 10, data), PageGeometry(8, 4))
    assert compile_query(pages.key_dict, pages.val_dict,
                         SearchRequest(tags={"x-agg-q": "red"})).n_terms == 0
    tags = dict(_REQS[1][0])
    twin = compile_query(pages.key_dict, pages.val_dict,
                         SearchRequest(tags=tags))
    agg = compile_query(pages.key_dict, pages.val_dict,
                        SearchRequest(tags=dict(tags, **{"x-agg-q": "red"})))
    assert twin.n_terms == agg.n_terms == 2
    np.testing.assert_array_equal(agg.term_keys, twin.term_keys)
    np.testing.assert_array_equal(agg.val_ranges, twin.val_ranges)
    req = SearchRequest(tags={"x-structural-q":
                              ir.quote('{"exists": {"kind": 2}}')})
    with pytest.raises(ValueError):
        structural_query(req, StructuralConfig())
    assert structural_query(req, StructuralConfig(enabled=True)) is not None
    cq = compile_query(pages.key_dict, pages.val_dict, req)
    assert cq.n_terms == 0


def test_written_block_files_identical(tmp_path):
    """write_search_block writes the same container, header and meta
    fields as the reference's for the same block."""
    ref_be = RefLocalBackend(str(tmp_path / "ref"))
    be = LocalBackend(str(tmp_path / "port"))
    geometry = (64, 8)
    ref_meta = RefBlockMeta(tenant_id="t")
    meta = BlockMeta(tenant_id="t", block_id=ref_meta.block_id)
    ref_hdr = ref_write_search_block(ref_be, ref_meta,
                                     _entries(8, 200, ref_data),
                                     geometry=RefGeometry(*geometry),
                                     encoding="zlib")
    hdr = write_search_block(be, meta, _entries(8, 200, data),
                             geometry=PageGeometry(*geometry),
                             encoding="zlib")
    assert hdr == ref_hdr
    for name in ("search", "search-header.json"):
        assert be.read("t", meta.block_id, name) == \
            ref_be.read("t", meta.block_id, name)
    assert json.loads(be.read("t", meta.block_id, "meta.json")) == \
        json.loads(ref_be.read("t", meta.block_id, "meta.json"))


@pytest.mark.parametrize("enc", ["none", "gzip", "zlib", "zstd"])
def test_codecs_read_reference_bytes(enc):
    raw = RefPages.build(_entries(10, 100, ref_data),
                         RefGeometry(32, 8)).to_bytes()
    if not compression.usable(enc):
        with pytest.raises(RuntimeError):
            compression.compress(raw, enc)
        return
    blob = ref_compression.compress(raw, enc)
    assert compression.decompress(blob, enc) == raw
    assert ref_compression.decompress(compression.compress(raw, enc),
                                      enc) == raw
