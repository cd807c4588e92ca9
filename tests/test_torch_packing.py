"""Packed residency in the port (``search/packing.py``, K5 and the packed
bodies of K1, K1s and K4) against the reference's packing.

The reference's gate is one process-wide switch; its own tests flip it
with ``packing.configure`` and clear ``pipeline._COMPILE_CACHE`` between
states (``tests/test_packing.py``), and so do these, in an autouse
fixture that leaves the process as it found it. The port's gate is a
flag on each database and engine. The reference runs on JAX's CPU
backend; the port on the CPU, where the kernel wrappers take their plain
versions (the kernels themselves run only on the card, where
``chip_smoke.py`` holds them against these).

Everything compared is an integer or a byte, so the tolerance is zero:
- the width rules at 15/16/17, 255/256/257 and 65535/65536/65537, and the
  duration rule;
- ``pack_ids_array``, ``pack_duration``, ``pack_columns`` and
  ``stack_host``'s packed batch, byte for byte;
- the plain ``unpack_ids``, ``duration_ok`` (bucket edges, hi = 2^32-1),
  ``mask_select(_grouped)`` and ``pack_mask_words`` against the jnp
  functions;
- K1's, K1s's and K4's plain versions against ``multi_scan_kernel``,
  ``scan_kernel`` and ``coalesced_scan_kernel`` on the reference's own
  packed staging, for every key/value width pair in {u4, u8, u16, u32}^2,
  u16 and bucketed durations (u8 and u16 residuals), and bool and word
  hit tables: equal counts, and the full match sets;
- end to end, a packed port ``TempoDB`` against a packed reference
  ``TempoDB`` and against an unpacked port one, through ``search``,
  ``search_block``, ``BackendSearchBlock.search`` and 8 concurrent
  threads; staged bytes, physical against logical; and two databases in
  one process, one packed and one not (ROADMAP.md item C).
Every thread join and future wait has a timeout.
"""

from __future__ import annotations

import concurrent.futures
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu import tempopb
from tempo_tpu.backend.local import LocalBackend as RefLocalBackend
from tempo_tpu.backend.types import BlockMeta as RefBlockMeta
from tempo_tpu.db import TempoDB as RefTempoDB
from tempo_tpu.db import TempoDBConfig as RefTempoDBConfig
from tempo_tpu.search import dict_probe as ref_dict_probe
from tempo_tpu.search import packing as ref_packing
from tempo_tpu.search import pipeline as ref_pipeline
from tempo_tpu.search.backend_search_block import \
    BackendSearchBlock as RefBackendSearchBlock
from tempo_tpu.search.backend_search_block import \
    write_search_block as ref_write_search_block
from tempo_tpu.search.columnar import ColumnarPages as RefColumnarPages
from tempo_tpu.search.columnar import PageGeometry as RefPageGeometry
from tempo_tpu.search.data import SearchData as RefSearchData
from tempo_tpu.search.engine import scan_kernel
from tempo_tpu.search.engine import stage as ref_stage
from tempo_tpu.search.multiblock import coalesced_scan_kernel
from tempo_tpu.search.multiblock import multi_scan_kernel
from tempo_tpu.search.multiblock import stack_host as ref_stack_host

from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.model.types import SearchBlockRequest, SearchRequest
from tempo_tpu_torch.search import dict_probe, packing
from tempo_tpu_torch.search.backend_search_block import BackendSearchBlock
from tempo_tpu_torch.search.columnar import ColumnarPages
from tempo_tpu_torch.search.engine import stage
from tempo_tpu_torch.search.kernels.pack import pack_mask_words_plain
from tempo_tpu_torch.search.kernels.scan import (coalesced_scan_plain,
                                                 multi_scan_plain,
                                                 scan_single_plain)
from tempo_tpu_torch.search.multiblock import stack_host

U32 = 0xFFFFFFFF
CPU = torch.device("cpu")
WAIT_S = 60


@pytest.fixture(autouse=True)
def _reference_gate_off_and_cold_cache():
    """The reference's gate is process-wide: start each test with it off
    and its compile cache empty, and leave it so."""
    ref_packing.configure(enabled=False)
    ref_pipeline._COMPILE_CACHE.clear()
    yield
    ref_packing.configure(enabled=False)
    ref_pipeline._COMPILE_CACHE.clear()


def _ref_gate(on: bool) -> None:
    ref_packing.configure(enabled=on)
    ref_pipeline._COMPILE_CACHE.clear()


# ---------------------------------------------------------------------------
# width rules and host packing


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 127, 128, 255, 256, 257,
                               32_767, 32_768, 65_535, 65_536, 65_537])
def test_width_rules_match_reference(n):
    assert packing.width_for_cardinality(n) \
        == ref_packing.width_for_cardinality(n)
    assert packing.legacy_kv_itemsize(n) == ref_packing.legacy_kv_itemsize(n)


def test_width_boundaries():
    assert [packing.width_for_cardinality(n) for n in (15, 16, 17)] \
        == ["u4", "u8", "u8"]
    assert [packing.width_for_cardinality(n) for n in (255, 256, 257)] \
        == ["u8", "u16", "u16"]
    assert [packing.width_for_cardinality(n)
            for n in (65_535, 65_536, 65_537)] == ["u16", "u32", "u32"]


@pytest.mark.parametrize("m", [0, 1, 0xFFFF, 0x10000, 0x1FFFF, 0x20000,
                               (1 << 24) - 1, 1 << 24, 3_600_000, U32, -5])
def test_dur_width_matches_reference(m):
    assert packing.dur_width(m) == ref_packing.dur_width(m)


def test_dur_width_rule():
    assert packing.dur_width(0xFFFF) == "u16"
    assert packing.dur_width(0x10000) == "q1"
    assert packing.dur_width(3_600_000) == "q6"       # u8 residual
    assert packing.dur_width((1 << 25) - 1) == "q9"   # u16 residual
    assert packing.dur_width(U32) == "q16"


@pytest.mark.parametrize("w,n", [("u4", 15), ("u8", 255), ("u16", 65_535),
                                 ("u32", 70_000)])
def test_pack_ids_array_is_the_references(w, n):
    rng = np.random.default_rng(7)
    ids = rng.integers(-1, n, size=(3, 5, 8)).astype(np.int32)
    ids[0, 0, :] = [-1, 0, n - 1, n - 2, -1, -1, 0, n - 1]
    got, want = packing.pack_ids_array(ids, w), \
        ref_packing.pack_ids_array(ids, w)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    back = packing.unpack_ids(torch.from_numpy(packing.device_view(got)), w)
    np.testing.assert_array_equal(back.numpy(), ids)


@pytest.mark.parametrize("dw", ["u16", "q1", "q6", "q8", "q9", "q16"])
def test_pack_duration_is_the_references(dw):
    rng = np.random.default_rng(8)
    top = 0xFFFF if dw == "u16" else min(U32, (1 << (16 + int(dw[1:]))) - 1)
    dur = rng.integers(0, top + 1, size=300, dtype=np.int64) \
        .astype(np.uint32)
    dur[:3] = [0, top, top // 2]
    got, want = packing.pack_duration(dur, dw), \
        ref_packing.pack_duration(dur, dw)
    for g, r in zip(got, want):
        if r is None:
            assert g is None
            continue
        assert g.dtype == r.dtype and g.tobytes() == r.tobytes()


@pytest.mark.parametrize("C", [4, 5])
@pytest.mark.parametrize("widths", [("u4", "u8", "u16"),
                                    ("u8", "u4", "q6"),
                                    ("u16", "u32", "q10")])
def test_pack_columns_is_the_references(widths, C):
    rng = np.random.default_rng(9)
    P, E = 3, 8
    arrays = {
        "kv_key": rng.integers(-1, 15, size=(P, E, C)).astype(np.int32),
        "kv_val": rng.integers(-1, 15, size=(P, E, C)).astype(np.int32),
        "entry_start": rng.integers(0, U32, size=(P, E)).astype(np.uint32),
        "entry_end": rng.integers(0, U32, size=(P, E)).astype(np.uint32),
        "entry_dur": rng.integers(0, 1 << 26, size=(P, E)).astype(np.uint32),
        "entry_valid": rng.random((P, E)) < 0.8}
    if widths[2] == "u16":
        arrays["entry_dur"] &= 0xFFFF
    got = packing.pack_columns(arrays, widths)
    want = ref_packing.pack_columns(arrays, widths)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert got["kv_key"].shape[-1] == (C + C % 2) // 2 \
        if widths[0] == "u4" else C


def test_logical_nbytes_matches_reference():
    for args in ((1024, 8, 9, 2135), (4096, 9, 10, 1_050_711),
                 (64, 5, 300, 70_000)):
        assert packing.logical_nbytes(*args) \
            == ref_packing.logical_nbytes(*args)


# ---------------------------------------------------------------------------
# the device half, plain torch against the jnp functions


def test_duration_ok_on_bucket_edges():
    rng = np.random.default_rng(11)
    for s in (1, 5, 6, 8, 9, 11, 16):
        dw = f"q{s}"
        top = min(1 << 32, 1 << (16 + s))
        dur = rng.integers(0, top, size=256, dtype=np.int64)
        edges = [max(0, min(top - 1, (m << s) + d))
                 for m in (0, 1, 2, 7, 100) for d in (-1, 0, 1)]
        dur = np.concatenate([dur, np.array(edges, dtype=np.int64)]) \
            .astype(np.uint32)
        q, r = ref_packing.pack_duration(dur, dw)
        tq = torch.from_numpy(packing.device_view(q))
        tr = torch.from_numpy(packing.device_view(r))
        bounds = [(0, U32), (1 << s, (3 << s) - 1), ((1 << s) + 1, 3 << s),
                  (5, 5), ((2 << s) - 1, 2 << s), (3 << s, U32),
                  (0, (1 << s) - 1), (U32, U32)]
        for _ in range(4):
            lo, hi = sorted(rng.integers(0, top, size=2).tolist())
            bounds.append((lo, hi))
        for lo, hi in bounds:
            want = np.asarray(ref_packing.duration_ok(
                jnp.asarray(q), jnp.asarray(r), jnp.uint32(lo),
                jnp.uint32(hi), dw))
            got = packing.duration_ok(tq, tr, lo, hi, dw).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{dw} {lo} {hi}")
            np.testing.assert_array_equal(
                got, (dur >= lo) & (dur <= hi), err_msg=f"{dw} {lo} {hi}")
    # exact u16 and the unpacked u32
    d16 = rng.integers(0, 0x10000, size=64).astype(np.uint16)
    got = packing.duration_ok(torch.from_numpy(d16.view(np.int16)), None,
                              100, 0xFFFF, "u16")
    np.testing.assert_array_equal(got.numpy(), d16 >= 100)


@pytest.mark.parametrize("w,n", [("u4", 15), ("u8", 200), ("u16", 3_000),
                                 ("u32", 70_000)])
def test_unpack_ids_matches_reference(w, n):
    rng = np.random.default_rng(12)
    ids = rng.integers(-1, n, size=(2, 4, 6)).astype(np.int32)
    packed = ref_packing.pack_ids_array(ids, w)
    want = np.asarray(ref_packing.unpack_ids(jnp.asarray(packed), w))
    got = packing.unpack_ids(torch.from_numpy(packing.device_view(packed)), w)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("V", [1, 31, 32, 33, 130, 2_135])
def test_pack_mask_words_matches_reference(V):
    rng = np.random.default_rng(V)
    hits = rng.random((3, V)) < 0.3
    hits[:, -1] = True
    want = np.asarray(ref_packing.pack_mask_words(jnp.asarray(hits)))
    got = packing.pack_mask_words(torch.from_numpy(hits))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        pack_mask_words_plain(torch.from_numpy(hits)).numpy(), got.numpy())
    assert packing.pack_mask_words(got) is got          # idempotent
    assert packing.is_packed_mask(got) and packing.is_packed_mask(want)
    assert not packing.is_packed_mask(torch.from_numpy(hits))
    np.testing.assert_array_equal(packing.unpack_mask_words(got, V), hits)
    for t in range(3):
        assert dict_probe.hits_to_ids(got[t]).tolist() \
            == ref_dict_probe.hits_to_ids(want[t]).tolist() \
            == np.nonzero(hits[t])[0].tolist()
    # a leading axis of groups, as compile_multi stacks them
    g3 = packing.pack_mask_words(torch.from_numpy(hits[None]))
    np.testing.assert_array_equal(g3.numpy()[0], got.numpy())


def test_mask_select_matches_reference():
    rng = np.random.default_rng(13)
    G, T, V = 2, 3, 70
    hits = rng.random((G, T, V)) < 0.4
    words = np.asarray(ref_packing.pack_mask_words(jnp.asarray(hits)))
    ids = rng.integers(0, V + 40, size=(4, 5, 6)).astype(np.int32)  # past V
    g = rng.integers(0, G, size=(4, 1, 1)).astype(np.int32)
    tw = torch.from_numpy(words.view(np.int32).copy())
    tb = torch.from_numpy(hits)
    ti = torch.from_numpy(ids).to(torch.int64)
    tg = torch.from_numpy(g).to(torch.int64)
    for t in range(T):
        for ref_tab, tab in ((jnp.asarray(hits), tb), (jnp.asarray(words),
                                                       tw)):
            want = np.asarray(ref_packing.mask_select_grouped(
                ref_tab, jnp.asarray(g), t, jnp.asarray(ids)))
            got = packing.mask_select_grouped(tab, tg, t, ti)
            np.testing.assert_array_equal(got.numpy(), want)
            want1 = np.asarray(ref_packing.mask_select(ref_tab[1, t],
                                                       jnp.asarray(ids)))
            got1 = packing.mask_select(tab[1, t], ti)
            np.testing.assert_array_equal(got1.numpy(), want1)


# ---------------------------------------------------------------------------
# K1, K1s, K4 plain versions on the reference's packed staging

E = 32
PAIRS = [(k, v) for k in ("u4", "u8", "u16", "u32")
         for v in ("u4", "u8", "u16", "u32")]
_CARD = {"u4": 12, "u8": 200, "u16": 3_000, "u32": 70_000}
_DUR = {"u16": 60_000, "q6": 3_600_000, "q10": (1 << 26) - 1}


def _synthetic_blocks(seed, n_keys, n_vals, max_dur, C, pages=(3, 2)):
    """(reference pages, port pages): blocks from the seed with the given
    dictionary sizes and duration cap (durations on bucket edges of the
    shifts the cap gives), C slots an entry."""
    rng = np.random.default_rng(seed)
    key_dict = [f"k{i:06d}" for i in range(n_keys)]
    val_dict = [f"v{i:07d}" for i in range(n_vals)]
    s = packing.dur_shift(packing.dur_width(max_dur))
    ref, port = [], []
    for P in pages:
        kv_key = rng.integers(0, n_keys, size=(P, E, C)).astype(np.int32)
        kv_key[..., :3] = np.arange(3) % n_keys   # keys the terms name
        kv_key[rng.random((P, E, C)) < 0.15] = -1
        kv_val = rng.integers(0, n_vals, size=(P, E, C)).astype(np.int32)
        kv_val[..., :3] = rng.integers(0, min(n_vals, 4), size=(P, E, 3))
        kv_val[0, 0, :2] = [n_vals - 1, n_vals - 2]
        kv_val[kv_key < 0] = -1
        start = rng.integers(1_000, 4_000, size=(P, E)).astype(np.uint32)
        end = (start + rng.integers(0, 50, size=(P, E))).astype(np.uint32)
        dur = rng.integers(0, max_dur + 1, size=(P, E)).astype(np.int64)
        edges = [max(0, min(max_dur, (m << s) + d))
                 for m in (1, 3, 7) for d in (-1, 0, 1)]
        dur.reshape(-1)[:len(edges)] = edges
        dur[0, -1] = max_dur
        dur = dur.astype(np.uint32)
        valid = rng.random((P, E)) < 0.9
        valid[0, -1] = True
        tid = np.frombuffer(rng.bytes(P * E * 16),
                            dtype=np.uint8).reshape(P, E, 16)
        pp = ColumnarPages.from_arrays(key_dict, val_dict, kv_key, kv_val,
                                       start, end, dur, valid,
                                       kv_val[..., 0], kv_val[..., 0], tid)
        rp = RefColumnarPages(
            geometry=RefPageGeometry(E, C), key_dict=key_dict,
            val_dict=val_dict, kv_key=pp.kv_key, kv_val=pp.kv_val,
            entry_start=pp.entry_start, entry_end=pp.entry_end,
            entry_dur=pp.entry_dur, entry_valid=pp.entry_valid,
            entry_root_svc=pp.entry_root_svc,
            entry_root_name=pp.entry_root_name, trace_ids=pp.trace_ids,
            n_entries=pp.n_entries, header=dict(pp.header))
        ref.append(rp)
        port.append(pp)
    return ref, port


def _dur_bounds(max_dur):
    """(dur_lo, dur_hi) pairs on the bucket edges of the cap's shift."""
    s = packing.dur_shift(packing.dur_width(max_dur)) or 6
    return [(0, U32), (3 << s, (7 << s) - 1), ((3 << s) + 1, U32),
            ((1 << s) - 1, 3 << s)]


def _t(a):
    return torch.from_numpy(np.array(packing.device_view(a)))


def _ref_cols(cat, names):
    return [jnp.asarray(cat[n]) for n in names]


_PAGE = ("kv_key", "kv_val", "entry_start", "entry_end", "entry_dur",
         "entry_valid", "page_block")


def _tables(rng, B, T, R, n_keys, n_vals):
    term_keys = rng.integers(0, min(n_keys, 3), size=(B, T)).astype(np.int32)
    term_keys[-1, -1] = -1
    lo = rng.integers(0, min(n_vals, 6), size=(B, T, R))
    hi = lo + rng.integers(0, max(2, n_vals // 3), size=(B, T, R))
    vr = np.stack([lo, hi], axis=-1).astype(np.int32)
    vr[:, :, -1] = (n_vals - 2, n_vals + 5)   # reaches the largest ids
    return term_keys, vr


def _match_set(scores):
    s = np.asarray(scores)
    return sorted(s[s >= 0].tolist()), set(np.nonzero(s >= 0)[0].tolist())


def _ref_match_set(ref_s, ref_i):
    s, i = np.asarray(ref_s), np.asarray(ref_i)
    return sorted(s[s >= 0].tolist()), set(i[s >= 0].tolist())


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_multi_scan_plain_matches_reference_packed(pair):
    """K1's plain version against multi_scan_kernel with the reference's
    widths on the reference's own packed stack_host output (odd C = 5,
    so u4 pads a slot), in range mode and with word hit tables."""
    kw, vw = pair
    i = PAIRS.index(pair)
    max_dur = list(_DUR.values())[i % 3]
    rp, pp = _synthetic_blocks(i, _CARD[kw], _CARD[vw], max_dur, C=5)
    _ref_gate(True)
    rh = ref_stack_host(rp, pad_to=8)
    ph = stack_host(pp, pad_to=8, packed=True)
    assert ph.widths == rh.widths and ph.widths[:2] == pair
    assert ph.cat_logical_nbytes == rh.cat_logical_nbytes
    assert sorted(ph.cat) == sorted(rh.cat)
    for k, want in rh.cat.items():
        got = ph.cat[k]
        assert got.shape == want.shape and got.itemsize == want.itemsize, k
        assert got.tobytes() == np.ascontiguousarray(want).tobytes(), k
    rng = np.random.default_rng(100 + i)
    B, T, R = 2, 2, 2
    tk, vr = _tables(rng, B, T, R, _CARD[kw], _CARD[vw])
    hits = rng.random((2, T, _CARD[vw])) < 0.3
    words = np.asarray(ref_packing.pack_mask_words(jnp.asarray(hits)))
    bg = np.array([0, -1], dtype=np.int32)
    pcols = [_t(ph.cat[n]) for n in _PAGE]
    res = ph.cat.get("entry_dur_res")
    n = ph.page_block.shape[0] * E
    for lo, hi in _dur_bounds(max_dur):
        for ref_h, port_h in ((None, None),
                              (jnp.asarray(words), _t(words))):
            out = multi_scan_kernel(
                *_ref_cols(rh.cat, _PAGE), jnp.asarray(tk), jnp.asarray(vr),
                jnp.uint32(lo), jnp.uint32(hi), jnp.uint32(0),
                jnp.uint32(U32), ref_h,
                None if ref_h is None else jnp.asarray(bg),
                None if res is None else jnp.asarray(rh.cat["entry_dur_res"]),
                n_terms=T, top_k=n, widths=rh.widths)
            s, c = multi_scan_plain(
                *pcols, torch.from_numpy(tk), torch.from_numpy(vr), T, lo,
                hi, 0, U32, port_h,
                None if port_h is None else torch.from_numpy(bg),
                ph.widths, None if res is None else _t(res))
            assert c.tolist() == [int(out[0]), int(out[1])]
            assert _match_set(s.numpy()) == _ref_match_set(out[2], out[3])
    # the unpacked port on the same blocks answers the same
    uh = stack_host(pp, pad_to=8)
    s0, c0 = multi_scan_plain(
        *[torch.from_numpy(np.ascontiguousarray(uh.cat[n])) for n in _PAGE],
        torch.from_numpy(tk), torch.from_numpy(vr), T, *_dur_bounds(
            max_dur)[1], 0, U32, torch.from_numpy(hits),
        torch.from_numpy(bg))
    s1, c1 = multi_scan_plain(
        *pcols, torch.from_numpy(tk), torch.from_numpy(vr), T,
        *_dur_bounds(max_dur)[1], 0, U32, _t(words), torch.from_numpy(bg),
        ph.widths, None if res is None else _t(res))
    assert torch.equal(s0, s1) and torch.equal(c0, c1)


@pytest.mark.parametrize("pair", [("u4", "u8"), ("u8", "u16"),
                                  ("u16", "u32"), ("u32", "u4")],
                         ids=lambda p: f"{p[0]}-{p[1]}")
@pytest.mark.parametrize("dur_cap", list(_DUR))
def test_scan_single_plain_matches_reference_packed(pair, dur_cap):
    """K1s's plain version against scan_kernel on the reference's packed
    single-block staging (engine.stage), with and without word hits."""
    kw, vw = pair
    max_dur = _DUR[dur_cap]
    rp, pp = _synthetic_blocks(7, _CARD[kw], _CARD[vw], max_dur, C=5,
                               pages=(3,))
    _ref_gate(True)
    rsp = ref_stage(rp[0])
    psp = stage(pp[0], CPU, packed=True)
    assert psp.widths == rsp.widths and psp.widths[2] == (
        packing.dur_width(max_dur))
    assert sorted(psp.device) == sorted(rsp.device)
    for k, want in rsp.device.items():
        got = psp.device[k].numpy()
        assert got.tobytes() == np.asarray(want).tobytes(), k
    rng = np.random.default_rng(3)
    T, R = 2, 2
    tk, vr = _tables(rng, 1, T, R, _CARD[kw], _CARD[vw])
    tk, vr = tk[0], vr[0]
    hits = rng.random((T, _CARD[vw])) < 0.3
    words = np.asarray(ref_packing.pack_mask_words(jnp.asarray(hits)))
    d = psp.device
    n = d["entry_valid"].numel()
    for lo, hi in _dur_bounds(max_dur):
        for ref_h, port_h in ((None, None), (jnp.asarray(words),
                                             _t(words))):
            out = scan_kernel(
                *(rsp.device[k] for k in _PAGE[:6]), jnp.asarray(tk),
                jnp.asarray(vr), jnp.uint32(lo), jnp.uint32(hi),
                jnp.uint32(0), jnp.uint32(U32), ref_h,
                rsp.device.get("entry_dur_res"), n_terms=T, top_k=n,
                widths=rsp.widths)
            s, c = scan_single_plain(
                *(d[k] for k in _PAGE[:6]), torch.from_numpy(tk),
                torch.from_numpy(vr), T, lo, hi, 0, U32, port_h,
                psp.widths, d.get("entry_dur_res"))
            assert c.tolist() == [int(out[0]), int(out[1])]
            assert _match_set(s.numpy()) == _ref_match_set(out[2], out[3])


@pytest.mark.parametrize("pair,dur_cap", [(("u4", "u16"), "u16"),
                                          (("u4", "u32"), "q6"),
                                          (("u8", "u4"), "q10")],
                         ids=["u4-u16-u16", "u4-u32-q6", "u8-u4-q10"])
def test_coalesced_scan_plain_matches_reference_packed(pair, dur_cap):
    """K4's plain version against coalesced_scan_kernel on the reference's
    packed staging, Q = 4: two word-hit members, a range member and a pad
    query."""
    kw, vw = pair
    max_dur = _DUR[dur_cap]
    rp, pp = _synthetic_blocks(11, _CARD[kw], _CARD[vw], max_dur, C=5)
    _ref_gate(True)
    rh = ref_stack_host(rp, pad_to=8)
    ph = stack_host(pp, pad_to=8, packed=True)
    rng = np.random.default_rng(17)
    Q, B, T, R, G = 4, 2, 2, 2, 2
    tabs = [_tables(rng, B, T, R, _CARD[kw], _CARD[vw]) for _ in range(Q)]
    term_keys = np.stack([t[0] for t in tabs])
    val_ranges = np.stack([t[1] for t in tabs])
    term_active = np.ones((Q, T), dtype=bool)
    term_active[1, 1] = False
    bounds = _dur_bounds(max_dur)
    dur_lo = np.array([bounds[q % 4][0] for q in range(Q)], dtype=np.uint32)
    dur_hi = np.array([bounds[q % 4][1] for q in range(Q)], dtype=np.uint32)
    dur_lo[Q - 1], dur_hi[Q - 1] = 1, 0          # the pad query
    win_start = np.zeros(Q, dtype=np.uint32)
    win_end = np.full(Q, U32, dtype=np.uint32)
    hits = rng.random((Q, G, T, _CARD[vw])) < 0.3
    words = np.asarray(ref_packing.pack_mask_words(jnp.asarray(hits)))
    block_group = np.array([[0, 1], [-1, -1], [1, -1], [-1, -1]],
                           dtype=np.int32)
    n = ph.page_block.shape[0] * E
    res = ph.cat.get("entry_dur_res")
    counts, inspected, scores, idx = coalesced_scan_kernel(
        *_ref_cols(rh.cat, _PAGE), jnp.asarray(term_keys),
        jnp.asarray(val_ranges), jnp.asarray(term_active),
        jnp.asarray(dur_lo), jnp.asarray(dur_hi), jnp.asarray(win_start),
        jnp.asarray(win_end), jnp.asarray(words), jnp.asarray(block_group),
        None if res is None else jnp.asarray(rh.cat["entry_dur_res"]),
        n_terms=T, top_k=n, widths=rh.widths)
    vh = tuple(None if (block_group[q] < 0).all() else _t(words[q])
               for q in range(Q))
    s, c, ins = coalesced_scan_plain(
        *[_t(ph.cat[k]) for k in _PAGE], torch.from_numpy(term_keys),
        torch.from_numpy(val_ranges), torch.from_numpy(term_active),
        *(_t(x) for x in (dur_lo, dur_hi, win_start, win_end)), vh,
        torch.from_numpy(block_group), ph.widths,
        None if res is None else _t(res))
    assert int(ins) == int(inspected)
    assert c.tolist() == np.asarray(counts).tolist()
    assert sum(c.tolist()) > 0
    for q in range(Q):
        assert _match_set(s[q].numpy()) == _ref_match_set(scores[q], idx[q])


def test_missing_rollup_still_gets_a_correct_width():
    """A container whose header has no max_dur_ms scans its column once:
    the width still covers its longest duration, as the reference's
    does."""
    rp, pp = _synthetic_blocks(5, 12, 200, 3_600_000, C=4, pages=(2,))
    for p in (rp[0], pp[0]):
        del p.header["max_dur_ms"]
    assert pp[0].max_dur_ms() == rp[0].max_dur_ms() \
        == int(pp[0].entry_dur.max())
    assert stack_host(pp, packed=True).widths[2] == "q6"
    assert stage(pp[0], CPU, packed=True).widths[2] == "q6"


# ---------------------------------------------------------------------------
# end to end: TempoDB, packed and not, against the packed reference

TENANT = "t1"
MAX_PAGES = 16
PROBE_MIN = 64
BASE_S = 1_700_000_000
SERVICES = [f"svc-{i:02d}" for i in range(12)]


def _entries(rng, b, n, first_session, sessions, long_ms):
    """n traces of block b: four base tags plus session.id (session
    blocks) or host.name, so every trace fills C = 5 slots (odd: the u4
    layout pads one); `long_ms` caps the durations of 1 trace in 8."""
    out = []
    for j in range(n):
        start = BASE_S + b * 1800 + int(rng.integers(0, 1800))
        dur_ms = int(rng.integers(1, 30_000))
        if long_ms and j % 8 == 0:
            dur_ms = int(rng.integers(60_000, long_ms))
        if long_ms and j % 97 == 0:
            dur_ms = [65_535, 65_536, 131_071, 131_072, 600_000][j % 5]
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
        }
        if sessions:
            sd.kvs["session.id"] = {f"session-{first_session + j:07d}"}
        else:
            sd.kvs["host.name"] = {f"host-{int(rng.integers(8))}"}
        out.append(sd)
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Ten blocks written by the reference: session blocks (value
    dictionaries of ~100-330 values: u8 and u16, probed at 64), host
    blocks (~40 values: u8, range path), and three blocks with long
    durations (up to 2^21 and 2^25 ms: q6 and q10 buckets)."""
    root = tmp_path_factory.mktemp("torch_packing")
    be = RefLocalBackend(str(root / "blocks"))
    rng = np.random.default_rng(20261020)
    geometry = RefPageGeometry(entries_per_page=E, kv_per_entry=5)
    first = 0
    for b in range(10):
        n = int(rng.integers(90, 300))
        long_ms = {2: 1 << 21, 5: 1 << 25, 8: 3_600_000}.get(b, 0)
        entries = _entries(rng, b, n, first, b % 3 != 1, long_ms)
        first += n
        ref_write_search_block(be, RefBlockMeta(tenant_id=TENANT), entries,
                               geometry=geometry, encoding="zlib")
    return root


def _requests():
    def req(tags=None, **kw):
        return tags or {}, kw

    ex = {"x-dbg-exhaustive": ""}
    return {
        "exhaustive_scattered": req(dict(ex, **{"session.id": "77"}),
                                    limit=50),
        "point": req({"session.id": "session-0000123"}),
        "prefix": req({"session.id": "session-000123"}, limit=30),
        "service": req({"service.name": "svc-1"}, limit=40),
        "region_status": req({"region": "west", "http.status_code": "5"}),
        "dur_inside_buckets": req(min_duration_ms=59_000,
                                  max_duration_ms=59_999, limit=100),
        "dur_bucket_aligned": req(min_duration_ms=65_536,
                                  max_duration_ms=131_071, limit=100),
        "dur_long": req(min_duration_ms=600_000, limit=20),
        "dur_long_exhaustive": req(dict(ex), min_duration_ms=1_500_000,
                                   limit=1000),
        "dur_edge_svc": req({"service.name": "svc-0"},
                            min_duration_ms=3 * 1024,
                            max_duration_ms=7 * 1024 - 1, limit=100),
        "window": req({"session.id": "1"}, start=BASE_S + 3 * 1800 + 300,
                      end=BASE_S + 8 * 1800, min_duration_ms=5_000),
    }


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


def _same(got, want) -> None:
    assert _traces(got) == _traces(want)
    assert _metrics(got.metrics) == _metrics(want.metrics)


def _cfg(packed, **kw):
    return TempoDBConfig(search_max_batch_pages=MAX_PAGES,
                         search_device_probe_min_vals=PROBE_MIN,
                         search_packed_residency=packed, **kw)


@pytest.fixture(scope="module")
def dbs(corpus, tmp_path_factory):
    """(packed reference, packed port, unpacked port), each with every
    group staged by one exhaustive request, so early quits scan the same
    groups."""
    wal = tmp_path_factory.mktemp("torch_packing_wal")
    ref_packing.configure(enabled=True)
    ref = RefTempoDB(
        RefLocalBackend(str(corpus / "blocks")), str(wal),
        RefTempoDBConfig(search_max_batch_pages=MAX_PAGES, auto_mesh=False,
                         host_state_dir="",
                         search_device_probe_min_vals=PROBE_MIN,
                         search_packed_residency=True))
    packed = TempoDB(LocalBackend(str(corpus / "blocks")), _cfg(True),
                     device="cpu")
    plain = TempoDB(LocalBackend(str(corpus / "blocks")), _cfg(False),
                    device="cpu")
    for db in (ref, packed, plain):
        db.poll()
    tags, kw = _requests()["exhaustive_scattered"]
    want = ref.search(TENANT, _ref_req(tags, kw)).response()
    for db in (packed, plain):
        _same(db.search(TENANT, SearchRequest(tags=dict(tags), **kw))
              .response(), want)
    ref_packing.configure(enabled=False)
    yield ref, packed, plain
    packed.close()
    plain.close()


def test_corpus_reaches_the_widths(dbs):
    """The packed batches hold u4 keys (C 5 -> 6), u8 and u16 values, u16
    and bucketed durations (u8 and u16 residuals), and word hit masks;
    the reference staged the same widths."""
    ref, packed, plain = dbs
    got = sorted(c.batch.widths for c in packed.batcher._cache.values())
    want = sorted(c.batch.widths for c in ref.batcher._cache.values())
    assert got == want
    assert {w[0] for w in got} == {"u4"}
    assert {w[1] for w in got} >= {"u8", "u16"}
    durs = {w[2] for w in got}
    assert "u16" in durs and len(durs - {"u16"}) >= 1
    for c in packed.batcher._cache.values():
        d = c.batch.device
        assert d["kv_key"].dtype == torch.uint8 and d["kv_key"].shape[2] == 3
        if c.batch.widths[2] != "u16":
            s = int(c.batch.widths[2][1:])
            assert d["entry_dur_res"].dtype == (torch.uint8 if s <= 8
                                                else torch.int16)
    assert all(c.batch.widths is None
               for c in plain.batcher._cache.values())


@pytest.mark.parametrize("name", list(_requests()))
def test_search_packed_matches_packed_reference_and_unpacked(dbs, name):
    ref, packed, plain = dbs
    _ref_gate(True)
    tags, kw = _requests()[name]
    want = ref.search(TENANT, _ref_req(tags, kw)).response()
    req = SearchRequest(tags=dict(tags), **kw)
    _same(packed.search(TENANT, req).response(), want)
    _same(plain.search(TENANT, req).response(), want)


def test_probe_products_are_words_and_the_cache_keeps_64(dbs):
    """A packed engine's probe products are word masks (K5's output),
    and its compile cache keeps up to 64 of them per dictionary (8 for
    bool masks)."""
    _ref, packed, plain = dbs
    from tempo_tpu_torch.search import pipeline

    eng = packed.batcher.engine
    cache = eng.compile_cache
    words = [o[2] for d in cache._by_dict.values() for o in d.values()
             if o != pipeline._PRUNED and o[2] is not None]
    assert words and all(packing.is_packed_mask(w) for w in words)
    assert all(not packing.is_packed_mask(o[2])
               for d in plain.batcher.engine.compile_cache._by_dict.values()
               for o in d.values()
               if o != pipeline._PRUNED and o[2] is not None)
    fresh = pipeline.CompileCache()
    w = torch.zeros((1, 2), dtype=torch.int32)
    b = torch.zeros((1, 64), dtype=torch.bool)
    for i in range(100):
        fresh.put(b"fp", ("w", i), (None, None, w))
        fresh.put(b"fp", ("b", i), (None, None, b))
    kept = list(fresh._by_dict[b"fp"])
    assert sum(1 for s in kept if s[0] == "w") == 64
    assert sum(1 for s in kept if s[0] == "b") == 8


def _jobs(port):
    out = []
    for m in sorted(port.blocklist.metas(TENANT), key=lambda m: m.block_id):
        for start, count in ((0, 0), (1, 2)):
            out.append(dict(tenant_id=TENANT, block_id=m.block_id,
                            start_page=start, pages_to_search=count,
                            encoding=m.encoding, version=m.version,
                            data_encoding=m.data_encoding,
                            start_time=m.start_time, end_time=m.end_time))
    return out


@pytest.mark.parametrize("name", ["point", "dur_bucket_aligned",
                                  "dur_long", "region_status"])
def test_search_block_packed_matches_reference(dbs, name):
    ref, packed, plain = dbs
    _ref_gate(True)
    tags, kw = _requests()[name]
    for j in _jobs(packed):
        rr = tempopb.SearchBlockRequest(**j)
        rr.search_req.CopyFrom(_ref_req(tags, kw))
        want = ref.search_block(rr).response()
        req = SearchBlockRequest(
            search_req=SearchRequest(tags=dict(tags), **kw), **j)
        _same(packed.search_block(req).response(), want)
        _same(plain.search_block(req).response(), want)


@pytest.fixture(scope="module")
def single_blocks(dbs, corpus):
    ref, packed, _plain = dbs
    rbe = RefLocalBackend(str(corpus / "blocks"))
    pbe = LocalBackend(str(corpus / "blocks"))
    out = []
    for rm, pm in zip(sorted(ref.blocklist.metas(TENANT),
                             key=lambda m: m.block_id),
                      sorted(packed.blocklist.metas(TENANT),
                             key=lambda m: m.block_id)):
        out.append((RefBackendSearchBlock(rbe, rm, probe_min_vals=PROBE_MIN),
                    BackendSearchBlock(pbe, pm, probe_min_vals=PROBE_MIN,
                                       device="cpu", packed=True),
                    BackendSearchBlock(pbe, pm, probe_min_vals=PROBE_MIN,
                                       device="cpu")))
    return out


@pytest.mark.parametrize("name", ["exhaustive_scattered", "point",
                                  "service", "dur_bucket_aligned",
                                  "dur_long_exhaustive", "dur_edge_svc"])
def test_backend_search_block_packed_matches_reference(single_blocks, name):
    _ref_gate(True)
    tags, kw = _requests()[name]
    widths = set()
    for rb, pb, ub in single_blocks:
        want = rb.search(_ref_req(tags, kw)).response()
        req = SearchRequest(tags=dict(tags), **kw)
        _same(pb.search(req).response(), want)
        _same(ub.search(req).response(), want)
        widths.add(pb.staged().widths)
        assert pb.staged().widths == rb.staged().widths
    assert len({w[2] for w in widths}) >= 3      # u16, q6-ish, q10-ish


def test_concurrent_packed_searches_match_serial(dbs, corpus):
    """8 barrier-started threads through a packed coalescing TempoDB;
    every response equals the unpacked database's serial one, and some
    dispatch fused (K4's packed plain version)."""
    _ref, _packed, plain = dbs
    co = TempoDB(LocalBackend(str(corpus / "blocks")),
                 _cfg(True, search_coalesce_window_s=0.05), device="cpu")
    reqs = [(dict(t, **{"x-dbg-exhaustive": ""}), kw) for t, kw in (
        ({"session.id": "7"}, {"limit": 20}),
        ({"session.id": "12"}, {"limit": 20}),
        ({"service.name": "svc-1"}, {"limit": 20}),
        ({}, {"min_duration_ms": 65_536, "max_duration_ms": 131_071,
              "limit": 20}),
        ({"region": "east"}, {"min_duration_ms": 600_000, "limit": 20}),
        ({"session.id": "0000"}, {"limit": 20}),
        ({"http.status_code": "404"}, {"limit": 20}),
        ({}, {"start": BASE_S + 1800, "end": BASE_S + 5 * 1800,
              "limit": 20}))]
    try:
        co.poll()
        serial = [plain.search(TENANT, SearchRequest(tags=dict(t), **kw))
                  .response() for t, kw in reqs]
        co.search(TENANT, SearchRequest(tags=dict(reqs[0][0]), **reqs[0][1]))
        barrier = threading.Barrier(len(reqs))

        def one(i):
            barrier.wait(timeout=WAIT_S)
            t, kw = reqs[i]
            return co.search(TENANT, SearchRequest(tags=dict(t), **kw)) \
                .response()

        for _round in range(2):
            with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
                futs = [ex.submit(one, i) for i in range(len(reqs))]
                outs = [f.result(timeout=WAIT_S) for f in futs]
            for got, want in zip(outs, serial):
                _same(got, want)
        assert co.batcher.coalescer.fused > 0
        assert all(c.batch.widths is not None
                   for c in co.batcher._cache.values())
    finally:
        co.close()


def test_staged_bytes_physical_and_logical(dbs):
    """Packed: the budget charges physical bytes, fewer than the logical
    ones on this corpus; unpacked: the two are equal. debug_stats reports
    both."""
    _ref, packed, plain = dbs
    ps = packed.batcher.debug_stats()["cache"]
    us = plain.batcher.debug_stats()["cache"]
    assert ps["bytes"] == packed.batcher._cache_total == sum(
        c.nbytes for c in packed.batcher._cache.values())
    assert ps["bytes"] < ps["logical_bytes"]
    assert us["bytes"] == us["logical_bytes"]
    # the packed database's logical bytes are what the unpacked one holds
    assert ps["logical_bytes"] == us["bytes"]
    assert ps["dict_bytes"] == us["dict_bytes"] > 0


def test_two_databases_in_one_process_keep_their_layouts(corpus):
    """ROADMAP.md item C: the port's gate is per database. One packed and
    one unpacked TempoDB in one process, used in turns, each keep their
    own layout and mask format and answer alike (the reference's gate is
    process-wide: the most recent TempoDB decides for both)."""
    a = TempoDB(LocalBackend(str(corpus / "blocks")), _cfg(True),
                device="cpu")
    b = TempoDB(LocalBackend(str(corpus / "blocks")), _cfg(False),
                device="cpu")
    try:
        a.poll()
        b.poll()
        for name in ("exhaustive_scattered", "dur_long_exhaustive",
                     "point", "dur_bucket_aligned"):
            tags, kw = _requests()[name]
            req = SearchRequest(tags=dict(tags), **kw)
            _same(a.search(TENANT, req).response(),
                  b.search(TENANT, req).response())
        assert a.batcher._cache and b.batcher._cache
        assert all(c.batch.widths is not None
                   for c in a.batcher._cache.values())
        assert all(c.batch.widths is None
                   for c in b.batcher._cache.values())
        assert a.batcher.engine.packed and not b.batcher.engine.packed
    finally:
        a.close()
        b.close()
