"""Kernel K1 / K1s by the rule of its CUDA kernel (``kernels.scan.
scan_tiled``) against the plain versions (``multi_scan_plain``,
``scan_single_plain``) and the reference's ``multi_scan_kernel`` /
``scan_kernel`` on JAX's CPU backend.

The kernels walk tiles of one page; with terms, each entry's key run is
compared with a term's key a 32-bit word of lanes at a time (SWAR), a
slot's value is tested only where its key names the term (by a per-block
bitmap of value ids for a range block), and an entry stops at its first
failing term; ``scan_tiled`` is that rule in PyTorch. Inputs are made
from a seed with numpy at a small size (a few pages, E = 64-256): every
unpacked layout pair at C = 8 and 9, every packed pair, byte and word hit
tables narrower than the largest id (ids past a table's end), bucketed
durations on the bounds' buckets with structural verdicts, pad pages, an
entry whose only matching slot is its last, term keys no lane can hold,
value ids past a bitmap, more ranges than bitmaps take and more terms
than the SWAR test takes. All outputs are integers: the tolerance is
zero (equal scores and counts; against the reference, equal counts and
match sets, the reference's top-k taken over every entry).
"""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.search import packing as ref_packing
from tempo_tpu.search.engine import scan_kernel
from tempo_tpu.search.multiblock import multi_scan_kernel

from tempo_tpu_torch.search import packing
from tempo_tpu_torch.search.kernels.scan import (K1_PAT_TERMS, k1_tile,
                                                 multi_scan_plain,
                                                 scan_single_plain,
                                                 scan_tiled)

U32 = 0xFFFFFFFF
_NP = {"int8": np.int8, "int16": np.int16, "int32": np.int32}
IDS = ("int8", "int16", "int32")
CODES = ("u4", "u8", "u16", "u32")


def _case(seed, *, P=5, E=96, C=8, B=3, T=2, R=3, kv=("int8", "int16"),
          widths=None, hits=None, verdicts=False, single=False, n_keys=6,
          dur_max=60_000):
    """Seeded K1 (or, with `single`, K1s) inputs as numpy arrays: keys
    -1..n_keys-1, value ids up to 14 (a u4 column) or 120, 1 entry in 10
    invalid, pages 2 and P-1 pad pages (K1), ranges of which some are
    empty, hit tables of each block group narrower than the largest id,
    block group -1 (ranges) on the last block."""
    rng = np.random.default_rng(seed)
    vmax = 14 if widths is not None and widths[1] == "u4" else 120
    kk = rng.integers(-1, n_keys, size=(P, E, C))
    vv = rng.integers(-1, vmax + 1, size=(P, E, C))
    vv[kk < 0] = -1
    c = dict(kk=kk, vv=vv, valid=rng.random((P, E)) < 0.9,
             start=rng.integers(2**31 - 40, 2**31 + 40,
                                size=(P, E)).astype(np.uint32),
             dur=rng.integers(0, dur_max + 1, size=(P, E)).astype(np.uint32))
    c["end"] = np.minimum(c["start"].astype(np.int64)
                          + rng.integers(0, 30, (P, E)),
                          U32).astype(np.uint32)
    rows = (1,) if single else (B,)
    c["term_keys"] = rng.integers(0, n_keys, size=rows + (T,)).astype(
        np.int32)
    lo = rng.integers(0, vmax, size=rows + (T, R))
    hi = lo + rng.integers(0, vmax // 3, size=rows + (T, R))
    vr = np.stack([lo, hi], axis=-1).astype(np.int32)
    vr[rng.random(rows + (T, R)) < 0.3] = (1, 0)
    c["val_ranges"] = vr
    c["page_block"] = None
    if not single:
        pb = rng.integers(0, B, size=P).astype(np.int32)
        pb[[2, P - 1]] = -1
        c["page_block"] = pb
    c["val_hits"] = c["block_group"] = None
    if hits is not None:
        G = 1 if single else 2
        h = rng.random((G, T, int(rng.integers(vmax // 2, vmax)))) < 0.4
        if hits == "words":
            h = packing.pack_mask_words(torch.from_numpy(h)).numpy().view(
                np.uint32)
        c["val_hits"] = h[0] if single else h
        if not single:
            bg = rng.integers(0, G, size=B).astype(np.int32)
            bg[-1] = -1
            c["block_group"] = bg
    c["verdicts"] = ((rng.random(P * E) < 0.7).astype(np.uint8)
                     if verdicts else None)
    c.update(kv=kv, widths=widths, n_terms=T, single=single)
    return c


def _columns(c):
    """(port tensors, reference arrays) of the page columns, packed at
    c["widths"] or in c["kv"]'s dtypes."""
    w = c["widths"]
    res = None
    if w is None:
        k = c["kk"].astype(_NP[c["kv"][0]])
        v = c["vv"].astype(_NP[c["kv"][1]])
        d = c["dur"]
    else:
        k = packing.pack_ids_array(c["kk"], w[0])
        v = packing.pack_ids_array(c["vv"], w[1])
        d, res = packing.pack_duration(c["dur"], w[2])
    ref = [k, v, c["start"], c["end"], d, c["valid"]]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(
            packing.device_view(a) if a.dtype.kind == "u" else a))

    port = [t(x) for x in ref]
    return port, ref, (None if res is None else t(res)), res


def _hits(h):
    if h is None:
        return None, None
    if h.dtype == np.uint32:
        return torch.from_numpy(h.view(np.int32)), jnp.asarray(h)
    return torch.from_numpy(h), jnp.asarray(h)


def _bounds(c):
    """Bounds on the bucket edges of the duration width (exact for u16
    and u32 durations)."""
    w = c["widths"]
    s = packing.dur_shift(w[2]) if w is not None else 0
    if not s:
        return (5_000, 40_000, 2**31 - 10, 2**31 + 30)
    return ((3 << s) + 1, (7 << s) - 1, 0, U32)


def _run(c, bounds):
    """(tiled, plain, reference) outputs: the port's as (scores, counts),
    the reference's as (count, inspected, match set)."""
    port, ref, pres, rres = _columns(c)
    pvh, rvh = _hits(c["val_hits"])
    tk = torch.from_numpy(c["term_keys"])
    vr = torch.from_numpy(c["val_ranges"])
    ver = None if c["verdicts"] is None else torch.from_numpy(c["verdicts"])
    T = c["n_terms"]
    n = c["valid"].size
    valid = c["valid"]
    if c["verdicts"] is not None:      # the reference takes no verdicts
        valid = valid & (c["verdicts"].reshape(valid.shape) != 0)
    rb = [jnp.uint32(x) for x in bounds]
    if c["single"]:
        args = (*port, tk[0], vr[0], T, *bounds, pvh, c["widths"], pres,
                ver)
        plain = scan_single_plain(*args)
        tiled = scan_tiled(*port, None, tk[0], vr[0], T, *bounds, pvh,
                           None, c["widths"], pres, ver, grid=3)
        out = scan_kernel(*(jnp.asarray(x) for x in ref[:5]),
                          jnp.asarray(valid), jnp.asarray(c["term_keys"][0]),
                          jnp.asarray(c["val_ranges"][0]), *rb, rvh,
                          None if rres is None else jnp.asarray(rres),
                          n_terms=T, top_k=n, widths=c["widths"])
    else:
        pb = torch.from_numpy(c["page_block"])
        bg = (None if c["block_group"] is None
              else torch.from_numpy(c["block_group"]))
        args = (*port, pb, tk, vr, T, *bounds, pvh, bg, c["widths"], pres,
                ver)
        plain = multi_scan_plain(*args)
        tiled = scan_tiled(*args, grid=3)
        out = multi_scan_kernel(
            *(jnp.asarray(x) for x in ref[:5]), jnp.asarray(valid),
            jnp.asarray(c["page_block"]), jnp.asarray(c["term_keys"]),
            jnp.asarray(c["val_ranges"]), *rb, rvh,
            None if bg is None else jnp.asarray(c["block_group"]),
            None if rres is None else jnp.asarray(rres), n_terms=T,
            top_k=n, widths=c["widths"])
    s, i = np.asarray(out[2]), np.asarray(out[3])
    return tiled, plain, (int(out[0]), int(out[1]),
                          set(i[s >= 0].tolist()))


def _check(c, bounds=None):
    bounds = _bounds(c) if bounds is None else bounds
    tiled, plain, (count, inspected, matched) = _run(c, bounds)
    assert torch.equal(tiled[0], plain[0])
    assert tiled[1].tolist() == plain[1].tolist()
    scores = tiled[0].numpy()
    assert set(np.nonzero(scores >= 0)[0].tolist()) == matched
    assert int(tiled[1][0]) == count
    live = c["valid"] if c["single"] else \
        c["valid"] & (c["page_block"] >= 0)[:, None]
    assert int(tiled[1][1]) == int(live.sum())
    if c["verdicts"] is None:
        assert int(tiled[1][1]) == inspected
    return tiled


def _seed(*parts) -> int:
    return zlib.crc32("/".join(map(str, parts)).encode())


@pytest.mark.parametrize("C", [8, 9])
@pytest.mark.parametrize("kv", [(k, v) for k in IDS for v in IDS],
                         ids=lambda p: f"{p[0]}-{p[1]}")
def test_unpacked_pairs(kv, C):
    """Every unpacked layout pair at an even and an odd C; the hit mode
    turns with the pair (ranges, bytes, words)."""
    i = IDS.index(kv[0]) * 3 + IDS.index(kv[1])
    hits = (None, "bytes", "words")[(i + C) % 3]
    tiled = _check(_case(_seed(kv, C), C=C, kv=kv, hits=hits))
    assert int(tiled[1][0]) > 0


@pytest.mark.parametrize("pair", [(k, v) for k in CODES for v in CODES],
                         ids=lambda p: f"{p[0]}-{p[1]}")
def test_packed_pairs(pair):
    """Every packed layout pair (C = 10; u4 needs an even C), with byte
    or word hit tables or ranges."""
    i = CODES.index(pair[0]) * 4 + CODES.index(pair[1])
    hits = (None, "bytes", "words")[i % 3]
    _check(_case(_seed(pair), C=10, widths=(*pair, "u16"), hits=hits,
                 E=64))


@pytest.mark.parametrize("pair", [("u8", "u16"), ("u16", "u32"),
                                  ("u32", "u8")],
                         ids=lambda p: f"{p[0]}-{p[1]}")
def test_packed_pairs_odd_c(pair):
    _check(_case(_seed(pair, "odd"), C=9, widths=(*pair, "u16"),
                 hits="words"))


@pytest.mark.parametrize("layout", ["int32", ("u4", "u32"), ("u8", "u4"),
                                    ("u16", "u16")],
                         ids=lambda p: p if isinstance(p, str)
                         else f"{p[0]}-{p[1]}")
@pytest.mark.parametrize("hits", [None, "bytes", "words"])
def test_single_block(layout, hits):
    """K1s: int32 ids or a packed pair, its hit table on every page."""
    kw = dict(kv=("int32", "int32")) if layout == "int32" else \
        dict(widths=(*layout, "u16"), C=10)
    _check(_case(_seed("single", layout, hits), single=True, hits=hits,
                 E=128, **kw))


@pytest.mark.parametrize("single", [False, True], ids=["K1", "K1s"])
@pytest.mark.parametrize("dw", ["q6", "q10"])
def test_bucketed_durations_and_verdicts(dw, single):
    """Durations in buckets with a residual, bounds on the buckets'
    edges (only the boundary buckets read the residual), and structural
    verdicts ANDed in."""
    max_dur = {"q6": 3_600_000, "q10": (1 << 26) - 1}[dw]
    c = _case(_seed("dur", dw, single), C=8, widths=("u4", "u16", dw),
              hits="words", verdicts=True, single=single, dur_max=max_dur)
    s = packing.dur_shift(dw)
    edges = [(m << s) + d for m in (3, 7) for d in (-1, 0, 1)]
    c["dur"].reshape(-1)[:len(edges)] = edges
    _check(c)
    _check(c, ((3 << s) - 1, 7 << s, 0, U32))


def test_pad_pages_and_the_last_slot():
    """An entry whose only matching slot is its last, beside pad pages
    (their entries are neither live nor matched, whatever they hold)."""
    c = _case(7, P=4, E=64, C=9, B=2, T=1, kv=("int8", "int32"))
    c["page_block"][:] = [0, -1, 1, -1]
    b = int(c["page_block"][0])
    key = int(c["term_keys"][b, 0])
    c["val_ranges"][b, 0, 0] = (50, 60)
    c["kk"][0, 0] = np.where(np.arange(9) == 8, key, (key + 1) % 6)
    c["vv"][0, 0] = 55
    c["valid"][0, 0] = True
    c["valid"][1] = True                 # a pad page's flags are not read
    tiled = _check(c, (0, U32, 0, U32))
    assert int(tiled[0][0]) >= 0
    scores = tiled[0].numpy().reshape(4, 64)
    assert (scores[[1, 3]] == -1).all()


def test_term_keys_outside_the_lanes_and_past_the_swar_terms():
    """int16 keys of 300-305 and a term key of 301 (a lane holds it), and
    more terms than the SWAR test takes (34: two past it)."""
    T = K1_PAT_TERMS + 2
    c = _case(11, P=3, E=64, C=12, B=2, T=T, kv=("int16", "int16"),
              n_keys=400)
    c["kk"][..., :6] = np.arange(6) + 300          # keys past the table
    c["term_keys"][:, :] = (np.arange(T) % 6)[None]
    c["term_keys"][0, 0] = 301
    c["val_ranges"][:, :, 0] = (0, 120)            # every value passes
    c["page_block"][:] = [0, 1, 0]
    for b in range(2):
        c["kk"][c["page_block"] == b, :, 6:] = np.arange(6)
    c["vv"][c["kk"] >= 0] = 7
    _check(c, (0, U32, 0, U32))
    tiled = _check(c)
    assert int(tiled[1][0]) > 0


def test_tiles_follow_the_launcher():
    """The tile sizes the launcher picks: with terms 256 entries of a
    page; without, 1,024, or the page rounded up to 4 when shorter."""
    assert k1_tile(1024, True) == 256
    assert k1_tile(100, True) == 256
    assert k1_tile(1024, False) == 1024
    assert k1_tile(100, False) == 100
    assert k1_tile(62, False) == 64


@pytest.mark.parametrize("kv", [("int8", "int16"), ("u4", "u8")],
                         ids=["int8-int16", "u4-u8"])
def test_keys_no_lane_holds_match_nothing(kv):
    """A term key past what a lane holds (int8: 200; u4 codes: 15) matches
    no slot, and the entry fails, as the plain version's compare says."""
    widths = None if kv[0] == "int8" else (*kv, "u16")
    c = _case(_seed("lanes", kv), C=8, kv=kv if widths is None else
              ("int8", "int16"), widths=widths, T=1)
    c["term_keys"][:, 0] = 200 if widths is None else 15
    tiled = _check(c, (0, U32, 0, U32))
    assert int(tiled[1][0]) == 0


def test_values_past_the_bitmaps_and_many_ranges():
    """int32 values with ids past 8,191 (tested by their ranges), and R =
    20 (past the bitmaps' 16: every value by its ranges)."""
    c = _case(13, P=4, E=64, C=8, B=2, T=2, kv=("int8", "int32"))
    c["vv"][c["kk"] >= 0] = np.random.default_rng(1).integers(
        0, 20_000, size=int((c["kk"] >= 0).sum()))
    c["val_ranges"][:, :, 0] = (8_000, 12_000)
    tiled = _check(c, (0, U32, 0, U32))
    assert int(tiled[1][0]) > 0
    wide = _case(14, P=3, E=64, C=8, B=2, T=2, R=20, kv=("int8", "int16"))
    _check(wide, (0, U32, 0, U32))


def test_reference_packing_is_the_ports():
    """The packed columns handed to the reference are its own packing."""
    ids = np.random.default_rng(3).integers(-1, 14, size=(2, 8, 10))
    for w in CODES:
        assert packing.pack_ids_array(ids, w).tobytes() == \
            ref_packing.pack_ids_array(ids, w).tobytes()
