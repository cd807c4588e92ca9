"""Kernel K1's hit-mask mode and kernel K1s (single block) against the
reference.

K1 in hit-mask mode is held against ``tempo_tpu.search.multiblock.
multi_scan_kernel`` with ``val_hits`` and ``block_group``; K1s against
``tempo_tpu.search.engine.scan_kernel`` with and without ``val_hits``.
Both references run on JAX's CPU backend; the port side is
``kernels.scan.multi_scan`` / ``scan_single`` then ``kernels.topk.topk``
on CPU tensors, which take the plain versions. Inputs are made from a
seed with numpy. All outputs are integers, so the tolerance is zero:
equal count and inspected, equal sorted top-k scores, and equal index
sets above the boundary score (ties at the k boundary may resolve to
different, equally valid entries; ROADMAP.md item C).
"""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.search.engine import scan_kernel
from tempo_tpu.search.multiblock import multi_scan_kernel

from tempo_tpu_torch.search.kernels.scan import multi_scan, scan_single
from tempo_tpu_torch.search.kernels.topk import topk

U32 = 0xFFFFFFFF
_NP = {"int8": np.int8, "int16": np.int16, "int32": np.int32}


def _entries(rng, P, E, C, n_keys, n_vals, kdt, vdt):
    kv_key = rng.integers(-1, n_keys, size=(P, E, C)).astype(_NP[kdt])
    kv_val = rng.integers(0, n_vals, size=(P, E, C)).astype(_NP[vdt])
    kv_val[kv_key < 0] = -1
    start = rng.integers(1_600_000_000, 1_600_000_000 + 3_000,
                         size=(P, E)).astype(np.uint32)
    end = (start + rng.integers(0, 100, size=(P, E))).astype(np.uint32)
    dur = rng.integers(0, 60_000, size=(P, E)).astype(np.uint32)
    valid = rng.random((P, E)) < 0.9
    return dict(kv_key=kv_key, kv_val=kv_val, entry_start=start,
                entry_end=end, entry_dur=dur, entry_valid=valid)


def _tables(rng, rows, T, R, n_keys, n_vals):
    Tw = max(1, T)
    term_keys = rng.integers(0, n_keys, size=rows + (Tw,)).astype(np.int32)
    lo = rng.integers(0, n_vals, size=rows + (Tw, R))
    hi = lo + rng.integers(0, max(1, n_vals // 3), size=rows + (Tw, R))
    val_ranges = np.stack([lo, hi], axis=-1).astype(np.int32)
    val_ranges[rng.random(rows + (Tw, R)) < 0.3] = (1, 0)
    return term_keys, val_ranges


def _multi_case(seed, *, P, E, C, B, G, T, R, kdt, vdt, n_vals):
    """A stacked batch with pad pages, probed rows (group >= 0), range rows
    (group -1), a dictionary-pruned row (key -1) and a header-skipped row
    (key -1, group -1, never-match ranges), as compile_multi builds
    them."""
    rng = np.random.default_rng(seed)
    n_keys = 5
    c = _entries(rng, P, E, C, n_keys, n_vals, kdt, vdt)
    page_block = (np.arange(P) % B).astype(np.int32)
    page_block[-max(1, P // 4):] = -1
    for name in ("kv_key", "kv_val"):
        c[name][page_block < 0] = -1
    c["entry_valid"][page_block < 0] = False
    term_keys, val_ranges = _tables(rng, (B,), T, R, n_keys, n_vals)
    # groups cycle -1, 0, .., G-1 over the blocks; block 0 probes with
    # group 0, block 3 with the last group, the last block uses ranges
    block_group = (np.arange(B) % (G + 1) - 1).astype(np.int32)
    block_group[0] = 0
    if B > 3:
        block_group[3] = G - 1
        term_keys[1] = -1                        # dictionary-pruned
        term_keys[2] = -1                        # header-skipped
        block_group[2] = -1
        val_ranges[2] = (1, 0)
    block_group[-1] = -1
    val_hits = rng.random((G, max(1, T), n_vals)) < 0.3
    c.update(page_block=page_block, term_keys=term_keys,
             val_ranges=val_ranges, val_hits=val_hits,
             block_group=block_group, n_terms=T)
    return c


def _single_case(seed, *, P, E, C, T, R, n_vals, hits):
    rng = np.random.default_rng(seed)
    n_keys = 5
    c = _entries(rng, P, E, C, n_keys, n_vals, "int32", "int32")
    c["entry_valid"][-1] = False                 # a pad page
    c["kv_key"][-1] = -1
    c["kv_val"][-1] = -1
    term_keys, val_ranges = _tables(rng, (), T, R, n_keys, n_vals)
    c.update(term_keys=term_keys, val_ranges=val_ranges, n_terms=T,
             val_hits=(rng.random((max(1, T), n_vals)) < 0.3
                       if hits else None))
    return c


MULTI = {
    "int8_T1_G1": dict(P=6, E=64, C=4, B=3, G=1, T=1, R=1, kdt="int8",
                       vdt="int8", n_vals=100),
    "int16_T2_G2": dict(P=8, E=128, C=8, B=5, G=2, T=2, R=2, kdt="int8",
                        vdt="int16", n_vals=3_000),
    "int32_T3_G3": dict(P=8, E=128, C=8, B=6, G=3, T=3, R=4, kdt="int16",
                        vdt="int32", n_vals=70_000),
    "T0_no_terms": dict(P=4, E=64, C=4, B=4, G=2, T=0, R=1, kdt="int8",
                        vdt="int8", n_vals=50),
}
SINGLE = {
    "ranges_T2": dict(P=8, E=128, C=8, T=2, R=4, n_vals=5_000, hits=False),
    "hits_T1": dict(P=8, E=128, C=8, T=1, R=1, n_vals=5_000, hits=True),
    "hits_T3": dict(P=4, E=256, C=4, T=3, R=1, n_vals=70_000, hits=True),
    "T0_no_terms": dict(P=4, E=64, C=4, T=0, R=1, n_vals=50, hits=False),
}
BOUNDS = {"unbounded": (0, U32, 0, U32),
          "tight": (10_000, 40_000, 1_600_000_500, 1_600_002_000)}


def _torch(c, names):
    out = {n: torch.from_numpy(np.ascontiguousarray(c[n])) for n in names}
    for n in ("entry_start", "entry_end", "entry_dur"):
        out[n] = torch.from_numpy(c[n].view(np.int32).copy())
    return out


def _assert_topk_contract(got_s, got_i, want_s, want_i):
    assert got_s.shape == want_s.shape
    np.testing.assert_array_equal(np.sort(got_s), np.sort(want_s))
    if got_s.size:
        b = got_s.min()
        assert set(got_i[got_s > b].tolist()) == \
            set(want_i[want_s > b].tolist())


@pytest.mark.parametrize("bounds", list(BOUNDS))
@pytest.mark.parametrize("name", list(MULTI))
def test_multi_scan_hit_mask_mode_matches_reference(name, bounds):
    c = _multi_case(zlib.crc32(name.encode()), **MULTI[name])
    b = BOUNDS[bounds]
    k = 128
    out = multi_scan_kernel(
        *(jnp.asarray(c[n]) for n in (
            "kv_key", "kv_val", "entry_start", "entry_end", "entry_dur",
            "entry_valid", "page_block", "term_keys", "val_ranges")),
        *(jnp.uint32(x) for x in b),
        val_hits=jnp.asarray(c["val_hits"]),
        block_group=jnp.asarray(c["block_group"]),
        n_terms=c["n_terms"], top_k=k)
    count, inspected, ref_s, ref_i = (int(out[0]), int(out[1]),
                                      np.asarray(out[2]), np.asarray(out[3]))
    t = _torch(c, ("kv_key", "kv_val", "entry_valid", "page_block",
                   "term_keys", "val_ranges", "val_hits", "block_group"))
    scores, counts = multi_scan(
        t["kv_key"], t["kv_val"], t["entry_start"], t["entry_end"],
        t["entry_dur"], t["entry_valid"], t["page_block"], t["term_keys"],
        t["val_ranges"], c["n_terms"], *b, t["val_hits"], t["block_group"])
    assert counts.tolist() == [count, inspected]
    top_s, top_i = topk(scores, k)
    _assert_topk_contract(top_s.numpy(), top_i.numpy(), ref_s, ref_i)
    np.testing.assert_array_equal(scores.numpy()[top_i.numpy()],
                                  top_s.numpy())


def test_hit_mask_rows_differ_from_range_rows():
    """The mode matters: the same tables with no hit tables give another
    answer, so the cases above exercise the lookups."""
    c = _multi_case(5, **MULTI["int16_T2_G2"])
    t = _torch(c, ("kv_key", "kv_val", "entry_valid", "page_block",
                   "term_keys", "val_ranges", "val_hits", "block_group"))
    args = (t["kv_key"], t["kv_val"], t["entry_start"], t["entry_end"],
            t["entry_dur"], t["entry_valid"], t["page_block"],
            t["term_keys"], t["val_ranges"], c["n_terms"], 0, U32, 0, U32)
    with_hits, _ = multi_scan(*args, t["val_hits"], t["block_group"])
    no_hits, _ = multi_scan(*args)
    assert not torch.equal(with_hits, no_hits)
    assert (with_hits >= 0).any()


@pytest.mark.parametrize("bounds", list(BOUNDS))
@pytest.mark.parametrize("name", list(SINGLE))
def test_scan_single_matches_reference(name, bounds):
    c = _single_case(zlib.crc32(name.encode()), **SINGLE[name])
    b = BOUNDS[bounds]
    k = 256
    vh = c["val_hits"]
    out = scan_kernel(
        *(jnp.asarray(c[n]) for n in (
            "kv_key", "kv_val", "entry_start", "entry_end", "entry_dur",
            "entry_valid", "term_keys", "val_ranges")),
        *(jnp.uint32(x) for x in b),
        None if vh is None else jnp.asarray(vh),
        n_terms=c["n_terms"], top_k=k)
    count, inspected, ref_s, ref_i = (int(out[0]), int(out[1]),
                                      np.asarray(out[2]), np.asarray(out[3]))
    t = _torch(c, ("kv_key", "kv_val", "entry_valid", "term_keys",
                   "val_ranges"))
    scores, counts = scan_single(
        t["kv_key"], t["kv_val"], t["entry_start"], t["entry_end"],
        t["entry_dur"], t["entry_valid"], t["term_keys"], t["val_ranges"],
        c["n_terms"], *b, None if vh is None else torch.from_numpy(vh))
    assert counts.tolist() == [count, inspected]
    top_s, top_i = topk(scores, k)
    _assert_topk_contract(top_s.numpy(), top_i.numpy(), ref_s, ref_i)


def test_scan_single_equals_multi_scan_over_one_block():
    """K1s is K1 with one block: the same columns through multi_scan with
    page_block all 0 and the tables as row 0 give the same scores."""
    c = _single_case(3, **SINGLE["ranges_T2"])
    t = _torch(c, ("kv_key", "kv_val", "entry_valid", "term_keys",
                   "val_ranges"))
    cols = (t["kv_key"], t["kv_val"], t["entry_start"], t["entry_end"],
            t["entry_dur"], t["entry_valid"])
    s1, c1 = scan_single(*cols, t["term_keys"], t["val_ranges"],
                         c["n_terms"], 0, U32, 0, U32)
    pb = torch.zeros(t["kv_key"].shape[0], dtype=torch.int32)
    s2, c2 = multi_scan(*cols, pb, t["term_keys"][None],
                        t["val_ranges"][None], c["n_terms"], 0, U32, 0, U32)
    assert torch.equal(s1, s2) and torch.equal(c1, c2)
