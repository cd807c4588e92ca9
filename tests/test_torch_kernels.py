"""The port's kernels K1 (multi_scan) and K2 (topk) against the reference.

The reference is ``tempo_tpu.search.multiblock.multi_scan_kernel`` run on
JAX's CPU backend, as the repository's own tests run it; the port side is
``kernels.scan.multi_scan`` then ``kernels.topk.topk`` on CPU tensors,
which take the kernels' plain versions. Both get the same staged arrays,
made from a seed with numpy. All outputs are integers, so the tolerance
is zero: equal count and inspected, equal sorted top-k scores, and equal
index sets above the boundary score (equal-score ties at the k boundary
may resolve to different, equally valid entries — ROADMAP.md item C).
The kernels themselves run only on the card (chip_smoke.py holds them
against these plain versions there).
"""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.search.multiblock import multi_scan_kernel

from tempo_tpu_torch.search.kernels.scan import multi_scan
from tempo_tpu_torch.search.kernels.topk import topk, topk_plain

U32 = 0xFFFFFFFF
_NP = {"int8": np.int8, "int16": np.int16, "int32": np.int32}
_VALS = {"int8": 120, "int16": 30_000, "int32": 100_000}


def _case(seed, *, P, E, C, B, T, R, kdt, vdt, pad_pages, start_mode):
    rng = np.random.default_rng(seed)
    n_keys = 6
    n_vals = _VALS[vdt]
    kv_key = rng.integers(-1, n_keys, size=(P, E, C)).astype(_NP[kdt])
    kv_val = rng.integers(0, n_vals, size=(P, E, C)).astype(_NP[vdt])
    kv_val[kv_key < 0] = -1
    if start_mode == "high":
        # starts around 2^31: the score clamps at 2^31-1, making ties
        start = rng.integers(2**31 - 50, 2**31 + 50, size=(P, E))
    else:
        start = rng.integers(1_600_000_000, 1_600_000_000 + 5_000,
                             size=(P, E))
    start = start.astype(np.uint32)
    end = (start.astype(np.int64) + rng.integers(0, 100, size=(P, E)))
    end = np.minimum(end, U32).astype(np.uint32)
    dur = rng.integers(0, 60_000, size=(P, E)).astype(np.uint32)
    dur[0, : min(E, 3)] = U32            # extreme durations
    valid = rng.random((P, E)) < 0.9
    page_block = rng.integers(0, B, size=P).astype(np.int32)
    if pad_pages:
        page_block[-max(1, P // 4):] = -1
        kv_key[page_block < 0] = -1
        kv_val[page_block < 0] = -1
        valid[page_block < 0] = False
    Tw = max(1, T)
    term_keys = rng.integers(0, n_keys, size=(B, Tw)).astype(np.int32)
    term_keys[rng.random((B, Tw)) < 0.15] = -1      # unmatchable terms
    lo = rng.integers(0, n_vals, size=(B, Tw, R))
    hi = lo + rng.integers(0, n_vals // 2, size=(B, Tw, R))
    val_ranges = np.stack([lo, hi], axis=-1).astype(np.int32)
    val_ranges[rng.random((B, Tw, R)) < 0.3] = (1, 0)   # padding ranges
    return dict(kv_key=kv_key, kv_val=kv_val, entry_start=start,
                entry_end=end, entry_dur=dur, entry_valid=valid,
                page_block=page_block, term_keys=term_keys,
                val_ranges=val_ranges, n_terms=T)


CASES = {
    # name: (shape + table kwargs, bounds (dur_lo, dur_hi, win_start, win_end), k)
    "int8_T0_unbounded": (dict(P=4, E=64, C=4, B=2, T=0, R=1, kdt="int8",
                               vdt="int8", pad_pages=True, start_mode="low"),
                          (0, U32, 0, U32), 128),
    "int8_T1_tight": (dict(P=6, E=64, C=4, B=3, T=1, R=1, kdt="int8",
                           vdt="int8", pad_pages=False, start_mode="low"),
                      (10_000, 40_000, 1_600_001_000, 1_600_003_000), 128),
    "int16_T3_R4": (dict(P=8, E=128, C=8, B=4, T=3, R=4, kdt="int16",
                         vdt="int16", pad_pages=True, start_mode="low"),
                    (0, U32, 0, U32), 256),
    "int32_T3_R2_high_starts": (dict(P=8, E=128, C=8, B=3, T=3, R=2,
                                     kdt="int32", vdt="int32",
                                     pad_pages=True, start_mode="high"),
                                (0, U32, 2**31, U32), 128),
    "mixed_int8_int16_T1": (dict(P=4, E=64, C=8, B=2, T=1, R=2,
                                 kdt="int8", vdt="int16", pad_pages=False,
                                 start_mode="high"),
                            (0, U32, 0, U32), 128),
    "duration_at_u32_max": (dict(P=4, E=64, C=4, B=2, T=0, R=1, kdt="int8",
                                 vdt="int8", pad_pages=False,
                                 start_mode="high"),
                            (U32, U32, 0, U32), 128),
    "k_above_n": (dict(P=2, E=8, C=2, B=1, T=0, R=1, kdt="int8", vdt="int8",
                       pad_pages=False, start_mode="low"),
                  (0, U32, 0, U32), 128),
    "two_stage_reference": (dict(P=40, E=1024, C=4, B=5, T=1, R=2,
                                 kdt="int8", vdt="int16", pad_pages=True,
                                 start_mode="low"),
                            (0, U32, 0, U32), 128),
}


def _ref(c, bounds, k):
    out = multi_scan_kernel(
        jnp.asarray(c["kv_key"]), jnp.asarray(c["kv_val"]),
        jnp.asarray(c["entry_start"]), jnp.asarray(c["entry_end"]),
        jnp.asarray(c["entry_dur"]), jnp.asarray(c["entry_valid"]),
        jnp.asarray(c["page_block"]), jnp.asarray(c["term_keys"]),
        jnp.asarray(c["val_ranges"]),
        *(jnp.uint32(b) for b in bounds),
        n_terms=c["n_terms"], top_k=k)
    count, inspected, scores, idx = out
    return int(count), int(inspected), np.asarray(scores), np.asarray(idx)


def _port(c, bounds, k):
    t = {name: torch.from_numpy(np.ascontiguousarray(c[name]))
         for name in ("kv_key", "kv_val", "entry_valid", "page_block",
                      "term_keys", "val_ranges")}
    for name in ("entry_start", "entry_end", "entry_dur"):
        t[name] = torch.from_numpy(c[name].view(np.int32).copy())
    scores, counts = multi_scan(
        t["kv_key"], t["kv_val"], t["entry_start"], t["entry_end"],
        t["entry_dur"], t["entry_valid"], t["page_block"], t["term_keys"],
        t["val_ranges"], c["n_terms"], *bounds)
    top_s, top_i = topk(scores, k)
    return (int(counts[0]), int(counts[1]), top_s.numpy(), top_i.numpy(),
            scores.numpy())


def _assert_topk_contract(got_s, got_i, want_s, want_i):
    assert got_s.shape == want_s.shape
    np.testing.assert_array_equal(np.sort(got_s), np.sort(want_s))
    assert np.all(np.diff(got_s) <= 0), "scores not in descending order"
    if got_s.size:
        boundary = got_s.min()
        assert set(got_i[got_s > boundary].tolist()) == \
            set(want_i[want_s > boundary].tolist())


@pytest.mark.parametrize("name", list(CASES))
def test_scan_and_topk_match_reference(name):
    shape, bounds, k = CASES[name]
    c = _case(zlib.crc32(name.encode()), **shape)
    count, inspected, ref_s, ref_i = _ref(c, bounds, k)
    got_count, got_insp, top_s, top_i, scores = _port(c, bounds, k)
    assert (got_count, got_insp) == (count, inspected)
    assert got_count == int((scores >= 0).sum())
    _assert_topk_contract(top_s, top_i, ref_s, ref_i)
    # every returned index really carries its score
    np.testing.assert_array_equal(scores[top_i], top_s)


def test_case_builder_is_deterministic():
    """The cases come from fixed seeds, so every worker builds the same
    arrays."""
    a = _case(7, **CASES["int8_T1_tight"][0])
    b = _case(7, **CASES["int8_T1_tight"][0])
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_unsigned_bounds_and_high_starts():
    """Starts >= 2^31 and 0xFFFFFFFF bounds compare unsigned: a window
    starting at 2^31 keeps the high starts, and the score of a start above
    2^31-1 clamps to 2^31-1."""
    c = _case(11, P=2, E=16, C=2, B=1, T=0, R=1, kdt="int8", vdt="int8",
              pad_pages=False, start_mode="high")
    c["entry_valid"][:] = True
    c["entry_dur"][:] = 5
    _, _, _, _, scores = _port(c, (0, U32, 2**31, U32), 8)
    end = c["entry_end"].reshape(-1).astype(np.int64)
    start = c["entry_start"].reshape(-1).astype(np.int64)
    want = np.where(end >= 2**31, np.minimum(start, 2**31 - 1), -1)
    np.testing.assert_array_equal(scores, want)
    _, _, _, _, scores = _port(c, (6, U32, 0, U32), 8)
    assert (scores == -1).all()          # every duration 5 < dur_lo 6


@pytest.mark.parametrize("n,k", [(1, 128), (50, 7), (3000, 1024),
                                 (70_000, 128)])
def test_topk_order_and_ties(n, k):
    """topk = stable sort by score descending, index ascending."""
    rng = np.random.default_rng(n)
    s = rng.integers(-1, 20, size=n).astype(np.int32)   # many ties
    got_s, got_i = topk_plain(torch.from_numpy(s), k)
    order = np.lexsort((np.arange(n), -s.astype(np.int64)))[:min(k, n)]
    np.testing.assert_array_equal(got_i.numpy(), order)
    np.testing.assert_array_equal(got_s.numpy(), s[order])
