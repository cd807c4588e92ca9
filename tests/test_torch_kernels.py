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

from tempo_tpu.search.engine import masked_topk as ref_masked_topk
from tempo_tpu.search.multiblock import multi_scan_kernel

from tempo_tpu_torch.search.kernels.scan import multi_scan
from tempo_tpu_torch.search.kernels import topk as topk_mod
from tempo_tpu_torch.search.kernels.topk import (topk, topk_plain,
                                                 topk_rows)

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


BASE_S = 1_700_000_000


def _column(kind: str, n: int, rng) -> np.ndarray:
    """An int32 score column of `kind`: random ties in [-1, 20), or one of
    the adversarial columns the card's kernel is held to (chip_smoke.py
    ``topk_columns``), here at CPU size."""
    if kind == "ties":
        return rng.integers(-1, 20, size=n).astype(np.int32)
    if kind == "all_minus_1":
        return np.full(n, -1, dtype=np.int32)
    if kind == "all_equal":
        return np.full(n, BASE_S, dtype=np.int32)
    # the tag cell's narrow window: block b's starts in [b*600, b*600+600)
    # after one base second, 8,192 entries a block here
    start = BASE_S + (np.arange(n) // 8192) * 600 + rng.integers(0, 600, n)
    if kind == "narrow_window":
        return np.where(rng.integers(0, 50, n) == 0, start,
                        -1).astype(np.int32)
    if kind == "every_entry_a_match":
        return start.astype(np.int32)
    uniform = rng.integers(0, 2**31 - 1, size=n)
    if kind == "uniform_int31":
        return uniform.astype(np.int32)
    if kind == "int32_max":
        return np.where(rng.random(n) < 0.01, 2**31 - 1,
                        uniform).astype(np.int32)
    if kind == "fewer_matches_than_k":
        s = np.full(n, -1, dtype=np.int32)
        m = min(50, n)
        s[rng.choice(n, m, replace=False)] = start[:m]
        return s
    raise ValueError(kind)


def _ref_topk(s: np.ndarray, k: int):
    """The reference's masked_topk over a score column (score >= 0 a
    match, its start second the score)."""
    mask = jnp.asarray(s >= 0)
    start = jnp.asarray(np.maximum(s, 0).astype(np.uint32))
    rs, ri = ref_masked_topk(mask, start, k)
    return np.asarray(rs), np.asarray(ri)


TOPK_CASES = [
    pytest.param(1, 128, "ties", id="1-128"),
    pytest.param(50, 7, "ties", id="50-7"),
    pytest.param(3000, 1024, "ties", id="3000-1024"),
    pytest.param(70_000, 128, "ties", id="70000-128"),
    pytest.param(20_000, 128, "all_minus_1", id="all_minus_1"),
    pytest.param(20_000, 1024, "all_minus_1", id="all_minus_1-k1024"),
    pytest.param(20_000, 128, "all_equal", id="all_equal"),
    pytest.param(70_000, 128, "narrow_window", id="narrow_window"),
    pytest.param(70_000, 4096, "narrow_window", id="narrow_window-k4096"),
    pytest.param(20_000, 128, "every_entry_a_match",
                 id="every_entry_a_match"),
    pytest.param(20_000, 128, "uniform_int31", id="uniform_int31"),
    pytest.param(20_000, 128, "int32_max", id="int32_max"),
    pytest.param(20_000, 128, "fewer_matches_than_k",
                 id="fewer_matches_than_k"),
    pytest.param(3000, 3000, "narrow_window", id="k_equals_n"),
    pytest.param(3000, 4096, "narrow_window", id="k_above_n"),
    pytest.param(1, 128, "int32_max", id="n1_int32_max"),
    pytest.param(2049, 128, "narrow_window", id="n2049"),
]


@pytest.mark.parametrize("n,k,kind", TOPK_CASES)
def test_topk_order_and_ties(n, k, kind):
    """topk = stable sort by score descending, index ascending, on random
    ties and on the adversarial columns; the wrapper (here its plain
    version) agrees, and the reference's masked_topk holds to the tie
    contract."""
    rng = np.random.default_rng(n)
    s = _column(kind, n, rng)
    got_s, got_i = topk_plain(torch.from_numpy(s), k)
    order = np.lexsort((np.arange(n), -s.astype(np.int64)))[:min(k, n)]
    np.testing.assert_array_equal(got_i.numpy(), order)
    np.testing.assert_array_equal(got_s.numpy(), s[order])
    ws, wi = topk(torch.from_numpy(s), k)
    assert torch.equal(ws, got_s) and torch.equal(wi, got_i)
    _assert_topk_contract(got_s.numpy(), got_i.numpy(), *_ref_topk(s, k))


ROW_KINDS = ["all_minus_1", "all_equal", "narrow_window",
             "every_entry_a_match", "uniform_int31", "int32_max",
             "fewer_matches_than_k", "ties"]


@pytest.mark.parametrize("n,k", [(20_000, 128), (20_000, 1024),
                                 (3000, 4096), (1, 128)])
def test_topk_rows_order_and_ties(n, k):
    """topk_rows (here its plain version) over rows of every adversarial
    kind at once (rows that a radix select resolves on different passes)
    is each row's stable sort, and holds to the tie contract against the
    reference's masked_topk row by row."""
    rng = np.random.default_rng(n + k)
    s = np.stack([_column(kind, n, rng) for kind in ROW_KINDS])
    got_s, got_i = topk_rows(torch.from_numpy(s), k)
    assert got_s.shape == got_i.shape == (len(ROW_KINDS), min(k, n))
    for q, row in enumerate(s):
        order = np.lexsort((np.arange(n), -row.astype(np.int64)))[:k]
        np.testing.assert_array_equal(got_i[q].numpy(), order)
        np.testing.assert_array_equal(got_s[q].numpy(), row[order])
        _assert_topk_contract(got_s[q].numpy(), got_i[q].numpy(),
                              *_ref_topk(row, k))


def test_topk_wrappers_refuse_bad_inputs():
    """Both wrappers refuse, on any device, another dtype, rank or layout
    and k < 1 (the CUDA route would misread them)."""
    col = torch.zeros(64, dtype=torch.int32)
    rows = torch.zeros((4, 64), dtype=torch.int32)
    for bad in (col.long(), col.float(), rows, col[::2]):
        with pytest.raises(ValueError):
            topk(bad, 8)
    for bad in (rows.long(), col, rows.t(), rows[:, ::2]):
        with pytest.raises(ValueError):
            topk_rows(bad, 8)
    for k in (0, -1):
        with pytest.raises(ValueError):
            topk(col, k)
        with pytest.raises(ValueError):
            topk_rows(rows, k)
    with pytest.raises(ValueError):
        topk_rows(torch.zeros((65536, 1), dtype=torch.int32), 1)


def test_topk_scratch_follows_the_route():
    """One call's scratch: the cooperative route's per-launch rows (they
    share it, launch after launch) at 8,192 + 32,768 keys a row; past
    COOP_MAX_K the chain's winners are the padded k, per row."""
    per_row = (8192 + 32768) * 8 + 3 * 2048 * 4 + 8 + 16
    assert topk_mod.scratch_bytes(1, 128, 264) == per_row + 64
    assert topk_mod.scratch_bytes(8, 1024, 264) == 8 * per_row + 64
    assert topk_mod.scratch_bytes(1000, 4096, 264) == 264 * per_row + 64
    assert topk_mod.scratch_bytes(2, 4097, 264) == 2 * (8192 * 8 + 40
                                                        + 2048 * 4)
