"""K7's kernel rule (``kernels.agg.agg_counts_tiled``: per-CTA partial
histograms over contiguous runs of 16-byte vectors, heads and tails one
entry at a time, then the column sum) against the plain version
(``agg_counts_rows_plain``) and the reference's ``agg_entry_counts``
through ``jax.jit`` ([K]) and ``jax.vmap`` ([Q, K]), exactly.

The inputs are ``bench_agg.K7_CASES`` made from a seed with numpy, the
cases ``chip_smoke.k7_edges`` holds the kernel to on the card: N = 0, 1,
3, 4,095 and 4,096 k + 1; score rows and keys starting off a 16-byte
boundary (the same phase and not); K = 1, 33, just below and above the
shared route's limit, 30,720; keys past K and negative; all rejected and
all accepted; one hot bin; ~10% accepted; rows whose starts fall at
different phases; more rows than CTAs. Each runs at grids of 1, 3, 132
and 1,000 CTAs (more CTAs than the rows have vectors).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.search.multiblock import agg_entry_counts

from tempo_tpu_torch.search.kernels import agg
from tempo_tpu_torch.search.kernels.bench_agg import K7_CASES, k7_case

CPU = torch.device("cpu")
GRIDS = (1, 3, 132, 1000)
SEED = 20261018
_ref_counts = jax.jit(agg_entry_counts, static_argnames=("n_keys",))


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """(scores, keys, K, the reference's counts) of one edge case."""
    scores, keys, K = k7_case(SEED, name, CPU)
    mask = jnp.asarray((scores >= 0).numpy())
    kj = jnp.asarray(keys.numpy())
    if scores.shape[0] == 1:
        want = np.asarray(_ref_counts(mask[0], kj, n_keys=K))[None]
    else:
        want = np.asarray(jax.jit(jax.vmap(
            lambda m: agg_entry_counts(m, kj, K)))(mask))
    return scores, keys, K, want


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("name", list(K7_CASES))
def test_tiled_rule_matches_plain_and_reference(name, grid):
    scores, keys, K, want = _case(name)
    got = agg.agg_counts_tiled(scores, keys, K, grid)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        agg.agg_counts_rows_plain(scores, keys, K).numpy(), want)


@pytest.mark.parametrize("name", list(K7_CASES))
def test_wrappers_take_the_plain_version_on_the_cpu(name):
    """The public wrappers on CPU tensors (a row view where Q = 1) equal
    the reference; the inputs' views are what the card gets."""
    scores, keys, K, want = _case(name)
    if scores.shape[0] == 1:
        got = agg.agg_counts(scores[0], keys, K)[None]
    else:
        got = agg.agg_counts_rows(scores, keys, K)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cases_reach_every_part_of_the_rule():
    """The edge cases straddle the shared route's limit, start off a
    16-byte boundary in and out of phase with the keys, and leave units
    without a vector at the larger grids."""
    routes = {name: agg.route(c["K"]) for name, c in K7_CASES.items()}
    assert routes["K just below the shared limit"] == "shared"
    assert routes["K just above the shared limit"] == "global"
    assert routes["K=30,720"] == "shared"
    assert agg.pitch(agg.SHARED_BINS) == agg.SHARED_BINS
    assert agg.route(agg.SHARED_BINS + 1) == "global"
    phases = set()
    for name in K7_CASES:
        scores, keys, _K, _w = _case(name)
        for q in range(scores.shape[0]):
            phases.add((scores[q].data_ptr() - keys.data_ptr()) % 16)
    assert phases == {0, 4, 8, 12}
    assert any(0 < c["n"] // 4 < max(GRIDS) // c["Q"]
               for c in K7_CASES.values())


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("Q", [1, 2, 8, 131, 132, 133, 200, 5000])
def test_partials_fit_the_output_buffer(Q, grid):
    """The kernel's units (Q x max(1, grid // Q)) never outnumber the
    partial rows the wrapper allocates (max(Q, SMs), grid <= SMs), and
    the partials start on a 16-byte boundary after the counts."""
    units = Q * max(1, grid // Q)
    assert units <= max(Q, grid)
    for K in (1, 3840, 30_720, agg.SHARED_BINS):
        counts = -(-Q * K // 4) * 4
        assert agg._out_ints(Q, K, grid) >= counts + units * agg.pitch(K)
    assert agg._out_ints(Q, agg.SHARED_BINS + 1, grid) == \
        Q * (agg.SHARED_BINS + 1)
