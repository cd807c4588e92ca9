"""K8's kernel rule (``kernels.agg.analytics_count_tiled``: CTAs over
contiguous runs of 16-byte vectors of series ids and durations, heads and
tails one entry at a time, each key in its CTA's histogram, then the
CTAs' partial rows summed by column, or global atomics past one CTA's
limit)
against the plain version (``analytics_count_plain``), the reference's
device count (``ANALYTICS._count_device``, durations below 2^62 ns) and
its host count (``ANALYTICS._count``, at and past 2^62 ns), exactly.

The inputs are ``bench_agg.K8_CASES`` made from a seed with numpy, the
cases ``chip_smoke.k8_edges`` holds the kernel to on the card: n = 0, 1,
3, 2,053, 4,097 and 4,096 x 5 + 3; series ids and durations starting off a
16-byte boundary, in phase with each other and not; K = 15, 960, 61,440,
either side of the CTA route's limit and far past it; series ids at or
past n_keys and negative; durations on every threshold and one either
side, 0, and 2^62 - 1 up to 2^63 - 1; one hot bin. Each runs at grids of
1, 3, 132 and 1,000 CTAs.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from tempo_tpu.search import analytics as ref_analytics

from tempo_tpu_torch.search import analytics
from tempo_tpu_torch.search.kernels import agg
from tempo_tpu_torch.search.kernels.bench_agg import K8_CASES, k8_case

CPU = torch.device("cpu")
GRIDS = (1, 3, 132, 1000)
SEED = 20261018


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """(series ids, durations, thresholds, n_keys, the reference's counts,
    which reference counted) of one edge case."""
    s, d, thr, n_keys, buckets = k8_case(SEED, name, CPU)
    sidx, dur = s.numpy().astype(np.int64), d.numpy()
    if dur.size and int(dur.max()) >= 1 << 62:
        want = ref_analytics.ANALYTICS._count(sidx, dur, n_keys, buckets)
        which = "host"
    else:
        want = ref_analytics.ANALYTICS._count_device(
            sidx, dur, n_keys, ref_analytics._dur_thresholds(buckets))
        which = "device"
    return s, d, thr, n_keys, np.asarray(want, dtype=np.int64), which


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("name", list(K8_CASES))
def test_tiled_rule_matches_plain_and_reference(name, grid):
    s, d, thr, n_keys, want, _which = _case(name)
    got = agg.analytics_count_tiled(s, d, thr, n_keys, grid)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (n_keys * (thr.numel() + 1),)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(K8_CASES))
def test_plain_and_wrapper_match_the_reference(name):
    """The plain version and the public wrapper on CPU tensors (views at
    the case's offsets) equal the reference; so does ``dense_counts``."""
    s, d, thr, n_keys, want, _which = _case(name)
    np.testing.assert_array_equal(
        agg.analytics_count_plain(s, d, thr, n_keys).numpy(), want)
    np.testing.assert_array_equal(
        agg.analytics_count(s, d, thr, n_keys).numpy(), want)
    if thr.numel() == len(analytics.LATENCY_BUCKETS_S):
        np.testing.assert_array_equal(
            analytics.dense_counts(s.numpy(), d.numpy(), n_keys,
                                   device="cpu"), want)


def test_cases_reach_every_part_of_the_rule():
    """The cases take both routes and straddle the CTA route's limit,
    start off a 16-byte boundary in and out of phase, reach both
    references, and leave CTAs without a vector at the larger grids."""
    routes = {name: agg.count_route(c["n_keys"] * (c["nb"] + 1))
              for name, c in K8_CASES.items()}
    assert routes["n=4,097"] == "cta"                   # K = 960
    assert routes["K=36,864, one CTA's limit"] == "cta"
    assert routes["K=36,865, the global route"] == "global"
    assert routes["K=61,440"] == "global"
    assert routes["K=450,560, the global route"] == "global"
    assert agg.count_route(agg.CTA_BINS) == "cta"
    assert agg.count_route(agg.CTA_BINS + 1) == "global"
    assert agg.CTA_BINS <= agg.SHARED_BINS
    phases, aligned, which = set(), set(), set()
    for name in K8_CASES:
        s, d, _thr, _nk, _want, w = _case(name)
        which.add(w)
        ps, pd = s.data_ptr(), d.data_ptr()
        phases.add((ps % 16, pd % 16))
        head = (-(ps // 4)) % 4
        aligned.add((pd + 8 * head) % 16 == 0)
    assert {0, 4, 8, 12} <= {p for p, _ in phases}
    assert aligned == {True, False} and which == {"host", "device"}
    assert any(0 < c["n"] // 4 < max(GRIDS) for c in K8_CASES.values())


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("K", [1, 15, 960, 36_864, 36_865, 56_320, 61_440,
                               450_560, 2**31 - 1000])
def test_partials_fit_the_output_buffer(K, sms):
    """The CTA route's partial rows (at most one a CTA, one CTA an SM, K
    rounded up to ``TILE`` each) fit the output the wrapper allocates,
    from a 16-byte boundary after the counts; the global route needs the
    counts alone."""
    kp = agg.pitch(K)
    assert kp % agg.TILE == 0 and kp >= K
    if agg.count_route(K) == "global":
        assert kp > agg.CTA_BINS
        assert agg.count_out_ints(K, sms) == K
        return
    assert kp <= agg.CTA_BINS
    counts = -(-K // 4) * 4
    assert agg.count_out_ints(K, sms) == counts + sms * kp
    assert (counts * 4) % 16 == 0


def test_cuda_wrapper_takes_host_thresholds():
    """K8 takes its thresholds in the launch's parameters: the analytics
    module hands it the host's tensor, made once per device and bucket
    tuple, and the CUDA wrapper refuses thresholds off the host before
    any launch."""
    a = analytics.thresholds_tensor(analytics.LATENCY_BUCKETS_S, CPU)
    assert a is analytics.thresholds_tensor(analytics.LATENCY_BUCKETS_S, CPU)
    assert a.device.type == "cpu" and a.dtype == torch.int64
    assert a.tolist() == list(analytics._dur_thresholds_full(
        analytics.LATENCY_BUCKETS_S))
    s = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="host"):
        agg._count_cuda(s, s.to(torch.int64), a.to("meta"), 4)
