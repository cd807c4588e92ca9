"""The port's dictionary probe (kernel K3's plain version and the compile
route around it) against the reference's.

The reference is ``tempo_tpu.search.dict_probe.probe_value_hits`` (its
``probe_kernel``) on JAX's CPU backend, as ``tests/test_dict_probe.py``
runs it; the port side is ``tempo_tpu_torch.search.dict_probe`` on CPU
tensors, which takes K3's plain version. Both get the same dictionaries
and needles, made from a seed with numpy, and are compared as value-id
sets through each package's ``hits_to_ids``: exact equality, since the
outputs are booleans. The CUDA kernel itself runs only on the card
(``chip_smoke.py`` holds it against the plain version there).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tempo_tpu import tempopb
from tempo_tpu.search import dict_probe as ref_probe
from tempo_tpu.search import pipeline as ref_pipeline

from tempo_tpu_torch.model.types import SearchRequest
from tempo_tpu_torch.search import dict_probe, pipeline
from tempo_tpu_torch.search.kernels import probe as probe_k

ALPHABET = list("ab7-_.") + ["é", "ß", "日", "本", "😀"]


def _dictionary(seed: int, n: int) -> list[str]:
    """`n` distinct sorted values over a small alphabet with multi-byte
    characters, the empty value among them."""
    rng = np.random.default_rng(seed)
    vals = {""}
    while len(vals) < n:
        ln = int(rng.integers(1, 12))
        vals.add("".join(ALPHABET[i]
                         for i in rng.integers(len(ALPHABET), size=ln)))
    return sorted(vals)


def _ref_ids(val_dict, needles):
    dd = ref_probe.stage_val_dict(val_dict)
    hits, any_hits = ref_probe.probe_value_hits(
        dd, [n.encode("utf-8") for n in needles])
    hits = np.asarray(hits)[:, :len(val_dict)]
    return ([ref_probe.hits_to_ids(h) for h in hits],
            np.asarray(any_hits).tolist())


def _port_ids(val_dict, needles):
    dd = dict_probe.stage_val_dict(val_dict, torch.device("cpu"))
    hits, any_hits = dict_probe.probe_value_hits(
        dd, [n.encode("utf-8") for n in needles])
    assert hits.shape == (len(needles), len(val_dict))
    return [dict_probe.hits_to_ids(h) for h in hits], any_hits.tolist()


def _truth(val_dict, needle):
    return np.asarray([i for i, v in enumerate(val_dict)
                       if needle.encode("utf-8") in v.encode("utf-8")],
                      dtype=np.int32)


FIXED = ["", "abc", "ab", "bca", "日本", "é7", "ca", "x",
         "😀", "a" * 64, "b😀"]
FIXED_NEEDLES = [
    [""],                    # the empty needle: every value, "" included
    ["ab"],
    ["ca"],                  # "ab"+"c..." would span a boundary: no match
    ["bcaé"],                # only across the "bca" | "é7" boundary
    ["日本"],                 # multi-byte UTF-8
    ["😀", "b😀", "é"],
    ["a" * 64],              # a needle of exactly MAX_NEEDLE_BYTES
    ["a", "b", "c", "x"],    # T = 4
]


@pytest.mark.parametrize("needles", FIXED_NEEDLES,
                         ids=lambda n: "|".join(n) or "empty")
def test_probe_fixed_edges_match_reference(needles):
    val_dict = sorted(FIXED)
    got, got_any = _port_ids(val_dict, needles)
    want, want_any = _ref_ids(val_dict, needles)
    for g, w, n in zip(got, want, needles):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _truth(val_dict, n))
    assert got_any == want_any == [g.size > 0 for g in got]


def test_probe_never_matches_across_a_value_boundary():
    val_dict = ["ab", "cd"]
    got, got_any = _port_ids(val_dict, ["bc", "abcd", "b", "c"])
    assert [g.tolist() for g in got] == [[], [], [0], [1]]
    assert got_any == [False, False, True, True]


@pytest.mark.parametrize("seed,n_vals,n_terms",
                         [(1, 40, 1), (2, 200, 2), (3, 500, 3),
                          (4, 1000, 4)])
def test_probe_seeded_dictionaries_match_reference(seed, n_vals, n_terms):
    val_dict = _dictionary(seed, n_vals)
    rng = np.random.default_rng(seed + 100)
    needles = []
    for t in range(n_terms):
        v = val_dict[int(rng.integers(len(val_dict)))]
        if t == 0 or not v:
            # a short substring of a real value, so some terms hit
            ln = int(rng.integers(0, 3))
            needles.append(v[:ln])
        else:
            needles.append("".join(
                ALPHABET[i] for i in rng.integers(len(ALPHABET), size=2)))
    got, got_any = _port_ids(val_dict, needles)
    want, want_any = _ref_ids(val_dict, needles)
    for g, w, n in zip(got, want, needles):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _truth(val_dict, n))
    assert got_any == want_any


def test_unmatchable_term_gives_an_all_false_row():
    """A needle of None (a term whose key is absent) matches nothing, not
    even through the empty needle's every-value rule."""
    dd = dict_probe.stage_val_dict(["", "a", "b"], torch.device("cpu"))
    hits, any_hits = dict_probe.probe_value_hits(dd, [None, b"", b"a"])
    assert hits.tolist() == [[False, False, False], [True, True, True],
                             [False, True, False]]
    assert any_hits.tolist() == [False, True, True]


def test_probe_rejects_oversized_needle_and_empty_list():
    dd = dict_probe.stage_val_dict(["a"], torch.device("cpu"))
    with pytest.raises(ValueError):
        dict_probe.probe_value_hits(dd, [b"a" * 65])
    with pytest.raises(ValueError):
        dict_probe.probe_value_hits(dd, [])


def test_packed_layout_and_nbytes():
    """buf holds the values' bytes back to back, off their starts; the
    staged bytes are exactly those two arrays."""
    vals = ["", "ab", "日本"]
    packed = dict_probe.pack_device_dict(vals)
    assert bytes(packed.buf) == "ab日本".encode()
    assert packed.off.tolist() == [0, 0, 2, 8]
    dd = dict_probe.place_device_dict(packed, torch.device("cpu"))
    assert dd.nbytes == 8 + 4 * 4 == packed.nbytes


# ---------------------------------------------------------------------------
# the compile route around the probe


KEYS = ["http.url", "session.id", "svc"]


def _ref_req(tags):
    r = tempopb.SearchRequest()
    for k, v in tags.items():
        r.tags[k] = v
    return r


def _compile_both(val_dict, tags, cache=None, cache_on=None):
    ref_dd = ref_probe.stage_val_dict(val_dict)
    want = ref_pipeline.compile_query(KEYS, val_dict, _ref_req(tags),
                                      staged_dict=ref_dd)
    dd = dict_probe.stage_val_dict(val_dict, torch.device("cpu"))
    got = pipeline.compile_query(KEYS, val_dict, SearchRequest(tags=tags),
                                 cache_on=cache_on, cache=cache,
                                 staged_dict=dd)
    return want, got


def _route_ids(cq, val_dict, t):
    """A compiled term's value-id set, whichever route built it."""
    if cq.val_hits is not None:
        return np.asarray(cq.val_hits[t])[:len(val_dict)].nonzero()[0]
    ids = [np.arange(lo, hi + 1) for lo, hi in cq.val_ranges[t]
           if lo <= hi]
    return np.concatenate(ids) if ids else np.zeros(0, dtype=np.int64)


@pytest.mark.parametrize("n_bytes,device_route", [(64, True), (65, False)])
def test_needle_length_picks_the_route_before_any_launch(monkeypatch,
                                                         n_bytes,
                                                         device_route):
    """A 64-byte needle probes on the device in both packages; a 65-byte
    one takes the exact host path in both, and the port never calls K3
    for it."""
    calls = []
    real = probe_k.dict_probe
    monkeypatch.setattr(probe_k, "dict_probe",
                        lambda *a: calls.append(1) or real(*a))
    needle = "é" * (n_bytes // 2) + "a" * (n_bytes % 2)
    assert len(needle.encode()) == n_bytes
    val_dict = sorted(["x" + needle + "y", needle, "a", "b"])
    want, got = _compile_both(val_dict, {"session.id": needle,
                                         "svc": "a"})
    assert (want.val_hits is not None) == device_route
    assert (got.val_hits is not None) == device_route
    assert len(calls) == (1 if device_route else 0)
    np.testing.assert_array_equal(got.term_keys, want.term_keys)
    for t in range(got.n_terms):
        np.testing.assert_array_equal(_route_ids(got, val_dict, t),
                                      _route_ids(want, val_dict, t))


def test_absent_key_prunes_or_gives_all_false_row_under_exhaustive():
    val_dict = sorted(["a1", "a2", "b1"])
    want, got = _compile_both(val_dict, {"no.such": "a", "svc": "a"})
    assert want is None and got is None
    want, got = _compile_both(val_dict, {"no.such": "", "svc": "a",
                                         "x-dbg-exhaustive": ""})
    np.testing.assert_array_equal(got.term_keys, want.term_keys)
    assert got.term_keys.tolist() == [-1, 2]
    assert not got.val_hits[0].any()          # despite the empty needle
    for t in range(2):
        np.testing.assert_array_equal(_route_ids(got, val_dict, t),
                                      _route_ids(want, val_dict, t))


def test_term_without_hits_prunes_unless_exhaustive():
    val_dict = sorted(["a1", "a2", "b1"])
    want, got = _compile_both(val_dict, {"svc": "zz"})
    assert want is None and got is None
    want, got = _compile_both(val_dict, {"svc": "zz",
                                         "x-dbg-exhaustive": ""})
    assert got is not None and want is not None
    assert not got.val_hits.any()


def test_compile_cache_hides_the_probe_on_a_repeat(monkeypatch):
    """A repeated tag-set is served from the compile cache: no K3 call."""
    calls = []
    real = probe_k.dict_probe
    monkeypatch.setattr(probe_k, "dict_probe",
                        lambda *a: calls.append(1) or real(*a))

    class Holder:
        pass

    holder, cache = Holder(), pipeline.CompileCache()
    val_dict = _dictionary(9, 300)
    dd = dict_probe.stage_val_dict(val_dict, torch.device("cpu"))
    req = SearchRequest(tags={"svc": "ab"})
    first = pipeline.compile_query(KEYS, val_dict, req, cache_on=holder,
                                   cache=cache, staged_dict=dd)
    again = pipeline.compile_query(KEYS, val_dict, req, cache_on=holder,
                                   cache=cache, staged_dict=dd)
    assert len(calls) == 1
    assert again.val_hits is first.val_hits


def test_compile_cache_keeps_at_most_eight_device_masks_per_dictionary():
    class Holder:
        pass

    holder, cache = Holder(), pipeline.CompileCache()
    val_dict = _dictionary(10, 200)
    dd = dict_probe.stage_val_dict(val_dict, torch.device("cpu"))
    needles = [v for v in val_dict if v][:12]
    for n in needles:
        pipeline.compile_query(KEYS, val_dict,
                               SearchRequest(tags={"svc": n}),
                               cache_on=holder, cache=cache, staged_dict=dd)
    # a host product (oversized needle) is kept beside them
    pipeline.compile_query(KEYS, val_dict,
                           SearchRequest(tags={"svc": "z" * 70}),
                           cache_on=holder, cache=cache, staged_dict=dd)
    entries = next(iter(cache._by_dict.values()))
    probed = [s for s, o in entries.items()
              if o != "pruned" and o[2] is not None]
    assert len(probed) == pipeline._PROBE_CACHE_MAX == 8
    # the newest eight survive
    assert [s[0][0][1] for s in probed] == needles[-8:]
    assert len(entries) == 9
