"""K3's kernel rule (``kernels.probe.dict_probe_tiled``: value tiles staged
once, byte chunks with their halo, candidate starts a word at a time,
the owner search over the tile's offsets, per-CTA ``any`` partials, bool
rows and words) against the plain version (``dict_probe_plain``) and the
reference's ``probe_kernel`` (through its ``probe_value_hits``) on the
same dictionary, and for words against the reference's
``packing.pack_mask_words``, exactly.

The inputs are ``bench_probe.K3_CASES`` made from a seed with numpy, the
cases ``chip_smoke.k3_edges`` holds the kernel to on the card: V = 1,
31, 32, 33 and 4,097; empty values; a value longer than a chunk with
matches across its seams; a match that would cross a value boundary and
one in the last bytes of buf; needles of 1, 2, 16 and 64 bytes, one
equal to a whole value and one longer than every value; the empty needle
and a None term; T = 1, 2, 33, 40 and 60; non-ASCII UTF-8; buf off a
16-byte boundary. Each runs at tiles of 32, 96 and 1,024 values; some at
grids of 1, 3 and 132 CTAs and more CTAs than tiles.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.search import dict_probe as ref_probe
from tempo_tpu.search import packing as ref_packing

from tempo_tpu_torch.search import dict_probe, packing, pipeline
from tempo_tpu_torch.model.types import SearchRequest
from tempo_tpu_torch.parallel import mesh
from tempo_tpu_torch.search.kernels import probe
from tempo_tpu_torch.search.kernels.bench_probe import (CHUNK, K3_CASES,
                                                        k3_case)

CPU = torch.device("cpu")
SEED = 20261018
TILES = (32, 96, 1024)
GRID_CASES = ("V=4,097", "V=33", "empty values", "T=40",
              "a value longer than a chunk, matches across its seams")


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """(inputs, the reference's bool hits [T, V], its words, any_hits):
    a None term's row is all false, as the port's compile gives it."""
    c = k3_case(SEED, name, CPU)
    V = len(c["vals"])
    rows = [t for t, n in enumerate(c["needles"]) if n is not None]
    want = np.zeros((len(c["needles"]), V), dtype=bool)
    if rows:
        rh, _rany = ref_probe.probe_value_hits(
            ref_probe.stage_val_dict(c["vals"]),
            [c["needles"][t] for t in rows])
        want[rows] = np.asarray(rh)[:, :V]
    words = np.asarray(ref_packing.pack_mask_words(jnp.asarray(want))) \
        .view(np.int32)
    return c, want, words, want.any(axis=1)


def _truth(c) -> np.ndarray:
    """Byte containment, value by value."""
    blobs = [v.encode("utf-8") for v in c["vals"]]
    return np.array([[n is not None and n in b for b in blobs]
                     for n in c["needles"]], dtype=bool).reshape(
                         len(c["needles"]), len(blobs))


def _check(got, want, words: bool) -> None:
    hits, any_hits = got
    w_hits, w_words, w_any = want
    if words:
        assert hits.dtype == torch.int32
        np.testing.assert_array_equal(hits.numpy(), w_words)
    else:
        assert hits.dtype == torch.bool
        np.testing.assert_array_equal(hits.numpy(), w_hits)
    np.testing.assert_array_equal(any_hits.numpy(), w_any)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", list(K3_CASES))
def test_tiled_rule_matches_plain_and_reference(name, tile):
    c, *want = _case(name)
    args = (c["buf"], c["off"], c["arr"], c["lens"])
    for words in (False, True):
        _check(probe.dict_probe_tiled(*args, words, tile=tile, grid=3),
               want, words)


@pytest.mark.parametrize("grid", [1, 3, 132, "more than tiles"])
@pytest.mark.parametrize("name", GRID_CASES)
def test_tiled_rule_at_every_grid(name, grid):
    c, *want = _case(name)
    tiles = -(-len(c["vals"]) // 32)
    g = tiles + 7 if grid == "more than tiles" else grid
    for words in (False, True):
        _check(probe.dict_probe_tiled(c["buf"], c["off"], c["arr"],
                                      c["lens"], words, tile=32, grid=g),
               want, words)


@pytest.mark.parametrize("name", list(K3_CASES))
def test_wrapper_forms_on_the_cpu(name):
    """The public wrapper on CPU tensors, in both forms, and the plain
    version equal the reference and byte containment."""
    c, hits, words, any_hits = _case(name)
    args = (c["buf"], c["off"], c["arr"], c["lens"])
    np.testing.assert_array_equal(hits, _truth(c))
    _check(probe.dict_probe(*args), (hits, words, any_hits), False)
    _check(probe.dict_probe(*args, True), (hits, words, any_hits), True)
    _check(probe.dict_probe_plain(*args), (hits, words, any_hits), False)


def test_cases_reach_every_part_of_the_rule():
    """A value longer than a chunk with a match across each seam, buf
    off a 16-byte boundary, more terms than a pass keeps (8) and than a
    launch takes, V either side of a word and of a tile of 32."""
    long = _case("a value longer than a chunk, matches across its seams")
    c, hits = long[0], long[1]
    blob = b"".join(v.encode() for v in c["vals"])
    assert len(c["vals"][0]) > CHUNK and probe.CHUNK == CHUNK
    starts = [i for i in range(len(blob)) if blob.startswith(b"seam-needle-x",
                                                            i)]
    assert [s < seam < s + 13 for s, seam in zip(starts, (CHUNK, 2 * CHUNK))
            ] == [True, True] and len(starts) == 2
    assert hits[0, :2].tolist() == [True, True]
    shifts = {k3_case(SEED, n, CPU)["buf"].data_ptr() % 16
              for n in ("buf from byte 1 of 16",
                        "buf from byte 7 of 16, a long value")}
    assert shifts == {1, 7}
    Ts = {len(_case(n)[0]["needles"]) for n in K3_CASES}
    assert {1, 2, 33, 40} <= Ts and max(Ts) > probe.LAUNCH_TERMS
    assert probe.launches(60) == 2 and probe.launches(56) == 1
    assert {1, 31, 32, 33, 4097} <= {len(_case(n)[0]["vals"])
                                     for n in K3_CASES}
    lens = {int(x) for n in K3_CASES for x in _case(n)[0]["lens"]}
    assert {-1, 0, 1, 2, 16, 64} <= lens


@pytest.mark.parametrize("words", [False, True])
@pytest.mark.parametrize("T,V", [(1, 1_050_711), (3, 4097), (40, 33),
                                 (2, 0), (60, 1024)])
def test_output_layout_holds_rows_any_and_partials(T, V, words):
    """The one allocation holds the rows, any_hits from a 16-byte
    boundary, and a row of partials a term for every grid the launcher
    picks (at most one CTA a tile), in whole 16-byte units (the word
    form views it as int32)."""
    nbytes, any_at = probe.out_layout(T, V, words)
    rows = T * -(-V // 32) * 4 if words else T * V
    assert any_at % 16 == 0 and any_at >= rows
    part_at = -(-(any_at + T) // 16) * 16
    tiles = max(1, -(-V // 32))          # the most any tile size gives
    assert nbytes % 16 == 0 and 0 <= nbytes - (part_at + T * tiles) < 16


def test_needles_stay_in_host_memory():
    arr, lens = dict_probe.needle_tensors([b"ab", None, b""])
    assert arr.device.type == "cpu" and lens.device.type == "cpu"
    assert arr.dtype == torch.uint8 and lens.tolist() == [2, -1, 0]
    assert arr[0, :2].tolist() == list(b"ab")


@pytest.mark.parametrize("S", [1, 2, 3])
def test_word_form_through_probe_value_hits(S):
    """probe_value_hits with `words` gives pack_mask_words of its bool
    form, on one device and value-sharded (per-shard words join whole),
    and any_hits is "any word != 0"."""
    c, hits, words, any_hits = _case("V=4,097")
    needles = c["needles"] + [None, b""]
    if S == 1:
        dd = dict_probe.stage_val_dict(c["vals"], CPU)
    else:
        pd = dict_probe.pack_device_dict(c["vals"], n_shards=S)
        dd = dict_probe.ShardedDeviceDict(
            packed=pd, exchange=mesh.LocalExchange(S),
            shards=tuple(dict_probe.place_device_dict(pd.shard(r), CPU)
                         for r in range(S)))
    b, b_any = dict_probe.probe_value_hits(dd, needles)
    w, w_any = dict_probe.probe_value_hits(dd, needles, True)
    assert w.dtype == torch.int32 and torch.equal(w, packing.pack_mask_words(b))
    assert torch.equal(w_any, b_any)
    V = len(c["vals"])
    np.testing.assert_array_equal(b[:2, :V].numpy(), hits)
    np.testing.assert_array_equal(b_any.numpy(),
                                  list(any_hits) + [False, True])


def test_packed_compile_takes_words_from_the_probe(monkeypatch):
    """A packed compile asks K3 for words (one call, no K5), and the
    compile cache never serves one mask form for the other: a product in
    the other form is a miss, one in the caller's form a hit."""
    calls, packs = [], []
    real = probe.dict_probe
    monkeypatch.setattr(probe, "dict_probe",
                        lambda *a: calls.append(len(a)) or real(*a))
    real_pack = packing._pack_kernel
    monkeypatch.setattr(packing, "_pack_kernel",
                        lambda h: packs.append(1) or real_pack(h))

    class Holder:
        pass

    vals = _case("V=4,097")[0]["vals"]
    dd = dict_probe.stage_val_dict(vals, CPU)
    req = SearchRequest(tags={"svc": "a"})
    holder, cache = Holder(), pipeline.CompileCache()
    outs = [pipeline.compile_query(["svc"], vals, req, cache_on=holder,
                                   cache=cache, staged_dict=dd,
                                   packed=packed)
            for packed in (False, True, True, False, False)]
    assert calls == [4, 5, 4] and not packs
    assert [o.val_hits.dtype for o in outs] == [torch.bool] + [
        torch.int32] * 2 + [torch.bool] * 2
    assert torch.equal(outs[1].val_hits,
                       packing.pack_mask_words(outs[0].val_hits))
    assert outs[2].val_hits is outs[1].val_hits
    assert outs[4].val_hits is outs[3].val_hits


def test_chip_smoke_k3_edges_rehearse_on_the_cpu():
    """``chip_smoke.k3_edges`` runs every case through the public wrapper
    in both forms; on CPU tensors the wrapper takes the plain version."""
    import chip_smoke

    report, err = chip_smoke.k3_edges(CPU, SEED)
    assert err == 0 and set(report) == set(K3_CASES)
    assert report["buf from byte 1 of 16"]["buf_mod_16"] == 1
    assert all(r["hits"] > 0 for n, r in report.items()
               if n != "a match across a value boundary")


@pytest.mark.parametrize("V,cap", [(1_050_711, 528), (8192, 528), (33, 528),
                                   (60_000, 132), (1, 528), (10**8, 528)])
def test_launcher_tile_choice(V, cap):
    """A tile is a multiple of 32 of at most TILE values, and the tiles
    fill the card's CTAs in one wave where V allows (the hc cell's
    dictionary: 522 tiles for 528 CTAs)."""
    tile = probe.tile_for(V, cap)
    assert tile % 32 == 0 and 32 <= tile <= probe.TILE
    tiles = -(-V // tile)
    assert tiles <= cap or tile == probe.TILE
    assert tile == 32 or -(-V // (tile - 32)) > cap
    if V == 1_050_711:
        assert tiles == 522
