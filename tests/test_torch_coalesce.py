"""Concurrent search in the port: ``stack_queries``, the fused dispatch
(K4 ``coalesced_scan`` + K2r ``topk_rows``) and the query coalescer,
against the reference.

The reference writes search blocks into a LocalBackend directory: four
carry a per-trace ``session.id`` unique across the corpus (dictionaries
of 150-250 values), two carry only low-cardinality tags. Both packages
lower the probe threshold to 64 values (the reference's own setting), so
one batch mixes probed blocks (hit-mask mode) and range blocks; a second
engine with the threshold at 0 keeps every block on the range path. The
reference runs on JAX's CPU backend, the port on the CPU, where the
kernel wrappers take their plain versions (the kernels themselves run
only on the card, where ``chip_smoke.py`` holds them against these).

What is held, with the tolerance zero (all values are integers):
- ``stack_queries`` field by field against the reference's, for Q = 1, 3
  (padded to 4) and 8, unequal term counts and range widths, probe and
  host-compiled members mixed;
- K4 then K2r against the reference's ``coalesced_scan_kernel`` on the
  same staged arrays, per query: equal count and inspected, equal top-k
  score multisets, and equal index sets above the boundary score
  (ROADMAP.md item C);
- a fused dispatch against solo K1 + K2 dispatches in the port, exactly,
  indices included;
- the coalescer's window, size and peer rules (mirroring
  ``tests/test_coalesce.py``), concurrent ``TempoDB.search`` against
  serial runs in both packages, and the peer counters after an early
  quit and after a dispatch that raises.
Every thread join and future wait has a timeout.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu import tempopb
from tempo_tpu.backend.local import LocalBackend as RefLocalBackend
from tempo_tpu.backend.types import BlockMeta as RefBlockMeta
from tempo_tpu.db import TempoDB as RefTempoDB
from tempo_tpu.db import TempoDBConfig as RefTempoDBConfig
from tempo_tpu.search.backend_search_block import \
    BackendSearchBlock as RefBackendSearchBlock
from tempo_tpu.search.backend_search_block import \
    write_search_block as ref_write_search_block
from tempo_tpu.search import pipeline as ref_pipeline
from tempo_tpu.search.columnar import PageGeometry as RefPageGeometry
from tempo_tpu.search.data import SearchData as RefSearchData
from tempo_tpu.search.engine import masked_topk as ref_masked_topk
from tempo_tpu.search.multiblock import \
    MultiBlockEngine as RefMultiBlockEngine
from tempo_tpu.search.multiblock import coalesced_scan_kernel
from tempo_tpu.search.multiblock import compile_multi as ref_compile_multi
from tempo_tpu.search.multiblock import stack_queries as ref_stack_queries

from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.model.types import SearchRequest
from tempo_tpu_torch.search import multiblock as port_multiblock
from tempo_tpu_torch.search.backend_search_block import BackendSearchBlock
from tempo_tpu_torch.search.batcher import (BlockBatcher, QueryCoalescer,
                                            ScanJob, _predicate_sig)
from tempo_tpu_torch.search.engine import (fetch_coalesced_out,
                                           fetch_scan_out, resolve_top_k)
from tempo_tpu_torch.search.kernels import scan as scan_k
from tempo_tpu_torch.search.kernels.scan import coalesced_scan_plain
from tempo_tpu_torch.search.kernels.topk import topk_plain, topk_rows_plain
from tempo_tpu_torch.search.multiblock import (MultiBlockEngine,
                                               compile_multi, stack_queries)

TENANT = "t1"
E = 32
MAX_PAGES = 16
PROBE_MIN = 64
BASE_S = 1_700_000_000
SERVICES = [f"svc-{i:02d}" for i in range(12)]
LONG_URL = "/api/v1/" + "segment/" * 8 + "end"   # 75 bytes: host route
CPU = torch.device("cpu")
WAIT_S = 60          # the longest any future or thread is waited for


def _block_entries(rng, b: int, n: int, first_session: int,
                   sessions: bool) -> list:
    out = []
    for j in range(n):
        start = BASE_S + b * 1800 + int(rng.integers(0, 1800))
        dur_ms = int(rng.integers(1, 30_000))
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
            "host.name": {f"host-{int(rng.integers(8))}"},
        }
        if sessions:
            sd.kvs["session.id"] = {f"session-{first_session + j:07d}"}
            if j % 37 == 0:
                sd.kvs["http.url"] = {LONG_URL + f"?n={j}"}
        out.append(sd)
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six blocks written by the reference: four with unique session ids,
    two (blocks 1 and 4) with low-cardinality tags only."""
    root = tmp_path_factory.mktemp("torch_coalesce")
    be = RefLocalBackend(str(root / "blocks"))
    rng = np.random.default_rng(20261019)
    geometry = RefPageGeometry(entries_per_page=E, kv_per_entry=8)
    first = 0
    for b in range(6):
        n = int(rng.integers(150, 250))
        entries = _block_entries(rng, b, n, first, sessions=b % 3 != 1)
        first += n
        ref_write_search_block(be, RefBlockMeta(tenant_id=TENANT), entries,
                               geometry=geometry, encoding="zlib")
    return root


def _ref_req(tags, kw):
    r = tempopb.SearchRequest()
    for k, v in tags.items():
        r.tags[k] = v
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def _port_req(tags, kw):
    return SearchRequest(tags=dict(tags), **kw)


# eight distinct requests: one to three terms, ranges of unequal width,
# probe members and host-compiled ones (no term; a needle over 64 bytes),
# and uint32 edge bounds (dur_hi >= 2^31; win_end = 0xFFFFFFFF, the
# default of an open window)
REQS = [
    ({"session.id": "77"}, {"limit": 20}),
    ({}, {"min_duration_ms": 5_000, "max_duration_ms": 3_000_000_000,
          "limit": 30}),
    ({"http.url": LONG_URL[:65]}, {"limit": 5}),
    ({"session.id": "1", "service.name": "svc-0"}, {"limit": 20}),
    ({"service.name": "svc-1"}, {"limit": 40}),
    ({"region": "west", "http.status_code": "5", "host.name": "host-"},
     {"limit": 20}),
    ({}, {"start": BASE_S + 2 * 1800 + 300, "end": BASE_S + 4 * 1800,
          "limit": 50}),
    ({"session.id": "session-000012", "x-dbg-exhaustive": ""},
     {"limit": 20}),
]


@pytest.fixture(scope="module")
def blocks(corpus):
    """(reference pages, port pages) of every block, by block id."""
    rbe = RefLocalBackend(str(corpus / "blocks"))
    pbe = LocalBackend(str(corpus / "blocks"))
    db = TempoDB(pbe, device="cpu")
    db.poll()
    db.close()
    rp, pp = [], []
    for m in sorted(db.blocklist.metas(TENANT), key=lambda m: m.block_id):
        rm = RefBlockMeta(tenant_id=TENANT, block_id=m.block_id,
                          encoding=m.encoding, version=m.version,
                          data_encoding=m.data_encoding,
                          start_time=m.start_time, end_time=m.end_time)
        rp.append(RefBackendSearchBlock(rbe, rm).pages())
        pp.append(BackendSearchBlock(pbe, m, device="cpu").pages())
    assert len(pp) == 6
    return rp, pp


@pytest.fixture(scope="module", params=[PROBE_MIN, 0], ids=["hits", "ranges"])
def staged(request, blocks):
    """One batch of all six blocks in each package: with the probe
    threshold at 64 (probed and range blocks mixed) or at 0 (all
    ranges)."""
    rp, pp = blocks
    ref_eng = RefMultiBlockEngine(top_k=128,
                                  device_probe_min_vals=request.param)
    eng = MultiBlockEngine(CPU, device_probe_min_vals=request.param)
    return (ref_eng, ref_eng.stage(rp), eng,
            eng.place(eng.stage_host(pp)), request.param)


def _compile_both(staged, reqs):
    ref_eng, rbatch, eng, batch, _pm = staged
    # the reference's compile cache is process-wide, and serves a probe
    # product to a batch that staged no dictionary; the port's belongs to
    # its engine. Start both from the batch's own staging.
    ref_pipeline._COMPILE_CACHE.clear()
    rmqs, mqs = [], []
    for tags, kw in reqs:
        rmq = ref_compile_multi(list(rbatch.blocks), _ref_req(tags, kw),
                                cache_on=rbatch)
        mq = compile_multi(list(batch.blocks), _port_req(tags, kw),
                           memo=batch.memo, cache=eng.compile_cache,
                           staged_dicts=batch.staged_dicts)
        assert (rmq is None) == (mq is None)
        rmq.limit = mq.limit = kw.get("limit") or 20
        rmqs.append(rmq)
        mqs.append(mq)
    return rmqs, mqs


def _members(Q):
    return {1: [REQS[0]], 3: [REQS[0], REQS[1], REQS[2]], 8: REQS}[Q]


@pytest.mark.parametrize("Q", [1, 3, 8])
def test_stack_queries_matches_reference(staged, Q):
    rmqs, mqs = _compile_both(staged, _members(Q))
    rcq, cq = ref_stack_queries(rmqs), stack_queries(mqs)
    for name in ("term_keys", "val_ranges", "term_active", "dur_lo",
                 "dur_hi", "win_start", "win_end"):
        want, got = np.asarray(getattr(rcq, name)), getattr(cq, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (cq.n_terms, cq.n_queries) == (rcq.n_terms, rcq.n_queries)
    assert cq.term_keys.shape[0] == {1: 1, 3: 4, 8: 8}[Q]
    if rcq.val_hits is None:
        assert cq.val_hits is None and cq.block_group is None
        return
    assert staged[4] == PROBE_MIN
    np.testing.assert_array_equal(cq.block_group, rcq.block_group)
    want = np.asarray(rcq.val_hits)                       # [Q, Gm, T, Vm]
    assert len(cq.val_hits) == want.shape[0]
    probed = 0
    for qi, h in enumerate(cq.val_hits):
        row = np.zeros(want.shape[1:], dtype=bool)
        if h is not None:
            probed += 1
            g, t, v = h.shape
            row[:g, :t, :v] = h.numpy()
        np.testing.assert_array_equal(row, want[qi], err_msg=f"query {qi}")
    if Q > 1:
        # probe members and host-compiled members in one stack
        assert 0 < probed < Q


def test_stack_queries_pads_and_clamps():
    """Pad queries match nothing (dur_lo 1 > dur_hi 0); extra terms of a
    real query are inactive; dur_hi and win_end clamp to uint32."""
    mk = port_multiblock.MultiQuery
    a = mk(term_keys=np.zeros((2, 1), np.int32),
           val_ranges=np.zeros((2, 1, 1, 2), np.int32), dur_lo=0,
           dur_hi=2**40, win_start=0, win_end=2**33, limit=20, n_terms=1)
    b = mk(term_keys=np.zeros((2, 3), np.int32),
           val_ranges=np.zeros((2, 3, 3, 2), np.int32), dur_lo=7,
           dur_hi=9, win_start=1, win_end=2, limit=20, n_terms=3)
    cq = stack_queries([a, b, a])
    assert cq.term_keys.shape == (4, 2, 4)
    assert cq.val_ranges.shape == (4, 2, 4, 4, 2)
    assert cq.term_active.tolist() == [[True, False, False, False],
                                       [True, True, True, False],
                                       [True, False, False, False],
                                       [False] * 4]
    assert cq.dur_lo.tolist() == [0, 7, 0, 1]
    assert cq.dur_hi.tolist() == [0xFFFFFFFF, 9, 0xFFFFFFFF, 0]
    assert cq.win_end.tolist() == [0xFFFFFFFF, 2, 0xFFFFFFFF, 0]
    with pytest.raises(ValueError):
        stack_queries([a, mk(term_keys=np.zeros((3, 1), np.int32),
                             val_ranges=np.zeros((3, 1, 1, 2), np.int32),
                             dur_lo=0, dur_hi=1, win_start=0, win_end=1,
                             limit=1, n_terms=1)])


def _port_arrays(batch):
    d = batch.device
    return (d["kv_key"], d["kv_val"], d["entry_start"], d["entry_end"],
            d["entry_dur"], d["entry_valid"], d["page_block"])


def _port_tables(cq):
    bounds = [torch.from_numpy(np.asarray(x, np.uint32).view(np.int32))
              for x in (cq.dur_lo, cq.dur_hi, cq.win_start, cq.win_end)]
    bg = (None if cq.block_group is None
          else torch.from_numpy(cq.block_group))
    return (torch.from_numpy(cq.term_keys), torch.from_numpy(cq.val_ranges),
            torch.from_numpy(cq.term_active), *bounds), cq.val_hits, bg


def _assert_topk_contract(got_s, got_i, want_s, want_i, what):
    """Equal score multisets, and equal index sets above the boundary
    score (ROADMAP.md item C)."""
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    np.testing.assert_array_equal(np.sort(got_s), np.sort(want_s),
                                  err_msg=what)
    if want_s.size:
        edge = want_s.min()
        assert set(got_i[got_s > edge].tolist()) \
            == set(want_i[want_s > edge].tolist()), what


def test_coalesced_function_matches_reference(staged):
    """coalesced_scan_plain then topk_rows_plain against the reference's
    coalesced_scan_kernel, Q = 8, on the same staged arrays."""
    ref_eng, rbatch, eng, batch, pm = staged
    rmqs, mqs = _compile_both(staged, REQS)
    rcq, cq = ref_stack_queries(rmqs), stack_queries(mqs)
    assert (cq.val_hits is not None) == (pm > 0)
    rd = rbatch.device
    for name, t in zip(("kv_key", "kv_val", "entry_start", "entry_end",
                        "entry_dur", "entry_valid", "page_block"),
                       _port_arrays(batch)):
        want = np.asarray(rd[name])
        got = t.numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=name)
    k = max(resolve_top_k(128, mq.limit) for mq in mqs)
    counts, inspected, scores, idx = coalesced_scan_kernel(
        rd["kv_key"], rd["kv_val"], rd["entry_start"], rd["entry_end"],
        rd["entry_dur"], rd["entry_valid"], rd["page_block"],
        jnp.asarray(rcq.term_keys), jnp.asarray(rcq.val_ranges),
        jnp.asarray(rcq.term_active), jnp.asarray(rcq.dur_lo),
        jnp.asarray(rcq.dur_hi), jnp.asarray(rcq.win_start),
        jnp.asarray(rcq.win_end), rcq.val_hits,
        None if rcq.block_group is None else jnp.asarray(rcq.block_group),
        n_terms=rcq.n_terms, top_k=k)
    tables, vh, bg = _port_tables(cq)
    s, c, ins = coalesced_scan_plain(*_port_arrays(batch), *tables, vh, bg)
    ts, ti = topk_rows_plain(s, k)
    assert int(ins) == int(inspected)
    assert c.tolist() == np.asarray(counts).tolist()
    assert sum(c.tolist()) > 0
    for q in range(cq.n_queries):
        _assert_topk_contract(ts[q].numpy(), ti[q].numpy(), scores[q],
                              idx[q], f"query {q}")


U32 = 0xFFFFFFFF


def _synthetic(seed, *, P, C, B, Q, T, R, V, dup=False, p_active=0.7,
               all_pad=False):
    """Staged arrays and stacked tables from a seed, with pad pages, -1
    keys, inactive terms, a pad query, uint32 edge columns and bounds,
    and, per query, a hit table of one width V (so the reference's
    stacking pads nothing) or none. With `dup`, every odd query repeats
    the query before it (its terms, tables and hit rows); with
    `all_pad`, every query is a pad query; `p_active` is the share of
    active terms."""
    rng = np.random.default_rng(seed)
    n_keys = 5
    kv_key = rng.integers(-1, n_keys, size=(P, E, C)).astype(np.int8)
    kv_val = rng.integers(-1, V + 3, size=(P, E, C)).astype(np.int16)
    kv_val[kv_key < 0] = -1
    start = rng.integers(2**31 - 40, 2**31 + 40, size=(P, E)) \
        .astype(np.uint32)
    end = (start.astype(np.int64) + rng.integers(0, 30, size=(P, E)))
    end = np.minimum(end, U32).astype(np.uint32)
    dur = rng.integers(0, 60_000, size=(P, E)).astype(np.uint32)
    dur[0, :4] = [U32, 2**31, 2**31 - 1, 0]
    valid = rng.random((P, E)) < 0.9
    page_block = rng.integers(0, B, size=P).astype(np.int32)
    page_block[-1] = -1
    term_keys = rng.integers(0, n_keys, size=(Q, B, T)).astype(np.int32)
    term_keys[rng.random((Q, B, T)) < 0.15] = -1
    lo = rng.integers(0, V, size=(Q, B, T, R))
    hi = lo + rng.integers(0, V // 2, size=(Q, B, T, R))
    val_ranges = np.stack([lo, hi], axis=-1).astype(np.int32)
    val_ranges[rng.random((Q, B, T, R)) < 0.3] = (1, 0)
    term_active = rng.random((Q, T)) < p_active
    term_active[:, 0] = True
    term_active[Q - 2] = False          # a query with no active term
    dur_lo = rng.integers(0, 20_000, size=Q).astype(np.uint32)
    dur_hi = np.full(Q, U32, dtype=np.uint32)
    dur_hi[0] = 2**31 + 5
    dur_hi[1] = 40_000
    win_start = np.zeros(Q, dtype=np.uint32)
    win_start[2] = 2**31
    win_end = np.full(Q, U32, dtype=np.uint32)
    win_end[3] = 2**31 + 10
    dur_lo[Q - 1], dur_hi[Q - 1] = 1, 0  # a pad query
    G = 2
    hits = rng.random((Q, G, T, V)) < 0.3
    block_group = rng.integers(-1, G, size=(Q, B)).astype(np.int32)
    block_group[0] = -1                 # a host-compiled member
    if dup:
        for a in (term_keys, val_ranges, term_active, hits, block_group):
            a[1::2] = a[0:Q - 1:2]
    if all_pad:
        dur_lo[:], dur_hi[:] = 1, 0
    return dict(kv_key=kv_key, kv_val=kv_val, entry_start=start,
                entry_end=end, entry_dur=dur, entry_valid=valid,
                page_block=page_block, term_keys=term_keys,
                val_ranges=val_ranges, term_active=term_active,
                dur_lo=dur_lo, dur_hi=dur_hi, win_start=win_start,
                win_end=win_end, hits=hits, block_group=block_group)


@pytest.mark.parametrize("hit_mode", [False, True], ids=["ranges", "hits"])
@pytest.mark.parametrize("seed,shape", [
    (1, dict(P=4, C=4, B=2, Q=4, T=2, R=2, V=90)),
    (2, dict(P=8, C=8, B=3, Q=8, T=4, R=4, V=200)),
    (3, dict(P=6, C=20, B=4, Q=4, T=1, R=1, V=60)),
    (4, dict(P=3, C=9, B=2, Q=64, T=1, R=2, V=50)),
    (5, dict(P=3, C=10, B=3, Q=32, T=4, R=2, V=70)),
    (6, dict(P=4, C=8, B=2, Q=8, T=2, R=2, V=40, dup=True)),
    (7, dict(P=4, C=6, B=3, Q=8, T=4, R=2, V=40, p_active=0.3)),
    (8, dict(P=3, C=5, B=2, Q=4, T=2, R=2, V=40, all_pad=True)),
], ids=["q4", "q8", "c20", "q64", "qt128", "dup", "inactive", "all_pad"])
def test_coalesced_function_on_synthetic_edges(seed, shape, hit_mode):
    """K4's plain version and K2r's against the reference on seeded
    arrays with the edges real corpora rarely hold: ids past the hit
    table (they clamp to its last entry) and below 0, starts around 2^31,
    C = 20; Q = 64, Q x T = 128 (two chunks of distinct terms), members
    with identical terms, mostly inactive terms, a dispatch of pad
    queries only; in hit mode, probed and range rows in one dispatch.
    K4's own rule in PyTorch (``coalesced_scan_keyfirst`` over
    ``k4_terms``) equals both, and each block's reduction holds one
    term per distinct (key, test) of its active pairs."""
    c = _synthetic(seed, **shape)
    Q = shape["Q"]
    page = [c[n] for n in ("kv_key", "kv_val", "entry_start", "entry_end",
                           "entry_dur", "entry_valid", "page_block")]
    tabs = [c[n] for n in ("term_keys", "val_ranges", "term_active",
                           "dur_lo", "dur_hi", "win_start", "win_end")]
    ref_hits = ref_bg = vh = bg = None
    if hit_mode:
        ref_hits = jnp.asarray(c["hits"])
        ref_bg = jnp.asarray(c["block_group"])
        vh = [None if (c["block_group"][q] < 0).all()
              else torch.from_numpy(c["hits"][q]) for q in range(Q)]
        if shape.get("dup"):        # a repeated member shares its tables
            vh[1::2] = vh[0:Q - 1:2]
        vh = tuple(vh)
        bg = torch.from_numpy(c["block_group"])
    k = 64
    counts, inspected, scores, idx = coalesced_scan_kernel(
        *[jnp.asarray(a) for a in page], *[jnp.asarray(a) for a in tabs],
        ref_hits, ref_bg, n_terms=shape["T"], top_k=k)

    def t(a):
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(a))

    args = [t(a) for a in page + tabs]
    s, cnt, ins = coalesced_scan_plain(*args, vh, bg)
    ts, ti = topk_rows_plain(s, k)
    assert int(ins) == int(inspected)
    assert cnt.tolist() == np.asarray(counts).tolist()
    assert cnt[Q - 1] == 0 and (s[Q - 1] == -1).all()
    for q in range(Q):
        _assert_topk_contract(ts[q].numpy(), ti[q].numpy(), scores[q],
                              idx[q], f"query {q}")
    s2, cnt2, ins2 = scan_k.coalesced_scan_keyfirst(*args, vh, bg)
    assert torch.equal(s2, s) and torch.equal(cnt2, cnt)
    assert int(ins2) == int(ins)
    _assert_k4_terms(args[7:12], vh, bg, shape)


def _assert_k4_terms(tabs, vh, bg, shape):
    """k4_terms per block: one term per distinct (key, test) of the
    active pairs, grouped by key into segments of one chunk each, and
    need masks naming, per query, exactly its active terms."""
    term_keys, val_ranges, term_active, dur_lo, dur_hi = tabs
    Q, B, T = term_keys.shape
    for b in range(B):
        tab = scan_k.k4_terms(term_keys, val_ranges, term_active, dur_lo,
                              dur_hi, b, vh, bg)
        terms, need = tab["terms"], tab["need"]
        sigs = [(u["key"], None if u["ranges"] is None
                 else tuple(u["ranges"].flatten().tolist()),
                 None if u["row"] is None else u["row"].data_ptr())
                for u in terms]
        assert len(set(sigs)) == len(sigs)
        live_q = [q for q in range(Q) if tab["queries"] >> q & 1]
        active = [(q, t) for q in live_q for t in range(T)
                  if term_active[q, t]]
        assert len(terms) <= len(active)
        assert len(need) == -(-len(terms) // 64)
        keys = [u["key"] for u in terms]
        assert {int(term_keys[q, b, t]) for q, t in active} == set(keys)
        for key, beg, mid, end in tab["segments"]:
            assert beg // 64 == (end - 1) // 64 and beg <= mid <= end
            assert all(kk == key for kk in keys[beg:end])
            assert all((u["row"] is None) == (p >= mid)
                       for p, u in enumerate(terms[beg:end], beg))
        for q in range(Q):
            bits = sum(bin(m[q]).count("1") for m in need)
            n_act = sum(1 for qq, _t in active if qq == q)
            assert (bits == 0) == (n_act == 0) and bits <= n_act
        if shape.get("dup"):
            for q in range(1, Q, 2):
                assert all(m[q] == m[q - 1] for m in need)
        if shape.get("all_pad"):
            assert not terms and tab["queries"] == 0


@pytest.mark.parametrize("n,k", [(1, 1), (50, 7), (50, 64), (300, 128)])
def test_topk_rows_plain_is_topk_per_row(n, k):
    """K2r's function row by row is K2's, ties and k > N included, and its
    scores are torch.topk's."""
    rng = np.random.default_rng(n * 1000 + k)
    s = torch.from_numpy(rng.integers(-1, 6, size=(5, n)).astype(np.int32))
    rs, ri = topk_rows_plain(s, k)
    assert rs.shape == ri.shape == (5, min(k, n))
    for q in range(5):
        ws, wi = topk_plain(s[q], k)
        assert torch.equal(rs[q], ws) and torch.equal(ri[q], wi)
        assert torch.equal(rs[q], torch.topk(s[q], min(k, n)).values)


def test_topk_rows_plain_matches_reference_vmap():
    import jax

    rng = np.random.default_rng(7)
    s = rng.integers(-1, 40, size=(4, 1000)).astype(np.int32)
    mask = jnp.asarray(s >= 0)
    start = jnp.asarray(np.maximum(s, 0).astype(np.uint32))
    want_s, want_i = jax.vmap(lambda m, st: ref_masked_topk(m, st, 128))(
        mask, start)
    got_s, got_i = topk_rows_plain(torch.from_numpy(s), 128)
    for q in range(4):
        _assert_topk_contract(got_s[q].numpy(), got_i[q].numpy(),
                              want_s[q], want_i[q], f"row {q}")


@pytest.mark.parametrize("Q", [2, 3, 8])
def test_fused_dispatch_equals_solo_dispatches(staged, Q):
    """The port's fused dispatch gives each member exactly what a solo
    dispatch (K1 + K2) gives it: count, inspected, scores and indices,
    truncated to the member's k."""
    _ref_eng, _rbatch, eng, batch, _pm = staged
    _rmqs, mqs = _compile_both(staged, REQS[:Q])
    solo = [eng.scan(batch, mq) for mq in mqs]
    k = max(resolve_top_k(eng.top_k, mq.limit) for mq in mqs)
    counts, inspected, scores, idx = fetch_coalesced_out(
        eng.coalesced_scan_async(batch, stack_queries(mqs), k))
    assert scores.shape == (port_multiblock._pow2(Q), k)
    for qi, (c, ins, s, i) in enumerate(solo):
        assert (int(counts[qi]), inspected) == (c, ins)
        kq = s.shape[0]
        np.testing.assert_array_equal(scores[qi][:kq], s)
        np.testing.assert_array_equal(idx[qi][:kq], i)


# ---------------------------------------------------------------------------
# the coalescer


@pytest.fixture
def small(blocks):
    """A port engine and one staged batch of two blocks."""
    _rp, pp = blocks
    eng = MultiBlockEngine(CPU)
    return eng, eng.place(eng.stage_host(pp[:2])), pp[:2]


def _mq(eng, batch, tags, limit=20):
    return compile_multi(list(batch.blocks), _port_req(tags, {"limit": limit}),
                         memo=batch.memo, cache=eng.compile_cache,
                         staged_dicts=batch.staged_dicts)


def _host(out):
    """A coalescer future's value as host (count, inspected, scores,
    idx)."""
    if isinstance(out, tuple):
        return fetch_scan_out(out)
    return tuple(out)


def _assert_same_out(got, want):
    count, inspected, scores, idx = got
    assert (count, inspected) == (want[0], want[1])
    kq = want[2].shape[0]
    np.testing.assert_array_equal(np.asarray(scores)[:kq], want[2])
    np.testing.assert_array_equal(np.asarray(idx)[:kq], want[3])


def test_window_timeout_flushes_without_peers(small):
    eng, batch, _pp = small
    co = QueryCoalescer(eng, window_s=0.15, max_queries=4,
                        active_fn=lambda: 2)
    try:
        mq = _mq(eng, batch, {"service.name": "svc-1"})
        want = eng.scan(batch, mq)
        t0 = time.perf_counter()
        fut = co.submit(batch, mq, resolve_top_k(eng.top_k, mq.limit))
        assert not fut.done(), "the window should park the query"
        assert co.stats()["pending"] == 1
        out = fut.result(timeout=WAIT_S)
        waited = time.perf_counter() - t0
        assert waited >= 0.10, f"flushed after {waited * 1e3:.1f} ms"
        _assert_same_out(_host(out), want)
        assert co.stats()["pending"] == 0
        assert (co.dispatches, co.fused) == (1, 0)
    finally:
        co.close()


def test_max_queries_triggers_immediate_fused_flush(small):
    eng, batch, _pp = small
    co = QueryCoalescer(eng, window_s=60.0, max_queries=2,
                        active_fn=lambda: 2)
    try:
        mq1 = _mq(eng, batch, {"service.name": "svc-1"})
        mq2 = _mq(eng, batch, {"service.name": "svc-02"}, limit=300)
        want1, want2 = eng.scan(batch, mq1), eng.scan(batch, mq2)
        f1 = co.submit(batch, mq1, resolve_top_k(eng.top_k, mq1.limit))
        f2 = co.submit(batch, mq2, resolve_top_k(eng.top_k, mq2.limit))
        assert f1.done() and f2.done(), "a full group must not wait"
        _assert_same_out(_host(f1.result(timeout=WAIT_S)), want1)
        _assert_same_out(_host(f2.result(timeout=WAIT_S)), want2)
        st = co.stats()
        assert (st["fused_dispatches"], st["queries"], st["ratio"]) \
            == (1, 2, 2.0)
    finally:
        co.close()


def test_solo_search_skips_window_entirely(small):
    eng, batch, _pp = small
    co = QueryCoalescer(eng, window_s=60.0, max_queries=8,
                        active_fn=lambda: 1)
    try:
        mq = _mq(eng, batch, {"service.name": "svc-1"})
        fut = co.submit(batch, mq, resolve_top_k(eng.top_k, mq.limit))
        assert fut.done(), "a solo submit must flush inline"
        assert (co.fused, co.dispatches) == (0, 1)
    finally:
        co.close()


def test_peers_hint_overrides_process_global_activity(small):
    eng, batch, _pp = small
    co = QueryCoalescer(eng, window_s=60.0, max_queries=8,
                        active_fn=lambda: 99)
    try:
        mq = _mq(eng, batch, {"service.name": "svc-1"})
        fut = co.submit(batch, mq, resolve_top_k(eng.top_k, mq.limit),
                        peers=1)
        assert fut.done(), "peers=1 must flush inline"
        assert (co.fused, co.dispatches) == (0, 1)
    finally:
        co.close()


def test_fused_flush_fault_fails_every_member(small, monkeypatch):
    eng, batch, _pp = small
    co = QueryCoalescer(eng, window_s=60.0, max_queries=2,
                        active_fn=lambda: 2)

    def boom(*a, **k):
        raise RuntimeError("K4 launch failed")

    monkeypatch.setattr(port_multiblock, "coalesced_scan", boom)
    try:
        f1 = co.submit(batch, _mq(eng, batch, {"service.name": "svc-1"}),
                       128)
        f2 = co.submit(batch, _mq(eng, batch, {"region": "west"}), 128)
        for f in (f1, f2):
            with pytest.raises(RuntimeError, match="K4 launch failed"):
                f.result(timeout=WAIT_S)
    finally:
        co.close()


def test_close_flushes_parked_queries(small):
    eng, batch, _pp = small
    co = QueryCoalescer(eng, window_s=60.0, max_queries=8,
                        active_fn=lambda: 2)
    mq = _mq(eng, batch, {"service.name": "svc-1"})
    fut = co.submit(batch, mq, 128)
    assert not fut.done()
    co.close()
    _assert_same_out(_host(fut.result(timeout=WAIT_S)), eng.scan(batch, mq))
    assert not co._sched.is_alive()
    with pytest.raises(RuntimeError):
        co.submit(batch, mq, 128)


def _jobs(pages):
    return [ScanJob(key=(f"blk-{i:03d}", 0, p.n_pages),
                    pages_fn=(lambda p=p: p), header=dict(p.header),
                    n_pages=p.n_pages, n_entries=p.n_entries,
                    geometry=(p.header["entries_per_page"],
                              p.header["kv_per_entry"]))
            for i, p in enumerate(pages)]


def _run_threads(fns):
    """Run the callables on barrier-started threads; returns their
    results. A thread that does not finish in time fails the test."""
    out = [None] * len(fns)
    errs = []
    barrier = threading.Barrier(len(fns))

    def one(i):
        try:
            barrier.wait(timeout=WAIT_S)
            out[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 -- reported below
            errs.append(e)

    ts = [threading.Thread(target=one, args=(i,), daemon=True)
          for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=WAIT_S)
        assert not t.is_alive(), "a search thread did not finish"
    if errs:
        raise errs[0]
    return out


def test_disjoint_concurrent_searches_skip_window(blocks):
    """Two concurrent searches over disjoint batches can never fuse, so
    neither may wait out the window."""
    _rp, pp = blocks
    jobs = _jobs(pp[:4])
    half_a, half_b = jobs[:2], jobs[2:]
    req = _port_req({"service.name": "svc-1"}, {"limit": 20})
    b = BlockBatcher(CPU, max_batch_pages=8, coalesce_window_s=0.6,
                     coalesce_max_queries=8)
    try:
        b.search(list(half_a), req)
        b.search(list(half_b), req)
        best = float("inf")
        for _ in range(3):   # tolerate one lost plan-timing race
            def timed(js):
                t0 = time.perf_counter()
                b.search(list(js), req)
                return time.perf_counter() - t0

            done = _run_threads([lambda: timed(half_a),
                                 lambda: timed(half_b)])
            best = min(best, max(done))
        assert best < 0.5, f"disjoint searches waited {best:.3f} s"
    finally:
        b.close()


def test_device_tables_cached_after_deferred_window_flush(blocks):
    """The uploaded query tables reach the per-predicate memo even when
    the dispatch ran on the window's flush thread after submit
    returned."""
    _rp, pp = blocks
    jobs = _jobs(pp[:2])
    b = BlockBatcher(CPU, coalesce_window_s=0.05, coalesce_max_queries=8)
    try:
        b.search(list(jobs), _port_req({"service.name": "svc-1"}, {}))
        req = _port_req({"service.name": "svc-02"}, {})
        with b._lock:     # a phantom peer on every staged batch
            gkeys = list(b._cache)
            for k in gkeys:
                b._interest[k] = b._interest.get(k, 0) + 1
        try:
            b.search(list(jobs), req)
        finally:
            with b._lock:
                for k in gkeys:
                    b._release_locked(k)
        assert b.coalescer.stats()["dispatches"] >= 2
        sig = _predicate_sig(req)
        memos = [c.query_cache[sig].get("device_tables")
                 for c in b._cache.values() if sig in c.query_cache]
        assert memos and all(m is not None for m in memos)
    finally:
        b.close()


# ---------------------------------------------------------------------------
# concurrent serving end to end


def _traces(resp) -> list:
    return [(t.trace_id, t.start_time_unix_nano, t.duration_ms,
             t.root_service_name, t.root_trace_name) for t in resp.traces]


def _metrics(m) -> tuple:
    return (m.inspected_traces, m.inspected_blocks, m.skipped_blocks,
            m.inspected_bytes, m.truncated_entries)


CONCURRENT = [
    ({"session.id": "77"}, {"limit": 20}),
    ({"service.name": "svc-0"}, {"limit": 20}),
    ({"http.status_code": "500"}, {"limit": 15}),
    ({"region": "east", "host.name": "host-3"}, {"limit": 20}),
    ({}, {"min_duration_ms": 20_000, "limit": 20}),
    ({"session.id": "session-00001", "x-dbg-exhaustive": ""},
     {"limit": 20}),
]


@pytest.fixture(scope="module", params=[PROBE_MIN, 0], ids=["hits", "ranges"])
def serving(request, corpus, tmp_path_factory):
    """The reference TempoDB, a port TempoDB with coalescing off and one
    with a 50 ms window and max_queries = 6, each with every group staged
    by an exhaustive request."""
    pm = request.param
    wal = tmp_path_factory.mktemp("torch_coalesce_wal")
    ref = RefTempoDB(
        RefLocalBackend(str(corpus / "blocks")), str(wal),
        RefTempoDBConfig(search_max_batch_pages=MAX_PAGES, auto_mesh=False,
                         host_state_dir="", search_device_probe_min_vals=pm,
                         search_coalesce_max_queries=1))

    def port(**kw):
        return TempoDB(LocalBackend(str(corpus / "blocks")),
                       TempoDBConfig(search_max_batch_pages=MAX_PAGES,
                                     search_device_probe_min_vals=pm, **kw),
                       device="cpu")

    serial = port(search_coalesce_max_queries=1)
    co = port(search_coalesce_window_s=0.05,
              search_coalesce_max_queries=len(CONCURRENT))
    stage = ({"x-dbg-exhaustive": ""}, {"limit": 5})
    for db in (ref, serial, co):
        db.poll()
    ref.search(TENANT, _ref_req(*stage))
    for db in (serial, co):
        db.search(TENANT, _port_req(*stage))
    yield ref, serial, co
    serial.close()
    co.close()


def test_default_config_coalesces():
    cfg = TempoDBConfig()
    assert (cfg.search_coalesce_window_s,
            cfg.search_coalesce_max_queries) == (0.003, 8)


def test_concurrent_searches_equal_serial_and_reference(serving):
    ref, serial, co = serving
    assert serial.batcher.coalescer is None
    want = [serial.search(TENANT, _port_req(t, kw)).response()
            for t, kw in CONCURRENT]
    for (t, kw), w in zip(CONCURRENT, want):
        r = ref.search(TENANT, _ref_req(t, kw)).response()
        assert _traces(w) == _traces(r)
        assert _metrics(w.metrics) == _metrics(r.metrics)
    before = co.batcher.coalescer.stats()
    got = _run_threads([
        (lambda t=t, kw=kw: co.search(TENANT, _port_req(t, kw)).response())
        for t, kw in CONCURRENT])
    for g, w in zip(got, want):
        assert _traces(g) == _traces(w)
        assert _metrics(g.metrics) == _metrics(w.metrics)
    st = co.batcher.debug_stats()["coalesce"]
    assert st["fused_dispatches"] > before["fused_dispatches"]
    assert st["pending"] == 0
    assert co.batcher.debug_stats()["peers"] == {"interest": {},
                                                 "unplanned": 0}


# ---------------------------------------------------------------------------
# peer counters


def _assert_no_peers(db):
    b = db.batcher
    assert b._interest == {} and b._unplanned == 0


def _assert_solo_arms_no_window(db):
    co = db.batcher.coalescer
    t0 = time.perf_counter()
    db.search(TENANT, _port_req({"service.name": "svc-03"}, {"limit": 20}))
    assert time.perf_counter() - t0 < co.window_s / 2
    assert co._deadlines == [] and co.stats()["pending"] == 0


@pytest.fixture
def slow_window_db(corpus):
    db = TempoDB(LocalBackend(str(corpus / "blocks")),
                 TempoDBConfig(search_max_batch_pages=MAX_PAGES,
                               search_device_probe_min_vals=PROBE_MIN,
                               search_coalesce_window_s=2.0),
                 device="cpu")
    db.poll()
    db.search(TENANT, _port_req({"x-dbg-exhaustive": ""}, {"limit": 5}))
    yield db
    db.close()


def test_no_peer_counter_leaks_after_early_quit(slow_window_db):
    db = slow_window_db
    n_groups = len(db.batcher._cache)
    assert n_groups > 1
    db.search(TENANT, _port_req({}, {"limit": 1}))
    assert db.batcher.last_dispatches < n_groups   # it quit early
    _assert_no_peers(db)
    _assert_solo_arms_no_window(db)


def test_no_peer_counter_leaks_after_a_dispatch_raises(slow_window_db,
                                                       monkeypatch):
    db = slow_window_db

    def boom(*a, **k):
        raise RuntimeError("K1 launch failed")

    with monkeypatch.context() as mp:
        mp.setattr(port_multiblock, "multi_scan", boom)
        with pytest.raises(RuntimeError, match="K1 launch failed"):
            db.search(TENANT, _port_req({"service.name": "svc-04"},
                                        {"limit": 20}))
    _assert_no_peers(db)
    _assert_solo_arms_no_window(db)


def test_early_quit_withdraws_its_parked_query(slow_window_db,
                                               monkeypatch):
    """A search that quits early takes its still-parked query out of the
    coalescer: with a 2 s window and two dispatches in flight, the first
    group's query flushes at once (no peer), the second's parks (a peer
    is claimed), and the first answer completes the request. Right after
    ``search`` returns nothing is pending, no window is armed, and no
    dispatch runs once the window has passed."""
    db = slow_window_db
    co = db.batcher.coalescer
    assert db.batcher.pipeline_depth > 1
    assert len(db.batcher._cache) > 1
    real = co.submit
    submits = []

    def submit(batch, mq, top_k, peers=None):
        submits.append(batch)
        return real(batch, mq, top_k, peers=1 if len(submits) == 1 else 2)

    monkeypatch.setattr(co, "submit", submit)
    before = co.stats()["dispatches"]
    t0 = time.perf_counter()
    db.search(TENANT, _port_req({}, {"limit": 1}))
    assert time.perf_counter() - t0 < co.window_s / 2
    assert len(submits) == 2                     # the second one parked
    st = co.stats()
    assert st["pending"] == 0 and co._deadlines == []
    assert st["dispatches"] == before + 1
    time.sleep(co.window_s + 0.3)
    assert co.stats()["dispatches"] == before + 1
    _assert_no_peers(db)


def test_wrappers_count_no_launch_on_the_cpu(staged):
    """On CPU tensors K4 and K2r take their plain versions and count no
    launch."""
    from tempo_tpu_torch.search.kernels import topk as topk_k

    _ref_eng, _rbatch, eng, batch, _pm = staged
    counters = (scan_k.COALESCED_LAUNCHES, scan_k.COALESCED_HIT_LAUNCHES,
                topk_k.ROW_LAUNCHES)
    for c in counters:
        c.reset()
    _rmqs, mqs = _compile_both(staged, REQS[:3])
    out = fetch_coalesced_out(eng.coalesced_scan_async(
        batch, stack_queries(mqs), 128))
    assert out[2].shape == (4, 128)
    assert [c.n for c in counters] == [0, 0, 0]


def test_future_results_type(small):
    """A solo flush resolves to scan_async's device outputs, a fused one
    to a member's slice of the shared host fetch."""
    eng, batch, _pp = small
    co = QueryCoalescer(eng, window_s=60.0, max_queries=2,
                        active_fn=lambda: 2)
    try:
        mq = _mq(eng, batch, {"service.name": "svc-1"})
        solo = co.submit(batch, mq, 128, peers=1).result(timeout=WAIT_S)
        assert isinstance(solo, tuple) and len(solo) == 3
        f1 = co.submit(batch, mq, 128)
        f2 = co.submit(batch, mq, 128)
        a = concurrent.futures.wait([f1, f2], timeout=WAIT_S)
        assert not a.not_done
        h1, h2 = _host(f1.result()), _host(f2.result())
        _assert_same_out(h1, fetch_scan_out(solo))
        _assert_same_out(h2, fetch_scan_out(solo))
    finally:
        co.close()


def test_id_past_a_members_table_clamps_to_its_own_last_entry():
    """Each query reads its own hit table, so an id past it clamps to that
    table's last entry, as K1 does. The reference pads the members'
    tables with False to the widest and reads False there (ROADMAP.md
    item C); real ids stay below their dictionary's size."""
    kv_key = torch.zeros((1, E, 1), dtype=torch.int8)
    kv_val = torch.full((1, E, 1), 6, dtype=torch.int16)   # past V = 4
    cols = (torch.arange(E, dtype=torch.int32).reshape(1, E),) * 2 + (
        torch.zeros((1, E), dtype=torch.int32),
        torch.ones((1, E), dtype=torch.bool),
        torch.zeros(1, dtype=torch.int32))
    narrow = torch.tensor([[[False, False, False, True]]])    # [1, 1, 4]
    wide = torch.zeros((1, 1, 8), dtype=torch.bool)
    zero = torch.zeros(2, dtype=torch.int32)
    u32 = torch.full((2,), -1, dtype=torch.int32)
    _s, counts, _ins = coalesced_scan_plain(
        kv_key, kv_val, *cols, torch.zeros((2, 1, 1), dtype=torch.int32),
        torch.tensor([[[[[1, 0]]]]] * 2, dtype=torch.int32).reshape(
            2, 1, 1, 1, 2), torch.ones((2, 1), dtype=torch.bool), zero, u32,
        zero, u32, (narrow, wide), torch.zeros((2, 1), dtype=torch.int32))
    assert counts.tolist() == [E, 0]


def test_stack_queries_refuses_structural_and_agg_members():
    """A group mixing structural and plain members is refused. Agg
    members are served now: the group shares the batch's stage, as the
    reference's stack_queries does."""
    mq = port_multiblock.MultiQuery(
        term_keys=np.zeros((1, 1), np.int32),
        val_ranges=np.zeros((1, 1, 1, 2), np.int32), dur_lo=0, dur_hi=1,
        win_start=0, win_end=1, limit=1, n_terms=1)
    assert stack_queries([mq, mq]).agg_stage is None
    bad = port_multiblock.MultiQuery(**vars(mq))
    bad.structural = object()
    with pytest.raises(ValueError):
        stack_queries([mq, bad])
    stage = object()
    agg = port_multiblock.MultiQuery(**vars(mq))
    agg.agg_stage = stage
    assert stack_queries([agg, agg]).agg_stage is stage
    assert stack_queries([mq, agg]).agg_stage is stage
