"""The port's structural query engine against the reference's.

Same seeds, same inputs, exact equality throughout:

- the IR (``search/ir.py``): canonical JSON of a seeded fuzz set, and the
  error paths;
- span rows: the search-data codec, the container's span segment (bytes
  both ways, ``slice_pages``, ``from_arrays``), ``stack_spans``, and the
  tables ``compile_structural`` builds, host and device-probe routes;
- kernel K6's plain version (``kernels.structural``) against the
  reference's ``structural_entry_mask`` run through ``jax.jit`` on the
  CPU, on the same staged arrays and tables: exact plans (the
  reference's ``_trace_mask``) and shape-bucketed groups (its
  ``_bucket_trace_mask``), unpacked and packed, ranges and hit masks
  (bool and words), with a span-less block in the batch, parent cycles
  and self-parents, and unsigned edges;
- end to end: ``TempoDB.search``, ``search_block`` and
  ``BackendSearchBlock.search`` on both packages over one LocalBackend
  directory the reference wrote, five fixed plans and a seeded fuzz of
  120 more: counts, inspected, trace sets and metrics equal;
- the gate: off, every entry point refuses the tag; two databases with
  different gates in one process.

The reference's gates are process-wide; an autouse fixture puts them
back after every test.
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu import tempopb
from tempo_tpu.backend.local import LocalBackend as RefLocalBackend
from tempo_tpu.backend.types import BlockMeta as RefBlockMeta
from tempo_tpu.db import TempoDB as RefTempoDB
from tempo_tpu.db import TempoDBConfig as RefTempoDBConfig
from tempo_tpu.search import data as ref_data
from tempo_tpu.search import ir as ref_ir
from tempo_tpu.search import packing as ref_packing
from tempo_tpu.search import pipeline as ref_pipeline
from tempo_tpu.search import structural as ref_structural
from tempo_tpu.search.backend_search_block import \
    BackendSearchBlock as RefBackendSearchBlock
from tempo_tpu.search.backend_search_block import \
    write_search_block as ref_write_search_block
from tempo_tpu.search.columnar import ColumnarPages as RefPages
from tempo_tpu.search.columnar import PageGeometry as RefGeometry
from tempo_tpu.search.multiblock import MultiBlockEngine as RefEngine

from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.model.types import (BlockSearchJob, SearchBlockRequest,
                                         SearchBlocksRequest, SearchRequest)
from tempo_tpu_torch.search import data, ir, structural
from tempo_tpu_torch.search.backend_search_block import BackendSearchBlock
from tempo_tpu_torch.search.columnar import ColumnarPages, PageGeometry
from tempo_tpu_torch.search.kernels import structural as k6
from tempo_tpu_torch.search.multiblock import (MultiBlockEngine, place_batch,
                                               place_spans)

TENANT = "t1"
GEO = (16, 4)            # entries per page, kv slot cap
PROBE_MIN = 64           # dictionaries this large probe on the "device"
BASE_S = 1_600_000_000
SVCS = ["api", "db", "auth", "cache", "web"]
OPS = ["op0", "op1", "op2"]
CPU = torch.device("cpu")
_ref_mask = jax.jit(ref_structural.structural_entry_mask,
                    static_argnames=("plan", "widths"))


@pytest.fixture(autouse=True)
def _reference_gates():
    """The reference's structural and packing gates are process-wide:
    each test starts with structural on and leaves both as it found
    them."""
    g = ref_structural.STRUCTURAL
    prev = (g.enabled, g.stack_enabled, g.bucket_enabled,
            g.bucket_max_nodes, ref_packing.PACKING.enabled)
    g.enabled = True
    ref_pipeline._COMPILE_CACHE.clear()
    yield
    (g.enabled, g.stack_enabled, g.bucket_enabled, g.bucket_max_nodes,
     ref_packing.PACKING.enabled) = prev
    ref_pipeline._COMPILE_CACHE.clear()


# ---------------------------------------------------------------------------
# inputs, made from a seed for either package


def entries(seed: int, n: int, mod, max_spans: int = 9, urls: int = 0,
            loops: bool = False, long_every: int = 0) -> list:
    """`n` traces as `mod.SearchData` with span rows (`mod`: either
    package's data module). Parents point at earlier spans, or none.
    `urls`: spans also carry one of that many http.url values (a larger
    dictionary). `loops`: some traces get a self-parent and a two-span
    parent cycle, and a span of ~4e9 ms. `long_every`: one trace in that
    many lasts 70,000-3,000,000,000 ms (bucketed packed durations)."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        sd = mod.SearchData(trace_id=(seed * 100_000 + i).to_bytes(16, "big"))
        sd.start_s = BASE_S + i
        sd.end_s = sd.start_s + rng.randint(0, 10)
        sd.dur_ms = rng.randint(1, 5000)
        if long_every and i % long_every == 0:
            sd.dur_ms = rng.randint(70_000, 3_000_000_000)
        sd.root_service = rng.choice(SVCS)
        sd.kvs = {"service.name": {sd.root_service},
                  "env": {"prod" if i % 2 else "dev"}}
        for _ in range(rng.randint(0, max_spans)):
            s = len(sd.spans)
            kvs = {"service.name": {rng.choice(SVCS)},
                   "name": {rng.choice(OPS)}}
            if urls:
                kvs["http.url"] = {f"/u/{rng.randrange(urls)}"}
            sd.spans.append(mod.SpanData(
                parent=(-1 if s == 0 or rng.random() < 0.2
                        else rng.randrange(s)),
                dur_ms=rng.randint(1, 1000), kind=rng.randint(0, 5),
                kvs=kvs))
        if loops and len(sd.spans) >= 3 and i % 3 == 0:
            sd.spans[0].parent = 0                  # its own parent
            sd.spans[1].parent, sd.spans[2].parent = 2, 1   # A -> B -> A
            sd.spans[-1].dur_ms = 4_000_000_000
        out.append(sd)
    return out


def spanless(n: int, mod, first: int = 90_000) -> list:
    return [mod.SearchData(trace_id=(first + i).to_bytes(16, "big"),
                           start_s=BASE_S + i, end_s=BASE_S + i + 1,
                           dur_ms=100, kvs={"env": {"prod"}})
            for i in range(n)]


def rand_span(rng: random.Random, depth: int):
    choices = ["tag", "dur", "kind"]
    if depth > 0:
        choices += ["and", "or", "not", "child", "desc"]
    op = rng.choice(choices)
    if op == "tag":
        return ir.SpanTag(rng.choice(["service.name", "name", "nope",
                                      "http.url"]),
                          rng.choice(["a", "p", "op", "db", "", "/u/1"]))
    if op == "dur":
        lo = rng.randint(0, 800)
        return ir.SpanDur(lo, lo + rng.randint(0, 800))
    if op == "kind":
        return ir.SpanKind(rng.randint(0, 5))
    if op in ("and", "or"):
        args = tuple(rand_span(rng, depth - 1)
                     for _ in range(rng.randint(1, 3)))
        return ir.SpanAnd(args) if op == "and" else ir.SpanOr(args)
    if op == "not":
        return ir.SpanNot(rand_span(rng, depth - 1))
    if op == "child":
        return ir.ChildOf(rand_span(rng, depth - 1),
                          rand_span(rng, depth - 1))
    return ir.DescOf(rand_span(rng, depth - 1), rand_span(rng, depth - 1))


def rand_trace(rng: random.Random, depth: int = 2):
    """A random trace-level tree (the reference's test generator's
    shapes), in the port's IR."""
    choices = ["exists", "count", "quantile", "tag", "dur"]
    if depth > 0:
        choices += ["and", "or", "not"]
    op = rng.choice(choices)
    if op == "exists":
        return ir.Exists(rand_span(rng, 2))
    if op == "count":
        return ir.Count(rand_span(rng, 1), rng.choice(ir.CMP_OPS),
                        rng.randint(0, 4))
    if op == "quantile":
        # the rationals the decimal form parses to (0.5, 0.9, 0.99, 0.25, 1)
        qn, qd = rng.choice([(5, 10), (9, 10), (99, 100), (25, 100),
                             (1, 1)])
        return ir.Quantile(rand_span(rng, 1), qn, qd,
                           rng.choice(ir.CMP_OPS), rng.randint(0, 900))
    if op == "tag":
        return ir.TraceTag(rng.choice(["service.name", "env", "nope"]),
                           rng.choice(["a", "prod", "dev", ""]))
    if op == "dur":
        lo = rng.randint(0, 4000)
        return ir.TraceDur(lo, lo + rng.randint(0, 4000))
    if op in ("and", "or"):
        args = tuple(rand_trace(rng, depth - 1)
                     for _ in range(rng.randint(1, 3)))
        return ir.TraceAnd(args) if op == "and" else ir.TraceOr(args)
    return ir.TraceNot(rand_trace(rng, depth - 1))


FIXED = {
    "child": '{"child": {"parent": {"tag": {"k": "service.name", "v": '
             '"api"}}, "child": {"dur": {"min_ms": 200}}}}',
    "desc": '{"desc": {"anc": {"tag": {"k": "service.name", "v": "db"}}, '
            '"span": {"kind": "client"}}}',
    "count": '{"count": {"of": {"tag": {"k": "name", "v": "op"}}, '
             '"op": ">", "n": 3}}',
    "quantile": '{"quantile": {"of": {"dur": {"min_ms": 1}}, "q": "0.9", '
                '"op": ">=", "ms": 500}}',
    "and_not_exists": '{"and": [{"tag": {"k": "env", "v": "prod"}}, '
                      '{"not": {"exists": {"kind": 4}}}]}',
}


def fixed_and_fuzz(seed: int, n: int) -> list:
    rng = random.Random(seed)
    return [ir.parse(t) for t in FIXED.values()] + \
        [rand_trace(rng) for _ in range(n)]


def ref_expr(expr):
    return ref_ir.parse(ir.to_json(expr))


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# IR


def test_ir_fuzz_serializes_as_the_reference_does():
    rng = random.Random(11)
    for _ in range(300):
        expr = rand_trace(rng, depth=rng.randint(0, 3))
        text = ir.to_json(expr)
        ref = ref_ir.parse(text)
        assert ref_ir.to_json(ref) == text
        # (a quantile's rational re-parses from its decimal: 1/4 -> 25/100)
        assert ir.to_json(ir.parse(text)) == text
        assert ir.parse(text) == ir.parse(ref_ir.to_json(ref))
        assert ir.node_count(expr) == ref_ir.node_count(ref)
        assert ir.quote(text) == ref_ir.quote(text)
        assert ir.to_json(ir.parse_quoted(ir.quote(text))) == text


@pytest.mark.parametrize("src", [
    "", "[]", '{"exists": 1}', '{"nope": {}}', '{"and": []}',
    '{"count": {"of": {"kind": 1}, "op": "~", "n": 1}}',
    '{"count": {"of": {"kind": 1}, "op": ">", "n": -1}}',
    '{"quantile": {"of": {"kind": 1}, "q": "1.5", "op": ">", "ms": 1}}',
    '{"quantile": {"of": {"kind": 1}, "q": "0.0001", "op": ">", "ms": 1}}',
    '{"exists": {"kind": "weird"}}', '{"exists": {"kind": 9}}',
    '{"tag": {"k": ""}}', '{"dur": {"min_ms": 5, "max_ms": 1}}',
    '{"exists": {"tag": {"k": "a", "x": 1}}}',
    '{"or": [' + ",".join(['{"exists": {"kind": 1}}'] * 40) + ']}',
])
def test_ir_errors_match_the_reference(src):
    with pytest.raises(ref_ir.IRSyntaxError) as want:
        ref_ir.parse(src)
    with pytest.raises(ir.IRSyntaxError) as got:
        ir.parse(src)
    assert str(got.value) == str(want.value)
    assert got.value.path == want.value.path


# ---------------------------------------------------------------------------
# span rows: codec, container, staging, compile


def test_span_codec_matches_the_reference_both_ways():
    port = entries(3, 40, data, loops=True)
    ref = entries(3, 40, ref_data, loops=True)
    for p, r in zip(port + spanless(3, data), ref + spanless(3, ref_data)):
        pb = data.encode_search_data(p)
        assert pb == ref_data.encode_search_data(r)
        back = data.decode_search_data(pb, p.trace_id)
        assert back.spans == [
            data.SpanData(s.parent, min(s.dur_ms, 0xFFFFFFFF), s.kind & 0xFF,
                          s.kvs) for s in p.spans]
        rb = ref_data.decode_search_data(pb, p.trace_id)
        assert [(s.parent, s.dur_ms, s.kind, s.kvs) for s in rb.spans] == \
            [(s.parent, s.dur_ms, s.kind, s.kvs) for s in back.spans]
        assert back.kvs == p.kvs and back.dur_ms == p.dur_ms


def _built(seed: int, n: int = 60, **kw):
    return (ColumnarPages.build(entries(seed, n, data, **kw),
                                PageGeometry(*GEO)),
            RefPages.build(entries(seed, n, ref_data, **kw),
                           RefGeometry(*GEO)))


@pytest.mark.parametrize("kw", [{}, {"loops": True, "urls": 100},
                                {"max_spans": 0}])
def test_container_span_segment_is_byte_identical(kw):
    port, ref = _built(5, **kw)
    blob = port.to_bytes()
    assert blob == ref.to_bytes()
    assert port.has_spans == ref.has_spans
    assert port.n_spans == ref.n_spans
    back = ColumnarPages.from_bytes(blob)
    rback = RefPages.from_bytes(blob)
    for name, _dt in ColumnarPages._SPAN_ARRAYS:
        got, want = getattr(back, name), getattr(rback, name)
        assert (got is None) == (want is None)
        if got is not None:
            assert np.array_equal(got, want) and got.dtype == want.dtype
    if port.has_spans:
        assert ColumnarPages.from_bytes(ref.to_bytes()).n_spans == \
            ref.n_spans


@pytest.mark.parametrize("start,count", [(0, 1), (1, 2), (2, 10), (3, 0),
                                         (0, 99)])
def test_slice_pages_remaps_spans_as_the_reference_does(start, count):
    port, ref = _built(6, 70, loops=True)
    got, want = port.slice_pages(start, count), ref.slice_pages(start, count)
    assert got.has_spans == want.has_spans
    assert got.header == want.header
    for name, _dt in ColumnarPages._SPAN_ARRAYS:
        assert np.array_equal(getattr(got, name), getattr(want, name)), name


def test_from_arrays_takes_the_span_segment():
    port, _ref = _built(7, loops=True)
    arrays = [getattr(port, n) for n, _ in ColumnarPages._ARRAYS]
    spans = {n: getattr(port, n) for n, _ in ColumnarPages._SPAN_ARRAYS}
    again = ColumnarPages.from_arrays(
        port.key_dict, port.val_dict, *arrays,
        truncated_entries=port.header["truncated_entries"], spans=spans)
    assert again.to_bytes() == port.to_bytes()


def _blocks(seed: int, packed_long: bool = False):
    """Three blocks of each package (two with spans and different
    dictionaries, the second large enough to probe; one without spans)."""
    kw = {"long_every": 9} if packed_long else {}
    specs = [(seed, 30, {"loops": True, **kw}),
             (seed + 1, 30, {"urls": 120, **kw})]
    port = [ColumnarPages.build(entries(s, n, data, **k), PageGeometry(*GEO))
            for s, n, k in specs]
    ref = [RefPages.build(entries(s, n, ref_data, **k), RefGeometry(*GEO))
           for s, n, k in specs]
    port.append(ColumnarPages.build(spanless(5, data), PageGeometry(*GEO)))
    ref.append(RefPages.build(spanless(5, ref_data), RefGeometry(*GEO)))
    return port, ref


def test_stack_spans_matches_the_reference():
    port, ref = _blocks(8)
    E = GEO[0]
    pad = _pow2(sum(b.n_pages for b in port))
    got = structural.stack_spans(port, E, pad)
    want = ref_structural.STRUCTURAL.stack_spans(ref, E, pad)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k
    assert structural.stack_spans(port[2:], E, pad) is None
    trace = got["span_trace"]
    assert structural.max_entry_run(got) == int(
        np.bincount(trace[trace >= 0]).max())


def test_span_segment_check_refuses_a_parent_outside_its_trace():
    port, _ref = _built(9, 40)
    structural.check_span_segment(port)
    bad, _ = _built(9, 40)
    par = bad.span_parent.copy()
    t = bad.span_trace
    # point a span at a span of another trace
    j = int(np.flatnonzero(t != t[0])[0])
    par[j] = 0
    bad.span_parent = par
    with pytest.raises(ValueError, match="parent"):
        structural.stack_spans([bad], GEO[0], _pow2(bad.n_pages))
    bad2, _ = _built(9, 40)
    cnt = bad2.entry_span_count.copy()
    cnt.reshape(-1)[int(np.flatnonzero(cnt.reshape(-1))[0])] += 1
    bad2.entry_span_count = cnt
    with pytest.raises(ValueError, match="span"):
        structural.check_span_segment(bad2)


def _stage_both(port_blocks, ref_blocks, packed: bool, probe_min: int):
    """Each package's staged batch of the same blocks, and the port's
    engine. The arrays must be equal bit for bit."""
    ref_packing.PACKING.enabled = packed
    ref_pipeline._COMPILE_CACHE.clear()
    rhost = RefEngine(top_k=512, device_probe_min_vals=probe_min) \
        .stage_host(ref_blocks)
    eng = MultiBlockEngine(CPU, top_k=512, device_probe_min_vals=probe_min,
                           packed=packed,
                           structural_cfg=structural.StructuralConfig(True))
    host = eng.stage_host(port_blocks)
    batch = place_batch(host, CPU)
    for k, v in rhost.cat.items():
        assert host.cat[k].tobytes() == np.ascontiguousarray(v).tobytes(), k
    assert (host.span_cat is None) == (rhost.span_cat is None)
    for k, v in (rhost.span_cat or {}).items():
        assert host.span_cat[k].tobytes() == v.tobytes(), k
    assert host.widths == rhost.widths
    return eng, batch, rhost


def _as_ref_tables(st) -> tuple:
    """A port CompiledStructural's seven tables in the reference's form
    (a word mask as uint32)."""
    vh = st.val_hits
    if vh is not None:
        vh = vh.numpy()
        vh = vh.view(np.uint32) if vh.dtype == np.int32 else vh
    return (st.term_keys, st.val_ranges, vh, st.block_group, st.dur_params,
            st.kind_params, st.agg_params)


def _ref_verdicts(rhost, tables, plan) -> np.ndarray:
    c = rhost.cat
    tabs = tuple(None if t is None else jnp.asarray(t) for t in tables)
    out = _ref_mask(c["kv_key"], c["kv_val"], c["entry_dur"],
                    c["entry_valid"], c["page_block"], c.get("entry_dur_res"),
                    rhost.span_cat, tabs, plan=plan, widths=rhost.widths)
    return np.asarray(out).reshape(-1)


@pytest.mark.parametrize("probe", [False, True])
def test_compile_structural_tables_match_the_reference(probe):
    port, ref = _blocks(12)
    probe_min = PROBE_MIN if probe else 0
    eng, batch, _rhost = _stage_both(port, ref, False, probe_min)
    rbatch = RefEngine(top_k=512, device_probe_min_vals=probe_min) \
        .stage(ref)
    assert bool(batch.staged_dicts) == probe
    for expr in fixed_and_fuzz(13, 12):
        st = structural.compile_structural(
            expr, port, staged_dicts=batch.staged_dicts, memo=batch.memo)
        rst = ref_structural.compile_structural(
            ref_expr(expr), ref, cache_on=rbatch,
            staged_dicts=rbatch.staged_dicts)
        assert st.plan == rst.plan
        for i, (got, want) in enumerate(zip(_as_ref_tables(st),
                                            rst.tables())):
            assert (got is None) == (want is None)
            if got is None:
                continue
            got, want = np.asarray(got), np.asarray(want)
            if i == 2:
                # the reference's probe pads the value axis of its masks
                # to its dictionary bucket with False; the port's is exact
                V = got.shape[-1]
                assert not want[..., V:].any()
                want = want[..., :V]
            assert np.array_equal(got, want)
        if probe and st.term_keys is not None:
            assert st.val_hits is not None


# ---------------------------------------------------------------------------
# K6's plain version against the reference's kernels


MODES = [(False, 0), (False, PROBE_MIN), (True, 0), (True, PROBE_MIN)]


@pytest.mark.parametrize("packed,probe_min", MODES,
                         ids=["ranges", "hits", "packed-ranges",
                              "packed-words"])
def test_k6_plain_matches_trace_mask(packed, probe_min):
    """Exact plans: K6's plain version over the port's lane equals the
    reference's ``structural_entry_mask`` (``_trace_mask``) on the same
    staged arrays and tables."""
    port, ref = _blocks(20, packed_long=packed)
    eng, batch, rhost = _stage_both(port, ref, packed, probe_min)
    assert (batch.widths is not None) == packed
    if packed:
        assert batch.widths[2].startswith("q")     # bucketed durations
    hits = 0
    for expr in fixed_and_fuzz(21 + probe_min, 25):
        st = structural.compile_structural(
            expr, port, staged_dicts=batch.staged_dicts, packed=packed,
            memo=batch.memo)
        hits += st.val_hits is not None
        got = eng.structural_verdicts(batch, st.lanes())
        want = _ref_verdicts(rhost, _as_ref_tables(st), st.plan)
        assert np.array_equal(got[0].numpy().astype(bool), want), \
            ir.to_json(expr)
    assert (hits > 0) == bool(probe_min)


def _bucket_groups(seed: int, n: int, max_nodes: int = 16) -> list:
    """Random plans grouped by canonical bucket, groups of 2-8 members
    with at least two distinct plans."""
    rng = random.Random(seed)
    by = {}
    for _ in range(n):
        expr = rand_trace(rng, depth=rng.randint(1, 2))
        plan = structural._LeafCollector().lower_trace(expr)
        bk = structural.canonical_bucket(plan, max_nodes)
        if bk is not None:
            by.setdefault(bk, []).append(expr)
    out = []
    for bk, exprs in sorted(by.items(), key=lambda kv: str(kv[0])):
        if len({ir.to_json(e) for e in exprs}) >= 2:
            out.append((bk, exprs[:8]))
    return out


@pytest.mark.parametrize("packed,probe_min", MODES,
                         ids=["ranges", "hits", "packed-ranges",
                              "packed-words"])
def test_k6_plain_matches_bucket_trace_mask(packed, probe_min):
    """Bucketed groups: each lane of the port's stack equals the
    reference's ``_bucket_trace_mask`` for that member, over the
    reference's own stacked tables; in range mode the lanes' tables equal
    the reference's stack row for row."""
    port, ref = _blocks(30, packed_long=packed)
    eng, batch, rhost = _stage_both(port, ref, packed, probe_min)
    rbatch = RefEngine(top_k=512, device_probe_min_vals=probe_min) \
        .stage(ref)
    groups = _bucket_groups(31, 120)
    assert len(groups) >= 3
    for desc, exprs in groups[:6]:
        sts = [structural.compile_structural(
            e, port, staged_dicts=batch.staged_dicts, packed=packed,
            memo=batch.memo) for e in exprs]
        rsts = [ref_structural.compile_structural(
            ref_expr(e), ref, cache_on=rbatch,
            staged_dicts=rbatch.staged_dicts) for e in exprs]
        bst = structural.stack_bucketed(sts, desc)
        rbst = ref_structural.stack_bucketed(rsts, _pow2(len(rsts)), desc)
        got = eng.structural_verdicts(batch, bst.lanes).numpy()
        lanes = bst.lanes
        if not probe_min:
            rt = rbst.tables
            named = {"term_keys": rt[0], "val_ranges": rt[1],
                     "dur_params": rt[4], "kind_params": rt[5],
                     "agg_params": rt[6], "span_prog": rt[7],
                     "trace_prog": rt[8]}
            for name, want in named.items():
                if want is not None:
                    assert np.array_equal(getattr(lanes, name),
                                          np.asarray(want)[:len(sts)]), name
        for q in range(len(sts)):
            tq = tuple(None if t is None else
                       (t[q] if not hasattr(t, "devices") else
                        np.asarray(t)[q]) for t in rbst.tables)
            want = _ref_verdicts(rhost, tq, desc)
            assert np.array_equal(got[q].astype(bool), want), \
                (desc, ir.to_json(exprs[q]))


def _lanes_by_hand(B: int, *, sprog, tprog, dur=((0, 0),), kind=(0,),
                   agg=((0, 1, 0),)):
    Q = 1
    return structural.Lanes(
        span_prog=np.asarray([sprog], dtype=np.int32),
        trace_prog=np.asarray([tprog], dtype=np.int32),
        term_keys=np.full((Q, B, 1), -1, dtype=np.int32),
        val_ranges=np.tile(np.array([1, 0], dtype=np.int32),
                           (Q, B, 1, 1, 1)),
        dur_params=np.asarray([dur], dtype=np.uint32),
        kind_params=np.asarray([kind], dtype=np.int32),
        agg_params=np.asarray([agg], dtype=np.uint32))


U32 = 0xFFFFFFFF


@pytest.mark.parametrize("case", [
    # span dur leaf at the top of the uint32 range, counted
    ([[2, 0, 0, 0]], [[4, 1, 0, 3], [7, 1, 1, 0]],
     ((3_000_000_000, U32),), (0,), ((0, 1, 0),)),
    # count == 2^32 - 1 never holds; != always does
    ([[2, 0, 0, 0]], [[4, 1, 0, 4], [4, 1, 1, 5], [6, 1, 2, 0],
                      [7, 3, 3, 0]],
     ((0, U32),), (0,), ((U32, 0, 0), (U32, 0, 0))),
    # quantile with qn * n past 2^32 (wrapping rank) and x at the top
    ([[3, 0, 0, 0], [6, 1, 0, 0], [5, 1, 2, 0]],
     [[5, 3, 0, 1], [5, 3, 1, 3], [7, 1, 2, 0], [7, 3, 3, 0]],
     ((0, 0),), (2,), ((3_000_000_000, 7, U32 - 1), (2, 3, 999))),
    # an unknown opcode and pad slots read as false; clipped registers
    ([[0, 0, 0, 0], [9, 5, 5, 0], [5, 7, 1, 0]],
     [[3, 3, 0, 0], [0, 0, 0, 0], [9, 0, 0, 0], [8, 9, 0, 0]],
     ((0, 0),), (0,), ((0, 1, 0),)),
])
def test_k6_unsigned_and_clamped_edges_match_bucket_trace_mask(case):
    """Hand-made slot programs and tables at the edges the reference's
    uint32 arithmetic and clipped gathers define."""
    sprog, tprog, dur, kind, agg = case
    NS, NT = _pow2(len(sprog)), _pow2(len(tprog))
    sp = np.zeros((NS, 4), dtype=np.int32)
    sp[:len(sprog)] = sprog
    tp = np.zeros((NT, 4), dtype=np.int32)
    tp[:len(tprog) - 1] = tprog[:-1]
    tp[NT - 1] = tprog[-1]
    port, ref = _blocks(40)
    eng, batch, rhost = _stage_both(port, ref, False, 0)
    lanes = _lanes_by_hand(len(port), sprog=sp, tprog=tp, dur=dur,
                           kind=kind, agg=agg)
    got = eng.structural_verdicts(batch, lanes)[0].numpy().astype(bool)
    tables = (lanes.term_keys[0], lanes.val_ranges[0], None, None,
              lanes.dur_params[0], lanes.kind_params[0],
              lanes.agg_params[0], sp, tp)
    want = _ref_verdicts(rhost, tables, ("bucket", NS, NT, True))
    assert np.array_equal(got, want)


def test_k6_on_a_batch_without_spans():
    """No block carries spans: exists and quantiles are false, counts
    compare 0, as the reference's sctx-None path says."""
    port = [ColumnarPages.build(spanless(20, data), PageGeometry(*GEO))]
    ref = [RefPages.build(spanless(20, ref_data), RefGeometry(*GEO))]
    eng, batch, rhost = _stage_both(port, ref, False, 0)
    assert batch.span_device is None and rhost.span_cat is None
    for text, holds in (
            ('{"count": {"of": {"kind": 1}, "op": "<", "n": 1}}', True),
            ('{"exists": {"kind": 0}}', False),
            ('{"not": {"quantile": {"of": {"kind": 0}, "q": "0.5", '
             '"op": ">", "ms": 1}}}', True)):
        expr = ir.parse(text)
        st = structural.compile_structural(expr, port)
        got = eng.structural_verdicts(batch, st.lanes())[0].numpy()
        want = _ref_verdicts(rhost, _as_ref_tables(st), st.plan)
        assert np.array_equal(got.astype(bool), want)
        assert want.sum() == (20 if holds else 0)


def shuffle_span_runs(b, seed: int) -> None:
    """Reorder block `b`'s span axis so that its entries' runs lie in a
    seeded random order (each run stays contiguous, parents and begins
    remapped): the runs of one page are then no longer adjacent."""
    begin = b.entry_span_begin.reshape(-1).astype(np.int64)
    count = b.entry_span_count.reshape(-1).astype(np.int64)
    live = np.flatnonzero(count > 0)
    order = np.random.default_rng(seed).permutation(live)
    c = count[order]
    perm = np.repeat(begin[order] - (np.cumsum(c) - c), c) \
        + np.arange(int(c.sum()))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    par = b.span_parent[perm]
    b.span_parent = np.where(par >= 0, inv[np.clip(par, 0, None)],
                             -1).astype(b.span_parent.dtype)
    for name in ("span_trace", "span_dur", "span_kind", "span_kv_key",
                 "span_kv_val"):
        setattr(b, name, getattr(b, name)[perm])
    nb = np.where(count > 0, inv[np.clip(begin, 0, perm.size - 1)], 0)
    b.entry_span_begin = nb.astype(b.entry_span_begin.dtype).reshape(
        b.entry_span_begin.shape)


def test_k6_on_runs_out_of_entry_order():
    """A container whose runs are disjoint but not in entry order passes
    staging (each page's span range then passes its span count, the
    longest run staying what it was), and K6's plain version still equals
    the reference's ``_trace_mask`` and the in-order block's verdicts."""
    port, ref = _built(50, 120, loops=True)
    eng, batch, rhost = _stage_both([port], [ref], False, 0)
    want_run = max(int(c.sum()) for c in port.entry_span_count)
    sport, sref = _built(50, 120, loops=True)
    shuffle_span_runs(sport, 51)
    shuffle_span_runs(sref, 51)
    seng, sbatch, srhost = _stage_both([sport], [sref], False, 0)
    cols = srhost.span_cat
    cnt = cols["entry_span_count"].astype(np.int64)
    beg = cols["entry_span_begin"].astype(np.int64)
    ranges = [int((beg[p] + cnt[p])[cnt[p] > 0].max()
                  - beg[p][cnt[p] > 0].min())
              for p in range(cnt.shape[0]) if (cnt[p] > 0).any()]
    assert max(ranges) > want_run
    assert sbatch.span_max_run == batch.span_max_run
    for expr in fixed_and_fuzz(52, 20):
        st = structural.compile_structural(expr, [sport])
        got = seng.structural_verdicts(sbatch, st.lanes())[0].numpy()
        want = _ref_verdicts(srhost, _as_ref_tables(st), st.plan)
        assert np.array_equal(got.astype(bool), want), ir.to_json(expr)
        st0 = structural.compile_structural(expr, [port])
        assert np.array_equal(
            got, eng.structural_verdicts(batch, st0.lanes())[0].numpy())


def _long_trace(mod, sds: list, n_spans: int, seed: int) -> None:
    """Grow the first trace of `sds` to `n_spans` spans: half of the new
    ones chain to the span before (deep ancestors), the rest to a random
    earlier span."""
    rng = random.Random(seed)
    sd = sds[0]
    while len(sd.spans) < n_spans:
        s = len(sd.spans)
        par = -1 if s == 0 else (s - 1 if rng.random() < 0.5
                                 else rng.randrange(s))
        sd.spans.append(mod.SpanData(
            parent=par, dur_ms=rng.randint(1, 1000), kind=rng.randint(0, 5),
            kvs={"service.name": {rng.choice(SVCS)},
                 "name": {rng.choice(OPS)}}))


def _k6_corpus(case: str):
    """(port block, reference block) for a K6 edge case: `long_run`, one
    trace whose run passes the tile budget of the kernel; `cycles`, parent
    cycles and self-parents on runs out of entry order."""
    if case == "long_run":
        ents = entries(60, 50, data)
        rents = entries(60, 50, ref_data)
        n = k6.TILE_SPANS + 77
        _long_trace(data, ents, n, 61)
        _long_trace(ref_data, rents, n, 61)
        return (ColumnarPages.build(ents, PageGeometry(*GEO)),
                RefPages.build(rents, RefGeometry(*GEO)))
    port, ref = _built(62, 90, loops=True)
    shuffle_span_runs(port, 63)
    shuffle_span_runs(ref, 63)
    return port, ref


@pytest.mark.parametrize("case", ["long_run", "cycles"])
def test_k6_plain_matches_trace_mask_at_tile_edges(case):
    """K6's plain version against the reference's ``_trace_mask`` on the
    layouts the kernel's tiles meet at their edges: a run longer than a
    tile holds (alone in its tile, through the kernel's scratch), and
    parent cycles on runs out of entry order."""
    port, ref = _k6_corpus(case)
    eng, batch, rhost = _stage_both([port], [ref], False, 0)
    cnt = rhost.span_cat["entry_span_count"].reshape(-1)
    assert batch.span_max_run == int(cnt.max())
    if case == "long_run":
        assert batch.span_max_run > k6.TILE_SPANS
    else:
        par = port.span_parent
        assert (par == np.arange(par.size)).any()
    for expr in fixed_and_fuzz(64, 20):
        st = structural.compile_structural(expr, [port])
        got = eng.structural_verdicts(batch, st.lanes())[0].numpy()
        want = _ref_verdicts(rhost, _as_ref_tables(st), st.plan)
        assert np.array_equal(got.astype(bool), want), ir.to_json(expr)


def test_place_spans_returns_the_longest_entry_run():
    """``place_spans`` (every staging route's) returns the longest entry
    run, K6's scratch length for a run longer than its tiles hold; the
    shuffled runs of a block leave it as it was."""
    port, _ref = _built(70, 200)
    cols = structural.stack_spans([port], GEO[0], _pow2(port.n_pages))
    dev, run = place_spans(cols, CPU)
    trace = cols["span_trace"]
    assert run == int(np.bincount(trace[trace >= 0]).max()) > 0
    assert set(dev) == set(cols)
    shuffle_span_runs(port, 71)
    port._span_segment_checked = False
    cols2 = structural.stack_spans([port], GEO[0], _pow2(port.n_pages))
    assert place_spans(cols2, CPU)[1] == run
    assert place_spans(None, CPU) == (None, 0)


# ---------------------------------------------------------------------------
# end to end, over one directory the reference wrote


def _ref_req(tags: dict, kw: dict):
    r = tempopb.SearchRequest()
    for k, v in tags.items():
        r.tags[k] = v
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def _tags(expr, exhaustive: bool) -> dict:
    tags = {structural.STRUCTURAL_QUERY_TAG: ir.quote(ir.to_json(expr))}
    if exhaustive:
        tags["x-dbg-exhaustive"] = ""
    return tags


def _traces(resp) -> list:
    return sorted((t.trace_id, t.start_time_unix_nano, t.duration_ms,
                   t.root_service_name, t.root_trace_name)
                  for t in resp.traces)


def _metrics(m) -> tuple:
    return (m.inspected_traces, m.inspected_blocks, m.skipped_blocks,
            m.inspected_bytes, m.truncated_entries)


def _assert_same(got, want, exact_set: bool = True):
    assert _metrics(got.metrics) == _metrics(want.metrics)
    if exact_set:
        assert _traces(got) == _traces(want)
    else:
        assert len(got.traces) == len(want.traces)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Eight blocks the reference wrote: spans with parent cycles and
    self-parents, one block whose dictionary probes, one block without
    spans."""
    root = tmp_path_factory.mktemp("torch_structural")
    be = RefLocalBackend(str(root / "blocks"))
    for b in range(8):
        ents = entries(100 + b, 45, ref_data, loops=b % 2 == 0,
                       urls=150 if b == 3 else 0,
                       max_spans=0 if b == 6 else 9)
        for i, e in enumerate(ents):
            e.start_s += b * 1000
            e.end_s += b * 1000
        ref_write_search_block(be, RefBlockMeta(tenant_id=TENANT), ents,
                               geometry=RefGeometry(*GEO), encoding="zlib")
    return root


def _pair(root, tmp_path_factory, **cfg):
    ref = RefTempoDB(
        RefLocalBackend(str(root / "blocks")),
        str(tmp_path_factory.mktemp("torch_structural_wal")),
        RefTempoDBConfig(search_max_batch_pages=8, auto_mesh=False,
                         host_state_dir="", search_structural_enabled=True,
                         search_device_probe_min_vals=PROBE_MIN, **cfg))
    port = TempoDB(LocalBackend(str(root / "blocks")),
                   TempoDBConfig(search_max_batch_pages=8,
                                 search_structural_enabled=True,
                                 search_device_probe_min_vals=PROBE_MIN,
                                 **cfg),
                   device="cpu")
    ref.poll()
    port.poll()
    return ref, port


@pytest.fixture(scope="module")
def dbs(corpus, tmp_path_factory):
    ref_structural.STRUCTURAL.enabled = True
    ref, port = _pair(corpus, tmp_path_factory)
    # stage every group in both first, so early quits scan the same groups
    expr = ir.parse(FIXED["count"])
    _assert_same(port.search(TENANT, SearchRequest(tags=_tags(expr, True),
                                                   limit=1000)).response(),
                 ref.search(TENANT, _ref_req(_tags(expr, True),
                                             {"limit": 1000})).response())
    yield ref, port
    port.close()


def _search_both(ref, port, expr, exhaustive: bool, limit: int):
    ref_structural.STRUCTURAL.enabled = True
    ref_packing.PACKING.enabled = port.cfg.search_packed_residency
    tags = _tags(expr, exhaustive)
    want = ref.search(TENANT, _ref_req(tags, {"limit": limit})).response()
    got = port.search(TENANT, SearchRequest(tags=dict(tags), limit=limit)
                      ).response()
    _assert_same(got, want, exact_set=exhaustive or len(want.traces) < limit)
    return got


@pytest.mark.parametrize("name", list(FIXED))
def test_fixed_plans_through_search(dbs, name):
    ref, port = dbs
    expr = ir.parse(FIXED[name])
    got = _search_both(ref, port, expr, True, 1000)
    assert got.traces          # each fixed plan matches something here
    _search_both(ref, port, expr, False, 5)


@pytest.mark.parametrize("chunk", range(5))
def test_fuzzed_plans_through_search(dbs, chunk):
    """120 seeded random plans (24 a chunk), exhaustive and at limit 7."""
    ref, port = dbs
    rng = random.Random(5_000 + chunk)
    for _ in range(24):
        expr = rand_trace(rng)
        _search_both(ref, port, expr, True, 1000)
        _search_both(ref, port, expr, False, 7)


def _block_jobs(ref):
    out = []
    for m in sorted(ref.blocklist.metas(TENANT), key=lambda m: m.block_id):
        for start, count in ((0, 0), (1, 2)):
            out.append(dict(tenant_id=TENANT, block_id=m.block_id,
                            start_page=start, pages_to_search=count,
                            encoding=m.encoding, version=m.version,
                            data_encoding=m.data_encoding,
                            start_time=m.start_time, end_time=m.end_time))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_plans_through_search_block(dbs, seed):
    """The one-job request over whole blocks and page ranges (sliced
    span segments): the fixed plans, then 10 fuzzed ones."""
    ref, port = dbs
    exprs = fixed_and_fuzz(6_000 + seed, 10)
    for expr in exprs[5 * seed:]:
        tags = _tags(expr, True)
        for j in _block_jobs(ref):
            rr = tempopb.SearchBlockRequest(**j)
            rr.search_req.CopyFrom(_ref_req(tags, {"limit": 1000}))
            want = ref.search_block(rr).response()
            got = port.search_block(SearchBlockRequest(
                search_req=SearchRequest(tags=dict(tags), limit=1000),
                **j)).response()
            _assert_same(got, want)


@pytest.fixture(scope="module")
def single_blocks(dbs, corpus):
    ref, port = dbs
    be = RefLocalBackend(str(corpus / "blocks"))
    pbe = LocalBackend(str(corpus / "blocks"))
    cfg = port.cfg.structural()
    out = []
    for m, pm in zip(sorted(ref.blocklist.metas(TENANT),
                            key=lambda m: m.block_id),
                     sorted(port.blocklist.metas(TENANT),
                            key=lambda m: m.block_id)):
        out.append((RefBackendSearchBlock(be, m, probe_min_vals=PROBE_MIN),
                    BackendSearchBlock(pbe, pm, probe_min_vals=PROBE_MIN,
                                       device="cpu", structural_cfg=cfg)))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_plans_through_backend_search_block(single_blocks, seed):
    """The single-block engine (K6 then K1s) on every block."""
    exprs = fixed_and_fuzz(7_000 + seed, 12)
    for expr in exprs[5 * seed:]:
        for limit, ex in ((1000, True), (3, False)):
            tags = _tags(expr, ex)
            for rb, pb in single_blocks:
                ref_structural.STRUCTURAL.enabled = True
                ref_packing.PACKING.enabled = False
                want = rb.search(_ref_req(tags, {"limit": limit})).response()
                got = pb.search(SearchRequest(tags=dict(tags), limit=limit)
                                ).response()
                _assert_same(got, want, exact_set=ex)


@pytest.fixture(scope="module")
def packed_dbs(corpus, tmp_path_factory):
    ref_structural.STRUCTURAL.enabled = True
    ref_packing.PACKING.enabled = True
    ref, port = _pair(corpus, tmp_path_factory,
                      search_packed_residency=True)
    yield ref, port
    port.close()


def test_plans_through_packed_search(packed_dbs, dbs):
    """A packed database answers as the packed reference does, and as
    the unpacked port does."""
    ref, port = packed_dbs
    _ref_u, port_u = dbs
    for expr in fixed_and_fuzz(8_000, 20):
        got = _search_both(ref, port, expr, True, 1000)
        plain = port_u.search(TENANT, SearchRequest(
            tags=_tags(expr, True), limit=1000)).response()
        assert _traces(got) == _traces(plain)
    assert any(c.batch.widths is not None and c.batch.span_device is not None
               for c in port.batcher._cache.values())


# ---------------------------------------------------------------------------
# the gate


def test_gate_off_refuses_the_tag_at_every_entry_point(corpus):
    db = TempoDB(LocalBackend(str(corpus / "blocks")), TempoDBConfig(),
                 device="cpu")
    db.poll()
    tags = _tags(ir.parse(FIXED["desc"]), False)
    m = db.blocklist.metas(TENANT)[0]
    job = dict(block_id=m.block_id, encoding=m.encoding, version=m.version,
               data_encoding=m.data_encoding)
    try:
        with pytest.raises(ValueError, match="structural"):
            db.search(TENANT, SearchRequest(tags=dict(tags)))
        with pytest.raises(ValueError, match="structural"):
            db.search_block(SearchBlockRequest(
                search_req=SearchRequest(tags=dict(tags)), tenant_id=TENANT,
                **job))
        with pytest.raises(ValueError, match="structural"):
            db.search_blocks(SearchBlocksRequest(
                search_req=SearchRequest(tags=dict(tags)), tenant_id=TENANT,
                jobs=[BlockSearchJob(**job)]))
        with pytest.raises(ValueError, match="structural"):
            BackendSearchBlock(LocalBackend(str(corpus / "blocks")), m,
                               device="cpu").search(
                SearchRequest(tags=dict(tags)))
        # a plain request still works, and the batch staged no spans
        res = db.search(TENANT, SearchRequest(tags={"env": "prod"}))
        assert res.metrics.inspected_traces > 0
        assert all(c.batch.span_device is None
                   for c in db.batcher._cache.values())
    finally:
        db.close()


def test_two_databases_in_one_process_keep_their_gates(dbs, corpus):
    """The port's gate is per database (the reference's is one process
    switch): a gate-off database refuses while a gate-on one answers,
    interleaved."""
    _ref, on = dbs
    off = TempoDB(LocalBackend(str(corpus / "blocks")), TempoDBConfig(),
                  device="cpu")
    off.poll()
    expr = ir.parse(FIXED["child"])
    try:
        for _ in range(2):
            res = on.search(TENANT, SearchRequest(tags=_tags(expr, True),
                                                  limit=1000))
            assert res.response().traces
            with pytest.raises(ValueError):
                off.search(TENANT, SearchRequest(tags=_tags(expr, True)))
    finally:
        off.close()


def test_eval_host_is_the_reference_semantics():
    """The port's host oracle agrees with the reference's on every fuzzed
    plan and trace, cycles included."""
    ents = entries(50, 60, data, loops=True)
    rents = entries(50, 60, ref_data, loops=True)
    for expr in fixed_and_fuzz(51, 60):
        r = ref_expr(expr)
        assert [structural.eval_host(expr, sd) for sd in ents] == \
            [ref_structural.eval_host(r, sd) for sd in rents]
