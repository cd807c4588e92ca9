"""Structural query engine, host half: gate, compile, stacking, staging.

Counterpart of the reference's ``search/structural.py``, with its
explain tree (``CompiledStructural.explain``, priced by the offload
planner's scan rate). A structural request carries an IR tree
(``search/ir.py``) in the reserved tag ``x-structural-q``. Per staged
batch the tree compiles (``compile_structural``) into

- a **static plan**, nested tuples of ops and table indices, the same
  descriptor the reference builds (``_LeafCollector``);
- **parameter tables**, the reference's seven: per-block leaf term keys
  and value ranges (or device hit masks, through the same K3 probe
  route the tag terms take, under the exhaustive contract: a leaf never
  prunes a block), duration, kind and aggregate parameters.

On the device one kernel evaluates it, K6 (``kernels/structural.py``):
a slot-program interpreter over the staged span segment. Every plan is
flattened on the host into span rows ``[NS, 4]`` and trace rows
``[NT, 4]`` (``_flatten_plan``, the reference's bucketed-program form),
so an exact plan, a same-plan stack and a shape-bucketed stack of mixed
plans all run the same interpreter; ``Lanes`` holds those programs and
the tables, one lane per query. K6's ``[Q, P*E]`` verdicts AND into the
tag-search mask of K1, K1s or K4.

The gate is per database (``StructuralConfig``, from ``TempoDBConfig.
search_structural_*``), not one process-wide switch: with it off a
request carrying the tag is refused with ValueError, and nothing stages
spans. ``eval_host`` is the reference semantics over ``SearchData.spans``
in plain Python, the port's own oracle.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from . import ir

STRUCTURAL_QUERY_TAG = "x-structural-q"


class StructuralCompileError(ValueError):
    """A compile failure rooted in the query (never the corpus)."""


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


@dataclass(frozen=True)
class StructuralConfig:
    """One database's structural gate and knobs
    (TempoDBConfig.search_structural_enabled, _stack_enabled,
    _bucket_enabled, _bucket_max_nodes, _shard_spans, _remainder_pages)
    and span caps."""
    enabled: bool = False
    # concurrent structural queries with one plan descriptor stack into
    # one fused dispatch; off, a structural query dispatches alone at once
    stack_enabled: bool = False
    # with stacking: plans that canonicalize into one bucket shape fuse
    # too, as per-query slot programs
    bucket_enabled: bool = False
    # a plan with more flattened slots than this stays exact-plan
    bucket_max_nodes: int = 16
    # on a mesh (TempoDBConfig.search_structural_shard_spans): the span
    # segment reshards so each rank holds only its pages' spans, rebased
    # to its chunk (shard_span_segment); off, every rank holds the whole
    # span axis
    shard_spans: bool = False
    # on a mesh (TempoDBConfig.search_structural_remainder_pages): the page
    # axis pads to the least multiple of the shard count (remainder_pad)
    # instead of doubling from it
    remainder_pages: bool = False
    # span rows kept a trace, and kv pairs a span, where span rows are
    # extracted (the write path with the gate on, the fallback scan); the
    # reference's defaults, which no database of the port changes
    max_spans: int = 512
    max_span_kvs: int = 16

    def stack_group_key(self, batch, st) -> tuple | None:
        """The coalescer's group key of a structural query, or None (it
        dispatches alone): same batch and the same plan, or, with
        bucketing, the same canonical bucket."""
        if not self.stack_enabled:
            return None
        if self.bucket_enabled:
            bk = canonical_bucket(st.plan, self.bucket_max_nodes)
            if bk is not None:
                return (id(batch), bk)
        return (id(batch), st.plan)


OFF = StructuralConfig()


def structural_query(req, cfg: StructuralConfig) -> "ir.TraceExpr | None":
    """The request's parsed structural tree, or None when it carries no
    structural tag. Raises ValueError when it carries one and `cfg`'s
    gate is off, or when the tree does not parse."""
    if not cfg.enabled:
        if STRUCTURAL_QUERY_TAG in req.tags:
            raise ValueError(
                "structural queries disabled "
                "(TempoDBConfig.search_structural_enabled enables them)")
        return None
    raw = req.tags.get(STRUCTURAL_QUERY_TAG, "")
    if not raw:
        return None
    try:
        return ir.parse_quoted(raw)
    except ir.IRSyntaxError as e:
        raise ValueError(f"bad structural query: {e}") from None


def attach_query(req, expr: "ir.TraceExpr") -> None:
    """Stow an IR tree on a request: canonical compact JSON,
    percent-quoted, in the reserved tag."""
    req.tags[STRUCTURAL_QUERY_TAG] = ir.quote(ir.to_json(expr))


# ---------------------------------------------------------------------------
# span staging


def check_span_segment(b) -> None:
    """Raise ValueError unless block `b`'s span segment has the layout
    K6 relies on: each entry's run [begin, begin + count) lies in the
    span axis and holds exactly the spans whose span_trace is that entry,
    and every parent lies in its own span's run. Memoized on the block."""
    if getattr(b, "_span_segment_checked", False):
        return
    S = b.n_spans
    trace = b.span_trace.astype(np.int64)
    par = b.span_parent.astype(np.int64)
    begin = b.entry_span_begin.reshape(-1).astype(np.int64)
    count = b.entry_span_count.reshape(-1).astype(np.int64)
    live = np.flatnonzero(count > 0)
    c = count[live]
    # the rows of every live entry's run, and the entry each belongs to
    rows = np.repeat(begin[live] - (np.cumsum(c) - c), c) \
        + np.arange(int(c.sum()))
    ent = np.repeat(live, c)
    bad = None
    if (count < 0).any() or (begin[live] < 0).any() \
            or (begin[live] + c > S).any():
        bad = "an entry's span run leaves the span axis"
    elif (trace >= count.size).any() or not np.array_equal(
            np.bincount(trace[trace >= 0], minlength=count.size), count):
        bad = "entry span counts disagree with span_trace"
    elif not np.array_equal(trace[rows], ent):
        bad = "a span lies outside its entry's run"
    else:
        # runs are now disjoint and each holds exactly its trace's spans
        owner = np.full(S, -1, dtype=np.int64)
        owner[rows] = ent
        if ((par >= S) | ((par >= 0) & (owner[np.clip(par, 0, S - 1)]
                                        != trace))).any():
            bad = "a span's parent lies outside its trace"
    if bad is not None:
        raise ValueError(f"malformed span segment: {bad}")
    b._span_segment_checked = True


def stack_spans(blocks: list, E: int, pad_pages: int) -> dict | None:
    """The blocks' span segments stacked for one staged batch (the
    reference's ``stack_spans``): flat span arrays concatenate with index
    remaps (trace += page offset * E, parent and begin += span base), the
    span axis pads to a power of two, and span_block gives each span its
    block's row of the leaf tables. None when no block carries spans.
    Each block's segment is checked first (``check_span_segment``)."""
    if not any(b.has_spans for b in blocks):
        return None
    for b in blocks:
        if b.has_spans:
            check_span_segment(b)
    total = sum(b.n_spans for b in blocks)
    S = _pow2(max(1, total))
    Cs = max(b.span_kv_key.shape[1] for b in blocks if b.has_spans)
    cols = {
        "span_trace": np.full(S, -1, dtype=np.int32),
        "span_parent": np.full(S, -1, dtype=np.int32),
        "span_block": np.zeros(S, dtype=np.int32),
        "span_dur": np.zeros(S, dtype=np.uint32),
        "span_kind": np.zeros(S, dtype=np.int8),
        "span_kv_key": np.full((S, Cs), -1, dtype=np.int32),
        "span_kv_val": np.full((S, Cs), -1, dtype=np.int32),
        "entry_span_begin": np.zeros((pad_pages, E), dtype=np.int32),
        "entry_span_count": np.zeros((pad_pages, E), dtype=np.int32),
    }
    base = 0
    page_off = 0
    for bi, b in enumerate(blocks):
        P = b.n_pages
        if b.has_spans:
            n = b.n_spans
            cols["span_trace"][base:base + n] = b.span_trace + page_off * E
            par = b.span_parent.astype(np.int32, copy=True)
            par[par >= 0] += base
            cols["span_parent"][base:base + n] = par
            cols["span_block"][base:base + n] = bi
            cols["span_dur"][base:base + n] = b.span_dur
            cols["span_kind"][base:base + n] = b.span_kind
            cols["span_kv_key"][base:base + n, :b.span_kv_key.shape[1]] \
                = b.span_kv_key
            cols["span_kv_val"][base:base + n, :b.span_kv_val.shape[1]] \
                = b.span_kv_val
            cnt = b.entry_span_count
            cols["entry_span_begin"][page_off:page_off + P] = \
                np.where(cnt > 0, b.entry_span_begin + base, 0)
            cols["entry_span_count"][page_off:page_off + P] = cnt
            base += n
        page_off += P
    return cols


def stage_single(pages, pad_pages: int) -> dict | None:
    """stack_spans of one block (the single-block engine's staging)."""
    return stack_spans([pages], pages.geometry.entries_per_page, pad_pages)


def max_entry_run(cols: dict) -> int:
    """The longest entry run of a staged segment: K6 takes a run longer
    than its tiles hold through scratch of this length."""
    cnt = cols["entry_span_count"]
    return int(cnt.max()) if cnt.size else 0


def remainder_pad(cfg: StructuralConfig, total: int,
                  n_shards: int) -> int | None:
    """The remainder-shard layout's page count for a mesh staging, the
    least multiple of `n_shards` holding `total` pages (the last shard
    owns the ragged tail of pad pages), or None when
    ``cfg.remainder_pages`` is off (the caller doubles from `n_shards`).
    The reference's ``StructuralGate.remainder_pad``."""
    if not cfg.remainder_pages:
        return None
    n = max(1, int(n_shards))
    return max(n, -(-int(total) // n) * n)


def shard_span_segment(cfg: StructuralConfig, span_cat: dict, n_shards: int,
                       pad_pages: int, E: int) -> dict | None:
    """A stacked span segment (``stack_spans``) resharded so that shard s's
    chunk of one uniform power-of-two length holds exactly the spans of
    the traces on its pages, in shard-local coordinates: span_trace to
    the local entry flat index, span_parent and entry_span_begin to chunk
    positions. None when ``cfg.shard_spans`` is off, or the page axis does
    not split evenly (the caller keeps the whole span axis). The same
    bytes as the reference's ``StructuralGate.shard_span_segment``."""
    if not cfg.shard_spans:
        return None
    if n_shards <= 1 or pad_pages % n_shards:
        return None
    S_old = int(span_cat["span_trace"].shape[0])
    pp = pad_pages // n_shards
    trace = span_cat["span_trace"]
    live = trace >= 0
    shard_of = np.where(live, trace // (pp * E), -1)
    per_shard = _pow2(max(
        1, int(np.bincount(shard_of[live], minlength=n_shards).max()
               if live.any() else 1)))
    S_new = n_shards * per_shard
    Cs = span_cat["span_kv_key"].shape[1]
    out = {
        "span_trace": np.full(S_new, -1, dtype=np.int32),
        "span_parent": np.full(S_new, -1, dtype=np.int32),
        "span_block": np.zeros(S_new, dtype=np.int32),
        "span_dur": np.zeros(S_new, dtype=np.uint32),
        "span_kind": np.zeros(S_new, dtype=np.int8),
        "span_kv_key": np.full((S_new, Cs), -1, dtype=np.int32),
        "span_kv_val": np.full((S_new, Cs), -1, dtype=np.int32),
    }
    # old span index -> position in its chunk; -1 for padding rows
    local_of = np.full(S_old, -1, dtype=np.int64)
    for s in range(n_shards):
        idx = np.flatnonzero(shard_of == s)
        n = len(idx)
        if not n:
            continue
        local_of[idx] = np.arange(n)
        dst = slice(s * per_shard, s * per_shard + n)
        out["span_trace"][dst] = trace[idx] - s * pp * E
        par = span_cat["span_parent"][idx]
        safe = np.clip(par, 0, S_old - 1)
        # a parent lies in its span's trace, hence on its shard; a pointer
        # to another shard maps to -1 (no parent)
        out["span_parent"][dst] = np.where(
            (par >= 0) & (shard_of[safe] == s) & (local_of[safe] >= 0),
            local_of[safe], -1).astype(np.int32)
        for name in ("span_block", "span_dur", "span_kind", "span_kv_key",
                     "span_kv_val"):
            out[name][dst] = span_cat[name][idx]
    begin = span_cat["entry_span_begin"]
    count = span_cat["entry_span_count"]
    safe_b = np.clip(begin, 0, S_old - 1)
    out["entry_span_begin"] = np.where(
        count > 0, local_of[safe_b], 0).astype(np.int32)
    out["entry_span_count"] = count
    return out


def rank_spans(span_cat: dict, rank: int, world: int, sharded: bool,
               E: int) -> dict:
    """Rank `rank`'s span columns of a staged segment, its pages' entry
    runs and:

    - `sharded` (``shard_span_segment``'s layout): its chunk of the span
      axis, already in local coordinates;
    - else the whole span axis, the run begins and parents in global span
      positions, and span_trace rebased to the rank's local entry flat
      index, -1 for the spans of other ranks' traces (K6's bounded
      ancestor walk reads the entry run count at span_trace; a rank never
      visits another rank's spans)."""
    pp = span_cat["entry_span_begin"].shape[0] // world
    rows = slice(rank * pp, (rank + 1) * pp)
    out = {"entry_span_begin": span_cat["entry_span_begin"][rows],
           "entry_span_count": span_cat["entry_span_count"][rows]}
    if sharded:
        per = span_cat["span_trace"].shape[0] // world
        chunk = slice(rank * per, (rank + 1) * per)
        for name in _SPAN_AXIS_NAMES:
            out[name] = span_cat[name][chunk]
        return out
    for name in _SPAN_AXIS_NAMES:
        out[name] = span_cat[name]
    t = span_cat["span_trace"].astype(np.int64) - rank * pp * E
    out["span_trace"] = np.where((t >= 0) & (t < pp * E), t,
                                 -1).astype(np.int32)
    return out


_SPAN_AXIS_NAMES = ("span_trace", "span_parent", "span_block", "span_dur",
                    "span_kind", "span_kv_key", "span_kv_val")


# ---------------------------------------------------------------------------
# compilation: IR -> (static plan, parameter tables)


@dataclass
class Lanes:
    """K6's per-query inputs, one lane per query, padded alike: the
    flattened slot programs and the seven parameter tables with a leading
    query axis. Pad rows are inert: term key -1 with the empty range
    [1, 0], zero duration and kind rows, aggregate rows (0, 1, 0)."""
    span_prog: np.ndarray     # int32 [Q, NS, 4]
    trace_prog: np.ndarray    # int32 [Q, NT, 4]; the result is slot NT-1
    term_keys: np.ndarray     # int32 [Q, B, T]
    val_ranges: np.ndarray    # int32 [Q, B, T, R, 2]
    dur_params: np.ndarray    # uint32 [Q, D, 2]
    kind_params: np.ndarray   # int32 [Q, K]
    agg_params: np.ndarray    # uint32 [Q, A, 3]
    # each lane's own hit table [G, T', V] (bool, or int32 words) on the
    # device, or None (a lane compiled on the host); None when no lane
    # probed. block_group int32 [Q, B], rows of -1 for those without.
    val_hits: tuple | None = None
    block_group: np.ndarray | None = None
    _device: dict = field(default_factory=dict, repr=False)

    @property
    def n_lanes(self) -> int:
        return int(self.span_prog.shape[0])

    def device(self, dev) -> tuple:
        """The lanes' arrays on `dev`, uploaded once per device: (span
        programs, trace programs, term_keys, val_ranges, dur_params,
        kind_params, agg_params, block_group or None), uint32 tables as
        int32 bits."""
        key = str(dev)
        hit = self._device.get(key)
        if hit is None:
            from .multiblock import _upload

            arrays = [self.span_prog, self.trace_prog, self.term_keys,
                      self.val_ranges, self.dur_params.view(np.int32),
                      self.kind_params, self.agg_params.view(np.int32)]
            if self.block_group is not None:
                arrays.append(self.block_group)
            up = _upload(arrays, dev)
            hit = self._device[key] = tuple(up[:7]) + (
                up[7] if self.block_group is not None else None,)
        return hit


@dataclass
class CompiledStructural:
    """One query's structural predicate compiled against one batch:
    ``plan`` is the static descriptor (nested tuples of ops and leaf
    indices), the tables its parameters (the reference's seven)."""

    plan: tuple
    n_blocks: int
    term_keys: np.ndarray | None      # int32 [B, T]
    val_ranges: np.ndarray | None     # int32 [B, T, R, 2]
    val_hits: object = None           # device [G, T, Vm] (bool or words)
    block_group: np.ndarray | None = None   # int32 [B]
    dur_params: np.ndarray | None = None    # uint32 [D, 2]
    kind_params: np.ndarray | None = None   # int32 [K]
    agg_params: np.ndarray | None = None    # uint32 [A, 3]
    node_info: list = field(default_factory=list)  # (nid, op, detail)
    # node id (preorder) -> estimated bytes it touches on the device
    # (plan_node_bytes): the weights that the query's measured execute
    # time splits over in its ?explain=1 plan tree
    node_bytes: dict = field(default_factory=dict)
    _lanes: Lanes | None = field(default=None, repr=False)

    def tables(self) -> tuple:
        return (self.term_keys, self.val_ranges, self.val_hits,
                self.block_group, self.dur_params, self.kind_params,
                self.agg_params)

    def weight(self) -> int:
        """The elements of this predicate's tables: added to a member's
        tag-table rows when a fused dispatch's measured stage times split
        over its members (query_stats.apportion)."""
        return int(sum(t.numel() if hasattr(t, "numel") else int(t.size)
                       for t in self.tables() if t is not None))

    def explain(self, measured_device_s: float | None = None,
                rate_s_per_byte: float | None = None,
                planner=None) -> dict:
        """The compiled plan tree: per node its op, parameters, estimated
        bytes and ms (the bytes through `rate_s_per_byte`, else through
        the planner's live scan rate: `planner`, or the process planner),
        and, given a measured kernel total, its share of it by bytes (one
        fused kernel has no per-node timer)."""
        from .planner import PLANNER

        p = PLANNER if planner is None else planner
        total_bytes = max(1, sum(self.node_bytes.values()))
        out: dict = {"nodes": []}
        for nid, op, detail in self.node_info:
            nb = self.node_bytes.get(nid, 0)
            rate = (rate_s_per_byte if rate_s_per_byte is not None
                    else p.rate("scan", nb))
            node = {"id": nid, "op": op, "est_bytes": int(nb),
                    "est_ms": round(nb * rate * 1e3, 6)}
            if detail:
                node["detail"] = detail
            if measured_device_s is not None:
                node["device_ms"] = round(
                    measured_device_s * (nb / total_bytes) * 1e3, 6)
            out["nodes"].append(node)
        return out

    def lanes(self) -> Lanes:
        """This query as K6's single lane (memoized)."""
        if self._lanes is None:
            self._lanes = _stack_lanes([self], [_programs(self.plan)])
        return self._lanes


@dataclass
class StackedStructural:
    """Same-plan members stacked along the coalescer's query axis: one
    lane per real member (pad queries of the fused dispatch match nothing
    in K4 and get no lane)."""
    plan: tuple
    lanes: Lanes
    n_queries: int


@dataclass
class BucketedStructural:
    """Mixed-plan members fused under one bucket descriptor
    ``("bucket", NS, NT, has_rel)``: each lane carries its member's own
    slot programs, padded to the bucket's slot counts."""
    plan: tuple
    lanes: Lanes
    n_queries: int
    active_nodes: int = 0    # the members' real slots
    slot_nodes: int = 0      # n_queries * (NS + NT)


def compile_structural(expr: "ir.TraceExpr", blocks: list,
                       staged_dicts: dict | None = None,
                       packed: bool = False,
                       memo: dict | None = None,
                       entry_kv_slots: int = 1) -> CompiledStructural:
    """Lower an IR tree against a batch's blocks: collect leaves, probe
    every distinct dictionary once per leaf set (the device probe for a
    dictionary in `staged_dicts`, else the host walk; exhaustive: a leaf
    never prunes, an unmatched leaf is False for that block) and assemble
    block-indexed tables as compile_multi does for the tag terms. With
    `packed` the probe's hit masks are words. `entry_kv_slots`: the
    blocks' kv slots an entry (``geometry.kv_per_entry``), the weight of
    a trace-tag node in ``node_bytes``."""
    leaves = _LeafCollector()
    plan = leaves.lower_trace(expr)
    term_keys = val_ranges = val_hits = block_group = None
    if leaves.terms:
        term_keys, val_ranges, val_hits, block_group = _assemble_terms(
            leaves.terms, blocks, staged_dicts=staged_dicts, packed=packed,
            memo=memo)
    return CompiledStructural(
        plan=plan, n_blocks=len(blocks), term_keys=term_keys,
        val_ranges=val_ranges, val_hits=val_hits, block_group=block_group,
        dur_params=(np.asarray(leaves.durs, dtype=np.uint32)
                    if leaves.durs else None),
        kind_params=(np.asarray(leaves.kinds, dtype=np.int32)
                     if leaves.kinds else None),
        agg_params=(np.asarray(leaves.aggs, dtype=np.uint32)
                    if leaves.aggs else None),
        node_info=leaves.node_info,
        node_bytes=plan_node_bytes(
            plan, n_spans=sum(getattr(b, "n_spans", 0) for b in blocks),
            n_entries=sum(
                getattr(b, "n_pages", 1)
                * getattr(getattr(b, "geometry", None), "entries_per_page",
                          1024)
                for b in blocks),
            span_kv_slots=max(
                [b.span_kv_key.shape[1] for b in blocks
                 if getattr(b, "has_spans", False)] or [1]),
            entry_kv_slots=entry_kv_slots))


def plan_node_bytes(plan: tuple, n_spans: int, n_entries: int,
                    span_kv_slots: int = 1,
                    entry_kv_slots: int = 1) -> dict:
    """Per-node device-byte estimates of a plan (the reference's cost
    model): the bytes each op touches, with the log factor of the
    descendant join. They are the weights the measured execute time of
    one fused kernel splits over in the explain tree."""
    S = max(1, n_spans)
    PE = max(1, n_entries)
    out: dict[int, int] = {}

    def w_span(p) -> None:
        op, nid = p[0], p[1]
        if op == "tag":
            out[nid] = S * span_kv_slots * 8
        elif op == "dur":
            out[nid] = S * 4
        elif op == "kind":
            out[nid] = S
        elif op in ("and", "or"):
            out[nid] = S * len(p[2])
            for sub in p[2]:
                w_span(sub)
        elif op == "not":
            out[nid] = S
            w_span(p[2])
        elif op == "child":
            out[nid] = S * 12
            w_span(p[2])
            w_span(p[3])
        elif op == "desc":
            out[nid] = S * 12 * max(1, (S - 1).bit_length())
            w_span(p[2])
            w_span(p[3])

    def w_trace(p) -> None:
        op, nid = p[0], p[1]
        if op == "ttag":
            out[nid] = PE * entry_kv_slots * 8
        elif op == "tdur":
            out[nid] = PE * 4
        elif op == "exists":
            out[nid] = S * 4 + PE * 8
            w_span(p[2])
        elif op in ("count", "q"):
            out[nid] = (S * 4 + PE * 8) * (2 if op == "q" else 1)
            w_span(p[4])
        elif op in ("and", "or"):
            out[nid] = PE * len(p[2])
            for sub in p[2]:
                w_trace(sub)
        elif op == "not":
            out[nid] = PE
            w_trace(p[2])

    w_trace(plan)
    return out


class _LeafCollector:
    """IR walk: dedupe leaves into parameter tables and emit the static
    plan descriptor; node ids are preorder positions."""

    def __init__(self) -> None:
        self.terms: list[tuple[str, str]] = []
        self._term_idx: dict[tuple[str, str], int] = {}
        self.durs: list[tuple[int, int]] = []
        self._dur_idx: dict[tuple[int, int], int] = {}
        self.kinds: list[int] = []
        self._kind_idx: dict[int, int] = {}
        self.aggs: list[tuple[int, int, int]] = []
        self.node_info: list[tuple[int, str, str]] = []
        self._next_id = 0

    def _nid(self, op: str, detail: str = "") -> int:
        nid = self._next_id
        self._next_id += 1
        self.node_info.append((nid, op, detail))
        return nid

    def _term(self, key: str, value: str) -> int:
        t = (key, value)
        i = self._term_idx.get(t)
        if i is None:
            i = self._term_idx[t] = len(self.terms)
            self.terms.append(t)
        return i

    def _dur(self, lo: int, hi: int) -> int:
        d = (lo, hi)
        i = self._dur_idx.get(d)
        if i is None:
            i = self._dur_idx[d] = len(self.durs)
            self.durs.append(d)
        return i

    def _kind(self, k: int) -> int:
        i = self._kind_idx.get(k)
        if i is None:
            i = self._kind_idx[k] = len(self.kinds)
            self.kinds.append(k)
        return i

    def lower_span(self, e: "ir.SpanExpr") -> tuple:
        if isinstance(e, ir.SpanTag):
            nid = self._nid("span.tag", f"{e.key}~{e.value}")
            return ("tag", nid, self._term(e.key, e.value))
        if isinstance(e, ir.SpanDur):
            nid = self._nid("span.dur", f"[{e.lo_ms},{e.hi_ms}]ms")
            return ("dur", nid, self._dur(e.lo_ms, e.hi_ms))
        if isinstance(e, ir.SpanKind):
            nid = self._nid("span.kind", str(e.kind))
            return ("kind", nid, self._kind(e.kind))
        if isinstance(e, ir.SpanAnd):
            nid = self._nid("span.and")
            return ("and", nid, tuple(self.lower_span(a) for a in e.args))
        if isinstance(e, ir.SpanOr):
            nid = self._nid("span.or")
            return ("or", nid, tuple(self.lower_span(a) for a in e.args))
        if isinstance(e, ir.SpanNot):
            nid = self._nid("span.not")
            return ("not", nid, self.lower_span(e.arg))
        if isinstance(e, ir.ChildOf):
            nid = self._nid("child", "parent-pointer join")
            return ("child", nid, self.lower_span(e.parent),
                    self.lower_span(e.child))
        if isinstance(e, ir.DescOf):
            nid = self._nid("desc", "ancestor join")
            return ("desc", nid, self.lower_span(e.anc),
                    self.lower_span(e.span))
        raise StructuralCompileError(
            f"unknown span node {type(e).__name__}")

    def lower_trace(self, e: "ir.TraceExpr") -> tuple:
        if isinstance(e, ir.TraceTag):
            nid = self._nid("trace.tag", f"{e.key}~{e.value}")
            return ("ttag", nid, self._term(e.key, e.value))
        if isinstance(e, ir.TraceDur):
            nid = self._nid("trace.dur", f"[{e.lo_ms},{e.hi_ms}]ms")
            return ("tdur", nid, self._dur(e.lo_ms, e.hi_ms))
        if isinstance(e, ir.Exists):
            nid = self._nid("exists", "segment reduce")
            return ("exists", nid, self.lower_span(e.of))
        if isinstance(e, ir.Count):
            nid = self._nid("count", f"{e.op} {e.n}")
            ai = len(self.aggs)
            self.aggs.append((e.n, 0, 0))
            return ("count", nid, e.op, ai, self.lower_span(e.of))
        if isinstance(e, ir.Quantile):
            nid = self._nid(
                "quantile",
                f"p{e.q_num}/{e.q_den} {e.op} {e.x_ms}ms (rank counts)")
            ai = len(self.aggs)
            self.aggs.append((e.q_num, e.q_den, e.x_ms))
            return ("q", nid, e.op, ai, self.lower_span(e.of))
        if isinstance(e, ir.TraceAnd):
            nid = self._nid("and")
            return ("and", nid, tuple(self.lower_trace(a) for a in e.args))
        if isinstance(e, ir.TraceOr):
            nid = self._nid("or")
            return ("or", nid, tuple(self.lower_trace(a) for a in e.args))
        if isinstance(e, ir.TraceNot):
            nid = self._nid("not")
            return ("not", nid, self.lower_trace(e.arg))
        raise StructuralCompileError(
            f"unknown trace node {type(e).__name__}")


def _assemble_terms(terms: list, blocks: list, staged_dicts: dict | None,
                    packed: bool, memo: dict | None):
    """Per-block leaf term tables, one probe per distinct dictionary:
    [B, T] key ids, [B, T, R, 2] ranges and, where a staged dictionary's
    device probe answered, [G, T, Vm] hit masks with the block -> group
    map (zero-padded to the widest dictionary, as the reference pads)."""
    import torch

    from .multiblock import _dict_groups

    staged_dicts = staged_dicts or {}
    _fp_of, rep_idx, rows_of = _dict_groups(blocks, memo)
    T = len(terms)
    compiled = {fp: _probe_leaf_terms(blocks[i], terms,
                                      staged_dicts.get(fp), packed)
                for fp, i in rep_idx.items()}
    B = len(blocks)
    R = _pow2(max([1] + [vr.shape[1] for _tk, vr, _vh in compiled.values()
                         if vr is not None]))
    term_keys = np.full((B, T), -1, dtype=np.int32)
    val_ranges = np.tile(np.array([1, 0], dtype=np.int32), (B, T, R, 1))
    for fp, (tk, vr, _vh) in compiled.items():
        rows = np.asarray(rows_of[fp], dtype=np.int64)
        term_keys[rows[:, None], np.arange(T)] = tk
        r_n = vr.shape[1]
        val_ranges[rows[:, None, None], np.arange(T)[:, None],
                   np.arange(r_n)] = vr[:, :r_n]
    probe_fps = [fp for fp, c in compiled.items() if c[2] is not None]
    val_hits = block_group = None
    if probe_fps:
        hs = [compiled[fp][2] for fp in probe_fps]
        Vm = max(int(h.shape[1]) for h in hs)
        val_hits = torch.zeros((len(hs), T, Vm), dtype=hs[0].dtype,
                               device=hs[0].device)
        for g, h in enumerate(hs):
            val_hits[g, :, :h.shape[1]] = h
        block_group = np.full(B, -1, dtype=np.int32)
        for g, fp in enumerate(probe_fps):
            block_group[np.asarray(rows_of[fp], dtype=np.int64)] = g
    return term_keys, val_ranges, val_hits, block_group


_LEAF_CACHE_MAX = 8
# one lock for every block's leaf-probe cache
_leaf_cache_lock = threading.Lock()


def _probe_leaf_terms(block, terms: list, staged_dict, packed: bool):
    """One dictionary's leaf-term probe, memoized on the immutable
    container (8 entries a block): (term_keys [T], val_ranges [T, R, 2],
    val_hits [T, V] or None) under the exhaustive contract (a missing key
    gets id -1, an empty value set the empty ranges). The device probe
    answers when the dictionary is staged and every needle fits it (K3,
    in words with `packed`); otherwise the host walk. Device products
    cache apart from host ones, and per mask format."""
    from . import dict_probe
    from .pipeline import _device_probe_tags, _host_probe_tags

    device = staged_dict is not None and max(
        len(v.encode("utf-8")) for _k, v in terms) \
        <= dict_probe.MAX_NEEDLE_BYTES
    sig = (tuple(terms), device, device and packed)
    with _leaf_cache_lock:
        cache = getattr(block, "_structural_leaf_cache", None)
        if cache is None:
            cache = block._structural_leaf_cache = OrderedDict()
        hit = cache.get(sig)
        if hit is not None:
            cache.move_to_end(sig)
            return hit
    if device:
        out = _device_probe_tags(terms, block.key_dict, staged_dict, True,
                                 packed)
    else:
        out = _host_probe_tags(terms, block.key_dict, block.val_dict, True)
    with _leaf_cache_lock:
        cache[sig] = out
        while len(cache) > _LEAF_CACHE_MAX:
            cache.popitem(last=False)
    return out


# ---------------------------------------------------------------------------
# slot programs: every plan flattens into span rows [opcode, a, b, 0] and
# trace rows [opcode, a, b, c] (a/b table indices for leaves, 1-based
# register indices for combinators, register 0 the all-false dummy; for
# aggregates a is the span register, b the agg_params row, c the compare
# code). Pad slots are opcode 0 and unreachable from the result slot.

_SOP = {"tag": 1, "dur": 2, "kind": 3, "and": 4, "or": 5, "not": 6,
        "child": 7, "desc": 8}
_TOP = {"ttag": 1, "tdur": 2, "exists": 3, "count": 4, "q": 5,
        "and": 6, "or": 7, "not": 8}
_CMPC = {">": 0, ">=": 1, "<": 2, "<=": 3, "==": 4, "!=": 5}


def _flatten_span(plan: tuple, rows: list) -> int:
    """Postorder-flatten a span plan into program rows; returns the
    node's 1-based result register. N-ary and/or binarize into chains."""
    op = plan[0]
    if op in ("tag", "dur", "kind"):
        rows.append([_SOP[op], plan[2], 0, 0])
        return len(rows)
    if op in ("and", "or"):
        r = _flatten_span(plan[2][0], rows)
        for sub in plan[2][1:]:
            r2 = _flatten_span(sub, rows)
            rows.append([_SOP[op], r, r2, 0])
            r = len(rows)
        return r
    if op == "not":
        r = _flatten_span(plan[2], rows)
        rows.append([_SOP["not"], r, 0, 0])
        return len(rows)
    if op in ("child", "desc"):
        ra = _flatten_span(plan[2], rows)
        rb = _flatten_span(plan[3], rows)
        rows.append([_SOP[op], ra, rb, 0])
        return len(rows)
    raise StructuralCompileError(f"bad span plan op {op!r}")


def _flatten_trace(plan: tuple, trows: list, srows: list) -> int:
    op = plan[0]
    if op in ("ttag", "tdur"):
        trows.append([_TOP[op], plan[2], 0, 0])
        return len(trows)
    if op == "exists":
        sr = _flatten_span(plan[2], srows)
        trows.append([_TOP["exists"], sr, 0, 0])
        return len(trows)
    if op in ("count", "q"):
        sr = _flatten_span(plan[4], srows)
        trows.append([_TOP[op], sr, plan[3], _CMPC[plan[2]]])
        return len(trows)
    if op in ("and", "or"):
        r = _flatten_trace(plan[2][0], trows, srows)
        for sub in plan[2][1:]:
            r2 = _flatten_trace(sub, trows, srows)
            trows.append([_TOP[op], r, r2, 0])
            r = len(trows)
        return r
    if op == "not":
        r = _flatten_trace(plan[2], trows, srows)
        trows.append([_TOP["not"], r, 0, 0])
        return len(trows)
    raise StructuralCompileError(f"bad trace plan op {op!r}")


def _flatten_plan(plan: tuple) -> tuple[list, list]:
    """(span_rows, trace_rows) of an exact plan. The final trace row is
    always a root copy, OR(root, root), so the result register is the
    last trace slot whatever the plan's shape."""
    srows: list = []
    trows: list = []
    root = _flatten_trace(plan, trows, srows)
    trows.append([_TOP["or"], root, root, 0])
    return srows, trows


def canonical_bucket(plan: tuple, max_nodes: int) -> tuple | None:
    """An exact plan's bucket descriptor ``("bucket", NS, NT, has_rel)``:
    NS/NT the power-of-two slot tiers of its flattened span/trace
    programs (NT with the root-copy slot), has_rel whether it uses
    child/desc. None when it has more than `max_nodes` slots."""
    try:
        srows, trows = _flatten_plan(plan)
    except (StructuralCompileError, IndexError, KeyError, TypeError):
        return None
    if len(srows) + len(trows) > max(2, int(max_nodes)):
        return None
    NS = _pow2(len(srows)) if srows else 0
    NT = _pow2(len(trows))
    has_rel = any(r[0] in (_SOP["child"], _SOP["desc"]) for r in srows)
    return ("bucket", NS, NT, bool(has_rel))


def _programs(plan: tuple, NS: int | None = None,
              NT: int | None = None) -> tuple:
    """An exact plan's (span [max(1, NS), 4], trace [NT, 4]) programs;
    given a bucket's NS/NT, padded to them with the root copy moved to
    slot NT-1."""
    srows, trows = _flatten_plan(plan)
    NS = len(srows) if NS is None else NS
    NT = len(trows) if NT is None else NT
    sp = np.zeros((max(1, NS), 4), dtype=np.int32)
    if srows:
        sp[:len(srows)] = np.asarray(srows, dtype=np.int32)
    tp = np.zeros((NT, 4), dtype=np.int32)
    if len(trows) > 1:
        tp[:len(trows) - 1] = np.asarray(trows[:-1], dtype=np.int32)
    tp[NT - 1] = trows[-1]
    return sp, tp


def _stack_lanes(sts: list, progs: list) -> Lanes:
    """Lanes from compiled members and their (span, trace) programs, the
    tables padded to the group's powers of two (the reference's
    ``stack_bucketed`` padding)."""
    Q = len(sts)
    B = sts[0].n_blocks
    with_terms = [st for st in sts if st.term_keys is not None]
    Tm = _pow2(max([1] + [st.term_keys.shape[1] for st in with_terms]))
    Rm = _pow2(max([1] + [st.val_ranges.shape[2] for st in with_terms]))
    term_keys = np.full((Q, B, Tm), -1, dtype=np.int32)
    val_ranges = np.tile(np.array([1, 0], dtype=np.int32),
                         (Q, B, Tm, Rm, 1))
    for qi, st in enumerate(sts):
        if st.term_keys is not None:
            vr = st.val_ranges
            term_keys[qi, :, :st.term_keys.shape[1]] = st.term_keys
            val_ranges[qi, :, :vr.shape[1], :vr.shape[2]] = vr

    def padded(name: str, width: tuple, fill, dtype):
        rows = [getattr(st, name) for st in sts]
        n = _pow2(max([1] + [r.shape[0] for r in rows if r is not None]))
        out = np.empty((Q, n) + width, dtype=dtype)
        out[...] = fill
        for qi, r in enumerate(rows):
            if r is not None:
                out[qi, :r.shape[0]] = r
        return out

    val_hits = block_group = None
    if any(st.val_hits is not None for st in sts):
        val_hits = tuple(st.val_hits for st in sts)
        block_group = np.full((Q, B), -1, dtype=np.int32)
        for qi, st in enumerate(sts):
            if st.val_hits is not None:
                block_group[qi] = st.block_group
    NS = max(sp.shape[0] for sp, _tp in progs)
    NT = max(tp.shape[0] for _sp, tp in progs)
    if any(sp.shape[0] != NS or tp.shape[0] != NT for sp, tp in progs):
        raise StructuralCompileError("stacked programs differ in length")
    return Lanes(
        span_prog=np.stack([sp for sp, _tp in progs]),
        trace_prog=np.stack([tp for _sp, tp in progs]),
        term_keys=term_keys, val_ranges=val_ranges,
        dur_params=padded("dur_params", (2,), 0, np.uint32),
        kind_params=padded("kind_params", (), 0, np.int32),
        agg_params=padded("agg_params", (3,),
                          np.array([0, 1, 0], dtype=np.uint32), np.uint32),
        val_hits=val_hits, block_group=block_group)


def stack_structural(sts: list) -> StackedStructural:
    """Stack same-plan compiled predicates, one lane each (the
    reference's ``stack_structural``; every member must share the
    plan)."""
    plan = sts[0].plan
    if any(st.plan != plan for st in sts[1:]):
        raise StructuralCompileError(
            "stacked structural members must share one plan")
    prog = _programs(plan)
    return StackedStructural(plan=plan,
                             lanes=_stack_lanes(sts, [prog] * len(sts)),
                             n_queries=len(sts))


def stack_bucketed(sts: list, desc: tuple) -> BucketedStructural:
    """Stack mixed-plan compiled predicates under one bucket descriptor
    (every member's canonical_bucket must be `desc`): each lane runs its
    member's own program, padded to the bucket's NS/NT."""
    _op, NS, NT, _rel = desc
    progs = [_programs(st.plan, NS, NT) for st in sts]
    active = sum(len(s) + len(t)
                 for s, t in (_flatten_plan(st.plan) for st in sts))
    return BucketedStructural(plan=desc, lanes=_stack_lanes(sts, progs),
                              n_queries=len(sts), active_nodes=active,
                              slot_nodes=len(sts) * (NS + NT))


def stack_members(sts: list, bucket_max_nodes: int):
    """A fused group's structural members stacked: same plan as
    StackedStructural, else all in one bucket as BucketedStructural
    (raising otherwise, as the reference's stack_queries does)."""
    if all(st.plan == sts[0].plan for st in sts[1:]):
        return stack_structural(sts)
    buckets = {canonical_bucket(st.plan, bucket_max_nodes) for st in sts}
    if len(buckets) != 1 or None in buckets:
        raise ValueError("coalesced structural queries must share one plan "
                         "or canonicalize into one bucket shape")
    return stack_bucketed(sts, buckets.pop())


# ---------------------------------------------------------------------------
# host reference evaluator (the port's oracle)


_CMP = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}


def eval_host(expr: "ir.TraceExpr", sd) -> bool:
    """The reference semantics over a SearchData's span rows: substring
    tag terms, inclusive ranges, pointer joins, and the integer
    rank-count quantile (no sort, no float)."""
    spans = list(sd.spans or ())
    n_spans = len(spans)

    def sev(e) -> list:
        if isinstance(e, ir.SpanTag):
            out = []
            for sp in spans:
                vs = sp.kvs.get(e.key)
                out.append(bool(vs) and (not e.value or
                                         any(e.value in x for x in vs)))
            return out
        if isinstance(e, ir.SpanDur):
            return [e.lo_ms <= sp.dur_ms <= e.hi_ms for sp in spans]
        if isinstance(e, ir.SpanKind):
            return [sp.kind == e.kind for sp in spans]
        if isinstance(e, ir.SpanAnd):
            ms = [sev(a) for a in e.args]
            return [all(m[i] for m in ms) for i in range(n_spans)]
        if isinstance(e, ir.SpanOr):
            ms = [sev(a) for a in e.args]
            return [any(m[i] for m in ms) for i in range(n_spans)]
        if isinstance(e, ir.SpanNot):
            return [not v for v in sev(e.arg)]
        if isinstance(e, ir.ChildOf):
            pm, cm = sev(e.parent), sev(e.child)
            return [cm[i] and 0 <= spans[i].parent < n_spans
                    and pm[spans[i].parent] for i in range(n_spans)]
        if isinstance(e, ir.DescOf):
            am, sm = sev(e.anc), sev(e.span)
            out = []
            for i in range(n_spans):
                ok = False
                if sm[i]:
                    p = spans[i].parent
                    # at most n_spans hops: a parent cycle ends
                    for _ in range(n_spans):
                        if not 0 <= p < n_spans:
                            break
                        if am[p]:
                            ok = True
                            break
                        p = spans[p].parent
                out.append(ok)
            return out
        raise StructuralCompileError(
            f"unknown span node {type(e).__name__}")

    def tev(e) -> bool:
        if isinstance(e, ir.TraceTag):
            vs = sd.kvs.get(e.key)
            return bool(vs) and (not e.value
                                 or any(e.value in x for x in vs))
        if isinstance(e, ir.TraceDur):
            return e.lo_ms <= sd.dur_ms <= e.hi_ms
        if isinstance(e, ir.Exists):
            return any(sev(e.of))
        if isinstance(e, ir.Count):
            return _CMP[e.op](sum(sev(e.of)), e.n)
        if isinstance(e, ir.Quantile):
            m = sev(e.of)
            n = sum(m)
            if n == 0:
                return False
            r = (e.q_num * n + e.q_den - 1) // e.q_den
            if e.op in (">", ">="):
                ci = sum(1 for i, v in enumerate(m) if v and
                         (spans[i].dur_ms > e.x_ms if e.op == ">"
                          else spans[i].dur_ms >= e.x_ms))
                return ci >= n - r + 1
            if e.op in ("<", "<="):
                ci = sum(1 for i, v in enumerate(m) if v and
                         (spans[i].dur_ms < e.x_ms if e.op == "<"
                          else spans[i].dur_ms <= e.x_ms))
                return ci >= r
            chi = sum(1 for i, v in enumerate(m)
                      if v and spans[i].dur_ms >= e.x_ms)
            clo = sum(1 for i, v in enumerate(m)
                      if v and spans[i].dur_ms <= e.x_ms)
            eq = (chi >= n - r + 1) and (clo >= r)
            return eq if e.op == "==" else not eq
        if isinstance(e, ir.TraceAnd):
            return all(tev(a) for a in e.args)
        if isinstance(e, ir.TraceOr):
            return any(tev(a) for a in e.args)
        if isinstance(e, ir.TraceNot):
            return not tev(e.arg)
        raise StructuralCompileError(
            f"unknown trace node {type(e).__name__}")

    return tev(expr)
