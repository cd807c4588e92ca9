"""Per-trace search data: its extraction from a trace proto, and its
wire codec.

Counterpart of the reference's ``search/data.py``. For each trace it
records the tag key -> values map (resource and span attributes, span
names under ``name``, ``error`` for error-status spans) under a byte
budget, the time range, and the root service and span name that render a
result without decoding the trace; with the structural gate on, one row a
span too (``collect_span_rows``). It holds the merge of a trace's
micro-batches (``SearchData.merge``, ``clone_search_data``) and the host
predicate ``search_data_matches`` that the WAL head's walk and the tail
subscriptions evaluate. Protobuf is imported where a proto is walked, so
the search path needs none. Wire format, little-endian, length-prefixed:

  | u32 start_s | u32 end_s | u32 dur_ms | u16 root_svc_len | root_svc
  | u16 root_name_len | root_name | u16 n_keys |
  per key: | u16 key_len | key | u16 n_vals | (u16 val_len | val)* |

followed, only when the trace carries span rows (the structural engine's
substrate, ``SpanData``), by the optional span section:

  | u16 n_spans | per span: u16 parent (0xFFFF = -1) | u32 dur_ms
  | u8 kind | u16 n_keys | per key as above |

A payload without spans ends at the kv map, byte-identical to the legacy
form; the decoder detects the section by the bytes left after the map.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

_U32 = struct.Struct("<I")
_U16 = struct.Struct("<H")

# tag bytes kept a trace (keys and values), the reference's
# max_search_bytes_per_trace default
DEFAULT_MAX_SEARCH_BYTES = 5 << 10
# span rows a trace, and kv pairs a span, captured for the structural
# engine (StructuralConfig.max_spans / max_span_kvs override them)
DEFAULT_MAX_SPANS = 512
DEFAULT_MAX_SPAN_KVS = 16
STATUS_CODE_ERROR = 2   # tempopb.Status.STATUS_CODE_ERROR


@dataclass
class SpanData:
    """One span's summary row for the structural engine: its parent's
    index within the trace's span list (-1 = a root or unknown parent),
    duration, OTLP kind and the span-level kv set."""
    parent: int = -1
    dur_ms: int = 0
    kind: int = 0
    kvs: dict = field(default_factory=dict)  # str -> set[str]


@dataclass
class SearchData:
    trace_id: bytes = b""
    start_s: int = 0
    end_s: int = 0
    dur_ms: int = 0
    root_service: str = ""
    root_name: str = ""
    kvs: dict = field(default_factory=dict)  # str -> set[str]
    spans: list = field(default_factory=list)  # list[SpanData]

    @property
    def start_ns(self) -> int:
        # the columnar format keeps seconds; results carry start_s * 1e9
        return self.start_s * 1_000_000_000

    def merge(self, other: "SearchData") -> None:
        """Fold a later micro-batch of the same trace in: earliest start,
        latest end, longest duration, the first root names, the union of
        the tag values, and the span rows appended with their parents
        shifted by the rows already here (a parent in another batch is
        not known from the summaries: it stays -1)."""
        if other.start_s and (not self.start_s
                              or other.start_s < self.start_s):
            self.start_s = other.start_s
        if other.end_s > self.end_s:
            self.end_s = other.end_s
        self.dur_ms = max(self.dur_ms, other.dur_ms)
        if not self.root_service and other.root_service:
            self.root_service = other.root_service
            self.root_name = other.root_name
        for k, vs in other.kvs.items():
            self.kvs.setdefault(k, set()).update(vs)
        base = len(self.spans)
        for sp in other.spans:
            self.spans.append(SpanData(
                parent=sp.parent + base if sp.parent >= 0 else -1,
                dur_ms=sp.dur_ms, kind=sp.kind,
                kvs={k: set(vs) for k, vs in sp.kvs.items()}))


def clone_search_data(sd: SearchData) -> SearchData:
    """Copy-on-write clone for the merge-on-append stores (live tier, WAL
    head): the store replaces its entry with a merged clone, so an entry
    once published never changes and a reader may build from a snapshot
    of references outside the store's lock. Span rows are shared (a merge
    appends rows, it never changes one)."""
    return SearchData(
        trace_id=sd.trace_id, start_s=sd.start_s, end_s=sd.end_s,
        dur_ms=sd.dur_ms, root_service=sd.root_service,
        root_name=sd.root_name,
        kvs={k: set(v) for k, v in sd.kvs.items()}, spans=list(sd.spans))


def extract_search_data(trace_id: bytes, trace,
                        max_bytes: int = DEFAULT_MAX_SEARCH_BYTES,
                        range_ns: tuple[int, int] | None = None,
                        spans: bool = False) -> SearchData:
    """One trace's search data. Tag values are kept first seen first
    while a key and value fit in `max_bytes` (each distinct value once).
    `range_ns`: the trace's (start_ns, end_ns) when the caller has it.
    A trace whose spans end before they start gets a duration of 0 (clock
    skew is valid input). The root is the earliest parentless span, else
    the earliest span. With `spans`, the span rows too (the structural
    gate's walk), under the default caps."""
    sd = SearchData(trace_id=trace_id)
    if range_ns is None:
        from ..model.matches import trace_range_ns

        range_ns = trace_range_ns(trace)
    start_ns, end_ns = range_ns
    sd.start_s = start_ns // 1_000_000_000
    sd.end_s = end_ns // 1_000_000_000
    sd.dur_ms = (min(max(0, end_ns - start_ns) // 1_000_000, 0xFFFFFFFF)
                 if end_ns else 0)

    budget = max_bytes
    root = None
    kvs = sd.kvs
    any_str = _any_value_str
    for batch in trace.batches:
        svc = ""
        for kv in batch.resource.attributes:
            v = any_str(kv.value)
            k = kv.key
            if v:
                cost = len(k) + len(v)
                if budget >= cost:
                    s = kvs.get(k)
                    if s is None:
                        s = kvs[k] = set()
                    if v not in s:
                        s.add(v)
                        budget -= cost
            if k == "service.name":
                svc = v
        for ss in batch.scope_spans:
            for span in ss.spans:
                v = span.name
                if v:
                    cost = 4 + len(v)
                    if budget >= cost:
                        s = kvs.get("name")
                        if s is None:
                            s = kvs["name"] = set()
                        if v not in s:
                            s.add(v)
                            budget -= cost
                if span.status.code == STATUS_CODE_ERROR and budget >= 9:
                    s = kvs.get("error")
                    if s is None:
                        s = kvs["error"] = set()
                    if "true" not in s:
                        s.add("true")
                        budget -= 9
                for kv in span.attributes:
                    v = any_str(kv.value)
                    if v:
                        k = kv.key
                        cost = len(k) + len(v)
                        if budget >= cost:
                            s = kvs.get(k)
                            if s is None:
                                s = kvs[k] = set()
                            if v not in s:
                                s.add(v)
                                budget -= cost
                if not span.parent_span_id and (
                        root is None or span.start_time_unix_nano < root[0]):
                    root = (span.start_time_unix_nano, svc, span.name)
    if root is None:
        # no parentless span: the earliest span overall
        for batch in trace.batches:
            svc = ""
            for kv in batch.resource.attributes:
                if kv.key == "service.name":
                    svc = kv.value.string_value
            for ss in batch.scope_spans:
                for span in ss.spans:
                    if root is None or span.start_time_unix_nano < root[0]:
                        root = (span.start_time_unix_nano, svc, span.name)
    if root is not None:
        sd.root_service, sd.root_name = root[1], root[2]
    if spans:
        sd.spans = collect_span_rows(trace)
    return sd


def collect_span_rows(trace, max_spans: int = DEFAULT_MAX_SPANS,
                      max_kvs: int = DEFAULT_MAX_SPAN_KVS) -> list:
    """One SpanData row a span, in walk order, at most `max_spans`, with
    parents resolved by span id (a span is never its own parent). A row's
    kvs: its resource's ``service.name``, ``name``, ``error`` and its
    attributes, at most `max_kvs` keys."""
    rows: list[SpanData] = []
    idx_of: dict[bytes, int] = {}       # span id -> row index
    parents: list[bytes] = []           # raw parent ids, resolved after
    for batch in trace.batches:
        svc = ""
        for kv in batch.resource.attributes:
            if kv.key == "service.name":
                svc = kv.value.string_value
        for ss in batch.scope_spans:
            for span in ss.spans:
                if len(rows) >= max_spans:
                    break
                st, en = span.start_time_unix_nano, span.end_time_unix_nano
                sp = SpanData(
                    parent=-1,
                    dur_ms=min(max(0, en - st) // 1_000_000, 0xFFFFFFFF)
                    if en else 0,
                    kind=int(span.kind))
                kvs = sp.kvs
                n_kv = 0
                if svc:
                    kvs["service.name"] = {svc}
                    n_kv += 1
                if span.name and n_kv < max_kvs:
                    kvs["name"] = {span.name}
                    n_kv += 1
                if span.status.code == STATUS_CODE_ERROR and n_kv < max_kvs:
                    kvs["error"] = {"true"}
                    n_kv += 1
                for kv in span.attributes:
                    if n_kv >= max_kvs:
                        break
                    v = _any_value_str(kv.value)
                    if v:
                        kvs.setdefault(kv.key, set()).add(v)
                        n_kv += 1
                if span.span_id:
                    idx_of.setdefault(bytes(span.span_id), len(rows))
                parents.append(bytes(span.parent_span_id))
                rows.append(sp)
    for i, pid in enumerate(parents):
        if pid:
            pi = idx_of.get(pid)
            if pi is not None and pi != i:
                rows[i].parent = pi
    return rows


def _any_value_str(v) -> str:
    """An AnyValue as the string the search matches: strings as they are,
    ints in decimal, bools as true/false, doubles by repr; "" for the
    other kinds."""
    which = v.WhichOneof("value")
    if which == "string_value":
        return v.string_value
    if which == "int_value":
        return str(v.int_value)
    if which == "bool_value":
        return "true" if v.bool_value else "false"
    if which == "double_value":
        return repr(v.double_value)
    return ""


def search_data_matches(sd: SearchData, req, cfg) -> bool:
    """The host predicate over one trace's search data, the kernels'
    semantics: durations in ms, the window in seconds, tag values as
    substrings; the in-band tags (exhaustive, structural, agg) are no
    predicates. A structural request is evaluated by
    ``structural.eval_host`` under the database's StructuralConfig `cfg`
    (ValueError when its gate is off)."""
    if req.min_duration_ms and sd.dur_ms < req.min_duration_ms:
        return False
    if req.max_duration_ms and sd.dur_ms > req.max_duration_ms:
        return False
    if req.start and sd.end_s < req.start:
        return False
    if req.end and sd.start_s > req.end:
        return False
    from . import structural
    from .pipeline import request_terms

    for k, v in request_terms(req):
        vs = sd.kvs.get(k)
        if not vs:
            return False
        if v and not any(v in x for x in vs):
            return False
    expr = structural.structural_query(req, cfg)
    return expr is None or structural.eval_host(expr, sd)


def _put_kvs(out: bytearray, kvs: dict) -> None:
    keys = sorted(kvs)
    out += _U16.pack(len(keys))
    for k in keys:
        kb = k.encode("utf-8")[:0xFFFF]
        out += _U16.pack(len(kb)) + kb
        vals = sorted(kvs[k])
        out += _U16.pack(len(vals))
        for v in vals:
            vb = v.encode("utf-8")[:0xFFFF]
            out += _U16.pack(len(vb)) + vb


def encode_search_data(sd: SearchData) -> bytes:
    out = bytearray()
    out += _U32.pack(sd.start_s & 0xFFFFFFFF)
    out += _U32.pack(sd.end_s & 0xFFFFFFFF)
    out += _U32.pack(min(sd.dur_ms, 0xFFFFFFFF))
    for s in (sd.root_service, sd.root_name):
        b = s.encode("utf-8")[:0xFFFF]
        out += _U16.pack(len(b)) + b
    _put_kvs(out, sd.kvs)
    if sd.spans:
        spans = sd.spans[:0xFFFF]
        out += _U16.pack(len(spans))
        for sp in spans:
            out += _U16.pack(sp.parent if 0 <= sp.parent < 0xFFFF
                             else 0xFFFF)
            out += _U32.pack(min(sp.dur_ms, 0xFFFFFFFF))
            out.append(sp.kind & 0xFF)
            _put_kvs(out, sp.kvs)
    return bytes(out)


def decode_search_data(buf: bytes, trace_id: bytes = b"") -> SearchData:
    off = 0

    def u32():
        nonlocal off
        (v,) = _U32.unpack_from(buf, off)
        off += 4
        return v

    def u16():
        nonlocal off
        (v,) = _U16.unpack_from(buf, off)
        off += 2
        return v

    def s():
        nonlocal off
        n = u16()
        v = buf[off:off + n].decode("utf-8", errors="replace")
        off += n
        return v

    def kvs() -> dict:
        out = {}
        for _ in range(u16()):
            k = s()
            out[k] = {s() for _ in range(u16())}
        return out

    sd = SearchData(trace_id=trace_id)
    sd.start_s, sd.end_s, sd.dur_ms = u32(), u32(), u32()
    sd.root_service, sd.root_name = s(), s()
    sd.kvs = kvs()
    if off < len(buf):
        for _ in range(u16()):
            p = u16()
            sp = SpanData(parent=-1 if p == 0xFFFF else p, dur_ms=u32(),
                          kind=buf[off])
            off += 1
            sp.kvs = kvs()
            sd.spans.append(sp)
    return sd
