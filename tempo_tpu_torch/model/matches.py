"""A search request evaluated against a whole trace proto (a copy of the
reference's ``model/matches.py``).

The fallback scan of blocks without a search container decodes every
trace object and asks ``matches``; ``trace_search_metadata`` renders a
match. Tag values match as substrings of string attributes and exactly
as the string of an int, bool or double; span names count under
``name`` and an error status as ``error=true``; durations are in ms and
the window in unix seconds. A structural request is evaluated on the
host (``structural.eval_host``) over the trace's span rows, under the
database's ``StructuralConfig``: its gate and its span caps.

Protobuf is imported where a proto is walked, not with the module.
"""

from __future__ import annotations

from .types import TraceSearchMetadata


def _attr_matches(kv, want_key: str, want_val: str) -> bool:
    if kv.key != want_key:
        return False
    which = kv.value.WhichOneof("value")
    if which == "string_value":
        return want_val in kv.value.string_value
    if which == "int_value":
        return want_val == str(kv.value.int_value)
    if which == "bool_value":
        return want_val == ("true" if kv.value.bool_value else "false")
    if which == "double_value":
        return want_val == repr(kv.value.double_value)
    return False


def _iter_all_attrs(trace):
    """Resource and span attributes, and per span the derived ``name``
    and, for an error status, ``error=true``."""
    from .. import tempopb

    for batch in trace.batches:
        yield from batch.resource.attributes
        for ss in batch.scope_spans:
            for span in ss.spans:
                yield from span.attributes
                nk = tempopb.KeyValue()
                nk.key = "name"
                nk.value.string_value = span.name
                yield nk
                if span.status.code == tempopb.Status.STATUS_CODE_ERROR:
                    ek = tempopb.KeyValue()
                    ek.key = "error"
                    ek.value.string_value = "true"
                    yield ek


def trace_range_ns(trace) -> tuple[int, int]:
    """(earliest span start, latest span end) in unix ns; (0, 0) when no
    span has an end."""
    start, end = 2**63, 0
    for batch in trace.batches:
        for ss in batch.scope_spans:
            for span in ss.spans:
                start = min(start, span.start_time_unix_nano)
                end = max(end, span.end_time_unix_nano)
    if end == 0:
        return 0, 0
    return start, end


def matches(trace, req, cfg) -> bool:
    """Does `trace` answer `req`? `cfg`: the database's StructuralConfig;
    a structural request raises ValueError when its gate is off."""
    from ..search import structural
    from ..search.pipeline import request_terms

    start_ns, end_ns = trace_range_ns(trace)
    # unclamped, as the reference's matcher: a trace whose spans end
    # before they start has a negative duration here
    dur_ms = (end_ns - start_ns) // 1_000_000
    if req.min_duration_ms and dur_ms < req.min_duration_ms:
        return False
    if req.max_duration_ms and dur_ms > req.max_duration_ms:
        return False
    if req.start and end_ns // 1_000_000_000 < req.start:
        return False
    if req.end and start_ns // 1_000_000_000 > req.end:
        return False
    terms = request_terms(req)
    if terms:
        attrs = list(_iter_all_attrs(trace))
        for k, v in terms:
            if not any(_attr_matches(kv, k, v) for kv in attrs):
                return False
    expr = structural.structural_query(req, cfg)
    if expr is not None:
        from ..search.data import SearchData, _any_value_str, \
            collect_span_rows

        sd = SearchData(dur_ms=min(max(0, dur_ms), 0xFFFFFFFF))
        for kv in _iter_all_attrs(trace):
            v = _any_value_str(kv.value)
            if v:
                sd.kvs.setdefault(kv.key, set()).add(v)
        sd.spans = collect_span_rows(trace, max_spans=cfg.max_spans,
                                     max_kvs=cfg.max_span_kvs)
        if not structural.eval_host(expr, sd):
            return False
    return True


def trace_search_metadata(trace_id: bytes, trace) -> TraceSearchMetadata:
    """A result row: the id, the range, and the root span's service and
    name (the earliest parentless span, else the earliest span)."""
    start_ns, end_ns = trace_range_ns(trace)
    m = TraceSearchMetadata(trace_id=trace_id.hex())
    m.start_time_unix_nano = start_ns if start_ns < 2**63 else 0
    m.duration_ms = min(max(0, end_ns - start_ns) // 1_000_000, 0xFFFFFFFF)
    root, root_service = None, ""
    earliest, earliest_service = None, ""
    for batch in trace.batches:
        svc = ""
        for kv in batch.resource.attributes:
            if kv.key == "service.name":
                svc = kv.value.string_value
        for ss in batch.scope_spans:
            for span in ss.spans:
                t = span.start_time_unix_nano
                if not span.parent_span_id and (
                        root is None or t < root.start_time_unix_nano):
                    root, root_service = span, svc
                if earliest is None or t < earliest.start_time_unix_nano:
                    earliest, earliest_service = span, svc
    if root is None:
        root, root_service = earliest, earliest_service
    if root is not None:
        m.root_trace_name = root.name
        m.root_service_name = root_service
    return m
