"""The distributor's walk over pushed OTLP batches: spans regrouped by
trace id, one search-data record a trace, and the items an ingester takes
(a copy of the reference's ``Distributor._regroup_extract`` and
``regroup_by_trace``, ``modules/distributor.py``; the same traces, the
same search data and the same bytes).

One trace's spans arrive scattered over resource batches. The walk
rebuilds one Trace an id, keeping each span's resource and scope, and in
the same pass collects the trace's tags (first seen first, under the byte
budget), its range and its root. With the structural gate on, a second
walk over each regrouped trace adds its span rows.

This module has the walks only. ``push_items`` runs the native walker
(``ops/native.py`` ``ingest_regroup``, the port's C++ host runtime) over
the serialized batches; ``push_items_plain`` builds the same items from
the Python walk, ``regroup_extract``, which stays as the walker's plain
version and gives a push with an invalid trace id its error. The
``Distributor`` service around them (the ring, write quorum, tenant
overrides and rate limits, the generator's forwarder) comes with the
serving layer. Protobuf is imported where batches are walked.
"""

from __future__ import annotations

from ..ops import native
from ..search.data import (DEFAULT_MAX_SEARCH_BYTES, STATUS_CODE_ERROR,
                           SearchData, _any_value_str, collect_span_rows,
                           encode_search_data)
from ..search.kernels import LaunchCount
from ..search.structural import OFF, StructuralConfig
from ..utils.ids import pad_trace_id, validate_trace_id


def regroup_extract(batches: list, max_search_bytes: int
                    ) -> tuple[dict, int, dict]:
    """``regroup_by_trace`` and ``extract_search_data`` in one walk over
    the spans. Returns (Trace by padded id, span count, SearchData by id
    with its range, duration and root filled in). A batch's resource
    attributes are read once and charged to each trace's budget once, in
    arrival order, where the trace first meets that batch."""
    from .. import tempopb

    out: dict[bytes, object] = {}
    sds: dict[bytes, SearchData] = {}
    budget: dict[bytes, int] = {}
    rng: dict[bytes, list] = {}      # tid -> [start_ns, end_ns]
    root: dict[bytes, tuple] = {}    # tid -> (start, svc, name)
    first: dict[bytes, tuple] = {}   # the earliest child span, if no root
    dest_by: dict[tuple, object] = {}
    dss_by: dict[tuple, object] = {}
    pad_cache: dict[bytes, bytes] = {}
    n_spans = 0
    for bi, batch in enumerate(batches):
        res_kvs = [(kv.key, _any_value_str(kv.value))
                   for kv in batch.resource.attributes]
        svc = ""
        for k, v in res_kvs:
            if k == "service.name":
                svc = v   # the last one wins, as in extract_search_data
        for si, ss in enumerate(batch.scope_spans):
            for span in ss.spans:
                raw = span.trace_id
                tid = pad_cache.get(raw)
                if tid is None:
                    validate_trace_id(raw)
                    tid = pad_cache[raw] = pad_trace_id(raw)
                n_spans += 1
                sd = sds.get(tid)
                if sd is None:
                    sd = sds[tid] = SearchData(trace_id=tid)
                    budget[tid] = max_search_bytes
                    rng[tid] = [2**63, 0]
                kvs = sd.kvs
                b = budget[tid]
                dss = dss_by.get((tid, bi, si))
                if dss is None:
                    trace = out.get(tid)
                    if trace is None:
                        trace = out[tid] = tempopb.Trace()
                    dest = dest_by.get((tid, bi))
                    if dest is None:
                        dest = trace.batches.add()
                        dest.resource.CopyFrom(batch.resource)
                        dest.schema_url = batch.schema_url
                        dest_by[(tid, bi)] = dest
                        for k, v in res_kvs:   # once a (trace, batch)
                            if v:
                                cost = len(k) + len(v)
                                if b >= cost:
                                    s = kvs.get(k)
                                    if s is None:
                                        s = kvs[k] = set()
                                    if v not in s:
                                        s.add(v)
                                        b -= cost
                    dss = dest.scope_spans.add()
                    dss.scope.CopyFrom(ss.scope)
                    dss.schema_url = ss.schema_url
                    dss_by[(tid, bi, si)] = dss
                dss.spans.append(span)

                st = span.start_time_unix_nano
                en = span.end_time_unix_nano
                r = rng[tid]
                if st < r[0]:
                    r[0] = st
                if en > r[1]:
                    r[1] = en

                v = span.name
                if v:
                    cost = 4 + len(v)
                    if b >= cost:
                        s = kvs.get("name")
                        if s is None:
                            s = kvs["name"] = set()
                        if v not in s:
                            s.add(v)
                            b -= cost
                if span.status.code == STATUS_CODE_ERROR and b >= 9:
                    s = kvs.get("error")
                    if s is None:
                        s = kvs["error"] = set()
                    if "true" not in s:
                        s.add("true")
                        b -= 9
                for kv in span.attributes:
                    v = _any_value_str(kv.value)
                    if v:
                        k = kv.key
                        cost = len(k) + len(v)
                        if b >= cost:
                            s = kvs.get(k)
                            if s is None:
                                s = kvs[k] = set()
                            if v not in s:
                                s.add(v)
                                b -= cost
                budget[tid] = b

                if not span.parent_span_id:
                    prev = root.get(tid)
                    if prev is None or st < prev[0]:
                        root[tid] = (st, svc, span.name)
                else:
                    prev = first.get(tid)
                    if prev is None or st < prev[0]:
                        first[tid] = (st, svc, span.name)

    for tid, sd in sds.items():
        start_ns, end_ns = rng[tid]
        if end_ns == 0:
            start_ns = 0   # no span has an end: trace_range_ns's (0, 0)
        sd.start_s = start_ns // 1_000_000_000
        sd.end_s = end_ns // 1_000_000_000
        # clock skew can put the end before the start: the duration
        # clamps to 0, as extract_search_data's
        sd.dur_ms = (min(max(0, end_ns - start_ns) // 1_000_000, 0xFFFFFFFF)
                     if end_ns else 0)
        r = root.get(tid) or first.get(tid)
        if r is not None:
            sd.root_service, sd.root_name = r[1], r[2]
    return out, n_spans, sds


def regroup_by_trace(batches: list) -> tuple[dict, int]:
    """Spans regrouped by trace id, without search data. Returns (Trace by
    padded id, span count). A destination is found by the source's batch
    and scope position, so a resource repeated in the input becomes two
    batches of the trace, as in the reference."""
    from .. import tempopb

    out: dict[bytes, object] = {}
    dest_by: dict[tuple, object] = {}   # (tid, batch) -> ResourceSpans
    dss_by: dict[tuple, object] = {}    # (tid, batch, scope) -> ScopeSpans
    pad_cache: dict[bytes, bytes] = {}
    n_spans = 0
    for bi, batch in enumerate(batches):
        for si, ss in enumerate(batch.scope_spans):
            for span in ss.spans:
                raw = span.trace_id
                tid = pad_cache.get(raw)
                if tid is None:
                    validate_trace_id(raw)
                    tid = pad_cache[raw] = pad_trace_id(raw)
                n_spans += 1
                dss = dss_by.get((tid, bi, si))
                if dss is None:
                    trace = out.get(tid)
                    if trace is None:
                        trace = out[tid] = tempopb.Trace()
                    dest = dest_by.get((tid, bi))
                    if dest is None:
                        dest = trace.batches.add()
                        dest.resource.CopyFrom(batch.resource)
                        dest.schema_url = batch.schema_url
                        dest_by[(tid, bi)] = dest
                    dss = dest.scope_spans.add()
                    dss.scope.CopyFrom(ss.scope)
                    dss.schema_url = ss.schema_url
                    dss_by[(tid, bi, si)] = dss
                dss.spans.append(span)
    return out, n_spans


# pushes the native walker regrouped (push_items' calls that returned its
# items, not the Python walk's)
NATIVE_WALKS = LaunchCount()


def push_items(batches: list,
               max_search_bytes: int = DEFAULT_MAX_SEARCH_BYTES,
               structural_cfg: StructuralConfig = OFF) -> tuple[list, int]:
    """What a push hands its ingesters: ``(tid, start_s, end_s, segment,
    search_data_bytes)`` a trace, in first-seen order, and the span count.
    The segment is the regrouped trace in the v2 push framing; with
    `structural_cfg`'s gate on, the search data carries span rows under
    its caps. The native walker builds them from the serialized batches,
    byte for byte ``push_items_plain``'s; a span with an invalid trace id
    sends the push through the Python walk, which raises its error, as the
    reference's distributor does."""
    blobs = [b.SerializeToString() for b in batches]
    try:
        n_spans, items, _summaries = native.ingest_regroup(
            blobs, max_search_bytes, spans=structural_cfg.enabled,
            max_spans=structural_cfg.max_spans,
            max_span_kvs=structural_cfg.max_span_kvs)
    except native.InvalidTraceId:
        return push_items_plain(batches, max_search_bytes, structural_cfg)
    NATIVE_WALKS.bump()
    return items, n_spans


def push_items_plain(batches: list,
                     max_search_bytes: int = DEFAULT_MAX_SEARCH_BYTES,
                     structural_cfg: StructuralConfig = OFF
                     ) -> tuple[list, int]:
    """``push_items`` from the Python walk (``regroup_extract``, then
    ``collect_span_rows`` over each regrouped trace with the gate on)."""
    from ..model.codec import CURRENT_ENCODING, segment_codec_for

    codec = segment_codec_for(CURRENT_ENCODING)
    by_trace, n_spans, sds = regroup_extract(batches, max_search_bytes)
    if structural_cfg.enabled:
        for tid, trace in by_trace.items():
            sds[tid].spans = collect_span_rows(
                trace, max_spans=structural_cfg.max_spans,
                max_kvs=structural_cfg.max_span_kvs)
    items = []
    for tid, trace in by_trace.items():
        sd = sds[tid]
        items.append((tid, sd.start_s, sd.end_s,
                      codec.prepare_for_write(trace, sd.start_s, sd.end_s),
                      encode_search_data(sd)))
    return items, n_spans
