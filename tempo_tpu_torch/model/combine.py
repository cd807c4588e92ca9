"""Trace combination: partial traces of one id merged into one, spans
deduped by span id (a copy of the reference's ``model/combine.py``).

Partials keep the order they are given in: the first partial's batches
come first, and a span seen again later is dropped."""

from __future__ import annotations

from .. import tempopb


def combine_trace_protos(traces: list[tempopb.Trace]) -> tempopb.Trace:
    if not traces:
        return tempopb.Trace()
    if len(traces) == 1:
        # a copy: callers own the result and may mutate it
        out = tempopb.Trace()
        out.CopyFrom(traces[0])
        return out
    out = tempopb.Trace()
    seen: set[bytes] = set()
    for t in traces:
        for batch in t.batches:
            kept = None
            for ss in batch.scope_spans:
                new_spans = [s for s in ss.spans if _span_key(s) not in seen]
                for s in new_spans:
                    seen.add(_span_key(s))
                if new_spans:
                    if kept is None:
                        kept = out.batches.add()
                        kept.resource.CopyFrom(batch.resource)
                        kept.schema_url = batch.schema_url
                    nss = kept.scope_spans.add()
                    nss.scope.CopyFrom(ss.scope)
                    nss.schema_url = ss.schema_url
                    nss.spans.extend(new_spans)
    return out


def _span_key(span: tempopb.Span) -> bytes:
    return span.span_id or span.SerializeToString()
