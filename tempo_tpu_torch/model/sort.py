"""Span sorting by start time (a copy of the reference's
``model/sort.py``)."""

from __future__ import annotations


def sort_trace(trace):
    """Sort each scope's spans by start time, in place (a stable sort);
    returns `trace`."""
    for batch in trace.batches:
        for ss in batch.scope_spans:
            spans = sorted(ss.spans, key=lambda s: s.start_time_unix_nano)
            del ss.spans[:]
            ss.spans.extend(spans)
    return trace
