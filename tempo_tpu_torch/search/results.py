"""Result collection: dedupe, limit, metrics, response ordering.

Counterpart of the reference's ``search/results.py``: a synchronous
collector carrying the SearchMetrics counters, the per-trace combination
rule (earlier start, longer duration, first root names) and the response
order ``(-start, trace_id)``.
"""

from __future__ import annotations

import dataclasses

from ..model.types import SearchMetrics, SearchResponse, TraceSearchMetadata
from .pipeline import is_exhaustive


class SearchResults:
    def __init__(self, limit: int = 20, no_quit: bool = False):
        self.limit = limit
        # no_quit suppresses `complete` so the scan never stops early —
        # set by the exhaustive debug tag
        self.no_quit = no_quit
        self._by_id: dict[str, TraceSearchMetadata] = {}
        self.metrics = SearchMetrics()

    @classmethod
    def for_request(cls, req) -> "SearchResults":
        return cls(limit=req.limit or 20, no_quit=is_exhaustive(req))

    def add(self, meta: TraceSearchMetadata) -> None:
        prev = self._by_id.get(meta.trace_id)
        if prev is None:
            self._by_id[meta.trace_id] = meta
            return
        if meta.start_time_unix_nano and (
            not prev.start_time_unix_nano
            or meta.start_time_unix_nano < prev.start_time_unix_nano
        ):
            prev.start_time_unix_nano = meta.start_time_unix_nano
        prev.duration_ms = max(prev.duration_ms, meta.duration_ms)
        if not prev.root_service_name:
            prev.root_service_name = meta.root_service_name
            prev.root_trace_name = meta.root_trace_name

    @property
    def n_results(self) -> int:
        return len(self._by_id)

    @property
    def complete(self) -> bool:
        return not self.no_quit and len(self._by_id) >= self.limit

    def response(self) -> SearchResponse:
        """Traces by start time, newest first, trace id breaking ties so
        the answer (and its limit cutoff) does not depend on the order in
        which groups drained."""
        metas = sorted(self._by_id.values(),
                       key=lambda m: (-m.start_time_unix_nano, m.trace_id)
                       )[: self.limit]
        return SearchResponse(traces=[dataclasses.replace(m) for m in metas],
                              metrics=dataclasses.replace(self.metrics))
