"""Result collection: dedupe, limit, metrics, response ordering.

Counterpart of the reference's ``search/results.py``: a synchronous
collector carrying the SearchMetrics counters, the per-trace combination
rule (earlier start, longer duration, first root names), the ``?agg=``
aggregate merged group by group, and the response order
``(-start, trace_id)``.
"""

from __future__ import annotations

import dataclasses
import json

from ..model.types import SearchMetrics, SearchResponse, TraceSearchMetadata
from .analytics import agg_requested, agg_response, merge_agg
from .pipeline import is_exhaustive


class SearchResults:
    def __init__(self, limit: int = 20, no_quit: bool = False):
        self.limit = limit
        # no_quit suppresses `complete` so the scan never stops early —
        # set by the exhaustive debug tag
        self.no_quit = no_quit
        self._by_id: dict[str, TraceSearchMetadata] = {}
        self.metrics = SearchMetrics()
        # the ?agg= payload (analytics.agg_response), merged across groups
        self.agg: dict | None = None

    @classmethod
    def for_request(cls, req) -> "SearchResults":
        """An aggregate must see every group, so a request carrying the
        ?agg= tag never quits early, whatever its database's gate (as
        the reference's collector)."""
        return cls(limit=req.limit or 20,
                   no_quit=is_exhaustive(req) or agg_requested(req))

    def add_agg(self, series: dict) -> None:
        """Fold one dispatch's decoded series (AggStage.decode) in."""
        self.agg = merge_agg(self.agg, agg_response(series))

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
        which groups drained; the aggregate as JSON with sorted keys, for
        the same reason."""
        metas = sorted(self._by_id.values(),
                       key=lambda m: (-m.start_time_unix_nano, m.trace_id)
                       )[: self.limit]
        metrics = dataclasses.replace(self.metrics)
        if self.agg is not None:
            metrics.agg_json = json.dumps(self.agg, sort_keys=True)
        return SearchResponse(traces=[dataclasses.replace(m) for m in metas],
                              metrics=metrics)
