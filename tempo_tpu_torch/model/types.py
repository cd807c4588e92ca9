"""Search request/response types as plain dataclasses.

The reference carries these as protobuf messages (``tempopb``:
SearchRequest, BlockSearchJob, SearchBlocksRequest, TraceSearchMetadata,
SearchMetrics, SearchResponse in protos/tempo.proto). The port keeps the proto's field names and defaults
but needs no protobuf runtime on the card path; conversion to and from the
wire messages belongs to whoever speaks the wire protocol.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SearchRequest:
    tags: dict = field(default_factory=dict)   # str -> str (substring)
    min_duration_ms: int = 0
    max_duration_ms: int = 0
    limit: int = 0
    start: int = 0   # unix seconds
    end: int = 0     # unix seconds


@dataclass
class BlockSearchJob:
    """One page-range job of a batched request: pages
    [start_page, start_page + pages_to_search) of one block's search
    container (0 pages = to the end), with the block meta fields needed
    to open it without a meta.json read."""
    block_id: str = ""
    start_page: int = 0
    pages_to_search: int = 0
    encoding: str = ""
    version: str = ""
    data_encoding: str = ""
    start_time: int = 0
    end_time: int = 0


@dataclass
class SearchBlocksRequest:
    search_req: SearchRequest = field(default_factory=SearchRequest)
    tenant_id: str = ""
    jobs: list = field(default_factory=list)   # list[BlockSearchJob]


@dataclass
class TraceSearchMetadata:
    trace_id: str = ""
    root_service_name: str = ""
    root_trace_name: str = ""
    start_time_unix_nano: int = 0
    duration_ms: int = 0


@dataclass
class SearchMetrics:
    inspected_traces: int = 0
    inspected_bytes: int = 0
    inspected_blocks: int = 0
    skipped_blocks: int = 0
    truncated_entries: int = 0


@dataclass
class SearchResponse:
    traces: list = field(default_factory=list)   # list[TraceSearchMetadata]
    metrics: SearchMetrics = field(default_factory=SearchMetrics)
