from .matches import matches, trace_range_ns, trace_search_metadata
from .sort import sort_trace
from .types import (BlockSearchJob, SearchBlocksRequest, SearchMetrics,
                    SearchRequest, SearchResponse, TraceSearchMetadata)

__all__ = ["SearchRequest", "BlockSearchJob", "SearchBlocksRequest",
           "TraceSearchMetadata", "SearchMetrics", "SearchResponse",
           "matches", "trace_range_ns", "trace_search_metadata",
           "sort_trace"]
