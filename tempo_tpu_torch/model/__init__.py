from .types import (BlockSearchJob, SearchBlocksRequest, SearchMetrics,
                    SearchRequest, SearchResponse, TraceSearchMetadata)

__all__ = ["SearchRequest", "BlockSearchJob", "SearchBlocksRequest",
           "TraceSearchMetadata", "SearchMetrics", "SearchResponse"]
