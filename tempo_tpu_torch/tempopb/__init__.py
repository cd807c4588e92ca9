"""Wire model: the protoc-generated trace protos and service messages.

``trace_pb2.py`` and ``tempo_pb2.py`` are byte-identical copies of the
reference's generated modules (sources in ``protos/``, regenerate with
``protos/gen.sh``). They register the same serialized files in protobuf's
default descriptor pool, so this package imports beside the reference's in
either order and both name one ``Trace`` class; a copy whose serialized
file differed at all would fail to import next to it ("duplicate file
name"). ``opencensus_pb2`` and ``remote_write_pb2`` come with the
receivers.
"""

from . import tempo_pb2, trace_pb2

Trace = tempo_pb2.Trace
PushBytesRequest = tempo_pb2.PushBytesRequest
PushResponse = tempo_pb2.PushResponse
TraceByIDRequest = tempo_pb2.TraceByIDRequest
TraceByIDResponse = tempo_pb2.TraceByIDResponse
TraceByIDMetrics = tempo_pb2.TraceByIDMetrics
SearchRequest = tempo_pb2.SearchRequest
SearchBlockRequest = tempo_pb2.SearchBlockRequest
SearchBlocksRequest = tempo_pb2.SearchBlocksRequest
BlockSearchJob = tempo_pb2.BlockSearchJob
SearchResponse = tempo_pb2.SearchResponse
TraceSearchMetadata = tempo_pb2.TraceSearchMetadata
SearchMetrics = tempo_pb2.SearchMetrics
SearchTagsRequest = tempo_pb2.SearchTagsRequest
SearchTagsResponse = tempo_pb2.SearchTagsResponse
SearchTagValuesRequest = tempo_pb2.SearchTagValuesRequest
SearchTagValuesResponse = tempo_pb2.SearchTagValuesResponse
PartialsResponse = tempo_pb2.PartialsResponse
ProcessJob = tempo_pb2.ProcessJob
ProcessResult = tempo_pb2.ProcessResult
PushSpansRequest = tempo_pb2.PushSpansRequest

ResourceSpans = trace_pb2.ResourceSpans
ScopeSpans = trace_pb2.ScopeSpans
Span = trace_pb2.Span
Status = trace_pb2.Status
Resource = trace_pb2.Resource
KeyValue = trace_pb2.KeyValue
AnyValue = trace_pb2.AnyValue

__all__ = [
    "Trace", "PushBytesRequest", "PushResponse", "TraceByIDRequest",
    "TraceByIDResponse", "TraceByIDMetrics", "SearchRequest",
    "SearchBlockRequest", "SearchBlocksRequest", "BlockSearchJob",
    "SearchResponse", "TraceSearchMetadata",
    "SearchMetrics", "SearchTagsRequest", "SearchTagsResponse",
    "SearchTagValuesRequest", "SearchTagValuesResponse", "PartialsResponse",
    "ProcessJob", "ProcessResult", "PushSpansRequest",
    "ResourceSpans", "ScopeSpans", "Span", "Status", "Resource",
    "KeyValue", "AnyValue", "trace_pb2", "tempo_pb2",
]
