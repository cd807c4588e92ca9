# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tempo.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import trace_pb2 as trace__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0btempo.proto\x12\x07tempopb\x1a\x0btrace.proto"D\n\x10PushSpansRequest\x120\n\x07batches\x18\x01 \x03(\x0b2\x1f.tempopb.trace.v1.ResourceSpans"#\n\x10PartialsResponse\x12\x0f\n\x07objects\x18\x01 \x03(\x0c"9\n\x05Trace\x120\n\x07batches\x18\x01 \x03(\x0b2\x1f.tempopb.trace.v1.ResourceSpans"D\n\x10PushBytesRequest\x12\x0e\n\x06traces\x18\x02 \x03(\x0c\x12\x0b\n\x03ids\x18\x03 \x03(\x0c\x12\x13\n\x0bsearch_data\x18\x04 \x03(\x0c"\x0e\n\x0cPushResponse"`\n\x10TraceByIDRequest\x12\x10\n\x08trace_id\x18\x01 \x01(\x0c\x12\x13\n\x0bblock_start\x18\x02 \x01(\t\x12\x11\n\tblock_end\x18\x03 \x01(\t\x12\x12\n\nquery_mode\x18\x05 \x01(\t"^\n\x11TraceByIDResponse\x12\x1d\n\x05trace\x18\x01 \x01(\x0b2\x0e.tempopb.Trace\x12*\n\x07metrics\x18\x02 \x01(\x0b2\x19.tempopb.TraceByIDMetrics")\n\x10TraceByIDMetrics\x12\x15\n\rfailed_blocks\x18\x01 \x01(\r"\xe3\x01\n\rSearchRequest\x12.\n\x04tags\x18\x01 \x03(\x0b2 .tempopb.SearchRequest.TagsEntry\x12\x17\n\x0fmin_duration_ms\x18\x02 \x01(\r\x12\x17\n\x0fmax_duration_ms\x18\x03 \x01(\r\x12\r\n\x05limit\x18\x04 \x01(\r\x12\r\n\x05start\x18\x05 \x01(\r\x12\x0b\n\x03end\x18\x06 \x01(\r\x12\x18\n\x07explain\x18\x07 \x01(\x08R\x07explain\x1a+\n\tTagsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x028\x01"\xa2\x02\n\x12SearchBlockRequest\x12*\n\nsearch_req\x18\x01 \x01(\x0b2\x16.tempopb.SearchRequest\x12\x10\n\x08block_id\x18\x02 \x01(\t\x12\x12\n\nstart_page\x18\x03 \x01(\r\x12\x17\n\x0fpages_to_search\x18\x04 \x01(\r\x12\x10\n\x08encoding\x18\x05 \x01(\t\x12\x17\n\x0findex_page_size\x18\x06 \x01(\r\x12\x15\n\rtotal_records\x18\x07 \x01(\r\x12\x15\n\rdata_encoding\x18\x08 \x01(\t\x12\x0f\n\x07version\x18\t \x01(\t\x12\x11\n\ttenant_id\x18\n \x01(\t\x12\x12\n\nstart_time\x18\x0b \x01(\r\x12\x10\n\x08end_time\x18\x0c \x01(\r"\xaf\x01\n\x0eBlockSearchJob\x12\x10\n\x08block_id\x18\x01 \x01(\t\x12\x12\n\nstart_page\x18\x02 \x01(\r\x12\x17\n\x0fpages_to_search\x18\x03 \x01(\r\x12\x10\n\x08encoding\x18\x04 \x01(\t\x12\x0f\n\x07version\x18\x05 \x01(\t\x12\x15\n\rdata_encoding\x18\x06 \x01(\t\x12\x12\n\nstart_time\x18\x07 \x01(\r\x12\x10\n\x08end_time\x18\x08 \x01(\r"{\n\x13SearchBlocksRequest\x12*\n\nsearch_req\x18\x01 \x01(\x0b2\x16.tempopb.SearchRequest\x12\x11\n\ttenant_id\x18\x02 \x01(\t\x12%\n\x04jobs\x18\x03 \x03(\x0b2\x17.tempopb.BlockSearchJob"g\n\x0eSearchResponse\x12,\n\x06traces\x18\x01 \x03(\x0b2\x1c.tempopb.TraceSearchMetadata\x12\'\n\x07metrics\x18\x02 \x01(\x0b2\x16.tempopb.SearchMetrics"\x8e\x01\n\x13TraceSearchMetadata\x12\x10\n\x08trace_id\x18\x01 \x01(\t\x12\x19\n\x11root_service_name\x18\x02 \x01(\t\x12\x17\n\x0froot_trace_name\x18\x03 \x01(\t\x12\x1c\n\x14start_time_unix_nano\x18\x04 \x01(\x06\x12\x13\n\x0bduration_ms\x18\x05 \x01(\r"\xe2\x02\n\rSearchMetrics\x12\x18\n\x10inspected_traces\x18\x01 \x01(\r\x12\x17\n\x0finspected_bytes\x18\x02 \x01(\x06\x12\x18\n\x10inspected_blocks\x18\x03 \x01(\r\x12\x16\n\x0eskipped_blocks\x18\x04 \x01(\r\x12\x19\n\x11truncated_entries\x18\x05 \x01(\r\x12\x15\n\rfailed_blocks\x18\x06 \x01(\r\x12%\n\x0edevice_seconds\x18\x07 \x01(\x01R\rdeviceSeconds\x124\n\x16inspected_bytes_device\x18\x08 \x01(\x06R\x14inspectedBytesDevice\x12(\n\x10query_stats_json\x18\t \x01(\tR\x0equeryStatsJson\x12\x18\n\x07partial\x18\n \x01(\x08R\x07partial\x12\x19\n\x08agg_json\x18\x0b \x01(\tR\x07aggJson"\x13\n\x11SearchTagsRequest"\'\n\x12SearchTagsResponse\x12\x11\n\ttag_names\x18\x01 \x03(\t"*\n\x16SearchTagValuesRequest\x12\x10\n\x08tag_name\x18\x01 \x01(\t"-\n\x17SearchTagValuesResponse\x12\x12\n\ntag_values\x18\x01 \x03(\t"\xbe\x02\n\nProcessJob\x12\x0e\n\x06job_id\x18\x01 \x01(\x04\x12\x11\n\ttenant_id\x18\x02 \x01(\t\x12\x0c\n\x04kind\x18\x03 \x01(\t\x12.\n\x0btrace_by_id\x18\x04 \x01(\x0b2\x19.tempopb.TraceByIDRequest\x123\n\rsearch_blocks\x18\x05 \x01(\x0b2\x1c.tempopb.SearchBlocksRequest\x12-\n\rsearch_recent\x18\x06 \x01(\x0b2\x16.tempopb.SearchRequest\x12/\n\x0bsearch_tags\x18\x07 \x01(\x0b2\x1a.tempopb.SearchTagsRequest\x12:\n\x11search_tag_values\x18\x08 \x01(\x0b2\x1f.tempopb.SearchTagValuesRequest"\xe3\x01\n\rProcessResult\x12\x0e\n\x06job_id\x18\x01 \x01(\x04\x12\r\n\x05error\x18\x02 \x01(\t\x12)\n\x05trace\x18\x03 \x01(\x0b2\x1a.tempopb.TraceByIDResponse\x12\'\n\x06search\x18\x04 \x01(\x0b2\x17.tempopb.SearchResponse\x12)\n\x04tags\x18\x05 \x01(\x0b2\x1b.tempopb.SearchTagsResponse\x124\n\ntag_values\x18\x06 \x01(\x0b2 .tempopb.SearchTagValuesResponse2\x8c\x01\n\x06Pusher\x12?\n\tPushBytes\x12\x19.tempopb.PushBytesRequest\x1a\x15.tempopb.PushResponse"\x00\x12A\n\x0bPushBytesV2\x12\x19.tempopb.PushBytesRequest\x1a\x15.tempopb.PushResponse"\x002S\n\x10MetricsGenerator\x12?\n\tPushSpans\x12\x19.tempopb.PushSpansRequest\x1a\x15.tempopb.PushResponse"\x002\xc7\x03\n\x07Querier\x12H\n\rFindTraceByID\x12\x19.tempopb.TraceByIDRequest\x1a\x1a.tempopb.TraceByIDResponse"\x00\x12A\n\x0cSearchRecent\x12\x16.tempopb.SearchRequest\x1a\x17.tempopb.SearchResponse"\x00\x12E\n\x0bSearchBlock\x12\x1b.tempopb.SearchBlockRequest\x1a\x17.tempopb.SearchResponse"\x00\x12G\n\x0cSearchBlocks\x12\x1c.tempopb.SearchBlocksRequest\x1a\x17.tempopb.SearchResponse"\x00\x12G\n\nSearchTags\x12\x1a.tempopb.SearchTagsRequest\x1a\x1b.tempopb.SearchTagsResponse"\x00\x12V\n\x0fSearchTagValues\x12\x1f.tempopb.SearchTagValuesRequest\x1a .tempopb.SearchTagValuesResponse"\x002\xb7\x02\n\x0fIngesterQuerier\x12F\n\x0cFindPartials\x12\x19.tempopb.TraceByIDRequest\x1a\x19.tempopb.PartialsResponse"\x00\x12;\n\x06Search\x12\x16.tempopb.SearchRequest\x1a\x17.tempopb.SearchResponse"\x00\x12G\n\nSearchTags\x12\x1a.tempopb.SearchTagsRequest\x1a\x1b.tempopb.SearchTagsResponse"\x00\x12V\n\x0fSearchTagValues\x12\x1f.tempopb.SearchTagValuesRequest\x1a .tempopb.SearchTagValuesResponse"\x002H\n\x08Frontend\x12<\n\x07Process\x12\x16.tempopb.ProcessResult\x1a\x13.tempopb.ProcessJob"\x00(\x010\x01b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tempo_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SEARCHREQUEST_TAGSENTRY._options = None
  _SEARCHREQUEST_TAGSENTRY._serialized_options = b'8\001'
  _PUSHSPANSREQUEST._serialized_start=37
  _PUSHSPANSREQUEST._serialized_end=105
  _PARTIALSRESPONSE._serialized_start=107
  _PARTIALSRESPONSE._serialized_end=142
  _TRACE._serialized_start=144
  _TRACE._serialized_end=201
  _PUSHBYTESREQUEST._serialized_start=203
  _PUSHBYTESREQUEST._serialized_end=271
  _PUSHRESPONSE._serialized_start=273
  _PUSHRESPONSE._serialized_end=287
  _TRACEBYIDREQUEST._serialized_start=289
  _TRACEBYIDREQUEST._serialized_end=385
  _TRACEBYIDRESPONSE._serialized_start=387
  _TRACEBYIDRESPONSE._serialized_end=481
  _TRACEBYIDMETRICS._serialized_start=483
  _TRACEBYIDMETRICS._serialized_end=524
  _SEARCHREQUEST._serialized_start=527
  _SEARCHREQUEST._serialized_end=754
  _SEARCHREQUEST_TAGSENTRY._serialized_start=711
  _SEARCHREQUEST_TAGSENTRY._serialized_end=754
  _SEARCHBLOCKREQUEST._serialized_start=757
  _SEARCHBLOCKREQUEST._serialized_end=1047
  _BLOCKSEARCHJOB._serialized_start=1050
  _BLOCKSEARCHJOB._serialized_end=1225
  _SEARCHBLOCKSREQUEST._serialized_start=1227
  _SEARCHBLOCKSREQUEST._serialized_end=1350
  _SEARCHRESPONSE._serialized_start=1352
  _SEARCHRESPONSE._serialized_end=1455
  _TRACESEARCHMETADATA._serialized_start=1458
  _TRACESEARCHMETADATA._serialized_end=1600
  _SEARCHMETRICS._serialized_start=1603
  _SEARCHMETRICS._serialized_end=1957
  _SEARCHTAGSREQUEST._serialized_start=1959
  _SEARCHTAGSREQUEST._serialized_end=1978
  _SEARCHTAGSRESPONSE._serialized_start=1980
  _SEARCHTAGSRESPONSE._serialized_end=2019
  _SEARCHTAGVALUESREQUEST._serialized_start=2021
  _SEARCHTAGVALUESREQUEST._serialized_end=2063
  _SEARCHTAGVALUESRESPONSE._serialized_start=2065
  _SEARCHTAGVALUESRESPONSE._serialized_end=2110
  _PROCESSJOB._serialized_start=2113
  _PROCESSJOB._serialized_end=2431
  _PROCESSRESULT._serialized_start=2434
  _PROCESSRESULT._serialized_end=2661
  _PUSHER._serialized_start=2664
  _PUSHER._serialized_end=2804
  _METRICSGENERATOR._serialized_start=2806
  _METRICSGENERATOR._serialized_end=2889
  _QUERIER._serialized_start=2892
  _QUERIER._serialized_end=3347
  _INGESTERQUERIER._serialized_start=3350
  _INGESTERQUERIER._serialized_end=3661
  _FRONTEND._serialized_start=3663
  _FRONTEND._serialized_end=3735
# @@protoc_insertion_point(module_scope)
