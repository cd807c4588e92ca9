# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: trace.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0btrace.proto\x12\x10tempopb.trace.v1\"\xf2\x01\n\x08\x41nyValue\x12\x16\n\x0cstring_value\x18\x01 \x01(\tH\x00\x12\x14\n\nbool_value\x18\x02 \x01(\x08H\x00\x12\x13\n\tint_value\x18\x03 \x01(\x03H\x00\x12\x16\n\x0c\x64ouble_value\x18\x04 \x01(\x01H\x00\x12\x33\n\x0b\x61rray_value\x18\x05 \x01(\x0b\x32\x1c.tempopb.trace.v1.ArrayValueH\x00\x12\x36\n\x0ckvlist_value\x18\x06 \x01(\x0b\x32\x1e.tempopb.trace.v1.KeyValueListH\x00\x12\x15\n\x0b\x62ytes_value\x18\x07 \x01(\x0cH\x00\x42\x07\n\x05value\"8\n\nArrayValue\x12*\n\x06values\x18\x01 \x03(\x0b\x32\x1a.tempopb.trace.v1.AnyValue\":\n\x0cKeyValueList\x12*\n\x06values\x18\x01 \x03(\x0b\x32\x1a.tempopb.trace.v1.KeyValue\"B\n\x08KeyValue\x12\x0b\n\x03key\x18\x01 \x01(\t\x12)\n\x05value\x18\x02 \x01(\x0b\x32\x1a.tempopb.trace.v1.AnyValue\"5\n\x14InstrumentationScope\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\"\\\n\x08Resource\x12.\n\nattributes\x18\x01 \x03(\x0b\x32\x1a.tempopb.trace.v1.KeyValue\x12 \n\x18\x64ropped_attributes_count\x18\x02 \x01(\r\"\x84\x01\n\rResourceSpans\x12,\n\x08resource\x18\x01 \x01(\x0b\x32\x1a.tempopb.trace.v1.Resource\x12\x31\n\x0bscope_spans\x18\x02 \x03(\x0b\x32\x1c.tempopb.trace.v1.ScopeSpans\x12\x12\n\nschema_url\x18\x03 \x01(\t\"~\n\nScopeSpans\x12\x35\n\x05scope\x18\x01 \x01(\x0b\x32&.tempopb.trace.v1.InstrumentationScope\x12%\n\x05spans\x18\x02 \x03(\x0b\x32\x16.tempopb.trace.v1.Span\x12\x12\n\nschema_url\x18\x03 \x01(\t\"\x8e\x07\n\x04Span\x12\x10\n\x08trace_id\x18\x01 \x01(\x0c\x12\x0f\n\x07span_id\x18\x02 \x01(\x0c\x12\x13\n\x0btrace_state\x18\x03 \x01(\t\x12\x16\n\x0eparent_span_id\x18\x04 \x01(\x0c\x12\x0c\n\x04name\x18\x05 \x01(\t\x12-\n\x04kind\x18\x06 \x01(\x0e\x32\x1f.tempopb.trace.v1.Span.SpanKind\x12\x1c\n\x14start_time_unix_nano\x18\x07 \x01(\x06\x12\x1a\n\x12\x65nd_time_unix_nano\x18\x08 \x01(\x06\x12.\n\nattributes\x18\t \x03(\x0b\x32\x1a.tempopb.trace.v1.KeyValue\x12 \n\x18\x64ropped_attributes_count\x18\n \x01(\r\x12,\n\x06\x65vents\x18\x0b \x03(\x0b\x32\x1c.tempopb.trace.v1.Span.Event\x12\x1c\n\x14\x64ropped_events_count\x18\x0c \x01(\r\x12*\n\x05links\x18\r \x03(\x0b\x32\x1b.tempopb.trace.v1.Span.Link\x12\x1b\n\x13\x64ropped_links_count\x18\x0e \x01(\r\x12(\n\x06status\x18\x0f \x01(\x0b\x32\x18.tempopb.trace.v1.Status\x1a\x7f\n\x05\x45vent\x12\x16\n\x0etime_unix_nano\x18\x01 \x01(\x06\x12\x0c\n\x04name\x18\x02 \x01(\t\x12.\n\nattributes\x18\x03 \x03(\x0b\x32\x1a.tempopb.trace.v1.KeyValue\x12 \n\x18\x64ropped_attributes_count\x18\x04 \x01(\r\x1a\x90\x01\n\x04Link\x12\x10\n\x08trace_id\x18\x01 \x01(\x0c\x12\x0f\n\x07span_id\x18\x02 \x01(\x0c\x12\x13\n\x0btrace_state\x18\x03 \x01(\t\x12.\n\nattributes\x18\x04 \x03(\x0b\x32\x1a.tempopb.trace.v1.KeyValue\x12 \n\x18\x64ropped_attributes_count\x18\x05 \x01(\r\"\x99\x01\n\x08SpanKind\x12\x19\n\x15SPAN_KIND_UNSPECIFIED\x10\x00\x12\x16\n\x12SPAN_KIND_INTERNAL\x10\x01\x12\x14\n\x10SPAN_KIND_SERVER\x10\x02\x12\x14\n\x10SPAN_KIND_CLIENT\x10\x03\x12\x16\n\x12SPAN_KIND_PRODUCER\x10\x04\x12\x16\n\x12SPAN_KIND_CONSUMER\x10\x05\"\xa2\x01\n\x06Status\x12\x0f\n\x07message\x18\x02 \x01(\t\x12\x31\n\x04\x63ode\x18\x03 \x01(\x0e\x32#.tempopb.trace.v1.Status.StatusCode\"N\n\nStatusCode\x12\x15\n\x11STATUS_CODE_UNSET\x10\x00\x12\x12\n\x0eSTATUS_CODE_OK\x10\x01\x12\x15\n\x11STATUS_CODE_ERROR\x10\x02J\x04\x08\x01\x10\x02\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'trace_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ANYVALUE._serialized_start=34
  _ANYVALUE._serialized_end=276
  _ARRAYVALUE._serialized_start=278
  _ARRAYVALUE._serialized_end=334
  _KEYVALUELIST._serialized_start=336
  _KEYVALUELIST._serialized_end=394
  _KEYVALUE._serialized_start=396
  _KEYVALUE._serialized_end=462
  _INSTRUMENTATIONSCOPE._serialized_start=464
  _INSTRUMENTATIONSCOPE._serialized_end=517
  _RESOURCE._serialized_start=519
  _RESOURCE._serialized_end=611
  _RESOURCESPANS._serialized_start=614
  _RESOURCESPANS._serialized_end=746
  _SCOPESPANS._serialized_start=748
  _SCOPESPANS._serialized_end=874
  _SPAN._serialized_start=877
  _SPAN._serialized_end=1787
  _SPAN_EVENT._serialized_start=1357
  _SPAN_EVENT._serialized_end=1484
  _SPAN_LINK._serialized_start=1487
  _SPAN_LINK._serialized_end=1631
  _SPAN_SPANKIND._serialized_start=1634
  _SPAN_SPANKIND._serialized_end=1787
  _STATUS._serialized_start=1790
  _STATUS._serialized_end=1952
  _STATUS_STATUSCODE._serialized_start=1868
  _STATUS_STATUSCODE._serialized_end=1946
# @@protoc_insertion_point(module_scope)
