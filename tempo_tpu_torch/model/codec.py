"""Trace object codecs: how a trace is framed as bytes inside blocks and
the WAL (a copy of the reference's ``model/codec.py``; the bytes are the
same both ways).

- v1: the Trace proto's bytes.
- v2: ``| u32 start | u32 end | Trace proto |``, start and end in unix
  seconds (masked to 32 bits), so a reader gets the range without
  parsing the proto.
- ``SegmentCodec``: the push path's framing, appended without
  re-marshalling.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from .. import tempopb

CURRENT_ENCODING = "v2"
ALL_ENCODINGS = ("v1", "v2")

_HDR = struct.Struct("<II")  # start, end unix seconds


class DecodeError(Exception):
    pass


@dataclass(frozen=True)
class ObjectCodec:
    """Encode and decode one stored trace object."""

    encoding: str

    def marshal(self, trace: tempopb.Trace, start: int = 0,
                end: int = 0) -> bytes:
        body = trace.SerializeToString()
        if self.encoding == "v1":
            return body
        return _HDR.pack(start & 0xFFFFFFFF, end & 0xFFFFFFFF) + body

    def prepare_for_read(self, obj: bytes) -> tempopb.Trace:
        t = tempopb.Trace()
        t.ParseFromString(self.trace_bytes(obj))
        return t

    def trace_bytes(self, obj: bytes) -> bytes:
        if self.encoding == "v1":
            return obj
        if len(obj) < _HDR.size:
            raise DecodeError("v2 object too short")
        return obj[_HDR.size:]

    def fast_range(self, obj: bytes) -> tuple[int, int] | None:
        """(start, end) unix seconds without a proto unmarshal; None for
        v1, which carries no range."""
        if self.encoding == "v1":
            return None
        if len(obj) < _HDR.size:
            raise DecodeError("v2 object too short")
        return _HDR.unpack_from(obj)

    def combine(self, *objs: bytes) -> bytes:
        """One object from partials of the same trace (several blocks or
        segments): spans deduped by span id, ranges merged."""
        from .combine import combine_trace_protos

        objs = [o for o in objs if o]
        if not objs:
            return self.marshal(tempopb.Trace())
        if len(objs) == 1:
            return objs[0]
        ranges = [self.fast_range(o) for o in objs]
        traces = [self.prepare_for_read(o) for o in objs]
        merged = combine_trace_protos(traces)
        if self.encoding == "v1":
            return merged.SerializeToString()
        start = min(r[0] for r in ranges if r)
        end = max(r[1] for r in ranges if r)
        return self.marshal(merged, start, end)


@dataclass(frozen=True)
class SegmentCodec:
    """Push-path framing: segments are marshalled once and appended to
    live traces and the WAL without re-encoding."""

    encoding: str

    def prepare_for_write(self, trace: tempopb.Trace, start: int,
                          end: int) -> bytes:
        return ObjectCodec(self.encoding).marshal(trace, start, end)

    def prepare_for_read(self, segments: list[bytes]) -> tempopb.Trace:
        codec = ObjectCodec(self.encoding)
        out = tempopb.Trace()
        for seg in segments:
            out.batches.extend(codec.prepare_for_read(seg).batches)
        return out

    def to_object(self, segments: list[bytes]) -> bytes:
        """Concatenate segments into one stored object, ranges merged."""
        codec = ObjectCodec(self.encoding)
        if len(segments) == 1:
            return segments[0]
        start, end = 0xFFFFFFFF, 0
        if self.encoding != "v1":
            for seg in segments:
                s, e = codec.fast_range(seg)
                start, end = min(start, s), max(end, e)
        t = self.prepare_for_read(segments)
        return codec.marshal(t, start if start != 0xFFFFFFFF else 0, end)

    def fast_range(self, segment: bytes) -> tuple[int, int] | None:
        return ObjectCodec(self.encoding).fast_range(segment)


def codec_for(encoding: str) -> ObjectCodec:
    if encoding not in ALL_ENCODINGS:
        raise ValueError(f"unknown trace encoding {encoding!r}")
    return ObjectCodec(encoding)


def segment_codec_for(encoding: str) -> SegmentCodec:
    if encoding not in ALL_ENCODINGS:
        raise ValueError(f"unknown trace encoding {encoding!r}")
    return SegmentCodec(encoding)
