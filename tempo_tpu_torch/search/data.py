"""Per-trace search data and its wire codec.

Counterpart of the reference's ``search/data.py`` without the proto
extraction (the port reads search blocks; it does not ingest traces).
Wire format, little-endian, length-prefixed:

  | u32 start_s | u32 end_s | u32 dur_ms | u16 root_svc_len | root_svc
  | u16 root_name_len | root_name | u16 n_keys |
  per key: | u16 key_len | key | u16 n_vals | (u16 val_len | val)* |

followed, only when the trace carries span rows (the structural engine's
substrate, ``SpanData``), by the optional span section:

  | u16 n_spans | per span: u16 parent (0xFFFF = -1) | u32 dur_ms
  | u8 kind | u16 n_keys | per key as above |

A payload without spans ends at the kv map, byte-identical to the legacy
form; the decoder detects the section by the bytes left after the map.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

_U32 = struct.Struct("<I")
_U16 = struct.Struct("<H")


@dataclass
class SpanData:
    """One span's summary row for the structural engine: its parent's
    index within the trace's span list (-1 = a root or unknown parent),
    duration, OTLP kind and the span-level kv set."""
    parent: int = -1
    dur_ms: int = 0
    kind: int = 0
    kvs: dict = field(default_factory=dict)  # str -> set[str]


@dataclass
class SearchData:
    trace_id: bytes = b""
    start_s: int = 0
    end_s: int = 0
    dur_ms: int = 0
    root_service: str = ""
    root_name: str = ""
    kvs: dict = field(default_factory=dict)  # str -> set[str]
    spans: list = field(default_factory=list)  # list[SpanData]


def _put_kvs(out: bytearray, kvs: dict) -> None:
    keys = sorted(kvs)
    out += _U16.pack(len(keys))
    for k in keys:
        kb = k.encode("utf-8")[:0xFFFF]
        out += _U16.pack(len(kb)) + kb
        vals = sorted(kvs[k])
        out += _U16.pack(len(vals))
        for v in vals:
            vb = v.encode("utf-8")[:0xFFFF]
            out += _U16.pack(len(vb)) + vb


def encode_search_data(sd: SearchData) -> bytes:
    out = bytearray()
    out += _U32.pack(sd.start_s & 0xFFFFFFFF)
    out += _U32.pack(sd.end_s & 0xFFFFFFFF)
    out += _U32.pack(min(sd.dur_ms, 0xFFFFFFFF))
    for s in (sd.root_service, sd.root_name):
        b = s.encode("utf-8")[:0xFFFF]
        out += _U16.pack(len(b)) + b
    _put_kvs(out, sd.kvs)
    if sd.spans:
        spans = sd.spans[:0xFFFF]
        out += _U16.pack(len(spans))
        for sp in spans:
            out += _U16.pack(sp.parent if 0 <= sp.parent < 0xFFFF
                             else 0xFFFF)
            out += _U32.pack(min(sp.dur_ms, 0xFFFFFFFF))
            out.append(sp.kind & 0xFF)
            _put_kvs(out, sp.kvs)
    return bytes(out)


def decode_search_data(buf: bytes, trace_id: bytes = b"") -> SearchData:
    off = 0

    def u32():
        nonlocal off
        (v,) = _U32.unpack_from(buf, off)
        off += 4
        return v

    def u16():
        nonlocal off
        (v,) = _U16.unpack_from(buf, off)
        off += 2
        return v

    def s():
        nonlocal off
        n = u16()
        v = buf[off:off + n].decode("utf-8", errors="replace")
        off += n
        return v

    def kvs() -> dict:
        out = {}
        for _ in range(u16()):
            k = s()
            out[k] = {s() for _ in range(u16())}
        return out

    sd = SearchData(trace_id=trace_id)
    sd.start_s, sd.end_s, sd.dur_ms = u32(), u32(), u32()
    sd.root_service, sd.root_name = s(), s()
    sd.kvs = kvs()
    if off < len(buf):
        for _ in range(u16()):
            p = u16()
            sp = SpanData(parent=-1 if p == 0xFFFF else p, dur_ms=u32(),
                          kind=buf[off])
            off += 1
            sp.kvs = kvs()
            sd.spans.append(sp)
    return sd
