"""Per-trace search data and its wire codec.

Counterpart of the reference's ``search/data.py`` without the proto
extraction (the slice reads search blocks; it does not ingest traces).
Wire format, little-endian, length-prefixed:

  | u32 start_s | u32 end_s | u32 dur_ms | u16 root_svc_len | root_svc
  | u16 root_name_len | root_name | u16 n_keys |
  per key: | u16 key_len | key | u16 n_vals | (u16 val_len | val)* |

The reference may append an optional span section after the kv map (its
structural engine); the decoder here reads the trace-level rollup and
ignores that trailing section.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

_U32 = struct.Struct("<I")
_U16 = struct.Struct("<H")


@dataclass
class SearchData:
    trace_id: bytes = b""
    start_s: int = 0
    end_s: int = 0
    dur_ms: int = 0
    root_service: str = ""
    root_name: str = ""
    kvs: dict = field(default_factory=dict)  # str -> set[str]


def encode_search_data(sd: SearchData) -> bytes:
    out = bytearray()
    out += _U32.pack(sd.start_s & 0xFFFFFFFF)
    out += _U32.pack(sd.end_s & 0xFFFFFFFF)
    out += _U32.pack(min(sd.dur_ms, 0xFFFFFFFF))
    for s in (sd.root_service, sd.root_name):
        b = s.encode("utf-8")[:0xFFFF]
        out += _U16.pack(len(b)) + b
    keys = sorted(sd.kvs)
    out += _U16.pack(len(keys))
    for k in keys:
        kb = k.encode("utf-8")[:0xFFFF]
        out += _U16.pack(len(kb)) + kb
        vals = sorted(sd.kvs[k])
        out += _U16.pack(len(vals))
        for v in vals:
            vb = v.encode("utf-8")[:0xFFFF]
            out += _U16.pack(len(vb)) + vb
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

    sd = SearchData(trace_id=trace_id)
    sd.start_s, sd.end_s, sd.dur_ms = u32(), u32(), u32()
    sd.root_service, sd.root_name = s(), s()
    for _ in range(u16()):
        k = s()
        sd.kvs[k] = {s() for _ in range(u16())}
    return sd
