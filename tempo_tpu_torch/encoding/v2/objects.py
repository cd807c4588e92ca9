"""Object framing (a copy of the reference's ``encoding/v2/objects.py``;
the bytes are the same both ways): the trace objects inside a block's
data pages (``streaming_block`` writes them, ``backend_block`` reads
them) and the records of the WAL head's search sidecar
(``search/streaming.py``).

``| u32 id_len | u32 data_len | id | data |``, little-endian.
"""

from __future__ import annotations

import struct
from typing import Iterator

_HDR = struct.Struct("<II")
MAX_OBJECT_SIZE = 1 << 30


class ObjectFramingError(ValueError):
    """A truncated or implausible object frame."""


def marshal_object(obj_id: bytes, data: bytes) -> bytes:
    return _HDR.pack(len(obj_id), len(data)) + obj_id + data


def unmarshal_objects(buf: bytes, *, tolerate_truncation: bool = False
                      ) -> Iterator[tuple[bytes, bytes]]:
    """Yield (id, data) pairs. With tolerate_truncation (WAL replay), a
    short or implausible tail ends the stream: a crashed writer's partial
    record is dropped."""
    off, n = 0, len(buf)
    while off < n:
        if off + _HDR.size > n:
            if tolerate_truncation:
                return
            raise ObjectFramingError("truncated object header")
        id_len, data_len = _HDR.unpack_from(buf, off)
        if id_len > 128 or data_len > MAX_OBJECT_SIZE:
            if tolerate_truncation:
                return
            raise ObjectFramingError(
                f"implausible object lens {id_len}/{data_len}")
        end = off + _HDR.size + id_len + data_len
        if end > n:
            if tolerate_truncation:
                return
            raise ObjectFramingError("truncated object body")
        yield (buf[off + _HDR.size: off + _HDR.size + id_len],
               buf[off + _HDR.size + id_len: end])
        off = end
