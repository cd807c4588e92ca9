"""Block index: fixed 28-byte records in checksummed pages (a copy of the
reference's ``encoding/v2/index.py``; the bytes are the same both ways).

Record = ``| 16B max_id | u64 start | u32 len |``, one per data page,
max_id the highest object id in the page. A page of records is
``| u32 record_count | u64 xxh64(records) | records |``: a torn or
corrupt page fails its checksum and raises IndexCorruptError.

Lookup: the first record whose max_id >= the target is the only data
page that can hold it.
"""

from __future__ import annotations

import bisect
import struct
from dataclasses import dataclass

import numpy as np

from ...utils.ids import pad_trace_id
from ...utils.xxh64 import xxh64

RECORD_LEN = 28
_PAGE_HDR = struct.Struct("<IQ")  # record_count, xxh64 of the records


class IndexCorruptError(Exception):
    pass


@dataclass(frozen=True)
class Record:
    max_id: bytes  # 16 bytes
    start: int     # byte offset of the data page
    length: int    # byte length of the data page

    def pack(self) -> bytes:
        return pad_trace_id(self.max_id) + struct.pack("<QI", self.start,
                                                       self.length)


class IndexWriter:
    """Packs records into checksummed pages of `records_per_page` each."""

    def __init__(self, records_per_page: int = 1024):
        self.records_per_page = max(1, records_per_page)

    def write(self, records: list[Record]) -> bytes:
        out = bytearray()
        for i in range(0, len(records), self.records_per_page):
            chunk = records[i:i + self.records_per_page]
            body = b"".join(r.pack() for r in chunk)
            out += _PAGE_HDR.pack(len(chunk), xxh64(body))
            out += body
        return bytes(out)


class IndexReader:
    """Parses a whole index object (28 bytes a data page, so small) into
    columns: ``ids`` [N, 16] uint8, ``starts`` [N] uint64, ``lengths``
    [N] uint32."""

    def __init__(self, data: bytes):
        ids, starts, lengths = [], [], []
        off, n = 0, len(data)
        while off < n:
            if off + _PAGE_HDR.size > n:
                raise IndexCorruptError("truncated index page header")
            count, checksum = _PAGE_HDR.unpack_from(data, off)
            off += _PAGE_HDR.size
            body = data[off:off + count * RECORD_LEN]
            if len(body) != count * RECORD_LEN:
                raise IndexCorruptError("truncated index page body")
            if xxh64(body) != checksum:
                raise IndexCorruptError("index page checksum mismatch")
            arr = np.frombuffer(body, dtype=np.uint8).reshape(count,
                                                              RECORD_LEN)
            ids.append(arr[:, :16])
            starts.append(arr[:, 16:24].copy().view("<u8").reshape(-1))
            lengths.append(arr[:, 24:28].copy().view("<u4").reshape(-1))
            off += count * RECORD_LEN
        if ids:
            self.ids = np.concatenate(ids)
            self.starts = np.concatenate(starts).astype(np.uint64)
            self.lengths = np.concatenate(lengths).astype(np.uint32)
        else:
            self.ids = np.zeros((0, 16), dtype=np.uint8)
            self.starts = np.zeros(0, dtype=np.uint64)
            self.lengths = np.zeros(0, dtype=np.uint32)
        # 16-byte ids compare as bytes exactly as the writer sorted them
        self._keys = [bytes(r) for r in self.ids]

    def __len__(self) -> int:
        return len(self.starts)

    def find_index(self, obj_id: bytes) -> int | None:
        """Position of the first record whose max_id >= obj_id: the only
        data page that can hold obj_id; None past the last record."""
        i = bisect.bisect_left(self._keys, pad_trace_id(obj_id))
        return i if i < len(self._keys) else None
