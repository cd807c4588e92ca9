"""Write-ahead log: one append-only file a head block, replayed after a
crash (the reference's ``wal/wal.py``; the files are the same both ways).

Every accepted trace segment is appended to its head block's file, and
flushed, before the push is acknowledged. A record is the object framing
of ``encoding/v2/objects.py`` around the segment compressed by the WAL's
codec. The filename carries what a replay needs:
``<block_id>+<tenant>+<version>+<encoding>+<data_encoding>``, the tenant
percent-encoded. Replay rescans each file: a torn tail (a crashed
writer's partial record) is cut off, a record that does not decompress is
dropped, and empty or unparseable files are removed.

Codecs: those of ``encoding/compression.py`` (``none``, ``gzip``,
``zlib``, ``zstd``, ``lz4``, ``snappy``, ``s2``). ``auto`` is snappy where
the port's host library has it, and zlib otherwise, as the reference's
``auto``. A codec this process cannot use raises when the WAL is built. A
file written with a codec this process cannot decode raises at replay,
naming the codec, and stays on disk: dropping its records would lose
acknowledged writes.
"""

from __future__ import annotations

import logging
import os
import time
import urllib.parse
from dataclasses import dataclass

from ..backend.types import VERSION_VT1, BlockMeta
from ..encoding.compression import (ENCODINGS, compress, decompress,
                                    usable, why_unusable)
from ..encoding.v2.objects import marshal_object, unmarshal_objects
from ..utils.ids import pad_trace_id

log = logging.getLogger(__name__)

_SEP = "+"


def resolve_wal_encoding(encoding: str = "auto") -> str:
    """The codec a WAL writes with; raises ValueError for one this
    process cannot use, when the WAL is built rather than at the first
    append."""
    if encoding == "auto":
        return "snappy" if usable("snappy") else "zlib"
    if encoding not in ENCODINGS:
        raise ValueError(f"wal_encoding {encoding!r}: supported are auto, "
                         f"{', '.join(ENCODINGS)}")
    if not usable(encoding):
        raise ValueError(f"wal_encoding {encoding!r} cannot be used in this "
                         f"process: {why_unusable(encoding)}")
    return encoding


def wal_filename(meta: BlockMeta) -> str:
    # the tenant is percent-encoded, so no tenant id can break the split
    tenant = urllib.parse.quote(meta.tenant_id, safe="")
    return _SEP.join([meta.block_id, tenant, meta.version,
                      meta.encoding or "none", meta.data_encoding])


def parse_wal_filename(name: str) -> BlockMeta:
    parts = name.split(_SEP)
    if len(parts) != 5:
        raise ValueError(f"unparseable wal filename {name!r}")
    block_id, tenant, version, encoding, data_encoding = parts
    if not block_id or not tenant:
        raise ValueError(f"unparseable wal filename {name!r}")
    return BlockMeta(version=version, block_id=block_id,
                     tenant_id=urllib.parse.unquote(tenant),
                     encoding=encoding, data_encoding=data_encoding)


@dataclass
class _Entry:
    obj_id: bytes
    offset: int
    length: int


class AppendBlock:
    """One head block: its WAL file and the offsets of its records."""

    def __init__(self, wal_dir: str, meta: BlockMeta, _replay: bool = False):
        from ..model.codec import segment_codec_for

        self.meta = meta
        self.path = os.path.join(wal_dir, wal_filename(meta))
        self._entries: list[_Entry] = []
        self._by_id: dict[bytes, list[int]] = {}
        self._codec = segment_codec_for(meta.data_encoding)
        self._enc = meta.encoding or "none"
        self.corrupt_records = 0   # dropped at replay
        self._fh = self._rfh = None
        self._closed = False
        if _replay:
            if not usable(self._enc):
                raise ValueError(
                    f"wal file {os.path.basename(self.path)!r}: its records "
                    f"are compressed with {self._enc!r}, which this process "
                    "cannot decode; the file is kept")
            self._replay_file()
            self._fh = open(self.path, "ab")
        else:
            self._fh = open(self.path, "wb")
        self._rfh = open(self.path, "rb")
        self._offset = os.path.getsize(self.path)

    # ---- write path

    def append(self, obj_id: bytes, segment: bytes,
               start: int = 0, end: int = 0) -> None:
        """Append and flush one segment of a trace; `start`, `end` (unix
        seconds) widen the block's range."""
        # the padded 16-byte key, so the iterator's order is the block
        # index's (StreamingBlock pads the same way)
        obj_id = pad_trace_id(obj_id)
        if self._enc != "none":
            segment = compress(segment, self._enc)
        rec = marshal_object(obj_id, segment)
        self._fh.write(rec)
        self._fh.flush()
        self._by_id.setdefault(obj_id, []).append(len(self._entries))
        self._entries.append(_Entry(obj_id, self._offset, len(rec)))
        self._offset += len(rec)
        self.meta.extend_range(start, end)
        self.meta.total_objects += 1

    @property
    def data_length(self) -> int:
        return self._offset

    def __len__(self) -> int:
        return len(self._entries)

    # ---- read path

    def _read_entry(self, e: _Entry) -> bytes:
        self._rfh.seek(e.offset)
        buf = self._rfh.read(e.length)
        for _, data in unmarshal_objects(buf):
            if self._enc == "none":
                return data
            try:
                return decompress(data, self._enc)
            except Exception as exc:  # noqa: BLE001 (codecs raise their own)
                raise ValueError(f"corrupt wal entry: {exc}") from exc
        raise ValueError("corrupt wal entry")

    def find(self, obj_id: bytes) -> bytes | None:
        """The trace's segments as one object, or None. A block closed
        under the reader (its completion handed off) answers None; a
        record that does not decode on an open block raises."""
        idxs = self._by_id.get(pad_trace_id(obj_id))
        if not idxs:
            return None
        try:
            segs = [self._read_entry(self._entries[i]) for i in idxs]
        except (AttributeError, ValueError, OSError):
            if self._closed:
                return None
            raise
        return self._codec.to_object(segs)

    def iterator(self):
        """(id, object) in ascending id order, each trace's segments
        combined: what block completion consumes."""
        for obj_id in sorted(self._by_id):
            yield obj_id, self.find(obj_id)

    # ---- lifecycle

    def close(self) -> None:
        # the flag first: a find() racing the close answers None
        self._closed = True
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._rfh:
            self._rfh.close()
            self._rfh = None

    def clear(self) -> None:
        self.close()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    # ---- replay

    def _replay_file(self) -> None:
        with open(self.path, "rb") as f:
            buf = f.read()
        off = 0
        for obj_id, data in unmarshal_objects(buf, tolerate_truncation=True):
            length = 8 + len(obj_id) + len(data)
            off += length
            if self._enc != "none":
                try:
                    data = decompress(data, self._enc)
                except Exception:  # noqa: BLE001 (codecs raise their own)
                    # dropped, as the reference drops it: indexed, it would
                    # make every find() and the block's completion raise;
                    # records are framed one by one, so the rest replay
                    self.corrupt_records += 1
                    continue
            self._by_id.setdefault(obj_id, []).append(len(self._entries))
            self._entries.append(_Entry(obj_id, off - length, length))
            r = self._codec.fast_range(data) if len(data) >= 8 else None
            if r:
                self.meta.extend_range(r[0], r[1])
            self.meta.total_objects += 1
        if self.corrupt_records:
            log.warning("wal replay %s: dropped %d corrupt record(s)",
                        os.path.basename(self.path), self.corrupt_records)
        if off < len(buf):   # cut the torn tail, so appends start clean
            with open(self.path, "ab") as f:
                f.truncate(off)


class WAL:
    def __init__(self, wal_dir: str, encoding: str = "auto"):
        self.dir = wal_dir
        self.encoding = resolve_wal_encoding(encoding)
        # the latest replay_all's figures: files, bytes, seconds
        self.last_replay: dict | None = None
        os.makedirs(wal_dir, exist_ok=True)

    def new_block(self, tenant: str, block_id: str | None = None
                  ) -> AppendBlock:
        """A head block of v2 trace objects, with a new id unless one is
        given."""
        meta = BlockMeta(version=VERSION_VT1, tenant_id=tenant,
                         data_encoding="v2", encoding=self.encoding)
        if block_id:
            meta.block_id = block_id
        return AppendBlock(self.dir, meta)

    def replay_all(self) -> tuple[list[AppendBlock], list[str]]:
        """Rescan the WAL directory. Returns (replayed blocks, removed
        files). Empty and unparseable files are removed, and so are search
        sidecars (``<wal file>.search``) whose block file is gone; a
        sidecar is replayed by its block's owner, not here. Raises
        ValueError for a file whose codec this process cannot decode,
        which stays on disk."""
        t0 = time.perf_counter()
        blocks: list[AppendBlock] = []
        removed: list[str] = []
        sidecars: list[str] = []
        for name in sorted(os.listdir(self.dir)):
            path = os.path.join(self.dir, name)
            if not os.path.isfile(path):
                continue
            if name.endswith(".search"):
                sidecars.append(name)
                continue
            try:
                meta = parse_wal_filename(name)
            except ValueError:
                os.unlink(path)
                removed.append(name)
                continue
            if os.path.getsize(path) == 0:
                os.unlink(path)
                removed.append(name)
                continue
            try:
                blocks.append(AppendBlock(self.dir, meta, _replay=True))
            except BaseException:
                for b in blocks:
                    b.close()
                raise
        kept = {os.path.basename(b.path) for b in blocks}
        for name in sidecars:
            if name[:-len(".search")] not in kept:
                os.unlink(os.path.join(self.dir, name))
                removed.append(name)
        self.last_replay = {
            "duration_s": time.perf_counter() - t0,
            "blocks": len(blocks),
            "bytes": sum(b.data_length for b in blocks),
            "corrupt_records": sum(b.corrupt_records for b in blocks),
            "removed_files": len(removed),
        }
        return blocks, removed
