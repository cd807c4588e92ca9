"""Streaming block writer: objects in, then data pages, index, bloom
shards and ``meta.json`` out (the reference's
``encoding/v2/streaming_block.py``; the same bytes for the same objects,
gzip pages aside, whose header carries the time of writing).

Objects arrive in ascending id order. Pages are cut at a target size of
uncompressed bytes and compressed, one index record a page, one bloom
over every id; meta.json is written last, as the commit record.
"""

from __future__ import annotations

from ...backend.raw import DoesNotExist, RawBackend
from ...backend.types import (NAME_DATA, NAME_INDEX, NAME_META, BlockMeta,
                              bloom_name)
from ...utils.ids import pad_trace_id
from ..compression import compress
from .bloom import ShardedBloom
from .index import IndexWriter, Record
from .objects import marshal_object

DEFAULT_PAGE_SIZE = 1 << 20          # 1 MiB uncompressed
DEFAULT_RECORDS_PER_INDEX_PAGE = 1024
DEFAULT_BLOOM_FP = 0.01
DEFAULT_BLOOM_SHARD_SIZE = 100 << 10  # 100 KiB shards
DEFAULT_FLUSH_SIZE = 30 << 20


class StreamingBlock:
    def __init__(self, meta: BlockMeta,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 records_per_index_page: int = DEFAULT_RECORDS_PER_INDEX_PAGE,
                 bloom_fp: float = DEFAULT_BLOOM_FP,
                 backend: RawBackend | None = None,
                 flush_size: int = DEFAULT_FLUSH_SIZE):
        """With `backend`, compressed pages stream out through
        ``backend.append`` every `flush_size` bytes, so a block of any
        size builds in bounded memory. Without it, pages accumulate and
        are written once at complete()."""
        self.meta = meta
        self.page_size = page_size
        self.records_per_index_page = records_per_index_page
        self.bloom_fp = bloom_fp
        self.backend = backend
        self.flush_size = flush_size

        self._pages: list[bytes] = []
        self._pages_bytes = 0
        self._tracker = None
        self._appending = False
        self._records: list[Record] = []
        self._cur = bytearray()
        self._cur_max_id = b""
        self._offset = 0
        self._last_id = b""
        self._ids: list[bytes] = []
        # objects already committed, for abort: without a meta.json they
        # are invisible to the blocklist, so nothing else reclaims them
        self._written: list[str] = []
        self._write_backend: RawBackend | None = None
        self._meta_attempted = False

    def add_object(self, obj_id: bytes, data: bytes,
                   start: int = 0, end: int = 0) -> None:
        # the 16-byte padded key everywhere (index, bloom, page framing),
        # so short 64-bit ids sort and probe alike
        obj_id = pad_trace_id(obj_id)
        if self._last_id and obj_id < self._last_id:
            raise ValueError("objects must be added in ascending id order")
        self._last_id = obj_id
        self._ids.append(obj_id)
        self._cur += marshal_object(obj_id, data)
        self._cur_max_id = obj_id
        self.meta.total_objects += 1
        self.meta.extend_range(start, end)
        if len(self._cur) >= self.page_size:
            self._cut_page()

    def _cut_page(self) -> None:
        if not self._cur:
            return
        page = compress(bytes(self._cur), self.meta.encoding)
        self._pages.append(page)
        self._pages_bytes += len(page)
        self._records.append(Record(self._cur_max_id, self._offset,
                                    len(page)))
        self._offset += len(page)
        self._cur = bytearray()
        if self.backend is not None and self._pages_bytes >= self.flush_size:
            self._flush_pages()

    def _flush_pages(self) -> None:
        """Stream the buffered compressed pages to the backend as one
        append part."""
        if not self._pages:
            return
        self._tracker = self.backend.append(
            self.meta.tenant_id, self.meta.block_id, NAME_DATA,
            self._tracker, b"".join(self._pages))
        self._appending = True
        self._pages = []
        self._pages_bytes = 0

    def complete(self, backend: RawBackend | None = None) -> BlockMeta:
        """Write data, index and bloom shards, then meta.json last."""
        backend = backend if backend is not None else self.backend
        self._write_backend = backend
        self._cut_page()
        if self._appending:
            self._flush_pages()
            backend.close_append(self.meta.tenant_id, self.meta.block_id,
                                 NAME_DATA, self._tracker)
            self._appending = False
            self._written.append(NAME_DATA)
            data = None
        else:
            data = b"".join(self._pages)

        shards = max(1, -(-len(self._ids) * 16 // DEFAULT_BLOOM_SHARD_SIZE))
        bloom = ShardedBloom(
            shard_count=shards, fp_rate=self.bloom_fp,
            expected_per_shard=max(1, -(-len(self._ids) // shards)))
        bloom.add_many(self._ids)

        m = self.meta
        m.size = self._offset
        m.total_records = len(self._records)
        m.index_page_size = self.records_per_index_page
        m.bloom_shard_count = bloom.shard_count
        m.bloom_shard_size_bytes = bloom.shard_size_bytes()
        if self._ids:
            m.min_id = self._ids[0].hex()
            m.max_id = self._ids[-1].hex()

        if data is not None:
            backend.write(m.tenant_id, m.block_id, NAME_DATA, data)
            self._written.append(NAME_DATA)
        backend.write(m.tenant_id, m.block_id, NAME_INDEX,
                      IndexWriter(self.records_per_index_page)
                      .write(self._records))
        self._written.append(NAME_INDEX)
        for s in range(bloom.shard_count):
            backend.write(m.tenant_id, m.block_id, bloom_name(s),
                          bloom.marshal_shard(s))
            self._written.append(bloom_name(s))
        self._meta_attempted = True
        backend.write_block_meta(m)
        return m

    def abort(self) -> None:
        """Discard the block under construction: release the append in
        progress and delete every object complete() already wrote."""
        if self._appending and self.backend is not None:
            try:
                self.backend.abort_append(self.meta.tenant_id,
                                          self.meta.block_id, NAME_DATA,
                                          self._tracker)
            except Exception:  # noqa: BLE001 (abort is best-effort cleanup)
                pass
        be = self._write_backend or self.backend
        if be is not None:
            safe = True
            if self._meta_attempted:
                # a meta.json that reached the backend despite an error
                # would point at deleted objects: it goes first, and the
                # rest only if its delete is known to have worked
                try:
                    be.delete(self.meta.tenant_id, self.meta.block_id,
                              NAME_META)
                except DoesNotExist:
                    pass
                except Exception:  # noqa: BLE001 (meta state unknown:
                    safe = False   # keep the block whole)
            if safe:
                for name in self._written:
                    try:
                        be.delete(self.meta.tenant_id, self.meta.block_id,
                                  name)
                    except Exception:  # noqa: BLE001 (best-effort cleanup)
                        pass
                self._written = []
        self._tracker = None
        self._appending = False
        self._pages = []
        self._pages_bytes = 0
        self._cur = bytearray()
