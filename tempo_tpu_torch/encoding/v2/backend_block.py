"""Backend block reader: bloom, then index, then one page read, then a
walk of the page (the reference's ``encoding/v2/backend_block.py``)."""

from __future__ import annotations

from typing import Iterator

from ...backend.raw import RawBackend
from ...backend.types import NAME_DATA, NAME_INDEX, BlockMeta, bloom_name
from ...utils.ids import pad_trace_id
from ..compression import decompress
from .bloom import ShardedBloom
from .index import IndexReader
from .objects import unmarshal_objects


class BackendBlock:
    def __init__(self, backend: RawBackend, meta: BlockMeta):
        self.backend = backend
        self.meta = meta
        self._index: IndexReader | None = None

    def index(self) -> IndexReader:
        """The block's index, read and checked at the first call (raises
        IndexCorruptError on a bad page)."""
        if self._index is None:
            self._index = IndexReader(self.backend.read(
                self.meta.tenant_id, self.meta.block_id, NAME_INDEX))
        return self._index

    def read_page(self, record_idx: int) -> bytes:
        idx = self.index()
        raw = self.backend.read_range(
            self.meta.tenant_id, self.meta.block_id, NAME_DATA,
            int(idx.starts[record_idx]), int(idx.lengths[record_idx]))
        return decompress(raw, self.meta.encoding)

    def find_by_id(self, obj_id: bytes) -> bytes | None:
        """The stored object of `obj_id` (8- or 16-byte spelling), or
        None. Objects lie in ascending padded-id order, so the page walk
        stops at the first larger id."""
        key = pad_trace_id(obj_id)
        if self.meta.bloom_shard_count:
            shard = ShardedBloom.shard_for(key, self.meta.bloom_shard_count)
            blob = self.backend.read(self.meta.tenant_id, self.meta.block_id,
                                     bloom_name(shard))
            if not ShardedBloom.test_marshalled(blob, key):
                return None
        i = self.index().find_index(key)
        if i is None:
            return None
        for oid, data in unmarshal_objects(self.read_page(i)):
            oid = pad_trace_id(oid)
            if oid == key:
                return data
            if oid > key:
                return None
        return None

    def iter_objects(self, start_page: int = 0, pages: int | None = None
                     ) -> Iterator[tuple[bytes, bytes]]:
        """(id, data) over pages [start_page, start_page + pages)."""
        idx = self.index()
        end = len(idx) if pages is None else min(len(idx), start_page + pages)
        for i in range(start_page, end):
            yield from unmarshal_objects(self.read_page(i))

    def bytes_in_pages(self, start_page: int, pages: int | None = None) -> int:
        idx = self.index()
        end = len(idx) if pages is None else min(len(idx), start_page + pages)
        return int(idx.lengths[start_page:end].sum())
