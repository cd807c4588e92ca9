"""Backend search block: write the columnar container, read it back.

Counterpart of the reference's ``search/backend_search_block.py`` minus
its single-block ``search`` (a later slice, with kernel B1). At block
completion the search entries are built into the columnar container
(object ``search``, compressed) plus a small JSON header
(``search-header.json``) used to prune the block without touching the
container. Blocks written here are read by the reference and vice versa.
"""

from __future__ import annotations

import json
import threading

from ..backend.raw import RawBackend
from ..backend.types import NAME_SEARCH, NAME_SEARCH_HEADER, BlockMeta
from ..encoding.compression import compress, decompress
from .columnar import ColumnarPages, PageGeometry
from .data import SearchData


def write_search_block(backend: RawBackend, meta: BlockMeta,
                       entries: list[SearchData],
                       geometry: PageGeometry = PageGeometry(),
                       encoding: str = "zlib") -> dict:
    """Build the container from per-trace search data and write it."""
    return write_search_pages(backend, meta,
                              ColumnarPages.build(entries, geometry),
                              encoding)


def write_search_pages(backend: RawBackend, meta: BlockMeta,
                       pages: ColumnarPages, encoding: str = "zlib") -> dict:
    """Write an already-built container and its header, then re-commit the
    block meta with the container geometry. Returns the header."""
    blob = compress(pages.to_bytes(), encoding)
    header = dict(pages.header)
    header["encoding"] = encoding
    header["compressed_size"] = len(blob)
    backend.write(meta.tenant_id, meta.block_id, NAME_SEARCH, blob)
    backend.write(meta.tenant_id, meta.block_id, NAME_SEARCH_HEADER,
                  json.dumps(header).encode())
    meta.search_pages = header["n_pages"]
    meta.search_size = len(blob)
    meta.search_entries_per_page = header["entries_per_page"]
    meta.search_kv_per_entry = header["kv_per_entry"]
    backend.write_block_meta(meta)
    return header


class BackendSearchBlock:
    """One block's search header and container, loaded lazily and cached."""

    def __init__(self, backend: RawBackend, meta: BlockMeta,
                 header: dict | None = None):
        self.backend = backend
        self.meta = meta
        self._header = header
        self._pages: ColumnarPages | None = None
        self._lock = threading.Lock()

    def header(self) -> dict:
        if self._header is None:
            self._header = json.loads(self.backend.read(
                self.meta.tenant_id, self.meta.block_id, NAME_SEARCH_HEADER))
        return self._header

    def pages(self) -> ColumnarPages:
        with self._lock:
            if self._pages is None:
                hdr = self.header()
                blob = self.backend.read(self.meta.tenant_id,
                                         self.meta.block_id, NAME_SEARCH)
                raw = decompress(blob, hdr.get("encoding", "zstd"))
                self._pages = ColumnarPages.from_bytes(raw)
            return self._pages
