"""Blocklist poller: list tenants and blocks, read each block's meta.

Counterpart of the reader half of the reference's ``db/poller.py``: a
direct poll with bounded concurrency. Building or reading the tenant index
(``index.json.gz``) and compacted metas are not part of this slice; a
block without a live ``meta.json`` is left out.
"""

from __future__ import annotations

import concurrent.futures

from ..backend.raw import DoesNotExist, RawBackend
from ..backend.types import BlockMeta


class Poller:
    def __init__(self, backend: RawBackend, concurrency: int = 50):
        self.backend = backend
        self.concurrency = concurrency

    def poll(self) -> dict[str, list[BlockMeta]]:
        return {t: self.poll_tenant(t) for t in self.backend.list_tenants()}

    def poll_tenant(self, tenant: str) -> list[BlockMeta]:
        def read_one(block_id: str):
            try:
                return self.backend.read_block_meta(tenant, block_id)
            except DoesNotExist:
                return None  # compacted, or torn: no live meta

        blocks = self.backend.list_blocks(tenant)
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=max(1, min(self.concurrency, len(blocks)))) as ex:
            metas = [m for m in ex.map(read_one, blocks) if m is not None]
        metas.sort(key=lambda m: (m.start_time, m.block_id))
        return metas
