"""Per-tenant in-memory block lists (counterpart of the reference's
``db/blocklist.py``, without compacted metas)."""

from __future__ import annotations

import threading

from ..backend.types import BlockMeta


class Blocklist:
    def __init__(self):
        self._lock = threading.Lock()
        self._metas: dict[str, list[BlockMeta]] = {}
        # bumped on every membership change: readers key derived caches
        # (job lists, group plans) on (tenant, epoch)
        self._epoch = 0

    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def metas(self, tenant: str) -> list[BlockMeta]:
        with self._lock:
            return list(self._metas.get(tenant, []))

    def apply_poll_results(self, metas: dict) -> None:
        with self._lock:
            new_m = {t: list(ms) for t, ms in metas.items()}
            if new_m != self._metas:
                self._epoch += 1
            self._metas = new_m

    def add(self, tenant: str, metas: list[BlockMeta]) -> None:
        """Between polls: blocks this process wrote join the tenant's list
        at once."""
        with self._lock:
            self._metas.setdefault(tenant, []).extend(metas)
            self._epoch += 1
