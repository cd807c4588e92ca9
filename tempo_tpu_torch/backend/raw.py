"""Object-storage backend interface (the reference's ``backend/raw.py``
without the compactor's operations). Keypath layout:
``<tenant>/<block_id>/<name>``, tenant-level objects at
``<tenant>/<name>``."""

from __future__ import annotations

import abc

from .types import NAME_META, BlockMeta


class BackendError(Exception):
    pass


class DoesNotExist(BackendError):
    pass


class RawBackend(abc.ABC):
    @abc.abstractmethod
    def write(self, tenant: str, block_id: str | None, name: str,
              data: bytes) -> None:
        """Write an object atomically (block_id None -> tenant object)."""

    @abc.abstractmethod
    def read(self, tenant: str, block_id: str | None, name: str) -> bytes:
        ...

    @abc.abstractmethod
    def read_range(self, tenant: str, block_id: str | None, name: str,
                   offset: int, length: int) -> bytes:
        ...

    @abc.abstractmethod
    def delete(self, tenant: str, block_id: str | None, name: str) -> None:
        ...

    # Large objects stream out in parts, so a block writer never holds a
    # whole block in memory. The default keeps the parts in memory and
    # writes once on close; a backend with native multipart appends
    # overrides all three.

    def append(self, tenant: str, block_id: str | None, name: str,
               tracker, data: bytes):
        """Append `data` to an object under construction. `tracker` is the
        value the previous append returned (None starts a new object).
        Returns the updated tracker. The object is not visible until
        close_append."""
        if tracker is None:
            tracker = []
        tracker.append(bytes(data))
        return tracker

    def close_append(self, tenant: str, block_id: str | None, name: str,
                     tracker) -> None:
        """Finalize an appended object (the commit point for `name`)."""
        if tracker is not None:
            self.write(tenant, block_id, name, b"".join(tracker))

    def abort_append(self, tenant: str, block_id: str | None, name: str,
                     tracker) -> None:
        """Discard an append in progress. The default's tracker is an
        in-memory buffer: nothing to release."""

    @abc.abstractmethod
    def list_tenants(self) -> list[str]:
        ...

    @abc.abstractmethod
    def list_blocks(self, tenant: str) -> list[str]:
        ...

    def write_block_meta(self, meta: BlockMeta) -> None:
        self.write(meta.tenant_id, meta.block_id, NAME_META, meta.to_json())

    def read_block_meta(self, tenant: str, block_id: str) -> BlockMeta:
        return BlockMeta.from_json(self.read(tenant, block_id, NAME_META))
