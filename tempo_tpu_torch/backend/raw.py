"""Object-storage backend interface (the subset of the reference's
``backend/raw.py`` the search slice uses). Keypath layout:
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
    def list_tenants(self) -> list[str]:
        ...

    @abc.abstractmethod
    def list_blocks(self, tenant: str) -> list[str]:
        ...

    def write_block_meta(self, meta: BlockMeta) -> None:
        self.write(meta.tenant_id, meta.block_id, NAME_META, meta.to_json())

    def read_block_meta(self, tenant: str, block_id: str) -> BlockMeta:
        return BlockMeta.from_json(self.read(tenant, block_id, NAME_META))
