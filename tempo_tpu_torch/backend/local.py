"""Filesystem backend: ``<path>/<tenant>/<block>/<name>`` (the read/write
subset of the reference's ``backend/local.py``). Writes are atomic via
temp file + rename."""

from __future__ import annotations

import os
import tempfile

from ..utils.pathsafe import check_path_component
from .raw import DoesNotExist, RawBackend


class LocalBackend(RawBackend):
    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _p(self, tenant: str, block_id: str | None, name: str = "") -> str:
        check_path_component(tenant, "tenant")
        parts = [self.path, tenant]
        if block_id:
            parts.append(check_path_component(block_id, "block id"))
        if name:
            parts.append(check_path_component(name, "object name"))
        return os.path.join(*parts)

    def write(self, tenant, block_id, name, data: bytes) -> None:
        self._p(tenant, block_id, name)
        d = self._p(tenant, block_id)
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=f".{name}.")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, os.path.join(d, name))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def read(self, tenant, block_id, name) -> bytes:
        try:
            with open(self._p(tenant, block_id, name), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise DoesNotExist(f"{tenant}/{block_id}/{name}") from None

    def list_tenants(self) -> list[str]:
        try:
            return sorted(e for e in os.listdir(self.path)
                          if os.path.isdir(os.path.join(self.path, e)))
        except FileNotFoundError:
            return []

    def list_blocks(self, tenant: str) -> list[str]:
        base = self._p(tenant, None)
        try:
            return sorted(e for e in os.listdir(base)
                          if os.path.isdir(os.path.join(base, e)))
        except FileNotFoundError:
            return []
