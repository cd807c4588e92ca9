"""FNV-1a 32-bit, the bloom shard key (a copy of the fnv1a_32 half of the
reference's ``utils/hashing.py``): a scalar function over bytes and a
vectorised one over fixed-length keys."""

from __future__ import annotations

import numpy as np

_FNV1A_32_OFFSET = 0x811C9DC5
_FNV1A_32_PRIME = 0x01000193
_MASK32 = 0xFFFFFFFF


def fnv1a_32(data: bytes) -> int:
    h = _FNV1A_32_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV1A_32_PRIME) & _MASK32
    return h


def fnv1a_32_batch(ids: np.ndarray) -> np.ndarray:
    """fnv1a_32 of every row of an ``[N, L]`` uint8 array of fixed-length
    keys: one pass per byte position, vectorised over the N keys."""
    if ids.dtype != np.uint8 or ids.ndim != 2:
        raise ValueError("fnv1a_32_batch wants an [N, L] uint8 array")
    h = np.full(ids.shape[0], _FNV1A_32_OFFSET, dtype=np.uint64)
    for col in range(ids.shape[1]):
        h ^= ids[:, col].astype(np.uint64)
        h = (h * _FNV1A_32_PRIME) & _MASK32
    return h.astype(np.uint32)
