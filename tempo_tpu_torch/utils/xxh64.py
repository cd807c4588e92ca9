"""XXH64, the port's own copy.

The reference hashes bloom probes and index-page checksums with the
``xxhash`` package; the port does not depend on it, so it carries the
algorithm itself (Yann Collet's XXH64, the 64-bit variant of xxHash; the
same digest as ``xxhash.xxh64_intdigest``). Three forms:

- ``xxh64``: any bytes and seed, in C (``tt_xxhash64`` of the port's host
  library, ``ops/native.py``);
- ``xxh64_plain``: the same in Python, on ints masked to 64 bits (the
  plain version the tests hold the C one against);
- ``xxh64_16``: a ``[N, 16]`` uint8 array of padded trace ids at once,
  on uint64 arrays (numpy array arithmetic wraps modulo 2^64, which is
  what the algorithm wants; numpy uint64 *scalars* warn or raise on
  overflow, so none is used).
"""

from __future__ import annotations

import struct

import numpy as np

from ..ops import native

P1 = 0x9E3779B185EBCA87
P2 = 0xC2B2AE3D27D4EB4F
P3 = 0x165667B19E3779F9
P4 = 0x85EBCA77C2B2AE63
P5 = 0x27D4EB2F165667C5
MASK64 = 0xFFFFFFFFFFFFFFFF

_STRIPE = struct.Struct("<4Q")
_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & MASK64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * P2) & MASK64
    return (_rotl(acc, 31) * P1) & MASK64


def _merge(h: int, v: int) -> int:
    h ^= _round(0, v)
    return (h * P1 + P4) & MASK64


def _avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * P2) & MASK64
    h ^= h >> 29
    h = (h * P3) & MASK64
    return h ^ (h >> 32)


def xxh64(data: bytes, seed: int = 0) -> int:
    """The XXH64 digest of `data` under `seed`, as an int in [0, 2^64)."""
    return native.xxhash64(data, seed)


def xxh64_plain(data: bytes, seed: int = 0) -> int:
    """``xxh64`` in Python."""
    seed &= MASK64
    n = len(data)
    off = 0
    if n >= 32:
        v1 = (seed + P1 + P2) & MASK64
        v2 = (seed + P2) & MASK64
        v3 = seed
        v4 = (seed - P1) & MASK64
        while off + 32 <= n:
            a, b, c, d = _STRIPE.unpack_from(data, off)
            v1, v2 = _round(v1, a), _round(v2, b)
            v3, v4 = _round(v3, c), _round(v4, d)
            off += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & MASK64
        for v in (v1, v2, v3, v4):
            h = _merge(h, v)
    else:
        h = (seed + P5) & MASK64
    h = (h + n) & MASK64
    while off + 8 <= n:
        h ^= _round(0, _U64.unpack_from(data, off)[0])
        h = (_rotl(h, 27) * P1 + P4) & MASK64
        off += 8
    if off + 4 <= n:
        h ^= (_U32.unpack_from(data, off)[0] * P1) & MASK64
        h = (_rotl(h, 23) * P2 + P3) & MASK64
        off += 4
    while off < n:
        h ^= (data[off] * P5) & MASK64
        h = (_rotl(h, 11) * P1) & MASK64
        off += 1
    return _avalanche(h)


def _rotl_arr(x: np.ndarray, r: int) -> np.ndarray:
    return (x << r) | (x >> (64 - r))


def xxh64_16(ids: np.ndarray, seed: int = 0) -> np.ndarray:
    """``xxh64(bytes(row), seed)`` for every row of a ``[N, 16]`` uint8
    array, as a ``[N]`` uint64 array."""
    ids = np.ascontiguousarray(ids, dtype=np.uint8)
    if ids.ndim != 2 or ids.shape[1] != 16:
        raise ValueError(f"xxh64_16 wants [N, 16] uint8 ids, got "
                         f"{ids.shape}")
    lanes = ids.view("<u8").astype(np.uint64)          # [N, 2]
    with np.errstate(over="ignore"):
        h = np.full(len(ids), ((seed & MASK64) + P5 + 16) & MASK64,
                    dtype=np.uint64)
        for j in range(2):
            k = _rotl_arr(lanes[:, j] * P2, 31) * P1
            h ^= k
            h = _rotl_arr(h, 27) * P1 + P4
        h ^= h >> 33
        h *= P2
        h ^= h >> 29
        h *= P3
        h ^= h >> 32
    return h
