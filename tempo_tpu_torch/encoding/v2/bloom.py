"""Sharded bloom filters for trace-by-ID (the reference's
``encoding/v2/bloom.py``; the bits are the same for the same ids).

Ids spread over `shard_count` shards by fnv1a_32(id) % shards, so a reader
fetches one small shard object, not the whole filter. Probes are
Kirsch-Mitzenmacher double hashing over two XXH64 seeds:
``p_i = (h1 + i * h2) mod 2^64 mod m`` with ``h2`` forced odd. A shard is
``| u32 k | u32 reserved | u64 m | m/64 little-endian u64 words |``.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from ...utils.hashing import fnv1a_32, fnv1a_32_batch
from ...utils.xxh64 import MASK64, xxh64, xxh64_16

_HDR = struct.Struct("<IIQ")  # k hashes, reserved, m bits
_SEED2 = 0x9E3779B97F4A7C15


def _probe_positions(obj_id: bytes, k: int, m: int) -> np.ndarray:
    """The k bit positions of one id: the one definition that writers and
    readers share (a divergence would be a silent false negative)."""
    h1 = xxh64(obj_id, 0)
    h2 = xxh64(obj_id, _SEED2) | 1
    return np.asarray([((h1 + i * h2) & MASK64) % m for i in range(k)],
                      dtype=np.int64)


def _all_set(bits: np.ndarray, pos: np.ndarray) -> bool:
    words = bits[pos >> 6]
    return bool(np.all((words >> (pos & 63).astype(np.uint64)) & 1))


class ShardedBloom:
    def __init__(self, shard_count: int, fp_rate: float = 0.01,
                 expected_per_shard: int = 1000):
        self.shard_count = max(1, shard_count)
        self.fp = fp_rate
        n = max(1, expected_per_shard)
        m = max(64, int(-n * math.log(fp_rate) / (math.log(2) ** 2)))
        m = (m + 63) // 64 * 64
        self.m = m
        self.k = max(1, round(m / n * math.log(2)))
        self._bits = np.zeros((self.shard_count, m // 64), dtype=np.uint64)

    @staticmethod
    def shard_for(obj_id: bytes, shard_count: int) -> int:
        return fnv1a_32(obj_id) % max(1, shard_count)

    def _set(self, shards: np.ndarray, pos: np.ndarray) -> None:
        """Set bit pos[i, j] of shard shards[i] for every i, j."""
        flat = (shards[:, None] * (self.m // 64) + (pos >> 6)).ravel()
        bit = (np.uint64(1) << (pos & 63).astype(np.uint64)).ravel()
        np.bitwise_or.at(self._bits.reshape(-1), flat, bit)

    def add(self, obj_id: bytes) -> None:
        self._set(np.asarray([self.shard_for(obj_id, self.shard_count)]),
                  _probe_positions(obj_id, self.k, self.m)[None, :])

    def add_many(self, obj_ids) -> None:
        """Insert many ids at once: hashing, probe positions and the bit
        ORs vectorised when every id is 16 bytes (a block's padded ids),
        id by id otherwise."""
        ids = list(obj_ids)
        if not ids:
            return
        if any(len(o) != 16 for o in ids):
            for o in ids:
                self.add(o)
            return
        arr = np.frombuffer(b"".join(ids), dtype=np.uint8).reshape(-1, 16)
        with np.errstate(over="ignore"):
            h1 = xxh64_16(arr, 0)
            h2 = xxh64_16(arr, _SEED2) | 1
            i = np.arange(self.k, dtype=np.uint64)
            pos = ((h1[:, None] + i[None, :] * h2[:, None])
                   % self.m).astype(np.int64)
        shards = fnv1a_32_batch(arr).astype(np.int64) % self.shard_count
        self._set(shards, pos)

    def test(self, obj_id: bytes) -> bool:
        s = self.shard_for(obj_id, self.shard_count)
        return _all_set(self._bits[s], _probe_positions(obj_id, self.k,
                                                        self.m))

    # ---- serialization: one object per shard ----

    def marshal_shard(self, shard: int) -> bytes:
        return (_HDR.pack(self.k, 0, self.m)
                + self._bits[shard].astype("<u8").tobytes())

    @classmethod
    def test_marshalled(cls, data: bytes, obj_id: bytes) -> bool:
        k, _, m = _HDR.unpack_from(data)
        bits = np.frombuffer(data, dtype="<u8", offset=_HDR.size)
        if len(bits) != m // 64:
            raise ValueError("bloom shard truncated")
        return _all_set(bits.astype(np.uint64),
                        _probe_positions(obj_id, k, m))

    def shard_size_bytes(self) -> int:
        return _HDR.size + self.m // 8
