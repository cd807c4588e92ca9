"""Page compression codecs for the port.

Counterpart of the reference's ``encoding/v2/compression.py``, with the
stdlib codecs only: ``none``, ``gzip`` and ``zlib`` always work, ``zstd``
works when the ``zstandard`` package imports. A codec that is not usable
raises; the port never rewrites the codec a caller asked for (the
reference's ``best_available`` degradation is deliberately not ported).
"""

from __future__ import annotations

import gzip as _gzip
import zlib as _zlib

try:
    import zstandard as _zstd
except ImportError:
    _zstd = None


def _zstd_or_raise():
    if _zstd is None:
        raise RuntimeError("zstd needs the zstandard package, which is not "
                           "installed; use zlib, gzip or none")
    return _zstd


# codecs of the reference that need its native runtime, which the port
# does not bind yet
NATIVE_ENCODINGS = ("lz4", "snappy", "s2")


def usable(encoding: str) -> bool:
    """Can this process compress and decompress `encoding`?"""
    return encoding in ("none", "gzip", "zlib") or (
        encoding == "zstd" and _zstd is not None)


def compress(data: bytes, encoding: str, level: int = 3) -> bytes:
    if encoding == "none":
        return data
    if encoding == "gzip":
        return _gzip.compress(data, compresslevel=min(level + 3, 9))
    if encoding == "zlib":
        return _zlib.compress(data, level + 3)
    if encoding == "zstd":
        return _zstd_or_raise().ZstdCompressor(level=level).compress(data)
    raise ValueError(f"unsupported encoding {encoding!r}")


def decompress(data: bytes, encoding: str) -> bytes:
    if encoding == "none":
        return data
    if encoding == "gzip":
        return _gzip.decompress(data)
    if encoding == "zlib":
        return _zlib.decompress(data)
    if encoding == "zstd":
        return _zstd_or_raise().ZstdDecompressor().decompress(data)
    raise ValueError(f"unsupported encoding {encoding!r}")
