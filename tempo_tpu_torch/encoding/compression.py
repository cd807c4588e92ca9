"""Page compression codecs for the port.

Counterpart of the reference's ``encoding/v2/compression.py``: ``none``,
``gzip`` and ``zlib`` from the standard library; ``zstd``, ``lz4``,
``snappy`` and ``s2`` through the port's host library (``ops/native.py``).
``s2`` is snappy, as in the reference. zstd goes through the library when
the host has ``libzstd.so.1`` and through the ``zstandard`` package
otherwise, in the reference's order. A codec that is not usable raises;
the port never rewrites the codec a caller asked for (the reference's
``best_available`` degradation is deliberately not ported).
"""

from __future__ import annotations

import gzip as _gzip
import zlib as _zlib

from ..ops import native

try:
    import zstandard as _zstd
except ImportError:
    _zstd = None

ENCODINGS = ("none", "gzip", "zlib", "zstd", "lz4", "snappy", "s2")

# the host library's codec each name uses
_LIBRARY_CODEC = {"zstd": "zstd", "lz4": "lz4", "snappy": "snappy",
                  "s2": "snappy"}


def _library_has(encoding: str) -> bool:
    return native.has_codec(_LIBRARY_CODEC[encoding])


def usable(encoding: str) -> bool:
    """Can this process compress and decompress `encoding`?"""
    if encoding in ("none", "gzip", "zlib"):
        return True
    if encoding not in _LIBRARY_CODEC:
        return False
    return _library_has(encoding) or (encoding == "zstd"
                                      and _zstd is not None)


def why_unusable(encoding: str) -> str:
    """What a process lacks for `encoding` (a phrase for error messages)."""
    if encoding not in ENCODINGS:
        return f"{encoding!r} is no codec; supported are {', '.join(ENCODINGS)}"
    if encoding == "zstd":
        return "zstd needs libzstd.so.1 or the zstandard package"
    lib = "liblz4.so.1" if encoding == "lz4" else "the host library's snappy"
    return f"{encoding} needs {lib}"


def _unusable(encoding: str):
    raise RuntimeError(f"{encoding} unavailable: {why_unusable(encoding)}")


def compress(data: bytes, encoding: str, level: int = 3) -> bytes:
    if encoding == "none":
        return data
    if encoding == "gzip":
        return _gzip.compress(data, compresslevel=min(level + 3, 9))
    if encoding == "zlib":
        return _zlib.compress(data, level + 3)
    if encoding in _LIBRARY_CODEC:
        if _library_has(encoding):
            if encoding == "zstd":
                return native.zstd_compress(data, level)
            if encoding == "lz4":
                return native.lz4_compress(data)
            return native.snappy_compress(data)
        if encoding == "zstd" and _zstd is not None:
            return _zstd.ZstdCompressor(level=level).compress(data)
        _unusable(encoding)
    raise ValueError(f"unsupported encoding {encoding!r}")


def decompress(data: bytes, encoding: str) -> bytes:
    if encoding == "none":
        return data
    if encoding == "gzip":
        return _gzip.decompress(data)
    if encoding == "zlib":
        return _zlib.decompress(data)
    if encoding in _LIBRARY_CODEC:
        if _library_has(encoding):
            if encoding == "zstd":
                return native.zstd_decompress(data)
            if encoding == "lz4":
                return native.lz4_decompress(data)
            return native.snappy_decompress(data)
        if encoding == "zstd" and _zstd is not None:
            return _zstd.ZstdDecompressor().decompress(data)
        _unusable(encoding)
    raise ValueError(f"unsupported encoding {encoding!r}")
