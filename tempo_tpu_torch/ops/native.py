"""ctypes binding of the port's native host runtime
(``tempo_tpu_torch/csrc/host/tempotpu.cc``): block codecs (zstd, lz4,
snappy), XXH64, CRC32C, the dictionary substring scan and the OTLP ingest
walker. The counterpart of the reference's ``ops/native.py``, with its
functions and wire forms: lz4 and snappy blocks carry a u64 length
prefix, so WAL files and pages pass between the two packages both ways.

The library is built at the first call that needs it, never at import:
the host's C++ compiler (``$CXX``, else ``g++``) compiles the one source
into ``tempo_tpu_torch/csrc/build/``, named by a hash of the source, the
flags and the compiler, with the compiler's output saved beside it; later
processes reuse a library whose name matches. Processes that build at
once write temporary names and rename atomically. A failed build or load
raises with the compiler's log; nothing falls back to a Python path.

zstd and lz4 come from the host's ``libzstd.so.1`` and ``liblz4.so.1``,
opened by the library at their first use, so a host without one of them
loses that codec only: ``codecs()`` names the codecs that loaded, and a
call into a missing one raises ``CodecUnavailable``. Snappy is the
library's own, and the rest needs nothing external.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCE = CSRC / "host" / "tempotpu.cc"
BUILD_DIR = CSRC / "build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
LIBS = ["-ldl"]

_lock = threading.Lock()
_LIB = None
_CODECS: tuple = ()
# the compiler's output for the loaded library (its version line first),
# and whether this process compiled it or found it built
BUILD_LOG = ""
BUILT = False


class CodecUnavailable(RuntimeError):
    """The host lacks the library of the codec asked for."""


class NativeBufferTooSmall(RuntimeError):
    pass


class InvalidTraceId(ValueError):
    """The walker met a span whose trace id is empty or longer than 16
    bytes; the caller runs the Python walk, which raises its own error."""


def compiler() -> str:
    """The C++ compiler the build uses: ``$CXX``, else ``g++``, else
    ``c++`` on PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler ($CXX, g++ or c++): the port's "
                           "host library cannot be built")
    return cxx


def _target(cxx: str) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join([cxx, *CXX_FLAGS, *LIBS]).encode())
    return BUILD_DIR / f"libtempotpu-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the host library unless a library of this source, flags
    and compiler is built already; returns its path. Raises with the
    compiler's output if the build fails."""
    global BUILD_LOG, BUILT
    cxx = compiler()
    out = _target(cxx)
    log_path = out.with_suffix(".log")
    if out.exists() and log_path.exists():
        BUILD_LOG = log_path.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    tmp = out.with_name(f".{out.name}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    log = (version.splitlines() or [cxx])[0] + "\n$ " + " ".join(cmd) \
        + "\n" + proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed (exit "
                           f"{proc.returncode}):\n{log}")
    # the log first, then the library: a library never lacks its log
    tmp_log = tmp.with_suffix(".log")
    tmp_log.write_text(log)
    os.replace(tmp_log, log_path)
    os.replace(tmp, out)
    BUILD_LOG, BUILT = log, True
    return out


def _bind(lib: ctypes.CDLL) -> None:
    cp, sz, ll = ctypes.c_char_p, ctypes.c_size_t, ctypes.c_longlong
    for name in ("tt_zstd_decompress", "tt_lz4_compress",
                 "tt_lz4_decompress", "tt_snappy_compress",
                 "tt_snappy_decompress"):
        fn = getattr(lib, name)
        fn.restype = ll
        fn.argtypes = [cp, sz, cp, sz]
    lib.tt_zstd_compress.restype = ll
    lib.tt_zstd_compress.argtypes = [cp, sz, cp, sz, ctypes.c_int]
    lib.tt_zstd_content_size.restype = ll
    lib.tt_zstd_content_size.argtypes = [cp, sz]
    lib.tt_codecs.restype = ctypes.c_int
    lib.tt_codecs.argtypes = []
    lib.tt_xxhash64.restype = ctypes.c_ulonglong
    lib.tt_xxhash64.argtypes = [cp, sz, ctypes.c_ulonglong]
    lib.tt_crc32c.restype = ctypes.c_uint
    lib.tt_crc32c.argtypes = [cp, sz, ctypes.c_uint]
    lib.tt_ingest_regroup2.restype = ll
    lib.tt_ingest_regroup2.argtypes = [cp, sz, ll, ll, ll, ll, cp, sz]
    lib.tt_substr_scan.restype = ll
    lib.tt_substr_scan.argtypes = [
        cp, ctypes.POINTER(ll), ll, cp, ll, ctypes.POINTER(ctypes.c_int),
        ll]


def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB, _CODECS
    got = _LIB
    if got is not None:
        return got
    with _lock:
        if _LIB is None:
            loaded = ctypes.CDLL(str(build()))
            _bind(loaded)
            bits = loaded.tt_codecs()   # opens the codec libraries
            _CODECS = tuple(name for name, bit in _CODEC_BITS if bits & bit)
            _LIB = loaded
        return _LIB


_CODEC_BITS = (("zstd", 1), ("lz4", 2), ("snappy", 4))


def codecs() -> tuple:
    """The codecs whose libraries loaded, of zstd, lz4 and snappy."""
    lib()
    return _CODECS


def has_codec(name: str) -> bool:
    return name in codecs()


_LEN_HDR = struct.Struct("<Q")  # uncompressed length of an lz4/snappy block
_LEN32 = struct.Struct("<I")


def _unavailable(codec: str):
    raise CodecUnavailable(f"{codec}: this host has no lib{codec}.so.1, so "
                           "this process cannot use the codec")


def _bytes(data) -> bytes:
    # ctypes passes bytes as char*; a bytearray or memoryview is copied
    return data if isinstance(data, bytes) else bytes(data)


def _run(fn_name: str, data, cap: int, *extra) -> bytes:
    data = _bytes(data)
    out = ctypes.create_string_buffer(max(1, cap))
    n = getattr(lib(), fn_name)(data, len(data), out, cap, *extra)
    if n == -2:
        raise NativeBufferTooSmall(fn_name)
    if n == -5:
        _unavailable(fn_name.split("_")[1])
    if n < 0:
        raise RuntimeError(f"{fn_name} failed ({n})")
    return ctypes.string_at(out, n)


def zstd_compress(data: bytes, level: int = 3) -> bytes:
    return _run("tt_zstd_compress", data,
                len(data) + (len(data) >> 6) + 1024, level)


# a corrupt frame header must not drive an allocation: nothing written
# here exceeds this
_ZSTD_MAX_ONESHOT = 1 << 30


def zstd_decompress(data: bytes) -> bytes:
    """A frame that declares its size is inflated into one allocation of
    that size; a frame without one (a streamed writer's, or several
    frames) through a growing buffer."""
    data = _bytes(data)
    size = lib().tt_zstd_content_size(data, len(data))
    if size == -5:
        _unavailable("zstd")
    if 0 <= size <= _ZSTD_MAX_ONESHOT:
        try:
            return _run("tt_zstd_decompress", data, int(size))
        except NativeBufferTooSmall:
            pass   # several frames: the first one's size is not the total
    elif size == -1:
        raise RuntimeError("zstd decompress failed: not a zstd frame")
    bound = max(1 << 16, len(data) * 32)
    for _ in range(4):
        try:
            return _run("tt_zstd_decompress", data, bound)
        except NativeBufferTooSmall:
            bound *= 8
    raise RuntimeError("zstd decompress failed: frame too large")


def lz4_compress(data: bytes) -> bytes:
    body = _run("tt_lz4_compress", data, len(data) + len(data) // 255 + 64)
    return _LEN_HDR.pack(len(data)) + body


def lz4_decompress(data: bytes) -> bytes:
    (n,) = _LEN_HDR.unpack_from(data)
    return _run("tt_lz4_decompress", data[_LEN_HDR.size:], int(n))


def snappy_compress(data: bytes) -> bytes:
    # the C side's bound: 32 + n + n / 6
    body = _run("tt_snappy_compress", data, 32 + len(data) + len(data) // 6)
    return _LEN_HDR.pack(len(data)) + body


def snappy_decompress(data: bytes) -> bytes:
    (n,) = _LEN_HDR.unpack_from(data)
    return _run("tt_snappy_decompress", data[_LEN_HDR.size:], int(n))


def xxhash64(data: bytes, seed: int = 0) -> int:
    data = _bytes(data)
    return int(lib().tt_xxhash64(data, len(data),
                                 seed & 0xFFFFFFFFFFFFFFFF))


def crc32c(data: bytes, crc: int = 0) -> int:
    data = _bytes(data)
    return int(lib().tt_crc32c(data, len(data), crc))


def ingest_regroup(batch_blobs: list, max_search_bytes: int,
                   spans: bool = False, max_spans: int = 512,
                   max_span_kvs: int = 16):
    """Regroup by trace and search-data extraction over SERIALIZED
    ResourceSpans, in one native pass (``tt_ingest_regroup2``). Returns
    ``(n_spans, [(padded_tid, start_s, end_s, segment, search_data)],
    summaries)``: the items in first-seen order, byte for byte what
    ``modules/distributor.py`` ``push_items`` builds from the Python walk,
    and the per-span summaries for the metrics generator (a string table
    and 56-byte rows). ``spans=True`` adds each trace's span section,
    capped at `max_spans` rows and `max_span_kvs` pairs a row. Raises
    ``InvalidTraceId`` for a span whose trace id is empty or longer than
    16 bytes, and RuntimeError for bytes that are not ResourceSpans."""
    src = b"".join(_LEN32.pack(len(b)) + b for b in batch_blobs)
    cap = max(4096, len(src) * 2 + 1024)
    fn = lib().tt_ingest_regroup2
    while True:
        dst = ctypes.create_string_buffer(cap)
        got = fn(src, len(src), max_search_bytes, 1 if spans else 0,
                 int(max_spans), int(max_span_kvs), dst, cap)
        if got == -3:
            cap *= 2
            continue
        if got == -4:
            raise InvalidTraceId("invalid trace id length")
        if got < 0:
            raise RuntimeError(f"tt_ingest_regroup2 failed ({got})")
        buf = ctypes.string_at(dst, got)
        break
    n_traces, n_spans = struct.unpack_from("<II", buf, 0)
    out = []
    off = 8
    for _ in range(n_traces):
        tid = buf[off:off + 16]
        start_s, end_s, seg_len = struct.unpack_from("<III", buf, off + 16)
        off += 28
        seg = buf[off:off + seg_len]
        off += seg_len
        (sd_len,) = _LEN32.unpack_from(buf, off)
        off += 4
        out.append((tid, start_s, end_s, seg, buf[off:off + sd_len]))
        off += sd_len
    return n_spans, out, buf[off:]


def substr_scan(packed: bytes, offsets, needle: bytes):
    """Ids (int32, ascending) of the packed dictionary's strings that
    contain `needle`: ``packed`` the strings' utf-8 bytes end to end,
    ``offsets`` their n+1 int64 byte offsets."""
    import numpy as np

    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    if n < 0 or int(offsets[-1]) > len(packed):
        raise ValueError("offsets do not fit the packed dictionary")
    cap = max(1024, n // 8)
    off_p = offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))
    fn = lib().tt_substr_scan
    while True:
        out = np.empty(cap, dtype=np.int32)
        got = fn(packed, off_p, n, needle, len(needle),
                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), cap)
        if got == -2:
            cap = min(n, cap * 8)
            continue
        if got < 0:
            raise RuntimeError(f"tt_substr_scan failed ({got})")
        return out[:got].copy()
