"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``tempo_tpu_torch/csrc/<name>.cu`` (with the ``*.cuh`` headers it
includes) compiles into its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), for ``sm_90a``. The
first call to :func:`load` starts one ``nvcc`` per source, all at once,
waits for them, and caches the results under
``tempo_tpu_torch/csrc/build/`` named by a hash of the source, the
headers and the flags, with nvcc's output (ptxas's register and spill
report) saved beside each; later processes reuse a library whose hash
matches and read its saved report. Nothing is built when the package is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas -v register/spill lines) per source, of the
# library this process loads: its own build's or the cached one's saved log
BUILD_LOG: dict[str, str] = {}
# the sources this process compiled (the others came from the cache)
BUILT: set[str] = set()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):   # the shared headers too
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every csrc/*.cu whose library (or its saved nvcc log) is
    missing, one nvcc process per source, all started together, and fill
    ``BUILD_LOG`` for every source. Returns name -> library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src))
               for src in sorted(CSRC.glob("*.cu"))}
    procs = {}
    for name, (src, out) in targets.items():
        log = out.with_suffix(".log")
        if out.exists() and log.exists():
            BUILD_LOG[name] = log.read_text()
            continue
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        BUILT.add(name)
        # the log first, then the library (atomic renames: a concurrent
        # builder loses nothing, and a library is never without its log)
        tmp_log = tmp.with_suffix(".log")
        tmp_log.write_text(log)
        os.replace(tmp_log, out.with_suffix(".log"))
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: out for name, (_src, out) in targets.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building all sources first if
    needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            for n, p in paths.items():
                _libs[n] = ctypes.CDLL(str(p))
            lib = _libs[name]
        return lib


def on_device(dev, fn, *args):
    """``fn(*args, stream)``, the stream being `dev`'s current one as a raw
    handle: a lean launch path for wrappers whose host time matters. It
    enters ``torch.cuda.device(dev)`` only when `dev` is not the current
    device already."""
    idx = dev.index
    if idx == _current_device():
        return fn(*args, _raw_stream(idx))
    with torch.cuda.device(dev):
        return fn(*args, _raw_stream(idx))


# the current stream's handle as an int, without building a Stream object,
# and the current device without torch.cuda's lazy-init check (a CUDA
# tensor exists, so CUDA is up)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_current_device = getattr(torch._C, "_cuda_getDevice",
                          torch.cuda.current_device)


def _raw_stream(idx: int) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(idx)
    return torch.cuda.current_stream(idx).cuda_stream


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        lib.tt_cuda_error_string.restype = ctypes.c_char_p
        lib.tt_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.tt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
