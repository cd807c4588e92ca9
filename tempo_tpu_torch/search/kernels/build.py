"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``tempo_tpu_torch/csrc/<name>.cu`` compiles into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), for ``sm_90a``. The first call to :func:`load` starts one
``nvcc`` per source, all at once, waits for them, and caches the results
under ``tempo_tpu_torch/csrc/build/`` named by a hash of the source and
flags; later processes reuse a library whose hash matches. Nothing is
built when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output per source of the last build in this process (ptxas -v
# register/shared-memory lines), for whoever wants to print it
BUILD_LOG: dict[str, str] = {}


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
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every csrc/*.cu whose library is missing, one nvcc process
    per source, all started together. Returns name -> library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src))
               for src in sorted(CSRC.glob("*.cu"))}
    procs = {}
    for name, (src, out) in targets.items():
        if out.exists():
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
        os.replace(tmp, out)  # atomic: a concurrent builder loses nothing
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


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        lib.tt_cuda_error_string.restype = ctypes.c_char_p
        lib.tt_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.tt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
