"""K3 ``dict_probe``: the substring probe over a packed value dictionary.

Counterpart of ``tempo_tpu/search/dict_probe.py`` ``_probe_core`` and
``probe_kernel`` (TPU kernel B5) on one device. The CUDA kernel is
``csrc/probe.cu``; the plain PyTorch version below is the CPU path and the
reference the kernel is held against on the card.

Inputs (all on one device, contiguous):
  buf      uint8 [N]      the values' UTF-8 bytes, value after value
  off      int32 [V+1]    value v owns buf[off[v]:off[v+1]]
  needles  uint8 [T, L]   needle t in its first lens[t] bytes, 1 <= L <= 64
  lens     int32 [T]      0 = the empty needle (matches every value);
                          -1 = a term that matches no value
Outputs: hits bool [T, V] (value v contains needle t, never across a value
boundary) and any_hits bool [T].
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCount
from .build import check, load

LAUNCHES = LaunchCount()

MAX_NEEDLE = 64


def dict_probe(buf, off, needles, lens):
    """(hits, any_hits) — the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if buf.device.type == "cpu":
        return dict_probe_plain(buf, off, needles, lens)
    return _dict_probe_cuda(buf, off, needles, lens)


def dict_probe_plain(buf, off, needles, lens):
    """The same function in plain PyTorch ops: the reference's rolling-
    window formulation. A window of length L starting at byte i matches
    when every byte equals the needle's and lies in the value that owns
    byte i; per-value hits come from a cumulative sum of match starts
    differenced at the value offsets."""
    dev = buf.device
    V = off.numel() - 1
    N = buf.numel()
    T = lens.numel()
    L = needles.shape[1]
    lengths = (off[1:] - off[:-1]).to(torch.int64)
    pos = torch.full((N,), -1, dtype=torch.int64, device=dev)
    used = int(off[V]) if V > 0 else 0
    pos[:used] = torch.repeat_interleave(
        torch.arange(V, dtype=torch.int64, device=dev), lengths)
    buf_ext = torch.cat([buf, buf.new_zeros(L)])
    pos_ext = torch.cat([pos, pos.new_full((L,), -2)])
    starts = off[:-1].to(torch.int64)
    ends = off[1:].to(torch.int64)
    hits = torch.zeros((T, V), dtype=torch.bool, device=dev)
    for t, ln in enumerate(lens.tolist()):
        if ln < 0:
            continue
        if ln == 0:
            hits[t] = True
            continue
        acc = pos >= 0
        for j in range(ln):
            acc &= (buf_ext[j:j + N] == needles[t, j]) \
                & (pos_ext[j:j + N] == pos)
        c = torch.cat([acc.new_zeros(1, dtype=torch.int64),
                       torch.cumsum(acc.to(torch.int64), 0)])
        hits[t] = (c[ends] - c[starts]) > 0
    return hits, hits.any(dim=1)


def _lib():
    lib = load("probe")
    if not getattr(lib, "_tt_typed", False):
        p = ctypes.c_void_p
        lib.tt_dict_probe.restype = ctypes.c_int
        lib.tt_dict_probe.argtypes = [p, p, ctypes.c_int64, p, p,
                                      ctypes.c_int, ctypes.c_int, p, p, p]
        lib._tt_typed = True
    return lib


def _dict_probe_cuda(buf, off, needles, lens):
    dev = buf.device
    for name, t, dt, dim in (("buf", buf, torch.uint8, 1),
                             ("off", off, torch.int32, 1),
                             ("needles", needles, torch.uint8, 2),
                             ("lens", lens, torch.int32, 1)):
        if t.dtype != dt or t.dim() != dim:
            raise ValueError(f"{name}: want {dt} of {dim} dims, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError("dict_probe inputs must be contiguous tensors "
                             "on one device")
    T, L = needles.shape
    if lens.numel() != T or T < 1:
        raise ValueError("needles [T, L] and lens [T] disagree, or T = 0")
    if not 1 <= L <= MAX_NEEDLE:
        raise ValueError(f"needle width {L} outside 1..{MAX_NEEDLE}")
    V = off.numel() - 1
    if V < 0:
        raise ValueError("off must hold V+1 offsets")
    hits = torch.empty((T, V), dtype=torch.bool, device=dev)
    any_hits = torch.zeros(T, dtype=torch.bool, device=dev)
    if V == 0:
        return hits, any_hits   # nothing to probe, nothing launched
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_dict_probe(buf.data_ptr(), off.data_ptr(), V,
                               needles.data_ptr(), lens.data_ptr(), T, L,
                               hits.data_ptr(), any_hits.data_ptr(), stream)
    check(lib, rc, "dict_probe")
    LAUNCHES.bump()
    return hits, any_hits
