"""K5 ``pack_mask_words``: bool hit masks to 32-bit words.

Counterpart of ``tempo_tpu/search/packing.py`` ``_pack_mask_jit`` and
``pack_mask_words`` (the mask half of TPU kernel B4). The CUDA kernel is
``csrc/pack.cu``; the plain PyTorch version below is the CPU path and the
reference the kernel is held against on the card.

Input: hits bool [..., V], contiguous. Output: int32 [..., ceil(V/32)]
holding uint32 bits: bit i of word w is hits[..., 32w + i], and the bits
past V are 0.
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCount
from .build import check, load

LAUNCHES = LaunchCount()


def pack_mask_words(hits):
    """Words of a bool mask — the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if hits.device.type == "cpu":
        return pack_mask_words_plain(hits)
    return _pack_cuda(hits)


def pack_mask_words_plain(hits):
    """The reference's formulation in plain PyTorch ops: pad V to a
    multiple of 32, shift each bit to its place, sum per word (on int64,
    then the low 32 bits as int32)."""
    V = hits.shape[-1]
    W = -(-V // 32)
    u = hits.to(torch.int64)
    if W * 32 != V:
        u = torch.cat([u, u.new_zeros(hits.shape[:-1] + (W * 32 - V,))],
                      dim=-1)
    u = u.reshape(hits.shape[:-1] + (W, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=hits.device)
    words = (u << shifts).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _lib():
    lib = load("pack")
    if not getattr(lib, "_tt_typed", False):
        p = ctypes.c_void_p
        lib.tt_pack_mask_words.restype = ctypes.c_int
        lib.tt_pack_mask_words.argtypes = [p, ctypes.c_int64, ctypes.c_int64,
                                           p, p]
        lib._tt_typed = True
    return lib


def _pack_cuda(hits):
    if hits.dtype != torch.bool or hits.dim() < 1:
        raise ValueError(f"pack_mask_words takes a bool [..., V] mask, got "
                         f"{hits.dtype} {tuple(hits.shape)}")
    if not hits.is_contiguous():
        raise ValueError("pack_mask_words takes a contiguous mask")
    dev = hits.device
    V = int(hits.shape[-1])
    W = -(-V // 32)
    rows = hits.numel() // V if V else 0
    out = torch.empty(hits.shape[:-1] + (W,), dtype=torch.int32, device=dev)
    if rows == 0 or W == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_pack_mask_words(hits.data_ptr(), rows, V,
                                    out.data_ptr(), stream)
    check(lib, rc, "pack_mask_words")
    LAUNCHES.bump()
    return out
