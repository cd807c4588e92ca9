"""K3 ``dict_probe``: the substring probe over a packed value dictionary.

Counterpart of ``tempo_tpu/search/dict_probe.py`` ``_probe_core`` and
``probe_kernel`` (TPU kernel B5) on one device and, in its word form, of
those followed by ``packing.pack_mask_words``. The CUDA kernel is
``csrc/probe.cu``: one cooperative launch a call over tiles of up to
``TILE`` values staged once in shared memory, every term against the
staged tile, either output form written in the same launch (its rule
rendered in PyTorch by ``dict_probe_tiled``). The plain version below is the CPU
path and the reference the kernel is held against on the card.

Inputs:
  buf      uint8 [N]      the values' UTF-8 bytes, value after value
  off      int32 [V+1]    value v owns buf[off[v]:off[v+1]]
  needles  uint8 [T, L]   needle t in its first lens[t] bytes, 1 <= L <= 64
  lens     int32 [T]      0 = the empty needle (matches every value);
                          -1 = a term that matches no value
buf and off lie on the device that runs the probe; needles and lens lie
in host memory, where the kernel's launch reads them (they travel in its
parameters, with no copy to the card). Outputs: hits bool [T, V] (value
v contains needle t, never across a value boundary) or, with `words`,
int32 [T, ceil(V/32)] (bit i of word w = value 32w+i; bits past V are 0),
and any_hits bool [T].

Launch counts: ``LAUNCHES`` (every K3 launch) and ``WORD_LAUNCHES`` (the
launches that wrote words).
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCount
from .build import check, load, on_device
from .pack import pack_mask_words_plain

LAUNCHES = LaunchCount()        # every K3 launch
WORD_LAUNCHES = LaunchCount()   # the launches that wrote words

MAX_NEEDLE = 64
TILE = 2048          # csrc/probe.cu kTile: values a tile, at most
CHUNK = 32640        # kChunk: starts a staged chunk of a tile's bytes
LAUNCH_TERMS = 56    # kLaunchTerms: terms a launch, at most


def dict_probe(buf, off, needles, lens, words=False):
    """(hits or words, any_hits) — the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    if buf.device.type == "cpu":
        hits, any_hits = dict_probe_plain(buf, off, needles, lens)
        return (pack_mask_words_plain(hits) if words else hits), any_hits
    return _dict_probe_cuda(buf, off, needles, lens, words)


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
        needle = needles[t].tolist()
        acc = pos >= 0
        for j in range(ln):
            acc &= (buf_ext[j:j + N] == needle[j]) \
                & (pos_ext[j:j + N] == pos)
        c = torch.cat([acc.new_zeros(1, dtype=torch.int64),
                       torch.cumsum(acc.to(torch.int64), 0)])
        hits[t] = (c[ends] - c[starts]) > 0
    return hits, hits.any(dim=1)


def dict_probe_tiled(buf, off, needles, lens, words=False, tile=TILE,
                     grid=1):
    """K3's rule as its kernel runs it, in PyTorch (no card path uses it).
    `grid` CTAs (at most one a tile) take tiles of `tile` values (a
    multiple of 32; the launcher picks it with ``tile_for``) in turn: CTA
    g tiles g, g + grid, .... A tile stages its offsets and then its bytes
    chunk by chunk: starts [c0, c0 + CHUNK) with a halo of MAX_NEEDLE - 1
    bytes, from the 16-byte boundary at or below buf + c0 (by the tensor's
    address). For each term, (A) a bitmap marks every staged byte where
    the needle's last two bytes sit (its one byte, for a needle of one
    byte), 32 bytes a thread a step; (B) each marked byte names a start
    (the byte less the needle's length less two); one in this chunk
    whose whole needle matches counts for the value that holds it (a
    table of each 32-byte group's value, then forward, when candidates
    are dense; a binary search over the staged offsets when sparse) if
    the match ends inside that value. A tile's flags become its bool
    rows or its words; each CTA ORs its flags by term into a row of
    partials, and any_hits ORs those."""
    if tile % 32:
        raise ValueError("a tile holds whole words of flags")
    V = off.numel() - 1
    T = lens.numel()
    lens_l = lens.tolist()
    rows = [needles[t].tolist() for t in range(T)]
    tiles = -(-V // tile)
    G = max(1, min(grid, tiles))
    hits = torch.zeros((T, tiles * tile), dtype=torch.bool)
    partials = torch.zeros((T, G), dtype=torch.bool)
    base = buf.data_ptr()
    for g in range(G):
        for k in range(g, tiles, G):
            v0 = k * tile
            nv = min(tile, V - v0)
            s_off = off[v0:v0 + nv + 1].to(torch.int64).cpu()
            b0, b1 = int(s_off[0]), int(s_off[nv])
            flags = torch.zeros((T, tile), dtype=torch.bool)
            for c0 in range(b0, b1, CHUNK):
                c1 = min(c0 + CHUNK, b1)
                e1 = min(c1 + MAX_NEEDLE - 1, b1)
                _tile_chunk(buf, base, s_off, c0, c1, e1, lens_l, rows,
                            flags)
            for t, ln in enumerate(lens_l):
                if ln == 0:
                    flags[t, :nv] = True
            hits[:, v0:v0 + tile] = flags
            partials[:, g] |= flags.any(dim=1)
    hits = hits[:, :V]
    any_hits = partials.any(dim=1)
    return (pack_mask_words_plain(hits) if words else hits), any_hits


def _tile_chunk(buf, base: int, s_off, c0: int, c1: int, e1: int,
                lens: list, rows: list, flags) -> None:
    """One staged chunk of a tile (``dict_probe_tiled``): ORs into `flags`
    the values that hold a confirmed match starting in [c0, c1)."""
    shift = (base + c0) % 16
    n = shift + e1 - c0
    staged = torch.zeros(n + 2 * MAX_NEEDLE + 32, dtype=torch.uint8)
    staged[shift:n] = buf[c0:e1].cpu()
    span, lim = c1 - c0, e1 - c0
    for t, ln in enumerate(lens):
        if ln <= 0:
            continue
        key = ln - 2 if ln > 1 else 0
        # (A) the marked bytes, as far as a start in this chunk reaches
        ncw = -(-(shift + span + key) // 32)
        cand = staged[:32 * ncw] == rows[t][key]
        if ln > 1:
            cand &= staged[1:32 * ncw + 1] == rows[t][key + 1]
        # (B) their starts: in this chunk, inside the staged bytes, the
        # whole needle, the owner, the match ending inside it
        st = torch.nonzero(cand).reshape(-1) - key
        r = st - shift
        st = st[(r >= 0) & (r < span) & (r + ln <= lim)]
        ok = torch.ones(st.shape, dtype=torch.bool)
        for j in range(ln):
            ok &= staged[st + j] == rows[t][j]
        p = c0 - shift + st[ok]
        owner = torch.searchsorted(s_off, p, right=True) - 1
        flags[t, owner[p + ln <= s_off[owner + 1]]] = True


# ---------------------------------------------------------------------------
# the card path

_LIB = None     # the typed library, once checked against this module


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = load("probe")
    p = ctypes.c_void_p
    i32, i64 = ctypes.c_int, ctypes.c_int64
    lib.tt_dict_probe.restype = i32
    lib.tt_dict_probe.argtypes = [p, p, i64, p, p, i32, i32, i32, p, i64, p]
    lib.tt_probe_tile_for.restype = i32
    lib.tt_probe_tile_for.argtypes = [i64, i32]
    lib.tt_probe_out_bytes.restype = i64
    lib.tt_probe_out_bytes.argtypes = [i32, i64, i32]
    for fn in (lib.tt_probe_tile, lib.tt_probe_chunk,
               lib.tt_probe_launch_terms):
        fn.restype = i32
        fn.argtypes = []
    if (lib.tt_probe_tile() != TILE or lib.tt_probe_chunk() != CHUNK
            or lib.tt_probe_launch_terms() != LAUNCH_TERMS
            or any(lib.tt_probe_out_bytes(T, V, w) != out_layout(T, V, w)[0]
                   for T, V, w in ((1, 1_050_711, 0), (3, 4097, 1),
                                   (40, 0, 0)))
            or any(lib.tt_probe_tile_for(V, c) != tile_for(V, c)
                   for V, c in ((1_050_711, 528), (8192, 528), (33, 528),
                                (60_000, 132), (10**8, 528)))):
        raise RuntimeError("csrc/probe.cu and kernels/probe.py disagree on "
                           "K3's constants")
    _LIB = lib
    return lib


def out_layout(T: int, V: int, words: bool) -> tuple:
    """(bytes, any_at): K3's output allocation, csrc/probe.cu out_bytes:
    the rows (bool [T, V] or int32 words [T, ceil(V/32)]), any_hits [T]
    from the next 16-byte boundary (`any_at`), then the kernel's partials
    [T, grid] from the one after (grid <= tiles <= ceil(V/32)), in whole
    16-byte units."""
    W = -(-V // 32)
    rows = T * W * 4 if words else T * V
    any_at = -(-rows // 16) * 16
    part_at = -(-(any_at + T) // 16) * 16
    return -(-(part_at + T * max(1, W)) // 16) * 16, any_at


def tile_for(V: int, cap: int) -> int:
    """csrc/probe.cu tile_for: the values a tile for V values on a card
    that holds `cap` CTAs at once: no more tiles than CTAs where V
    allows, a multiple of 32 in [32, TILE]."""
    t = -(-V // max(cap, 1))
    return max(32, min(TILE, -(-t // 32) * 32))


def launches(T: int) -> int:
    """K3 launches of a call over T terms."""
    return -(-T // LAUNCH_TERMS)


def _dict_probe_cuda(buf, off, needles, lens, words):
    dev = buf.device
    if (buf.dtype != torch.uint8 or off.dtype != torch.int32
            or needles.dtype != torch.uint8 or lens.dtype != torch.int32
            or buf.dim() != 1 or off.dim() != 1 or needles.dim() != 2
            or off.device != dev or not buf.is_contiguous()
            or not off.is_contiguous() or not needles.is_contiguous()
            or not lens.is_contiguous() or needles.is_cuda or lens.is_cuda):
        _refuse(buf, off, needles, lens)
    T, L = needles.shape
    V = off.numel() - 1
    if lens.numel() != T or T < 1 or V < 0:
        raise ValueError("needles [T, L] and lens [T] disagree, T = 0, or "
                         "off holds no offsets")
    if not 1 <= L <= MAX_NEEDLE:
        raise ValueError(f"needle width {L} outside 1..{MAX_NEEDLE}")
    nbytes, any_at = out_layout(T, V, words)
    # one allocation: the rows, any_hits and the kernel's partials
    out = torch.empty(nbytes, dtype=torch.bool, device=dev)
    lib = _LIB or _lib()
    rc = on_device(dev, lib.tt_dict_probe, buf.data_ptr(), off.data_ptr(), V,
                   needles.data_ptr(), lens.data_ptr(), T, L, int(words),
                   out.data_ptr(), nbytes)
    if rc:
        check(lib, rc, "dict_probe")
    for _ in range(launches(T)):
        LAUNCHES.bump()
        if words:
            WORD_LAUNCHES.bump()
    if words:
        W = -(-V // 32)
        hits = out.view(torch.int32).as_strided((T, W), (W, 1))
    else:
        hits = out.as_strided((T, V), (V, 1))
    return hits, out.as_strided((T,), (1,), any_at)


def _refuse(buf, off, needles, lens):
    for name, t, dt, dim in (("buf", buf, torch.uint8, 1),
                             ("off", off, torch.int32, 1),
                             ("needles", needles, torch.uint8, 2),
                             ("lens", lens, torch.int32, 1)):
        if t.dtype != dt or t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {dt} of {dim} "
                             f"dims, got {t.dtype} {tuple(t.shape)}")
    if off.device != buf.device:
        raise ValueError("buf and off must lie on one device")
    raise ValueError("needles and lens travel in K3's launch parameters: "
                     "pass them as host tensors")
