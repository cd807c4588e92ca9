"""Packed residency: narrow staged columns, unpacked inside the scans.

Counterpart of the reference's ``search/packing.py``. With the gate on,
a staged batch keeps its columns at the width its dictionaries and its
duration rollup need:

  kv id columns   code = id + 1 (pad -1 -> 0) as u8 / u16 / u32, or
                  u4: two codes per byte (low nibble = even slot) for
                  dictionaries of at most 15 values
  duration        exact u16 when the batch's largest duration fits;
                  else u16 buckets ``dur >> s`` plus the shifted-out low
                  bits as a residual column (u8 for s <= 8, else u16)
  probe hit masks bool [..., V] -> 32-bit words [..., ceil(V/32)]

K1, K1s and K4 (``kernels.scan``) read these bytes as they are: the
widening, the bucket compare and the bit select happen in registers.
Results are the same with the gate off or on; only the staged bytes
move.

The reference's gate is one process-wide switch (``PACKING``, the most
recent TempoDB wins). The port carries ``packed`` on each engine instead
(``TempoDBConfig.search_packed_residency`` -> ``BlockBatcher`` ->
``MultiBlockEngine``; ``BackendSearchBlock(packed=...)`` ->
``ScanEngine``), so two databases in one process keep their own layouts.

Unsigned columns on the device follow the port's convention for the
container's uint32 columns: the bits sit in a signed tensor of the same
width (u16 in int16, u32 in int32, hit-mask words in int32); u4 and u8
are uint8. The host half below is numpy and matches the reference's
arrays byte for byte; the device half is plain torch, which the kernels'
plain versions use.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.pack import pack_mask_words as _pack_kernel

_KV_DTYPES = {"u8": np.uint8, "u16": np.uint16, "u32": np.uint32}
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# width selection (host)


def plan_widths(n_keys: int, n_vals: int, max_dur_ms: int) -> tuple:
    """(key width, value width, duration width) of a batch whose largest
    dictionaries hold `n_keys` keys and `n_vals` values and whose
    durations are at most `max_dur_ms`."""
    return (width_for_cardinality(n_keys), width_for_cardinality(n_vals),
            dur_width(max_dur_ms))


def width_for_cardinality(n: int) -> str:
    """Narrowest code width for a dictionary of `n` ids. Codes are id+1
    with 0 for the pad slot, so n values need n+1 codes: the limits are
    15, 255 and 65,535."""
    if n <= 15:
        return "u4"
    if n <= 255:
        return "u8"
    if n <= 65_535:
        return "u16"
    return "u32"


def dur_width(max_dur_ms: int) -> str:
    """"u16" when every duration fits 16 bits, else "q<s>": buckets
    ``dur >> s`` with the smallest s that fits 16 bits, plus a
    residual."""
    m = max(0, int(max_dur_ms))
    if m <= 0xFFFF:
        return "u16"
    return f"q{m.bit_length() - 16}"


def legacy_kv_itemsize(n: int) -> int:
    """Bytes per slot of the unpacked layout for a dictionary of `n` ids
    (stack_host's signed narrowing with its -1 pad)."""
    return 1 if n <= 127 else (2 if n <= 32_767 else 4)


def dur_shift(dw: str) -> int:
    """The bucket shift of a duration width: 0 for "u16"."""
    return int(dw[1:]) if dw.startswith("q") else 0


# ---------------------------------------------------------------------------
# packing (host, numpy, at staging time)


def pack_ids_array(arr: np.ndarray, w: str) -> np.ndarray:
    """int32 ids (-1 = pad) -> width-`w` codes (id+1, pad 0). For "u4"
    the last axis must be even; slot 2j is the low nibble of byte j."""
    codes = arr.astype(np.int32, copy=False) + 1
    if w == "u4":
        lo = codes[..., 0::2]
        hi = codes[..., 1::2]
        return (lo | (hi << 4)).astype(np.uint8)
    return codes.astype(_KV_DTYPES[w])


def pack_duration(arr: np.ndarray, dw: str):
    """(buckets-or-exact u16, residual or None) of a uint32 duration
    column under width `dw`."""
    if dw == "u16":
        return arr.astype(np.uint16), None
    s = int(dw[1:])
    a = arr.astype(np.uint32, copy=False)
    res_dt = np.uint8 if s <= 8 else np.uint16
    return (a >> s).astype(np.uint16), (a & ((1 << s) - 1)).astype(res_dt)


def pack_columns(arrays: dict, widths) -> dict:
    """A staged column dict with its kv and duration columns packed;
    adds "entry_dur_res" for bucketed durations. With u4 on either kv
    column and an odd slot count, both columns gain one pad slot so they
    unpack to the same count."""
    kw, vw, dw = widths
    out = dict(arrays)
    kv_key, kv_val = arrays["kv_key"], arrays["kv_val"]
    if "u4" in (kw, vw) and kv_key.shape[-1] % 2:
        pad = [(0, 0)] * (kv_key.ndim - 1) + [(0, 1)]
        kv_key = np.pad(kv_key, pad, constant_values=-1)
        kv_val = np.pad(kv_val, pad, constant_values=-1)
    out["kv_key"] = pack_ids_array(kv_key, kw)
    out["kv_val"] = pack_ids_array(kv_val, vw)
    q, res = pack_duration(arrays["entry_dur"], dw)
    out["entry_dur"] = q
    if res is not None:
        out["entry_dur_res"] = res
    return out


def logical_nbytes(n_entries_padded: int, kv_slots: int, n_keys: int,
                   n_vals: int) -> int:
    """Bytes the unpacked layout would stage for this many (padded)
    entries: narrowed kv columns, u32 start/end/duration, bool valid."""
    kv = n_entries_padded * kv_slots * (legacy_kv_itemsize(n_keys)
                                        + legacy_kv_itemsize(n_vals))
    return int(kv + n_entries_padded * (4 + 4 + 4 + 1))


def device_view(a: np.ndarray) -> np.ndarray:
    """The port's device form of a packed host column: unsigned 16 and
    32-bit arrays as the signed arrays of the same bits."""
    if a.dtype == np.uint16:
        return a.view(np.int16)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a


# ---------------------------------------------------------------------------
# unpacking (device, plain torch): what the kernels do in registers


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of a tensor's bits, as int64."""
    mask = {torch.uint8: 0xFF, torch.int8: 0xFF, torch.int16: 0xFFFF,
            torch.int32: _U32}[x.dtype]
    return x.to(torch.int64) & mask


def unpack_ids(arr: torch.Tensor, w) -> torch.Tensor:
    """int64 ids (-1 = pad) of a kv column of width `w` (None: the
    unpacked layout, whose signed ids pass through widened)."""
    if w is None:
        return arr.to(torch.int64)
    if w == "u4":
        a = _bits(arr)
        codes = torch.stack([a & 0x0F, a >> 4], dim=-1)
        return codes.reshape(arr.shape[:-1] + (arr.shape[-1] * 2,)) - 1
    return _bits(arr) - 1


def duration_ok(entry_dur, entry_dur_res, dur_lo: int, dur_hi: int,
                dw) -> torch.Tensor:
    """The duration range test under width `dw` (None: unpacked u32).
    Bucketed widths compare buckets, exact inside (lo_q, hi_q), and
    rebuild the full value only where a row sits on a boundary
    bucket."""
    lo, hi = int(dur_lo) & _U32, int(dur_hi) & _U32
    if dw is None or not dw.startswith("q"):
        d = _bits(entry_dur)
        return (d >= lo) & (d <= hi)
    s = int(dw[1:])
    q = _bits(entry_dur)
    lo_q, hi_q = lo >> s, hi >> s
    inside = (q > lo_q) & (q < hi_q)
    boundary = (q == lo_q) | (q == hi_q)
    full = (q << s) | _bits(entry_dur_res)
    return inside | (boundary & (full >= lo) & (full <= hi))


def mask_select(row: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """One term's hit row at `ids` (>= 0): `row` is bool [V], or words
    [W] as int32 bits, where word w bit i is id 32w+i. An id past the
    row reads its last element (the last word, for words), as the
    reference's gather does."""
    if is_packed_mask(row):
        word = row[(ids >> 5).clamp(max=row.shape[-1] - 1)]
        return ((_bits(word) >> (ids & 31)) & 1) != 0
    return row[ids.clamp(max=row.shape[-1] - 1)]


def mask_select_grouped(vh: torch.Tensor, g: torch.Tensor, t: int,
                        ids: torch.Tensor) -> torch.Tensor:
    """mask_select on row (g, t) of a [G, T, V] bool or [G, T, W] word
    table; `g` broadcasts against `ids`."""
    last = vh.shape[-1] - 1
    if is_packed_mask(vh):
        word = vh[g, t, (ids >> 5).clamp(max=last)]
        return ((_bits(word) >> (ids & 31)) & 1) != 0
    return vh[g, t, ids.clamp(max=last)]


def is_packed_mask(x) -> bool:
    """True for a hit mask in the word format: an int32 tensor (the
    port's form) or a uint32 array (the reference's)."""
    dt = getattr(x, "dtype", None)
    return dt == torch.int32 or dt == np.uint32


def pack_mask_words(hits):
    """bool [..., V] -> int32 [..., ceil(V/32)] words on the mask's
    device (bit i of word w = value 32w+i; the tail past V is 0). A mask
    already in words passes through. On a CUDA tensor this launches K5
    (``kernels.pack``)."""
    if is_packed_mask(hits):
        return hits
    return _pack_kernel(hits)


def unpack_mask_words(words, v_pad: int) -> np.ndarray:
    """Host expansion of word masks back to bool [..., v_pad]."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    a = np.ascontiguousarray(np.asarray(words)).view(np.uint32)
    bits = np.unpackbits(a.view(np.uint8), axis=-1, bitorder="little")
    return bits[..., :v_pad].astype(bool)
