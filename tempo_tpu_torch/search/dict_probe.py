"""The dictionary probe on the device: substring prefilter next to the
columns.

Counterpart of the reference's ``search/dict_probe.py`` on one device. A
block whose value dictionary has at least ``DEVICE_PROBE_MIN_VALS``
distinct values stages the dictionary's bytes with its pages; query
compilation then answers each tag term's substring test with kernel K3
(``kernels.probe.dict_probe``) and hands the scan a ``[T, V]`` hit mask
instead of folding host id sets into ranges. Nothing but the prune
decision (``any_hits``, T bools) comes back to the host.

Layout, packed once per dictionary and memoized on the block's container:

  buf  uint8 [N]    the sorted values' UTF-8 bytes, value after value
  off  int32 [V+1]  value v owns buf[off[v]:off[v+1]]

The reference also stages a position map (4 bytes per dictionary byte)
and pads both axes to powers of two; its kernel needs the first and its
jit cache the second. K3 walks each value's own byte range, so neither is
staged here. The value-axis shard split of the reference (its mesh path)
is a later slice: one device holds the whole dictionary.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import packing
from .kernels import probe as probe_k

# Dictionaries below this many distinct values keep the exact host path:
# staging their bytes costs more than the host walk. TempoDBConfig
# `search_device_probe_min_vals` overrides it; <= 0 disables the probe.
DEVICE_PROBE_MIN_VALS = 50_000

# Needles longer than this take the exact host path for the whole query
# (the reference bounds its kernel's unroll there; K3 keeps the needles
# in a fixed shared-memory row of this width).
MAX_NEEDLE_BYTES = probe_k.MAX_NEEDLE


@dataclass
class PackedDeviceDict:
    """Host-side staging product for one distinct value dictionary."""
    n_vals: int
    buf: np.ndarray        # uint8 [N]
    off: np.ndarray        # int32 [V+1]

    @property
    def nbytes(self) -> int:
        return int(self.buf.nbytes + self.off.nbytes)


@dataclass
class DeviceDict:
    """A PackedDeviceDict's arrays on the device."""
    packed: PackedDeviceDict
    buf: torch.Tensor      # uint8 [N]
    off: torch.Tensor      # int32 [V+1]

    @property
    def n_vals(self) -> int:
        return self.packed.n_vals

    @property
    def device(self) -> torch.device:
        return self.buf.device

    @property
    def nbytes(self) -> int:
        """Device bytes this dictionary pins."""
        return int(self.buf.numel() * self.buf.element_size()
                   + self.off.numel() * self.off.element_size())


def pack_device_dict(val_dict: list) -> PackedDeviceDict:
    """Concatenate a sorted value dictionary's UTF-8 bytes and record each
    value's offset. Raises ValueError past int32 byte addressing."""
    blobs = [v.encode("utf-8") for v in val_dict]
    off = np.zeros(len(blobs) + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, blobs), dtype=np.int64,
                          count=len(blobs)), out=off[1:])
    if off[-1] >= 2**31:
        raise ValueError("dictionary exceeds int32 byte addressing")
    buf = np.frombuffer(b"".join(blobs), dtype=np.uint8)
    return PackedDeviceDict(n_vals=len(blobs), buf=buf,
                            off=off.astype(np.int32))


def place_device_dict(packed: PackedDeviceDict,
                      device: torch.device) -> DeviceDict:
    """Host-to-device copy of a packed dictionary."""
    # frombuffer arrays are read-only; torch wants a writable buffer
    buf = torch.from_numpy(np.array(packed.buf, copy=True)).to(device)
    off = torch.from_numpy(packed.off).to(device)
    return DeviceDict(packed=packed, buf=buf, off=off)


def packed_for(pages) -> PackedDeviceDict:
    """The packed value dictionary of a block container, memoized on it
    (containers are immutable), so an evicted batch re-stages with one
    copy and no re-pack."""
    packed = getattr(pages, "_device_dict_packed", None)
    if packed is None:
        packed = pages._device_dict_packed = pack_device_dict(
            pages.val_dict)
    return packed


def stage_val_dict(val_dict: list, device: torch.device,
                   cache_on=None) -> DeviceDict:
    """pack + place; with `cache_on` (the ColumnarPages holding
    `val_dict`) the packing is memoized on it."""
    packed = (pack_device_dict(val_dict) if cache_on is None
              else packed_for(cache_on))
    return place_device_dict(packed, device)


def probe_value_hits(ddev: DeviceDict, needles: list):
    """Run K3 for a list of UTF-8 needles against a staged dictionary.
    A needle of None stands for a term that must match nothing (its key
    is absent from the block). Returns (hits bool [T, V], any_hits bool
    [T]) on the dictionary's device; nothing synchronizes here.

    Raises ValueError for an empty list or a needle longer than
    MAX_NEEDLE_BYTES: callers route such queries to the host path before
    they get here."""
    arr, lens = needle_tensors(needles, ddev.device)
    return probe_k.dict_probe(ddev.buf, ddev.off, arr, lens)


def needle_tensors(needles: list, device: torch.device):
    """K3's needle inputs: uint8 [T, L] rows and int32 [T] lengths (-1 for
    a None needle). Raises ValueError for an empty list or a needle
    longer than MAX_NEEDLE_BYTES."""
    T = len(needles)
    if T == 0:
        raise ValueError("probe_value_hits needs at least one needle")
    lmax = max((len(n) for n in needles if n is not None), default=0)
    if lmax > MAX_NEEDLE_BYTES:
        raise ValueError(f"needle exceeds {MAX_NEEDLE_BYTES} bytes")
    arr = np.zeros((T, max(1, lmax)), dtype=np.uint8)
    lens = np.full(T, -1, dtype=np.int32)
    for t, nb in enumerate(needles):
        if nb is not None:
            arr[t, :len(nb)] = np.frombuffer(nb, dtype=np.uint8)
            lens[t] = len(nb)
    return (torch.from_numpy(arr).to(device),
            torch.from_numpy(lens).to(device))


def hits_to_ids(hits_row) -> np.ndarray:
    """One term's hit mask as a sorted id array (the bridge to
    pipeline.substring_value_ids for tests and checks). Takes both mask
    formats: a bool row, or a word row (int32 tensor or uint32 array) as
    a packed engine's probe leaves it."""
    if packing.is_packed_mask(hits_row):
        hits_row = packing.unpack_mask_words(hits_row,
                                             hits_row.shape[-1] * 32)
    if isinstance(hits_row, torch.Tensor):
        hits_row = hits_row.cpu().numpy()
    return np.nonzero(np.asarray(hits_row))[0].astype(np.int32)
