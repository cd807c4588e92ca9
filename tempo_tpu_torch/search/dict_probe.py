"""The dictionary probe on the device: substring prefilter next to the
columns.

Counterpart of the reference's ``search/dict_probe.py`` on one device. A
block whose value dictionary has at least ``DEVICE_PROBE_MIN_VALS``
distinct values stages the dictionary's bytes with its pages; query
compilation then answers each tag term's substring test with kernel K3
(``kernels.probe.dict_probe``) and hands the scan a ``[T, V]`` hit mask
(a packed engine: ``[T, ceil(V/32)]`` words, from the same launch)
instead of folding host id sets into ranges. The needles travel in the
launch's parameters; nothing but the prune decision (``any_hits``, T
bools) comes back to the host.

Layout, packed once per dictionary and memoized on the block's container:

  buf  uint8 [N]    the sorted values' UTF-8 bytes, value after value
  off  int32 [V+1]  value v owns buf[off[v]:off[v+1]]

The reference also stages a position map (4 bytes per dictionary byte)
and pads both axes to powers of two; its kernel needs the first and its
jit cache the second. K3 walks each value's own byte range, so neither is
staged here.

On a mesh (``parallel/mesh.py``) the value axis splits over the ranks,
the reference's ``dist_probe_kernel``: ``pack_device_dict(val_dict,
n_shards)`` gives rank r the contiguous value range ``[r*vs, (r+1)*vs)``
(``PackedDeviceDict.shard``; ``vs`` is a multiple of 32, so a gathered
mask packs into words that never straddle two ranks), each rank runs K3
over its range, and the ``[T, vs]`` masks (or ``[T, vs/32]`` words) are
``all_gather``ed into one ``[T, S*vs]`` mask (a layout copy) from which
``any_hits`` is taken
(``ShardedDeviceDict``, ``probe_value_hits``). Ids at or past V are pad
values no column holds.
"""

from __future__ import annotations

import time
from array import array
from dataclasses import dataclass, field

import numpy as np
import torch

from ..observability import profile
from . import packing
from .kernels import dist as dist_k
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
    # value-axis shards on a mesh (1: one device holds every value)
    n_shards: int = 1

    @property
    def nbytes(self) -> int:
        return int(self.buf.nbytes + self.off.nbytes)

    @property
    def vs(self) -> int:
        """Values a shard holds: ceil(V / n_shards) rounded up to a
        multiple of 32 on a mesh, V on one device."""
        if self.n_shards <= 1:
            return self.n_vals
        return -(-max(1, -(-self.n_vals // self.n_shards)) // 32) * 32

    def shard(self, rank: int) -> "PackedDeviceDict":
        """Rank `rank`'s value range [rank*vs, (rank+1)*vs), offsets from
        0, padded to vs values with empty ones."""
        vs = self.vs
        lo = min(rank * vs, self.n_vals)
        hi = min(lo + vs, self.n_vals)
        b0, b1 = int(self.off[lo]), int(self.off[hi])
        off = np.full(vs + 1, b1 - b0, dtype=np.int32)
        off[:hi - lo + 1] = self.off[lo:hi + 1] - b0
        return PackedDeviceDict(n_vals=vs, buf=self.buf[b0:b1], off=off)


@dataclass
class DeviceDict:
    """A PackedDeviceDict's arrays on the device."""
    packed: PackedDeviceDict
    buf: torch.Tensor      # uint8 [N]
    off: torch.Tensor      # int32 [V+1]
    # the profiling gate of the database that staged it: its probe's
    profiling: profile.Gate = field(default=profile.OFF, repr=False)

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


@dataclass
class ShardedDeviceDict:
    """A dictionary split over a mesh's value axis: the shards of the
    ranks this process runs (one on a ShardExchange, every rank on a
    LocalExchange), each a DeviceDict of `vs` values."""
    packed: PackedDeviceDict      # the whole dictionary, n_shards set
    shards: tuple
    exchange: object
    profiling: profile.Gate = field(default=profile.OFF, repr=False)

    @property
    def n_vals(self) -> int:
        return self.packed.n_vals

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def nbytes(self) -> int:
        """The whole dictionary's bytes, equal on every rank."""
        return self.packed.nbytes


def pack_device_dict(val_dict: list, n_shards: int = 1) -> PackedDeviceDict:
    """Concatenate a sorted value dictionary's UTF-8 bytes and record each
    value's offset; `n_shards` > 1 splits it over a mesh's value axis
    (``PackedDeviceDict.shard``). Raises ValueError past int32 byte
    addressing."""
    blobs = [v.encode("utf-8") for v in val_dict]
    off = np.zeros(len(blobs) + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, blobs), dtype=np.int64,
                          count=len(blobs)), out=off[1:])
    if off[-1] >= 2**31:
        raise ValueError("dictionary exceeds int32 byte addressing")
    buf = np.frombuffer(b"".join(blobs), dtype=np.uint8)
    return PackedDeviceDict(n_vals=len(blobs), buf=buf,
                            off=off.astype(np.int32), n_shards=n_shards)


def place_device_dict(packed: PackedDeviceDict, device: torch.device,
                      profiling: profile.Gate = profile.OFF) -> DeviceDict:
    """Host-to-device copy of a packed dictionary (observed as an h2d
    stage of mode dict_probe); the dictionary keeps `profiling` for its
    probe's records."""
    t0 = time.perf_counter() if profiling.enabled else 0.0
    # frombuffer arrays are read-only; torch wants a writable buffer
    buf = torch.from_numpy(np.array(packed.buf, copy=True)).to(device)
    off = torch.from_numpy(packed.off).to(device)
    if profiling.enabled:
        profiling.observe_stage("h2d", "dict_probe",
                                time.perf_counter() - t0,
                                nbytes=packed.nbytes)
    return DeviceDict(packed=packed, buf=buf, off=off, profiling=profiling)


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
                   cache_on=None,
                   profiling: profile.Gate = profile.OFF) -> DeviceDict:
    """pack + place; with `cache_on` (the ColumnarPages holding
    `val_dict`) the packing is memoized on it."""
    packed = (pack_device_dict(val_dict) if cache_on is None
              else packed_for(cache_on))
    return place_device_dict(packed, device, profiling)


def probe_value_hits(ddev, needles: list, words: bool = False):
    """Run K3 for a list of UTF-8 needles against a staged dictionary.
    A needle of None stands for a term that must match nothing (its key
    is absent from the block). Returns (hits bool [T, V], any_hits bool
    [T]) on the dictionary's device, or with `words` the mask as int32
    words [T, ceil(V/32)] (``packing.pack_mask_words``'s form, written by
    the same launch); nothing synchronizes here. A ShardedDeviceDict
    answers through the mesh: K3 over each local rank's range, then the
    all_gather, under the collective lock; its mask covers S*vs values
    (vs a multiple of 32, so the ranks' words join whole).

    Raises ValueError for an empty list or a needle longer than
    MAX_NEEDLE_BYTES: callers route such queries to the host path before
    they get here.

    The launches form one ``dict_probe`` record (the dictionary's gate).
    Its outputs feed a scan's kernels or a prune read, not a fetch, so
    the record is detached: it finishes once its end event has completed
    (``profile.Dispatch.detach``)."""
    rec = ddev.profiling.dispatch("dict_probe", ddev.device)
    with rec.stage("build"):
        arr, lens = needle_tensors(needles)
    args = (arr, lens, True) if words else (arr, lens)
    rec.add_bytes(h2d=arr.numel() + lens.numel() * 4)
    sharded = isinstance(ddev, ShardedDeviceDict)
    rec.compile_check(("probe", "dist") if sharded else ("probe",))
    if not sharded:
        with rec.launch():
            out = probe_k.dict_probe(ddev.buf, ddev.off, *args)
        rec.detach()
        return out
    ex = ddev.exchange
    with rec.launch():
        with ex.locked():
            gathered = ex.all_gather(
                [probe_k.dict_probe(d.buf, d.off, *args)[0]
                 for d in ddev.shards])                 # [S, T, vs(/32)]
        S, T, w = gathered.shape
        hits = gathered.permute(1, 0, 2).reshape(T, S * w)
        any_hits = (hits != 0).any(dim=1) if words else hits.any(dim=1)
    rec.detach()
    if hits.device.type == "cuda":
        dist_k.PROBE_LAUNCHES.bump()
    return hits, any_hits


def needle_tensors(needles: list):
    """K3's needle inputs, in host memory (the kernel's launch carries
    them): uint8 [T, L] rows and int32 [T] lengths (-1 for a None
    needle). Raises ValueError for an empty list or a needle longer than
    MAX_NEEDLE_BYTES."""
    T = len(needles)
    if T == 0:
        raise ValueError("probe_value_hits needs at least one needle")
    lmax = max((len(n) for n in needles if n is not None), default=0)
    if lmax > MAX_NEEDLE_BYTES:
        raise ValueError(f"needle exceeds {MAX_NEEDLE_BYTES} bytes")
    L = max(1, lmax)
    rows = bytearray(T * L)
    lens = array("i", [-1]) * T
    for t, nb in enumerate(needles):
        if nb is not None:
            rows[t * L:t * L + len(nb)] = nb
            lens[t] = len(nb)
    return (torch.frombuffer(rows, dtype=torch.uint8).view(T, L),
            torch.frombuffer(lens, dtype=torch.int32))


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
