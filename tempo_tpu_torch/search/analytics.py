"""Aggregate analytics: the ``?agg=red`` query and the ingest side's count.

Counterpart of the reference's ``search/analytics.py``. Its **query
side** is ported whole: ``?agg=red`` rides a search request as the
reserved tag ``x-agg-q`` (``attach_agg``), which is no tag term (query
compilation, probe signatures and the batcher's predicate memo leave it
out), and asks for group-by-service calls, errors and a latency
histogram of every trace the request matches. Per staged batch one
composite key per entry stages once (``stage_for_batch``, kept on the
``BlockBatch`` so it leaves with the batch):

    entry_agg[p, e] = (service * 15 + ms_bucket) * 2 + error

from columns the host already holds (the root service, the duration in
ms binned on ``MS_BUCKETS``, the exact ``error=true`` pair). After each
scan, kernel K7 (``kernels/agg.py``) counts those keys over the entries
the scan accepted, one ``[K]`` row per query (``[Q, K]`` for a fused
dispatch); the counts come back on the dispatch's one device-to-host
copy, and ``AggStage.decode`` turns them into the answer, merged across
groups by ``merge_agg``. Integer counts throughout, so every dispatch
form gives the same bytes.

Of the **ingest side** only the shared count is ported, ``dense_counts``
(the reference's ``AnalyticsEngine._count``) on kernel K8. The native
summary blob walk and the spanmetrics and service-graph drains it feeds
need the metrics generator, a later slice. K8 compares whole int64
nanoseconds, so ``dense_counts`` is exact for every duration and needs
no host route; it drops the reference's breaker, watchdog, planner
observation and metrics counters.

The gate is per database (``TempoDBConfig.search_analytics_enabled``,
passed to the batcher), not the reference's process-wide ``ANALYTICS``.
With it off the tag is ignored: no aggregate is answered, and, as in the
reference, the request still never quits early.
"""

from __future__ import annotations

import bisect
import functools
import threading

import numpy as np
import torch

from ..device import resolve_device
from .kernels.agg import analytics_count

AGG_QUERY_TAG = "x-agg-q"

# query-side latency bucket edges in integer milliseconds (the ingest
# edges times 1000, kept integral because entry_dur is already ms)
MS_BUCKETS = (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
              8192, 16384)
_NB1Q = len(MS_BUCKETS) + 1         # query-side bins incl. +Inf

# the ingest side's latency bucket edges in seconds (the metrics
# generator's, a copy of the reference's modules/generator.py)
LATENCY_BUCKETS_S = (0.002, 0.004, 0.008, 0.016, 0.032, 0.064, 0.128,
                     0.256, 0.512, 1.024, 2.048, 4.096, 8.192, 16.384)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# the ingest side's count


@functools.lru_cache(maxsize=4)
def _dur_thresholds(buckets: tuple) -> tuple:
    """Integer-nanosecond bucket thresholds: for each float edge ``b``,
    ``T = min{n : float64(n/1e9) > b}``, so ``dur_ns >= T`` is exactly
    ``dur_ns/1e9 > b`` and the bin ``sum_b [dur >= T_b]`` equals
    ``bisect_left(buckets, dur_ns/1e9)``. As (hi, lo) int31 limb pairs,
    the reference's form (hi = T >> 31)."""
    out = []
    for b in buckets:
        n = int(b * 1e9)
        while n > 0 and n / 1e9 > b:
            n -= 1
        while n / 1e9 <= b:
            n += 1
        out.append((n >> 31, n & 0x7FFFFFFF))
    return tuple(out)


@functools.lru_cache(maxsize=4)
def _dur_thresholds_full(buckets: tuple) -> tuple:
    """The same thresholds as whole integers, the form K8 compares."""
    return tuple((hi << 31) | lo for hi, lo in _dur_thresholds(buckets))


@functools.lru_cache(maxsize=16)
def thresholds_tensor(buckets: tuple, device: torch.device) -> torch.Tensor:
    """The whole thresholds as an int64 tensor on `device`, made once per
    device and bucket tuple (callers only read it). K8 takes them on the
    host for data on any device (its launch's parameters carry them), so
    ``dense_counts`` asks for the host's; a device copy serves
    ``torch.bucketize``, the yardstick beside K8."""
    return torch.tensor(_dur_thresholds_full(buckets), dtype=torch.int64,
                        device=device)


_HOST = torch.device("cpu")


def dense_counts(sidx: np.ndarray, dur: np.ndarray, n_keys: int,
                 buckets: tuple = LATENCY_BUCKETS_S,
                 device=None) -> np.ndarray:
    """Dense (series, latency bucket) counts of one micro-batch: int64
    [n_keys * (len(buckets) + 1)], bin ``series * (nb + 1) + b`` counting
    the rows of that series whose duration (int64 nanoseconds) lies in
    latency bucket b (``bisect_left`` on the edges in seconds). Rows of a
    series id at or past `n_keys` are not counted. Two copies in, one K8
    launch on `device` (``cuda`` by default; ``cpu`` runs its plain
    version), one copy back."""
    dev = resolve_device(device)
    s = torch.from_numpy(np.ascontiguousarray(sidx, dtype=np.int32)).to(dev)
    d = torch.from_numpy(np.ascontiguousarray(dur, dtype=np.int64)).to(dev)
    out = analytics_count(s, d, thresholds_tensor(tuple(buckets), _HOST),
                          n_keys)
    return out.cpu().numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# the query side


class AggStage:
    """Per-batch staged aggregation descriptor: the batch-global service
    table and the per-entry composite key column K7 counts.

    ``entry_agg[p, e] = (svc_gid * NB1 + ms_bucket) * 2 + err``, int32 in
    [0, n_keys). The service axis pads to a power of two, as the
    reference's does."""

    __slots__ = ("services", "n_keys", "host", "_device", "_lock",
                 "__weakref__")

    def __init__(self, services: tuple, host: np.ndarray):
        self.services = services
        self.n_keys = _pow2(max(1, len(services))) * _NB1Q * 2
        self.host = host
        self._device: dict = {}
        self._lock = threading.Lock()

    def device(self, dev: torch.device, part: tuple | None = None) \
            -> torch.Tensor:
        """The key column on the batch's device `dev` (int32 [P, E]),
        placed at the first call; with `part` = (rank, world) only that
        page shard's rows (a mesh rank's slice, [P / world, E])."""
        with self._lock:
            t = self._device.get(part)
            if t is None:
                rows = self.host
                if part is not None:
                    pp = rows.shape[0] // part[1]
                    rows = rows[part[0] * pp:(part[0] + 1) * pp]
                t = self._device[part] = torch.from_numpy(
                    np.ascontiguousarray(rows)).to(dev)
            return t

    @property
    def device_nbytes(self) -> int:
        """Bytes of the key columns placed on the device (0 before the
        first agg dispatch over the batch)."""
        return sum(t.numel() * t.element_size()
                   for t in list(self._device.values()))

    def decode(self, counts) -> dict:
        """Dense [n_keys] counts -> {service: {calls, errors, hist}}, the
        services with calls in table order. Integer-only, so every
        dispatch form decodes identically; the sums run once over the
        whole table, not per service."""
        s_pad = self.n_keys // (_NB1Q * 2)
        c = np.asarray(counts, dtype=np.int64).reshape(s_pad, _NB1Q, 2)
        hist = c.sum(axis=2)
        calls = hist.sum(axis=1)
        errors = c[:, :, 1].sum(axis=1)
        return {self.services[i]: {"calls": int(calls[i]),
                                   "errors": int(errors[i]),
                                   "hist": hist[i].tolist()}
                for i in np.flatnonzero(calls[:len(self.services)]).tolist()}


def agg_response(series: dict) -> dict:
    """The ?agg=red response payload."""
    return {"type": "red", "buckets_ms": list(MS_BUCKETS),
            "series": series}


def merge_agg(into: dict | None, other: dict | None) -> dict | None:
    """Integer merge of two agg payloads (one group's into the answer)."""
    if other is None:
        return into
    if into is None:
        return other
    dst = into["series"]
    for svc, s in other["series"].items():
        d = dst.get(svc)
        if d is None:
            dst[svc] = s
        else:
            d["calls"] += s["calls"]
            d["errors"] += s["errors"]
            d["hist"] = [a + b for a, b in zip(d["hist"], s["hist"])]
    return into


def attach_agg(req, spec: str) -> None:
    """Validate an ?agg= spec and stow it in the reserved tag. Raises
    ValueError on anything but the supported grammar."""
    spec = (spec or "").strip().lower()
    if spec != "red":
        raise ValueError(
            f"unsupported agg spec {spec!r} (supported: 'red')")
    req.tags[AGG_QUERY_TAG] = spec


def agg_requested(req) -> bool:
    return AGG_QUERY_TAG in req.tags


def _block_entry_agg(pages, svc_index: dict) -> np.ndarray:
    """One block's per-entry composite keys (host numpy)."""
    lut = np.empty(len(pages.val_dict) + 1, dtype=np.int64)
    unknown = svc_index[""]
    for i, v in enumerate(pages.val_dict):
        lut[i] = svc_index.get(v, unknown)
    lut[-1] = unknown                     # entry_root_svc == -1
    gids = lut[pages.entry_root_svc]
    bins = np.searchsorted(np.asarray(MS_BUCKETS, dtype=np.int64),
                           pages.entry_dur.astype(np.int64), side="left")
    err = np.zeros(pages.entry_dur.shape, dtype=np.int64)
    kid = bisect.bisect_left(pages.key_dict, "error")
    vid = bisect.bisect_left(pages.val_dict, "true")
    if (kid < len(pages.key_dict) and pages.key_dict[kid] == "error"
            and vid < len(pages.val_dict)
            and pages.val_dict[vid] == "true"):
        err = ((pages.kv_key == kid)
               & (pages.kv_val == vid)).any(axis=-1).astype(np.int64)
    return ((gids * _NB1Q + bins) * 2 + err).astype(np.int32)


def build_agg_stage(blocks, pad_pages: int, entries_per_page: int) \
        -> AggStage:
    """The batch-global composite-key column: one sorted service table
    over every member block's root services (plus the "" unknown slot),
    then per-block id remaps. Pad pages hold key 0, a real key: only the
    scan's verdict gates them."""
    names = {""}
    for b in blocks:
        ids = np.unique(b.entry_root_svc[b.entry_valid])
        for i in ids.tolist():
            if i >= 0:
                names.add(b.val_dict[i])
    services = tuple(sorted(names))
    svc_index = {s: i for i, s in enumerate(services)}
    arr = np.zeros((pad_pages, entries_per_page), dtype=np.int32)
    po = 0
    for b in blocks:
        arr[po:po + b.n_pages] = _block_entry_agg(b, svc_index)
        po += b.n_pages
    return AggStage(services, arr)


_STAGE_LOCK = threading.Lock()


def stage_for_batch(batch) -> AggStage:
    """The batch's AggStage (a multiblock.BlockBatch or ShardedBatch: the
    whole batch's keys; a mesh rank places its slice), built at the first
    agg request over it and kept on it: repeat requests reuse it, and an
    evicted batch frees it with its arrays. Two first requests racing
    build it twice and keep one."""
    st = batch.agg_stage
    if st is None:
        built = build_agg_stage(batch.blocks, batch.n_pages,
                                batch.blocks[0].geometry.entries_per_page)
        with _STAGE_LOCK:
            if batch.agg_stage is None:
                batch.agg_stage = built
            st = batch.agg_stage
    return st
