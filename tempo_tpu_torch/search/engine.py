"""The single-block scan engine, top-k sizing and the one-sync fetch of a
scan's outputs.

Counterpart of the reference's ``search/engine.py``: ``stage`` puts one
block's columns on the device (page axis padded to a power of two, kv
columns int32, as the reference stages them) with its value dictionary
when that clears the probe threshold; ``ScanEngine`` dispatches kernel
K1s (``kernels.scan.scan_single``, the port of B1) then K2
(``kernels.topk.topk``, B2) and renders the top-k as results. With
``packed``, ``stage`` packs the block's columns as ``packing.py`` says
(``StagedPages.widths``), and K1s reads them as they are. With the
structural gate on, ``stage`` stages the block's span segment too, and a
query with a structural predicate runs K6 first (``kernels.structural``),
its verdicts into K1s.
``DEFAULT_TOP_K``, ``resolve_top_k`` and ``fetch_scan_out`` are shared
with the batched path (``multiblock.py``); ``fetch_coalesced_out`` is
the fused (query-axis) path's fetch. An engine given its database's
profiling gate (``observability.profile.Gate``) opens a ``single``
record a dispatch; the fetch finishes it (its d2h stage, then the
execute stage read from the record's CUDA events).
"""

from __future__ import annotations

from dataclasses import dataclass

import time

import numpy as np
import torch

from ..model.types import TraceSearchMetadata
from ..observability import profile
from . import dict_probe, packing, structural
from .columnar import ColumnarPages
from .kernels.scan import scan_single
from .kernels.structural import structural_mask
from .kernels.topk import topk
from .pipeline import CompileCache, CompiledQuery

DEFAULT_TOP_K = 128

DEVICE_ARRAYS = ("kv_key", "kv_val", "entry_start", "entry_end",
                 "entry_dur", "entry_valid")


def resolve_top_k(base: int, limit: int) -> int:
    """top_k must cover the request limit or results are silently cut
    below it; it doubles from `base` until it does. No upper cap."""
    k = max(1, base)
    while k < limit:
        k *= 2
    return k


def fetch_scan_out(out) -> tuple:
    """(counts [2], scores [k], idx [k][, agg [K]]) device tensors -> host
    (count, inspected, scores, idx[, agg]) with a single device-to-host
    copy, which is also the one synchronisation point of the dispatch;
    the ?agg= counts (K7's, when the query asked for them) ride along."""
    counts, scores, idx, *agg = out
    k = int(scores.numel())
    host = profile.record_of(out).fetch([counts, scores, idx, *agg]).numpy()
    res = (int(host[0]), int(host[1]), np.ascontiguousarray(host[2:2 + k]),
           np.ascontiguousarray(host[2 + k:2 + 2 * k]))
    if agg:
        res += (np.ascontiguousarray(host[2 + 2 * k:]),)
    return res


def fetch_coalesced_out(out) -> tuple:
    """Query-axis variant of fetch_scan_out: (counts [Q], inspected,
    scores [Q, k], idx [Q, k][, agg [Qn, K]]) device tensors -> host
    (counts [Q], inspected, scores [Q, k], idx [Q, k][, agg [Qn, K]])
    with a single device-to-host copy, the one synchronisation point of
    the fused dispatch; members then slice their rows of the host
    arrays."""
    counts, inspected, scores, idx, *agg = out
    q, k = scores.shape
    host = profile.record_of(out).fetch(
        [counts, inspected.reshape(1), scores.reshape(-1), idx.reshape(-1),
         *(a.reshape(-1) for a in agg)]).numpy()
    body = host[q + 1:]
    res = (np.ascontiguousarray(host[:q]), int(host[q]),
           np.ascontiguousarray(body[:q * k].reshape(q, k)),
           np.ascontiguousarray(body[q * k:2 * q * k].reshape(q, k)))
    if agg:
        res += (np.ascontiguousarray(body[2 * q * k:].reshape(agg[0].shape)),)
    return res


@dataclass
class StagedPages:
    """One block's columns on the device, plus the host container that
    renders results."""
    device: dict          # name -> tensor, page axis padded to a bucket
    pages: ColumnarPages
    # dict_probe.DeviceDict when the value dictionary cleared the probe
    # threshold at staging time: compilation then probes on the device
    staged_dict: object = None
    # packing.py's (key, value, duration) widths; None = unpacked
    widths: tuple | None = None
    # the span segment on the device (structural gate on and the block
    # carries spans), and the longest entry run
    span_device: dict | None = None
    span_max_run: int = 0


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def pad_page_axis(pages: ColumnarPages, target: int) -> dict:
    """Numpy columns with the page axis padded to `target` pages of
    invalid entries and -1 kv slots."""
    out = {}
    P = pages.n_pages
    for name in DEVICE_ARRAYS:
        arr = getattr(pages, name)
        if target > P:
            pad = np.zeros((target - P,) + arr.shape[1:], dtype=arr.dtype)
            if name in ("kv_key", "kv_val"):
                pad -= 1
            arr = np.concatenate([arr, pad], axis=0)
        out[name] = arr
    return out


def stage_block_dict(pages: ColumnarPages, device: torch.device,
                     probe_min_vals: int | None,
                     profiling: profile.Gate = profile.OFF):
    """The block's value dictionary on the device when it has at least
    `probe_min_vals` values (None = dict_probe.DEVICE_PROBE_MIN_VALS;
    <= 0 never), else None. It carries `profiling`, its probe's gate."""
    mv = (dict_probe.DEVICE_PROBE_MIN_VALS if probe_min_vals is None
          else probe_min_vals)
    if mv <= 0 or len(pages.val_dict) < mv:
        return None
    return dict_probe.stage_val_dict(pages.val_dict, device, cache_on=pages,
                                     profiling=profiling)


def stage(pages: ColumnarPages, device: torch.device,
          probe_min_vals: int | None = None,
          packed: bool = False, spans: bool = False,
          profiling: profile.Gate = profile.OFF) -> StagedPages:
    """Copy a block's columns to the device, the page axis padded to a
    power of two (the reference's bucket; the port keeps it so both scan
    the same padded block), and its dictionary when it clears the probe
    threshold — applied here, at staging time. With `packed`, the
    columns pack at the widths a one-block batch would get
    (``packing.pack_columns``); with `spans` (the structural gate on),
    the block's span segment stages too. `profiling` observes the copy
    as an h2d stage (mode single)."""
    from .multiblock import place_spans

    B = _bucket(pages.n_pages)
    host = pad_page_axis(pages, B)
    widths = None
    if packed:
        widths = packing.plan_widths(len(pages.key_dict),
                                     len(pages.val_dict), pages.max_dur_ms())
        host = packing.pack_columns(host, widths)
    span_host = structural.stage_single(pages, B) if spans else None
    t0 = time.perf_counter() if profiling.enabled else 0.0
    dev = {}
    for k, v in host.items():
        v = packing.device_view(v)      # unsigned bits in signed tensors
        if not (v.flags.writeable and v.flags.c_contiguous):
            v = np.array(v, order="C")   # container bytes are read-only
        dev[k] = torch.from_numpy(v).to(device)
    span_dev, max_run = place_spans(span_host, device)
    if profiling.enabled:
        profiling.observe_stage(
            "h2d", "single", time.perf_counter() - t0,
            nbytes=sum(int(v.nbytes) for v in host.values())
            + sum(int(v.nbytes) for v in (span_host or {}).values()))
    return StagedPages(device=dev, pages=pages,
                       staged_dict=stage_block_dict(pages, device,
                                                    probe_min_vals,
                                                    profiling),
                       widths=widths, span_device=span_dev,
                       span_max_run=max_run)


class ScanEngine:
    """Single-block dispatch on one device: K1s then K2, one sync, and
    result rendering. Owns the compile cache of the blocks it serves;
    `packed` engines stage packed blocks and compile word hit masks.
    `profiling`: the database's gate (off: no record)."""

    def __init__(self, device: torch.device, top_k: int = DEFAULT_TOP_K,
                 packed: bool = False,
                 profiling: profile.Gate = profile.OFF):
        self.device = device
        self.top_k = top_k
        self.packed = packed
        self.profiling = profiling
        self.compile_cache = CompileCache(profiling)

    def _tables(self, cq: CompiledQuery):
        """The query's term tables on the device, widened to one row when
        there is no term (the kernel's tables are never empty)."""
        T = cq.n_terms
        tk = cq.term_keys if T else np.full(1, -1, dtype=np.int32)
        vr = cq.val_ranges if T else np.array([[[1, 0]]], dtype=np.int32)
        return (torch.from_numpy(np.ascontiguousarray(tk)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(vr)).to(self.device))

    def structural_verdicts(self, sp: StagedPages, lanes) -> torch.Tensor:
        """K6 over the block for each lane: uint8 [Q, P*E] (every page is
        the block's, row 0 of the tables)."""
        d = sp.device
        pb = torch.zeros(d["kv_key"].shape[0], dtype=torch.int32,
                         device=self.device)
        return structural_mask(
            d["kv_key"], d["kv_val"], d["entry_dur"], d["entry_valid"], pb,
            sp.span_device, sp.span_max_run, lanes.device(self.device),
            lanes.val_hits, sp.widths, d.get("entry_dur_res"))

    def scan_staged_async(self, sp: StagedPages, cq: CompiledQuery):
        """K1s then K2 on the current stream (K6 first for a structural
        query, its verdicts into K1s), without a device-to-host sync.
        Returns device tensors (counts [2] = (match count, inspected),
        top-k scores, top-k flat indices) carrying the dispatch's
        ``single`` record, which ``fetch_scan_out`` finishes."""
        rec = self.profiling.dispatch("single", self.device)
        with rec.stage("build"):
            tk, vr = self._tables(cq)
        d = sp.device
        rec.compile_check(("scan", "topk") if cq.structural is None
                          else ("scan", "topk", "structural"))
        with rec.launch():
            verdicts = None
            if cq.structural is not None:
                verdicts = self.structural_verdicts(
                    sp, cq.structural.lanes())[0]
            scores, counts = scan_single(
                d["kv_key"], d["kv_val"], d["entry_start"], d["entry_end"],
                d["entry_dur"], d["entry_valid"], tk, vr, cq.n_terms,
                cq.dur_lo, min(cq.dur_hi, 0xFFFFFFFF), cq.win_start,
                min(cq.win_end, 0xFFFFFFFF),
                cq.val_hits if cq.n_terms else None, sp.widths,
                d.get("entry_dur_res"), verdicts)
            top_scores, top_idx = topk(scores, resolve_top_k(self.top_k,
                                                             cq.limit))
        rec.set(n_pages=sp.pages.n_pages)
        return rec.attach((counts, top_scores, top_idx))

    def scan_staged(self, sp: StagedPages, cq: CompiledQuery) -> tuple:
        """(count, inspected, scores, idx) on the host."""
        return fetch_scan_out(self.scan_staged_async(sp, cq))

    def results(self, sp: StagedPages, cq: CompiledQuery,
                scores: np.ndarray, idx: np.ndarray) -> list:
        """Map top-k flat indices back to TraceSearchMetadata, stopping at
        the first non-match or at the limit; pad pages are skipped."""
        pages = sp.pages
        E = pages.geometry.entries_per_page
        out = []
        for s, i in zip(scores.tolist(), idx.tolist()):
            if s < 0 or len(out) >= cq.limit:
                break
            p, e = divmod(i, E)
            if p >= pages.n_pages:
                continue
            m = TraceSearchMetadata(
                trace_id=bytes(pages.trace_ids[p, e]).hex(),
                start_time_unix_nano=int(pages.entry_start[p, e])
                * 1_000_000_000,
                duration_ms=int(pages.entry_dur[p, e]))
            svc = int(pages.entry_root_svc[p, e])
            name = int(pages.entry_root_name[p, e])
            if svc >= 0:
                m.root_service_name = pages.val_dict[svc]
            if name >= 0:
                m.root_trace_name = pages.val_dict[name]
            out.append(m)
        return out
