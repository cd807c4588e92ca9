"""B9 ``hot_scan``: the live tier's scan over a capacity-padded stage.

Counterpart of ``tempo_tpu/search/live_tier.py`` ``_tier_valid`` and
``hot_scan_kernel`` (TPU kernel B9): B1's predicate, count and inspected
over the pages below a runtime live page count ``n_pages``, then B2's
top-k. The reference pads the stage's page axis to a power of two, its
``tier``, so that its jit key stays one shape while entries come and go,
and masks the pages at or past ``n_pages`` inside the kernel. The port
has no jit key: on a CUDA stage ``hot_scan`` launches K1s
(``csrc/scan.cu``) over the live prefix ``col[:n_pages]`` of each page
column (a contiguous view, the page axis leading), then K2
(``csrc/topk.cu``) over its scores, and for a structural request K6
(``csrc/structural.cu``) first over the same prefix, its verdicts into
K1s. No CTA reads a page at or past ``n_pages``, so a stale capacity page
is never read, and the count, the inspected entries and the top-k over
flat indices are the masked scan's. Like K1s it is bound by the bytes of
the live prefix (about 81 B an entry at 8 int32 kv slots).

``hot_scan_plain`` is the literal reference: the ``_tier_valid`` mask over
the whole capacity, then the plain K6 (for a structural request), K1s and
K2. The CPU path runs it; on the card ``chip_smoke.py`` holds the kernel
route against it. A call that launches counts once in ``scan.
HOT_LAUNCHES`` (its K1s, K2 and K6 launches count in their own counters
too).
"""

from __future__ import annotations

import dataclasses

import torch

from ..engine import ScanEngine, StagedPages, resolve_top_k
from ..pipeline import CompiledQuery
from .scan import HOT_LAUNCHES, scan_single_plain
from .structural import structural_mask_plain
from .topk import topk_plain


def live_prefix(sp: StagedPages, n_pages: int) -> StagedPages:
    """The stage's first `n_pages` pages: views of its page columns and of
    its span segment's entry runs (span rows are only those of live
    pages)."""
    spans = sp.span_device
    if spans is not None:
        spans = dict(spans, entry_span_begin=spans["entry_span_begin"]
                     [:n_pages],
                     entry_span_count=spans["entry_span_count"][:n_pages])
    return dataclasses.replace(
        sp, device={k: v[:n_pages] for k, v in sp.device.items()},
        span_device=spans)


def hot_scan(engine: ScanEngine, sp: StagedPages, n_pages: int,
             cq: CompiledQuery):
    """(counts [2] = (match count, inspected), top-k scores, top-k flat
    indices) over the live pages [0, n_pages) of a capacity stage, as
    device tensors with no sync: the plain version for a CPU stage, the
    kernels over the live prefix for a CUDA stage."""
    if sp.device["kv_key"].device.type == "cpu":
        return hot_scan_plain(engine, sp, n_pages, cq)
    out = engine.scan_staged_async(live_prefix(sp, n_pages), cq)
    HOT_LAUNCHES.bump()
    return out


def hot_scan_plain(engine: ScanEngine, sp: StagedPages, n_pages: int,
                   cq: CompiledQuery):
    """B9 in plain PyTorch ops, as the reference computes it: entries of
    pages at or past `n_pages` are made invalid over the whole capacity,
    then the scan and the top-k of every page."""
    d = sp.device
    tier = d["kv_key"].shape[0]
    live = torch.arange(tier, device=d["kv_key"].device)[:, None] < n_pages
    valid = d["entry_valid"] & live
    verdicts = None
    if cq.structural is not None:
        lanes = cq.structural.lanes()
        verdicts = structural_mask_plain(
            d["kv_key"], d["kv_val"], d["entry_dur"], valid,
            torch.zeros(tier, dtype=torch.int32, device=valid.device),
            sp.span_device, sp.span_max_run, lanes.device(valid.device),
            lanes.val_hits)[0]
    tk, vr = engine._tables(cq)
    scores, counts = scan_single_plain(
        d["kv_key"], d["kv_val"], d["entry_start"], d["entry_end"],
        d["entry_dur"], valid, tk, vr, cq.n_terms, cq.dur_lo,
        min(cq.dur_hi, 0xFFFFFFFF), cq.win_start,
        min(cq.win_end, 0xFFFFFFFF),
        cq.val_hits if cq.n_terms else None, verdicts=verdicts)
    top_scores, top_idx = topk_plain(scores, resolve_top_k(engine.top_k,
                                                           cq.limit))
    return counts, top_scores, top_idx
