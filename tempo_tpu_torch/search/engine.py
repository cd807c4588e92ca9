"""Top-k sizing and the one-sync fetch of a scan's outputs.

Counterpart of the parts of the reference's ``search/engine.py`` the
batched path uses (``DEFAULT_TOP_K``, ``resolve_top_k``,
``fetch_scan_out``). The single-block ``ScanEngine`` and its kernel (B1)
are a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_TOP_K = 128


def resolve_top_k(base: int, limit: int) -> int:
    """top_k must cover the request limit or results are silently cut
    below it; it doubles from `base` until it does. No upper cap."""
    k = max(1, base)
    while k < limit:
        k *= 2
    return k


def fetch_scan_out(out) -> tuple:
    """(counts [2], scores [k], idx [k]) device tensors -> host
    (count, inspected, scores, idx) with a single device-to-host copy,
    which is also the one synchronisation point of the dispatch."""
    counts, scores, idx = out
    k = int(scores.numel())
    host = torch.cat([counts, scores, idx]).cpu().numpy()
    return (int(host[0]), int(host[1]), np.ascontiguousarray(host[2:2 + k]),
            np.ascontiguousarray(host[2 + k:]))
