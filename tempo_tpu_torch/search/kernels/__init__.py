"""The port's hand-written CUDA kernels, their wrappers and plain versions.

  K1  ``scan.multi_scan``      (csrc/scan.cu)  <- tempo_tpu multiblock.multi_scan_kernel
  K1s ``scan.scan_single``     (csrc/scan.cu)  <- tempo_tpu engine.scan_kernel
  K2  ``topk.topk``            (csrc/topk.cu)  <- tempo_tpu engine.masked_topk
  K3  ``probe.dict_probe``     (csrc/probe.cu) <- tempo_tpu dict_probe.probe_kernel
                               (and, in words, packing.pack_mask_words after it)
  K4  ``scan.coalesced_scan``  (csrc/scan.cu)  <- tempo_tpu multiblock.coalesced_scan_kernel
  K2r ``topk.topk_rows``       (csrc/topk.cu)  <- its vmapped masked_topk
  K5  ``pack.pack_mask_words`` (csrc/pack.cu)  <- tempo_tpu packing.pack_mask_words
  K6  ``structural.structural_mask`` (csrc/structural.cu)
                               <- tempo_tpu structural.structural_entry_mask
  K7  ``agg.agg_counts``, ``agg.agg_counts_rows`` (csrc/agg.cu)
                               <- tempo_tpu multiblock.agg_entry_counts
  K8  ``agg.analytics_count``  (csrc/agg.cu)
                               <- tempo_tpu analytics.analytics_count_kernel
  B9  ``live.hot_scan``        (K1s + K2, K6 first, over a live prefix)
                               <- tempo_tpu live_tier.hot_scan_kernel
  K9  ``dist.shard_topk``      (csrc/dist.cu)  <- the global top-k tail of
                               tempo_tpu's mesh kernels (B10)

K3 is one cooperative launch a call over tiles of values staged once in
shared memory (candidates a 32-bit word at a time on the needle's last
two bytes, every term over one read, the needles in the launch's
parameters) that writes bool rows or, for a packed engine, the words K5
would: no main path launches K5 any longer.

K1, K1s and K4 also read batches staged in the packed layout
(``search/packing.py``): the scan half of the reference's packing
functions runs inside them; K6 reads the same layouts through the shared
readers of ``csrc/scan_common.cuh``. K1, K1s and K4 take K6's verdicts
as an optional input. K7 runs after K1 or K4 over the scores they
write.

Each wrapper takes its plain PyTorch version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises. Each kernel and mode keeps
a launch count that grows by one per call that launches the kernel, so a
run can show the main path went through it: in ``scan``, ``LAUNCHES`` /
``HIT_LAUNCHES`` (K1, range / hit-mask mode), ``SINGLE_LAUNCHES`` (K1s),
``COALESCED_LAUNCHES`` / ``COALESCED_HIT_LAUNCHES`` (K4), and for the
packed layout ``PACKED_LAUNCHES`` / ``PACKED_Q_LAUNCHES`` (K1 range mode
with u16 / bucketed durations), ``PACKED_HIT_LAUNCHES``,
``SINGLE_PACKED_LAUNCHES``, ``COALESCED_PACKED_LAUNCHES`` and
``COALESCED_PACKED_HIT_LAUNCHES``, and with verdicts (any layout and
hit mode) ``VERDICT_LAUNCHES``, ``SINGLE_VERDICT_LAUNCHES`` and
``COALESCED_VERDICT_LAUNCHES``; ``topk.LAUNCHES``, ``topk.ROW_LAUNCHES``,
``probe.LAUNCHES`` (every K3 launch) and ``probe.WORD_LAUNCHES`` (those
that wrote words), ``pack.LAUNCHES``, ``structural.LAUNCHES``, and
``agg.LAUNCHES`` / ``agg.ROW_LAUNCHES`` (K7, one row / a query axis),
``agg.COUNT_LAUNCHES`` (K8), ``scan.HOT_LAUNCHES`` (B9, a chain
whose K1s, K2 and K6 launches count in their own counters too),
``dist.LAUNCHES`` (K9) and the B10 chains' ``dist.MULTI_LAUNCHES``,
``COALESCED_LAUNCHES``, ``SINGLE_LAUNCHES`` and ``PROBE_LAUNCHES``.
"""

import threading


class LaunchCount:
    """A launch counter a wrapper bumps where it launches its kernel; safe
    to bump from the concurrent searches' threads."""

    def __init__(self):
        self.n = 0
        self._lock = threading.Lock()

    def bump(self) -> None:
        with self._lock:
            self.n += 1

    def reset(self) -> None:
        with self._lock:
            self.n = 0
