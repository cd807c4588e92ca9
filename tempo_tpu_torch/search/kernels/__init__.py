"""The port's hand-written CUDA kernels, their wrappers and plain versions.

  K1  ``scan.multi_scan``      (csrc/scan.cu)  <- tempo_tpu multiblock.multi_scan_kernel
  K1s ``scan.scan_single``     (csrc/scan.cu)  <- tempo_tpu engine.scan_kernel
  K2  ``topk.topk``            (csrc/topk.cu)  <- tempo_tpu engine.masked_topk
  K3  ``probe.dict_probe``     (csrc/probe.cu) <- tempo_tpu dict_probe.probe_kernel
  K4  ``scan.coalesced_scan``  (csrc/scan.cu)  <- tempo_tpu multiblock.coalesced_scan_kernel
  K2r ``topk.topk_rows``       (csrc/topk.cu)  <- its vmapped masked_topk

Each wrapper takes its plain PyTorch version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises. Each keeps a launch count
(``scan.LAUNCHES`` for K1 in range mode, ``scan.HIT_LAUNCHES`` for K1 in
hit-mask mode, ``scan.SINGLE_LAUNCHES``, ``scan.COALESCED_LAUNCHES`` and
``scan.COALESCED_HIT_LAUNCHES`` for K4 in either mode, ``topk.LAUNCHES``,
``topk.ROW_LAUNCHES``, ``probe.LAUNCHES``) that grows by one per call
that launches the kernel, so a run can show the main path went through
it.
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
