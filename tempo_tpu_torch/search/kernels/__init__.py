"""The port's hand-written CUDA kernels, their wrappers and plain versions.

  K1 ``scan.multi_scan``  (csrc/scan.cu)  <- tempo_tpu multiblock.multi_scan_kernel
  K2 ``topk.topk``        (csrc/topk.cu)  <- tempo_tpu engine.masked_topk

Each wrapper takes its plain PyTorch version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises. Each keeps a launch count
(``scan.LAUNCHES``, ``topk.LAUNCHES``) that grows by one per call that
launches the kernel, so a run can show the main path went through it.
"""


class LaunchCount:
    """A plain launch counter a wrapper bumps where it launches its
    kernel."""

    def __init__(self):
        self.n = 0

    def reset(self) -> None:
        self.n = 0
