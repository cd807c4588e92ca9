"""PyTorch/CUDA port of tempo-tpu's search engine, for one NVIDIA H100.

The JAX package ``tempo_tpu`` is the reference; this package is a second
implementation beside it that imports nothing from it. Module names mirror
the reference so each counterpart is easy to find
(``tempo_tpu_torch/search/multiblock.py`` <-> ``tempo_tpu/search/multiblock.py``).

The slice ported so far is backend tag search over search blocks:
``db.TempoDB.search`` -> ``search.batcher.BlockBatcher`` ->
``search.multiblock.MultiBlockEngine`` -> the hand-written CUDA kernels in
``csrc/`` (``scan.cu`` and ``topk.cu``). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; see ``device.py``.
"""
