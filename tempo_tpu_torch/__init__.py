"""PyTorch/CUDA port of tempo-tpu's read path, for one NVIDIA H100.

The JAX package ``tempo_tpu`` is the reference; this package is a second
implementation beside it that imports nothing from it. Module names mirror
the reference so each counterpart is easy to find
(``tempo_tpu_torch/search/multiblock.py`` <-> ``tempo_tpu/search/multiblock.py``).

The slices ported so far are backend tag search over search blocks:
``db.TempoDB.search`` (and ``search_block``, ``search_blocks``) ->
``search.batcher.BlockBatcher`` -> ``search.multiblock.MultiBlockEngine``,
and the single-block ``search.backend_search_block.BackendSearchBlock
.search`` -> ``search.engine.ScanEngine``, over the hand-written CUDA
kernels in ``csrc/`` (``scan.cu``, ``topk.cu``, and ``probe.cu`` for value
dictionaries large enough to probe on the device). Given a mesh
(``parallel/``), ``TempoDB`` shards every batch over ranks on
``torch.distributed`` and merges their top-k with ``csrc/dist.cu``.
Trace-by-ID is host code, as in the reference: ``db.TempoDB
.find_trace_by_id`` over ``encoding.v2.backend_block.BackendBlock``
(bloom, index, one data page), the blocks written by
``encoding.v2.streaming_block.StreamingBlock``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; see ``device.py``.
"""

__version__ = "0.1.0"
