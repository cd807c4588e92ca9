"""Search subsystem of the port: columnar search blocks, host query
compilation, and the batched scan over hand-written CUDA kernels.

  data.py        per-trace search data + wire codec
  columnar.py    the columnar page format + container codec (byte-
                 identical to the reference's)
  pipeline.py    host-side query compilation + block header pruning
  results.py     result collection: dedupe, limit, metrics, ordering
  engine.py      top-k sizing and the one-sync fetch of scan outputs
  kernels/       the CUDA kernels, their plain PyTorch versions, the build
  multiblock.py  stacking blocks into one batch, per-block query tables,
                 the batched scan (kernels K1 + K2) and result rendering
  backend_search_block.py  container write/read
  batcher.py     group planning, staged cache, pipelined dispatch
"""

from .columnar import ColumnarPages, PageGeometry
from .data import SearchData, decode_search_data, encode_search_data
from .results import SearchResults

__all__ = ["SearchData", "encode_search_data", "decode_search_data",
           "ColumnarPages", "PageGeometry", "SearchResults"]
