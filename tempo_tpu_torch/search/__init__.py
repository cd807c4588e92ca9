"""Search subsystem of the port: columnar search blocks, host query
compilation, and the batched scan over hand-written CUDA kernels.

  data.py        per-trace search data (span rows too): extraction from
                 a trace proto, wire codec
  columnar.py    the columnar page format + container codec (byte-
                 identical to the reference's), span segment included
  ir.py          the structural query IR (a copy of the reference's)
  structural.py  structural queries: gate, compile to slot programs and
                 tables, span staging, stacking, the host oracle
  pipeline.py    query compilation (host walk or device probe) + block
                 header pruning
  dict_probe.py  value dictionaries packed and staged for the device
                 probe (kernel K3)
  results.py     result collection: dedupe, limit, metrics, ordering
  engine.py      the single-block engine (kernels K1s + K2), top-k sizing
                 and the one-sync fetch of scan outputs
  analytics.py   ?agg=red: the staged composite keys, decode and merge of
                 the aggregate, the ingest side's dense count (kernel K8)
  kernels/       the CUDA kernels (K1-K8), their plain PyTorch versions,
                 the build
  multiblock.py  stacking blocks into one batch, per-block query tables,
                 the batched scan (kernels K1 + K2) and result rendering
  backend_search_block.py  container write/read, single-block search
  batcher.py     group planning, staged cache, pipelined dispatch
  live_tier.py   the live tier: per-tenant rolling stages of in-flight
                 traces scanned on the device (B9), tail subscriptions
  streaming.py   the WAL head's search block: sidecar file, replay, and
                 search through the live tier's scan or the host walk
"""

from .columnar import ColumnarPages, PageGeometry
from .data import (DEFAULT_MAX_SEARCH_BYTES, DEFAULT_MAX_SPAN_KVS,
                   DEFAULT_MAX_SPANS, SearchData, collect_span_rows,
                   decode_search_data, encode_search_data,
                   extract_search_data)
from .results import SearchResults

__all__ = ["SearchData", "encode_search_data", "decode_search_data",
           "extract_search_data", "collect_span_rows",
           "DEFAULT_MAX_SEARCH_BYTES", "DEFAULT_MAX_SPANS",
           "DEFAULT_MAX_SPAN_KVS", "ColumnarPages", "PageGeometry",
           "SearchResults"]
