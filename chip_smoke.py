#!/usr/bin/env python3
"""Drive the PyTorch port's search, trace-by-ID and ingest on one CUDA card.

  python3 chip_smoke.py                  # full size, as a user would call it
  python3 chip_smoke.py --blocks 8 --traces-per-block 8192 \\
      --hc-blocks 2 --hc-traces-per-block 131072 --long-blocks 4 \\
      --hc-packed-blocks 2 --st-blocks 4 \\
      --st-traces-per-block 16384 --agg-blocks 8 \\
      --wal-traces 16384 --tbi-traces-per-block 4096 \\
      --ingest-traces-per-block 4096                   # a quick check

The mesh cell (step 9) needs no flag and runs over the earlier cells'
corpora.

What it does, in order, failing (exit code != 0, no result line) on any
error:

1. builds the port's CUDA kernels (tempo_tpu_torch/csrc/*.cu, one nvcc per
   source, started together) for sm_90a, and beside them its host library
   (tempo_tpu_torch/csrc/host/tempotpu.cc, the host's C++ compiler:
   the ingest walker, the codecs, the substring scan, XXH64), printing
   the compiler and the codecs that loaded;
2. the tag-search cell: writes a seeded corpus through the port's write
   path (ColumnarPages.from_arrays -> write_search_pages, zlib) into a
   temporary LocalBackend, by default 256 blocks x 65,536 traces = 16.8M
   traces, 1,024 entries per page, 8 tags per trace; answers six requests
   through ``TempoDB.search`` on the card (launch counters set to 0 just
   before, read just after), each once warm and then timed; times three
   of them on the device (``KernelTimer``) for idle share; answers them
   again through a ``TempoDB`` on the CPU (the kernels' plain versions)
   and requires identical responses; then holds K1 (multi_scan, range
   mode) and K2 (topk) against their plain versions on the card and times
   them, K1 and K1s also at their design's edges (``k1_edges``: every
   reader pair and hit format, C = 8, 9, 10, 17 and 80, T = 0, 16 and 40,
   keys past the key table, runs of many tiles a CTA, verdicts; every
   launcher call replayed from 8 host threads at once; no K1 build
   spilling), K2 also on adversarial columns (``topk_columns``: all -1, all
   equal, the narrow window, uniform over int31, INT32_MAX scores, fewer
   matches than k, k = n, k > n, n = 1), printing the CUDA kernels and
   memsets the profiler saw per call (at most 3 for k <= 4,096) and the
   wrapper's host microseconds; then K4 (coalesced_scan, range mode) on
   8 stacked requests, and K4 at its design's edges (``k4_edges``: every
   reader pair and hit format, Q = 1 and 64, Q x T past one 64-term
   chunk, C = 9, 10, 17 and 80, fewer verdict rows than queries, ids past
   a member's table, pad pages; every launcher call replayed from 8
   host threads at once; and no K4 build spilling in ptxas's report),
   and K2r (topk_rows) at k = 128 and 1024, on K4's
   rows and on rows of the adversarial columns that stop on different
   passes, and a fused dispatch against the
   members' solo dispatches; then the concurrent phase (below) with 8
   bench requests and with 8 exhaustive ones, and the bench request alone
   once more; then the packed tag cell: a second TempoDB with
   ``search_packed_residency=True`` over the same blocks answers the six
   requests and the 8-client exhaustive set, each response equal to the
   unpacked database's, prints both databases' staged bytes (physical
   and logical), and holds K1 and K4 in the packed layout against their
   plain versions;
3. the long-duration cell: 64 blocks x 65,536 traces like the tag cell's,
   except that 1 trace in 64 lasts 60,000-3,600,000 ms (packed: u16
   duration buckets plus a u8 residual); an unpacked and a packed
   TempoDB answer four duration requests alike, and K1 with bucketed
   durations is held against its plain version;
4. the high-cardinality cell: 10 blocks x 1,048,576 traces, each trace
   with the 8 tags and a ``session.id`` unique across the corpus (~1.05M
   distinct values per block dictionary, so every block stages its
   dictionary for the device probe at the default 50k threshold); answers
   four requests through ``TempoDB.search``, one through
   ``TempoDB.search_block`` and two through ``BackendSearchBlock.search``
   (the single-block engine), each cold then 10 times warm, with launch
   counts per request; times three on the device; requires the CPU
   path's responses;
   then holds K3 (dict_probe) in bool rows and in words, K1 in hit-mask
   mode and K1s (scan_single) against their plain versions on the card
   and times them, and the whole probe call from needle bytes
   (``probe_value_hits``: card ms, host issue time, and by the profiler
   one ``probe_kernel`` launch a call and nothing else on the stream);
   K3 also at its design's edges (``k3_edges``: V = 1 to 4,097, empty
   values, a value longer than a chunk, matches across value boundaries
   and in the last bytes, needles of 1 to 64 bytes, the empty needle
   and a None term, T = 1 to 60, non-ASCII bytes, buf off a 16-byte
   boundary, both output forms; every launcher call replayed from 8
   host threads at once; no probe.cu build spilling); then K4 in
   hit-mask mode on 6 probed and 2 host-compiled requests, with the fused
   dispatch against the solo ones; then the concurrent phase with 8
   exhaustive session-id substrings, and the point lookup alone once
   more; then one request whose needle is longer than K3 takes (64
   bytes), so each block's dictionary is scanned on the host by the
   library's memmem scan (``hc_host_route``), its value ids over block
   0's dictionary held against numpy's for it and three short needles,
   both timed;
5. the packed high-cardinality cell: the hc corpus's first 4 blocks (one
   4,096-page group), an unpacked and a packed TempoDB through the same
   three entry points, each packed response equal to the unpacked one,
   K3 writing the word masks itself (no K5 launch on the path); then
   K1, K1s and K4 with word hit tables and K5 (pack_mask_words, which
   no main path launches any longer) against their plain versions;
6. the structural cell: 16 blocks x 65,536 traces like the tag cell's,
   each trace with 1-31 span rows (16.8M spans; service.name, name,
   http.status_code, 1-2,000 ms, kind 0-5), through a TempoDB with
   ``search_structural_enabled``: five structural plans (child, desc,
   count, quantile, and-not-exists), each exhaustive and at limit 20,
   through ``TempoDB.search``, ``search_block`` and
   ``BackendSearchBlock.search`` (block 0), each cold then timed; the
   CPU path's responses required; K6 (structural_mask: an exact desc
   plan, an exact quantile plan, 8 bucketed plans; its device time the
   median of 20 single calls between CUDA events) and K1, K4 and K1s
   with its verdicts against their plain versions, the fused dispatch
   against the solo ones; K6 also exact on runs out of entry order and
   at its design's edges (``k6_edges``: parent cycles, runs longer than
   a tile, no spans, packed, bool and word hit tables, a 2-rank mesh's
   rebased and sharded spans, pad pages and invalid entries; Q = 1, 8
   and 40; every launcher call replayed from 8 host threads at once);
   8 barrier-started clients with 8 plans of one
   canonical bucket, through a second TempoDB with stacking and
   bucketing on and through the first (off), every response equal to
   the serial one; then an unpacked and a packed TempoDB over the first
   4 blocks, every packed response equal to the unpacked one. The
   cell's database also answers one ``?agg=red`` request with the desc
   plan (K6, K1 with its verdicts, K7), equal to the CPU path's;
7. the RED cell (``?agg=red``, kernels K7 and K8): the tag cell's
   corpus with error=true on 1 trace in 50 (C = 9), no root service on 1
   in 100 (the "" series) and durations log-uniform over 1-60,000 ms, 1
   in 8 exactly on an MS_BUCKETS edge or one past it; 128 blocks x
   65,536 traces (``--agg-blocks``), two 4,096-page groups, so the
   aggregate merges across groups, through a TempoDB with
   ``search_analytics_enabled``: red_all (a whole-tenant RED panel),
   red_svc, red_slow, red_500_window, red_all at limit 1 and red_svc's
   plain twin, each cold then timed, with launches, device time and idle
   share; red_all's aggregate equal to a count on the host (numpy) and
   to limit 1's; the ingest count (``analytics.dense_counts``, K8) on
   two micro-batches made from the corpus (8,192 rows x 64 series,
   1,048,576 x 4,096), equal to the host's count; every response equal
   to the CPU path's; K7 ([1, N] and [8, N] at K = 3,840 and [1, N] at
   K = 30,720: the shared-memory route; K = 61,440: the global-atomic
   one) and K8 (K = 960, one CTA's shared memory; 61,440, global
   atomics) against their plain versions, timed, with
   bound and torch.bincount times; one K7 call one ``agg_kernel`` launch
   and one K8 call one ``count_kernel`` launch, nothing else on the
   stream (the profiler);
   K7 at its design's edges (``k7_edges``: N = 0 to 4,096 k + 1, rows and
   keys off a 16-byte boundary, K either side of the shared limit, keys
   out of range, one hot bin, red_svc's ~10% accepted, rows at odd
   phases; every launcher call replayed from 8 host threads at once; no
   agg.cu build spilling); K8 at its design's edges (``k8_edges``: n = 0
   to 4,096 x 5 + 3, columns off a 16-byte boundary in and out of phase,
   K either side of the CTA route's limit, series ids out of range,
   durations on every threshold and past 2^62, one hot bin; replayed
   from 8 threads); a packed TempoDB over the first
   64 blocks (``AGG_PACKED_BLOCKS``) through ``search_blocks``, each
   response equal to the unpacked database's; then the concurrent phase
   with 8 svc-00i agg requests and with 4 agg and 4 plain, every fused
   dispatch all agg or all plain;
8. the live cell (kernel B9, ``kernels/live.py`` ``hot_scan``: K1s and
   K2 over a stage's live pages, K6 first for a structural request),
   through a TempoDB with ``search_live_tier_enabled`` and
   ``search_structural_enabled``: one tenant's live stage of
   ``--live-traces`` (4,096, the default ``search_live_tier_max_entries``:
   4 pages, tier 4) traces with the 8 tags and 1-31 span rows each,
   absorbed as encoded SearchData in push batches of 64; seven requests
   (bench, substring, duration, window, exhaustive, one the dictionaries
   prune, the desc plan), each cold then timed, with launches (one B9
   call, K1s and K2, per search, none for the pruned one, K6 for the
   plan) and device time, every response equal to a CPU LiveTier's;
   then ``--rounds`` push rounds (cut the oldest 64, absorb 64 new,
   search for the newest 64, which must be the new batch): total, host
   build, copy and device time; a cut of half the stage (responses
   equal to the CPU path's), and B9 against its plain version on the
   stage from before the cut, whose pages past the live count hold
   valid entries; a second tenant one trace past max_entries, which the
   tier declines with no launch; and the WAL head: a
   ``StreamingSearchBlock`` of ``--wal-traces`` (262,144: 256 pages)
   traces appended to its sidecar file, replayed by ``rescan``, two
   requests cold then timed, responses equal to the CPU path's, and B9
   held against its plain version there and timed;
9. the mesh cell (``parallel/``, the B10 chains and K9): an NCCL process
   group at world size 1 on the card (a TCPStore on 127.0.0.1) and
   ``make_mesh()``; grouped ``TempoDB``s (``mesh=``) over the tag corpus
   (the six requests cold then timed, then the 8-client exhaustive rounds,
   which fuse through the dist coalesced chain), the hc corpus (its four
   requests, through the value-sharded probe), the structural corpus
   (``search_structural_shard_spans`` and ``_remainder_pages`` on: the
   five plans, exhaustive) and the RED corpus (red_all), every response
   equal to an ungrouped database's, with K9 and the collectives launched
   on each; one more grouped hc request, with ``explain`` and a new
   needle, whose query stats carry the collective lock's wait
   (``lock_wait``) and h2d bytes, beside the profiler's h2d of the
   sharded staging; ``DistributedScanEngine`` over one tag block; then
   the S = 3 and S = 4 arithmetic on the card through a ``LocalExchange`` (a
   4,096-page tag group, solo and fused; the hc group with its
   dictionaries split over S value shards; the structural group with
   whole and with sharded spans, the remainder layout at S = 3; the RED
   group's aggregates; the single-block engine), every dispatch equal to
   the single-device one exactly, indices included; K9 against its plain
   version and K2 at [S, Q, k'] = [1, 1, 128] (the main path's),
   [8, 8, 1024] and [4, 1, 128], and with ties across shards at S = 3, 8
   and 1, through the gathered entry the exchange calls (one kernel a
   call, no copy, by the profiler) and the two-tensor form, timed beside
   torch.topk over the gathered scores with the wrapper's host
   microseconds, the world-1 NCCL collectives timed, and the four B10
   chains against their plain versions;
10. the trace-by-ID cell (no kernel of its own; host work over blocks'
   blooms, indexes and data pages): 32 blocks x 16,384 traces of the tag
   corpus's shapes (``--tbi-blocks``, ``--tbi-traces-per-block``; a cut
   is printed), each written twice through the port, its search
   container and its trace objects (v2 traces of 8 spans under the
   entry's service.name, ``StreamingBlock``, zlib, 1 MiB pages), with
   one meta.json; one more block holds a second partial (2 new spans, 1
   duplicate) of 1 trace in 64 of blocks 0-3. The tag cell's exhaustive
   request at limit 64 through ``TempoDB.search`` on the card (K1 and
   K2, their launches added to the counts, the response equal to the CPU
   path's), then ``find_trace_by_id`` of each result (found, its v2
   header the result's start and end); 1,024 seeded present ids (the
   written object, or the combine of both partials), every partial's id,
   and 1,024 absent ids (None, no failed block; the bloom passes
   counted); write seconds, the first lookup, and p50/p95 of a hit, a
   miss and a partial, and of the checksum (the host library's XXH64, and
   the plain Python one) and the parse of a full 1,024-record index page;
11. the ingest cell (the write path; its kernels K1, K1s and K2 on the
   searches after it): OTLP ``ResourceSpans`` pushes of 8,192 spans
   (``--ingest-push-spans``) made from the seed, 4 head blocks x 16,384
   traces (``--ingest-blocks``, ``--ingest-traces-per-block``) of 8 spans
   each, 4 under the trace's service and 4 under a downstream one, 1
   trace in 64 split over two pushes and 1 in 256 with a span ending
   before it starts, then one block of 1,024 traces
   (``--ingest-bare-traces``). Each push: ``push_items`` (regroup and
   extraction by the host library's walker; every push must go through
   it, and the first head's pushes also through the Python walk,
   ``push_items_plain``, whose items must be byte-equal),
   ``AppendBlock.append`` into the port's WAL (codec ``auto``: snappy
   where the host library has it), and the head's
   ``StreamingSearchBlock``; each head through
   ``TempoDB.complete_block`` (zlib blocks and containers), the last one
   without entries, so without a container. The fourth head is dropped
   without a close and replayed (``WAL.replay_all``,
   ``StreamingSearchBlock.rescan``): the same objects and entries. Then
   six requests through ``TempoDB.search`` on the card, each equal to
   the CPU path's, the exhaustive one's results equal to a host count
   (the pushed search data through ``search_data_matches``, the bare
   block's pushed traces through ``matches``); ``search_block`` on a
   container block and the bare one, ``BackendSearchBlock.search`` on
   one; every result opened by ``find_trace_by_id``, byte-equal to its
   ``AppendBlock.find`` bytes from before completion. It prints
   extraction us a trace and spans a second (both walks over the first
   head), WAL append MB/s, replay s,
   ``complete_block`` s a block (objects, index and bloom, container),
   the first search and the warm p50/p95, and ingest to searchable: from
   the last push through completion and poll to the first search that
   returns its last trace. Where the host has libzstd, one more head
   block under ``TempoDBConfig()``'s defaults (zstd blocks and
   containers) is completed, searched on the card against the CPU path,
   and each result opened;
12. the attribution cell (per-query stats, ``search/query_stats.py``, and
   the dispatch profiler, ``observability/profile.py``), over the tag,
   structural and RED databases the earlier cells left staged, card and
   CPU: the tag cell's six requests, the desc plan and red_all with
   ``explain`` on the card and on the CPU, their query stats equal in
   every field that measures no time, each response equal to its twin
   without ``explain``; the p50 of 10 warm runs' ``device_seconds`` (the
   CUDA events of their dispatches) of the three requests ``KernelTimer``
   timed in the tag cell, each at least 0.9x that device ms and at most
   the request's wall p50; four 8-client exhaustive rounds with
   coalescing on, every dispatch's stage totals equal to the sum of the
   shares its members' stats received (within 1e-6 ms); the bench
   request 10 times with the profiling fence on (the same answers, its
   device seconds); and the bench request in 21 interleaved turns over
   three databases: both gates on, the profiler alone (query stats off),
   both off; the three p50s, the responses equal. It prints one
   ``attribution:`` line;
13. the host-tier and planner cell (``search/batcher.py``'s host-RAM
   tier and prewarm, ``TempoDB``'s header snapshot, ``search/
   planner.py``; no kernel of its own): a TempoDB over the tag corpus
   whose device budget holds a third of the staged bytes the tag cell's
   database reports and whose host tier holds them all answers the six
   requests, each exhaustive, in two rounds, each response equal to the
   all-resident database's, round 2 re-staging only from the host tier
   (``hbm_miss_host_hit``); the cache events of each round, and one
   group's re-stage ms cold (both tiers dropped) and from the host tier;
   a TempoDB with ``search_prewarm_on_poll`` (poll and prewarm s, then
   the bench request's first latency) and one restarted on the same
   ``host_state_dir`` (no header read from the backend; its first bench
   request without prewarm); the planner's seed in a fresh process (its
   compile a kernel library's load), then TempoDBs with the planner on
   over the hc corpus (the four requests, each response equal to the hc
   cell's, planner off) and over the tag corpus with
   ``search_device_probe_min_vals=1`` (the six requests, equal to the
   tag cell's database's): the seeded rates on the card, the verdicts by
   site and target, the median predicted-vs-actual error, and K3's
   launches a request, at least one where a compile-site verdict was the
   device and none where every one was the host;
14. prints the run's time, the kernels line, the card's name and power
   limit, and as the last line {"ok": true, "device": {...}}.

Responses are compared through ``canon``: the attributed device seconds
(``SearchMetrics.device_seconds``) are a timing and are set to 0 there.

Every kernel row's device ms is the median of 20 single calls, each
between two CUDA events with a spin kernel holding the stream while the
host issues it (``kernel_row``, ``bench_structural.event_ms``); a
request's or a round's device ms sums its kernel launches, each between
CUDA events behind such a spin (``KernelTimer``). No device time reads
torch.profiler; it only counts K2's and K9's launches a call. K1's,
K1s's and K4's rows also carry the registers and spill bytes ptxas
reported for the build each launched.

The concurrent phase: 8 client threads, barrier-started, send one
request each per round, one warm-up round and then ``--rounds`` timed
ones, through a ``TempoDB`` with the default query coalescer and through
a second one over the same blocks with coalescing off
(``search_coalesce_max_queries=1``). Every response must equal the
serial response of the same request. It prints round and request
latencies, launches per kernel, the coalescer's queries per dispatch,
and a round's device ms and idle share (3 more rounds with each dispatch
timed).

It imports nothing of JAX and nothing of the tempo_tpu package.
"""

from __future__ import annotations

import argparse
import bisect
import concurrent.futures
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
# how every kernel row's device ms is taken (``kernel_row``)
DEVICE_SOURCE = "cuda_events, median of 20 single calls"
# how every request's and round's device ms is taken (``KernelTimer``)
REQUEST_DEVICE_SOURCE = ("cuda_events around each kernel launch behind a "
                         "spin, summed a call, median of the calls")

ENTRIES_PER_PAGE = 1024          # the reference's PageGeometry default
BASE_S = 1_700_000_000
BLOCK_SPAN_S = 600              # block b's traces start in [b*600, b*600+600)
KEYS = {
    "component": [f"comp-{i}" for i in range(4)],
    "host.name": [f"host-{i:04d}" for i in range(2000)],
    "http.method": ["DELETE", "GET", "PATCH", "POST", "PUT"],
    "http.status_code": ["200", "201", "204", "301", "400", "404", "500",
                         "503"],
    "k8s.namespace": [f"ns-{i:02d}" for i in range(16)],
    "name": [f"op-{i:02d}" for i in range(32)],
    "region": ["ap-south-1", "eu-central-1", "eu-west-1", "us-east-1",
               "us-west-1", "us-west-2"],
    "service.name": [f"svc-{i:03d}" for i in range(64)],
}
SESSION_KEY = "session.id"      # the high-cardinality cell's ninth tag
SPAN_OPS = [f"op-{i}" for i in range(16)]   # the structural cell's spans
POINT_SESSION = 123_456         # the point lookup's session number
BENCH = {"service.name": "svc-007", "http.status_code": "500"}
KERNELS = ("multi_scan", "multi_scan_hits", "scan_single", "topk",
           "dict_probe", "coalesced_scan", "coalesced_scan_hits",
           "topk_rows", "multi_scan_packed", "multi_scan_packed_q",
           "multi_scan_packed_hits", "scan_single_packed",
           "coalesced_scan_packed", "coalesced_scan_packed_hits",
           "pack_mask_words", "structural_mask", "multi_scan_verdicts",
           "scan_single_verdicts", "coalesced_scan_verdicts", "agg_counts",
           "agg_counts_rows", "analytics_count", "hot_scan", "shard_topk",
           "dist_multi_scan", "dist_coalesced_scan", "dist_scan_single",
           "dist_probe")
# kernels held against their plain versions whose work no main path
# launches any longer: K5, whose words K3 writes itself on the packed route
OFF_PATH = ("pack_mask_words",)
CLIENTS = 8                     # concurrent clients
BUSY_ROUNDS = 3                 # rounds a concurrent row's device ms takes
# the concurrent clients' predicates: one service each, AND status 500
CONCURRENT_TAGS = [{"service.name": f"svc-00{i}", "http.status_code": "500"}
                   for i in range(CLIENTS)]
# the high-cardinality cell's concurrent session.id substrings
HC_SESSIONS = ("77", "123", "404", "5555", "0012", "99", "31", "808")
EXHAUSTIVE = {"x-dbg-exhaustive": ""}
# databases the earlier cells leave staged for the attribution cell, by
# corpus: {"gpu", "cpu", "reqs", "tenant", ...}, closed at the run's end;
# and the hc corpus's root and planner-off answers for the planner cell
STAGED: dict = {}


def requests(blocks: int) -> dict:
    """name -> (tags, other SearchRequest fields). The exhaustive one
    scans every block (no pruning, no early quit) and runs first, so every
    group is staged before the others."""
    mid = BASE_S + (blocks // 2) * BLOCK_SPAN_S
    return {
        "exhaustive_bench": (dict(BENCH, **{"x-dbg-exhaustive": ""}),
                             {"limit": 20}),
        "bench_and": (BENCH, {"limit": 20}),
        "substring": ({"host.name": "host-01"}, {"limit": 20}),
        "duration": ({}, {"min_duration_ms": 59_000,
                          "max_duration_ms": 59_999, "limit": 20}),
        "window": ({}, {"start": mid + 300, "end": mid + 2 * BLOCK_SPAN_S,
                        "limit": 20}),
        "limit_1000": (BENCH, {"limit": 1000}),
    }


def hc_requests() -> dict:
    """The high-cardinality cell's batched requests, in the order they
    run: the exhaustive one stages every group."""
    return {
        "hc_exhaustive_77": ({SESSION_KEY: "77", "x-dbg-exhaustive": ""},
                             {"limit": 20}),
        "hc_point": ({SESSION_KEY: f"session-{POINT_SESSION:08d}"},
                     {"limit": 20}),
        "hc_prefix": ({SESSION_KEY: f"session-{POINT_SESSION // 10:07d}"},
                      {"limit": 20}),
        "hc_77_and_svc": ({SESSION_KEY: "77", "service.name": "svc-007"},
                          {"limit": 20}),
    }


def make_block(seed: int, b: int, n: int, E: int, sessions: bool = False,
               long_every: int = 0, spans: bool = False, red: bool = False,
               counts=None, cycles: bool = False):
    """Block b's columns, from the seed, as the port's ColumnarPages. With
    `sessions`, every trace also carries session.id "session-%08d", unique
    across blocks of n traces, in a seeded order. With `long_every`, one
    trace in that many (seeded) lasts 60,000-3,600,000 ms instead of
    under 60,000. With `spans`, every trace also carries span rows
    (``span_segment``). With `red` (the RED cell), from a second seeded
    stream: error=true on 1 trace in 50 (a last kv slot, C = 9), no root
    service on 1 in 100, and durations log-uniform over 1-60,000 ms, 1
    in 8 of them exactly on an ``MS_BUCKETS`` edge or one past it.
    `counts` and `cycles` go to ``span_segment``."""
    import numpy as np

    from tempo_tpu_torch.search.columnar import ColumnarPages

    rng = np.random.default_rng([seed, b])
    base_vals = sorted({v for vs in KEYS.values() for v in vs}
                       | (set(SPAN_OPS) if spans else set())
                       | ({"true"} if red else set()))
    key_dict = sorted(list(KEYS) + ([SESSION_KEY] if sessions else [])
                      + (["error"] if red else []))
    # kv slot c holds key cols[c]: the keys in order, the error key last
    cols = [k for k in key_dict if k != "error"] + (["error"] if red
                                                    else [])
    # no base value starts with "session-", so the sessions (zero-padded,
    # numeric order = string order) form one run of the sorted dictionary
    lo = bisect.bisect_left(base_vals, "session-")
    n_sess = n if sessions else 0
    first = b * n
    val_dict = (base_vals[:lo]
                + [f"session-{first + k:08d}" for k in range(n_sess)]
                + base_vals[lo:])
    vidx = {v: (i if i < lo else i + n_sess)
            for i, v in enumerate(base_vals)}
    P = -(-n // E)
    C = len(key_dict)
    kv_key = np.broadcast_to(np.asarray([key_dict.index(k) for k in cols],
                                        dtype=np.int32), (P, E, C)).copy()
    kv_val = np.empty((P, E, C), dtype=np.int32)
    for k in KEYS:
        ids = np.asarray([vidx[v] for v in KEYS[k]], dtype=np.int32)
        kv_val[:, :, cols.index(k)] = ids[
            rng.integers(0, len(ids), size=(P, E))]
    start = (BASE_S + b * BLOCK_SPAN_S
             + rng.integers(0, BLOCK_SPAN_S, size=(P, E))).astype(np.uint32)
    dur = rng.integers(1, 60_000, size=(P, E)).astype(np.uint32)
    if long_every:
        long = rng.integers(0, long_every, size=(P, E)) == 0
        dur[long] = rng.integers(60_000, 3_600_001, size=int(long.sum()))
    end = (start + dur // 1000).astype(np.uint32)
    valid = (np.arange(P * E) < n).reshape(P, E)
    if sessions:
        col = np.full(P * E, -1, dtype=np.int32)
        col[:n] = lo + rng.permutation(n).astype(np.int32)
        kv_val[:, :, cols.index(SESSION_KEY)] = col.reshape(P, E)
    svc = kv_val[:, :, cols.index("service.name")].copy()
    if red:
        from tempo_tpu_torch.search.analytics import MS_BUCKETS

        rr = np.random.default_rng([seed, b, 1])
        err = rr.integers(0, 50, size=(P, E)) == 0
        kv_key[:, :, C - 1] = np.where(err, key_dict.index("error"), -1)
        kv_val[:, :, C - 1] = np.where(err, vidx["true"], -1)
        svc[rr.integers(0, 100, size=(P, E)) == 0] = -1
        dur = np.clip(np.exp(rr.uniform(0, np.log(60_000), size=(P, E))),
                      1, 60_000).astype(np.uint32)
        edges = np.asarray([e + d for e in MS_BUCKETS for d in (0, 1)],
                           dtype=np.uint32)
        on_edge = rr.integers(0, 8, size=(P, E)) == 0
        dur[on_edge] = edges[rr.integers(0, edges.size,
                                         size=int(on_edge.sum()))]
        end = (start + dur // 1000).astype(np.uint32)
    kv_key[~valid] = -1
    kv_val[~valid] = -1
    svc[~valid] = -1
    start[~valid] = end[~valid] = dur[~valid] = 0
    trace_ids = np.frombuffer(rng.bytes(P * E * 16),
                              dtype=np.uint8).reshape(P, E, 16)
    name = kv_val[:, :, cols.index("name")]
    return ColumnarPages.from_arrays(
        key_dict, val_dict, kv_key, kv_val, start, end, dur, valid, svc,
        name, trace_ids,
        spans=(span_segment(rng, n, P, E, key_dict, vidx, counts, cycles)
               if spans else None))


def span_segment(rng, n: int, P: int, E: int, key_dict: list,
                 vidx: dict, counts=None, cycles: bool = False) -> dict:
    """The span rows of n traces laid out as the container's span segment:
    1-31 spans a trace (uniform; or `counts`), span 0 the root, each later
    span's parent a random earlier span of its trace or, 1 in 20, none;
    a trace of more than 64 spans chains every span to the one before it;
    with `cycles`, every trace of 3+ spans has a self-parent (span 0) and
    an A -> B -> A pair (spans 1 and 2); service.name, name (op-0..op-15)
    and http.status_code per span (Cs = 4 slots, the last a pad),
    1-2,000 ms, kind 0-5."""
    import numpy as np

    if counts is None:
        counts = rng.integers(1, 32, size=n)
    counts = np.asarray(counts, dtype=np.int64)
    S = int(counts.sum())
    first = np.repeat(np.cumsum(counts) - counts, counts)
    local = np.arange(S) - first
    parent = np.where(local > 0, first + (rng.random(S) * local)
                      .astype(np.int64), -1)
    parent[(local > 0) & (rng.random(S) < 0.05)] = -1
    chain = (np.repeat(counts, counts) > 64) & (local > 0)
    parent[chain] = np.arange(S)[chain] - 1
    if cycles:
        f = (np.cumsum(counts) - counts)[counts >= 3]
        parent[f], parent[f + 1], parent[f + 2] = f, f + 2, f + 1
    cols = ("http.status_code", "name", "service.name")   # sorted keys
    kv_key = np.full((S, 4), -1, dtype=np.int32)
    kv_val = np.full((S, 4), -1, dtype=np.int32)
    for c, k in enumerate(cols):
        vals = SPAN_OPS if k == "name" else KEYS[k]
        ids = np.asarray([vidx[v] for v in vals], dtype=np.int32)
        kv_key[:, c] = key_dict.index(k)
        kv_val[:, c] = ids[rng.integers(0, len(ids), size=S)]
    begin = np.zeros(P * E, dtype=np.int32)
    count = np.zeros(P * E, dtype=np.int32)
    begin[:n] = np.cumsum(counts) - counts
    count[:n] = counts
    return {"span_trace": np.repeat(np.arange(n, dtype=np.int32), counts),
            "span_parent": parent.astype(np.int32),
            "span_dur": rng.integers(1, 2001, size=S).astype(np.uint32),
            "span_kind": rng.integers(0, 6, size=S).astype(np.int8),
            "span_kv_key": kv_key, "span_kv_val": kv_val,
            "entry_span_begin": begin.reshape(P, E),
            "entry_span_count": count.reshape(P, E)}


def block_id(b: int) -> str:
    return f"00000000-0000-4000-8000-{b:012d}"


def write_corpus(root: str, tenant: str, blocks: int, n: int, E: int,
                 seed: int, sessions: bool = False,
                 long_every: int = 0, spans: bool = False,
                 red: bool = False) -> int:
    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.backend.types import BlockMeta
    from tempo_tpu_torch.search.backend_search_block import \
        write_search_pages

    be = LocalBackend(root)

    def one(b):
        pages = make_block(seed, b, n, E, sessions, long_every, spans, red)
        meta = BlockMeta(tenant_id=tenant, block_id=block_id(b),
                         start_time=int(pages.header["min_start_s"]),
                         end_time=int(pages.header["max_end_s"]),
                         total_objects=n)
        return write_search_pages(be, meta, pages, "zlib")["compressed_size"]

    workers = min(os.cpu_count() or 4, 4 if sessions else 32)
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        return sum(ex.map(one, range(blocks)))


def counters() -> dict:
    from tempo_tpu_torch.parallel import mesh
    from tempo_tpu_torch.search.kernels import agg, dist, pack, probe, scan
    from tempo_tpu_torch.search.kernels import structural as k6
    from tempo_tpu_torch.search.kernels import topk

    return {"multi_scan": scan.LAUNCHES, "multi_scan_hits": scan.HIT_LAUNCHES,
            "scan_single": scan.SINGLE_LAUNCHES, "topk": topk.LAUNCHES,
            "dict_probe": probe.LAUNCHES,
            "dict_probe_words": probe.WORD_LAUNCHES,
            "coalesced_scan": scan.COALESCED_LAUNCHES,
            "coalesced_scan_hits": scan.COALESCED_HIT_LAUNCHES,
            "topk_rows": topk.ROW_LAUNCHES,
            "multi_scan_packed": scan.PACKED_LAUNCHES,
            "multi_scan_packed_q": scan.PACKED_Q_LAUNCHES,
            "multi_scan_packed_hits": scan.PACKED_HIT_LAUNCHES,
            "scan_single_packed": scan.SINGLE_PACKED_LAUNCHES,
            "coalesced_scan_packed": scan.COALESCED_PACKED_LAUNCHES,
            "coalesced_scan_packed_hits": scan.COALESCED_PACKED_HIT_LAUNCHES,
            "pack_mask_words": pack.LAUNCHES,
            "structural_mask": k6.LAUNCHES,
            "multi_scan_verdicts": scan.VERDICT_LAUNCHES,
            "scan_single_verdicts": scan.SINGLE_VERDICT_LAUNCHES,
            "coalesced_scan_verdicts": scan.COALESCED_VERDICT_LAUNCHES,
            "agg_counts": agg.LAUNCHES, "agg_counts_rows": agg.ROW_LAUNCHES,
            "analytics_count": agg.COUNT_LAUNCHES,
            "hot_scan": scan.HOT_LAUNCHES, "shard_topk": dist.LAUNCHES,
            "dist_multi_scan": dist.MULTI_LAUNCHES,
            "dist_coalesced_scan": dist.COALESCED_LAUNCHES,
            "dist_scan_single": dist.SINGLE_LAUNCHES,
            "dist_probe": dist.PROBE_LAUNCHES,
            "collectives": mesh.COLLECTIVES}


def reset_counts() -> None:
    for c in counters().values():
        c.reset()


def read_counts() -> dict:
    return {k: c.n for k, c in counters().items()}


def add_counts(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


class GcPauses:
    """Wall time of the interpreter's cyclic garbage collections while
    active (gc.callbacks), which land inside whichever request allocates
    at that moment."""

    def __init__(self):
        self.ms = []
        self._t0 = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms.append((time.perf_counter() - self._t0) * 1e3)
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def drive(call, reps: int, sync: bool) -> dict:
    """One cold call, then `reps` timed warm calls, launch counters set to
    0 just before and read after the cold call and after the last, and
    the collector's pauses during the warm calls."""
    import torch

    reset_counts()
    t0 = time.perf_counter()
    resp = canon(call().response())
    if sync:
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    cold = read_counts()
    lat = []
    with GcPauses() as pauses:
        for _ in range(reps):
            t0 = time.perf_counter()
            again = canon(call().response())
            if sync:
                torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            if again != resp:
                raise AssertionError("repeated search differs")
    return {"resp": resp, "first_s": first_s, "lat": sorted(lat),
            "launches_cold": cold, "launches": read_counts(),
            "gc_ms": pauses.ms}


def run_queries(db, tenant: str, reqs: dict, reps: int) -> dict:
    """Each request once warm, then `reps` timed runs. Returns per request
    the response of the warm run, the timings and the dispatches."""
    from tempo_tpu_torch.model.types import SearchRequest

    out = {}
    for name, (tags, kw) in reqs.items():
        req = SearchRequest(tags=dict(tags), **kw)
        try:
            out[name] = drive(lambda: db.search(tenant, req), reps,
                              db.device.type == "cuda")
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None
        out[name]["dispatches"] = db.batcher.last_dispatches
    return out


def canon(resp):
    """A response as it is compared: the database's attributed device
    seconds (``SearchMetrics.device_seconds``, a timing) set to 0. The
    attribution cell reads them from the explain breakdown instead."""
    import dataclasses

    return dataclasses.replace(resp, metrics=dataclasses.replace(
        resp.metrics, device_seconds=0.0))


def check_response(name: str, resp, tags: dict, kw: dict, n_total: int,
                   rootless: bool = False):
    """Every returned trace satisfies the request, the order is newest
    first, and the metrics are consistent. With `rootless` (a corpus with
    traces that have no root service) a result's root service is checked
    against the service.name term only where it has one."""
    m = resp.metrics
    if m.inspected_traces > n_total or m.inspected_traces < 0:
        raise AssertionError(f"{name}: inspected {m.inspected_traces}")
    limit = kw.get("limit") or 20
    if len(resp.traces) > limit:
        raise AssertionError(f"{name}: {len(resp.traces)} > limit {limit}")
    starts = [t.start_time_unix_nano for t in resp.traces]
    if starts != sorted(starts, reverse=True):
        raise AssertionError(f"{name}: results not newest first")
    for t in resp.traces:
        s = t.start_time_unix_nano // 1_000_000_000
        if kw.get("end") and s > kw["end"]:
            raise AssertionError(f"{name}: start {s} after window")
        lo, hi = kw.get("min_duration_ms", 0), kw.get("max_duration_ms", 0)
        if (lo and t.duration_ms < lo) or (hi and t.duration_ms > hi):
            raise AssertionError(f"{name}: duration {t.duration_ms}")
        svc = tags.get("service.name")
        if svc and svc not in t.root_service_name \
                and not (rootless and not t.root_service_name):
            raise AssertionError(f"{name}: root service "
                                 f"{t.root_service_name}")
    if tags.get("x-dbg-exhaustive") is not None and m.inspected_traces \
            != n_total:
        raise AssertionError(f"{name}: exhaustive scan inspected "
                             f"{m.inspected_traces} of {n_total}")


def profiled(fn, reps: int):
    """torch.profiler's key averages over `reps` calls of fn (after one
    warm call), CPU and CUDA activities. acc_events=True keeps the records
    of every cycle: without it the profiler drops those of earlier cycles
    in a long run (it kept 3 of 20 kernel records in one), and a sum over
    the records read low."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def device_events(averages) -> list:
    """The device-side events (kernels, copies, sets): a CPU op's self
    device time counts its kernels a second time."""
    from torch.autograd import DeviceType

    return [e for e in averages if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


class KernelTimer:
    """Device milliseconds of the kernels that requests launch, from CUDA
    events (C1: torch.profiler lost launch records late in full runs).
    While it is on, every C launcher of the port's kernels (each loaded
    library's ``tt_*`` launch functions, and the ones ``topk`` and
    ``dist`` keep) runs as: an event, a hold kernel, an event, the
    launch, an event, and then the host releases the hold (``csrc/
    timing.cu``: the hold spins until a counter in pinned memory reaches
    this launch's number). The last two events thus bracket the kernel
    alone, however long the host took to issue it: a fixed spin does not
    hold when other client threads keep the interpreter past it. A
    request's device ms is the sum over its launches: its kernels, not
    the copies of its tables and results (a few KB) nor NCCL's
    collectives. A hold that ran out (~50 ms) before its release is
    counted as uncovered. Threads take turns (one lock), so pairs on one
    stream never interleave; the batcher's result fetches take the same
    turns."""

    HOLD_CYCLES = 100_000_000       # the hold's limit: ~50 ms at ~1.9 GHz
    # the C functions that launch kernels, by library
    LAUNCHERS = {"scan": ("tt_scan_k1", "tt_coalesced_scan"),
                 "structural": ("tt_structural_mask",),
                 "pack": ("tt_pack_mask_words",),
                 "probe": ("tt_dict_probe",),
                 "agg": ("tt_agg_counts", "tt_analytics_count")}

    def __init__(self):
        self._lock = threading.Lock()
        self._saved: list = []
        self.pairs: list = []
        self._hold = None
        self._counter = None
        self._n = 0

    def __enter__(self):
        import ctypes

        import torch

        from tempo_tpu_torch.search.kernels import build, dist, topk

        lib = build.load("timing")
        self._hold = lib.tt_wait_host
        self._hold.restype = ctypes.c_int
        self._hold.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_longlong, ctypes.c_void_p]
        self._counter = torch.zeros(1, dtype=torch.int64, pin_memory=True)
        self._n = 0
        topk._fn()
        dist._fn()
        for name, fns in self.LAUNCHERS.items():
            lib = build.load(name)
            for fn in fns:
                real = getattr(lib, fn)
                self._saved.append((lib, fn, real))
                setattr(lib, fn, self._timed(real, fn))
        for mod in (topk, dist):
            self._saved.append((mod, "_FN", mod._FN))
            mod._FN = self._timed(mod._FN, mod._FN.__name__)
        # a client thread's result fetch waits for the stream and, while it
        # waits, keeps other threads from issuing a launch; taken in turn
        # with the timed launches, it never waits behind a hold
        from tempo_tpu_torch.search import batcher
        for name in ("fetch_scan_out", "fetch_coalesced_out"):
            real = getattr(batcher, name)
            self._saved.append((batcher, name, real))
            setattr(batcher, name, self._in_turn(real))
        return self

    def _in_turn(self, real):
        timer = self

        def in_turn(*a):
            with timer._lock:
                return real(*a)
        return in_turn

    def __exit__(self, *exc):
        for obj, name, real in reversed(self._saved):
            setattr(obj, name, real)
        self._saved.clear()

    def _timed(self, real, name):
        import torch

        from tempo_tpu_torch.search.kernels import build

        timer = self
        counter = self._counter.numpy()

        def timed(*a):
            with timer._lock:
                timer._n += 1
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(3)]
                stream = build._raw_stream(torch.cuda.current_device())
                ev[0].record()
                rc = timer._hold(timer._counter.data_ptr(), timer._n,
                                 timer.HOLD_CYCLES, stream)
                ev[1].record()
                try:
                    if rc == 0:
                        rc = real(*a)
                    ev[2].record()
                finally:
                    counter[0] = timer._n       # release the hold
                timer.pairs.append(ev)
            return rc
        timed.__name__ = name
        return timed

    def take(self) -> dict:
        """The device ms of the launches timed since the last take, their
        count and the uncovered ones; clears them. The pairs are taken
        before the device is synchronised: a launch another thread makes
        after the requests returned (a fused dispatch whose member had
        already quit) then goes to the next take, and every pair read here
        has completed."""
        import torch

        with self._lock:
            pairs, self.pairs = self.pairs, []
        torch.cuda.synchronize()
        ms = sum(ev[1].elapsed_time(ev[2]) for ev in pairs)
        # a hold that ran to its limit (~50 ms) was not released in time
        uncovered = sum(ev[0].elapsed_time(ev[1]) > 40.0 for ev in pairs)
        return {"device_ms": ms, "launches": len(pairs),
                "uncovered": uncovered}


def call_busy(fn, reps: int) -> dict:
    """Device time a call of fn: the median over `reps` warm calls of its
    kernels' device ms (``KernelTimer``), after one warm call."""
    fn()
    runs = []
    with KernelTimer() as timer:
        for _ in range(reps):
            fn()
            runs.append(timer.take())
    ms = sorted(r["device_ms"] for r in runs)
    return {"device_ms": ms[len(ms) // 2],
            "launches": max(r["launches"] for r in runs),
            "uncovered": sum(r["uncovered"] for r in runs),
            "source": REQUEST_DEVICE_SOURCE}


def device_busy(db, tenant: str, reqs: dict, names, reps: int) -> dict:
    """call_busy of each named request through ``db.search``."""
    from tempo_tpu_torch.model.types import SearchRequest

    out = {}
    for name in names:
        tags, kw = reqs[name]
        req = SearchRequest(tags=dict(tags), **kw)
        out[name] = call_busy(lambda: db.search(tenant, req), reps)
    return out


def print_busy(busy: dict, lat_report: dict) -> None:
    for name, b in busy.items():
        p50 = lat_report[name]["p50_ms"]
        b["idle_share_of_p50"] = max(0.0, 1 - b["device_ms"] / p50)
        print(f"device busy {name}: {b['device_ms']:.3f} ms per request "
              f"(CUDA events, {b['launches']} launches, "
              f"{b['uncovered']} uncovered) of {p50:.3f} ms p50, idle "
              f"share {b['idle_share_of_p50']:.2f}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the current stream (CUDA
    events around `reps` back-to-back calls, after one warm call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def require_equal(what: str, got: tuple, want: tuple) -> int:
    """Exact equality of kernel outputs and their plain versions' on the
    card; returns the largest absolute difference (0)."""
    import torch

    if any(g.is_cuda for g in got):
        torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{what} differs from its plain version")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


class LauncherReplay:
    """Records the C launcher calls that K1's, K1s's, K3's, K4's, K6's,
    K7's and K8's wrappers make between ``start`` and ``stop`` (each
    call's frame is kept, which keeps its tensors alive), then ``replay``
    calls those launchers again straight from several host threads at
    once, without the wrappers' Python between calls: a launcher that sets
    a kernel's shared-memory allowance to its own call's size fails its
    launch when another thread's smaller allowance lands between its set
    and its launch, and one whose cached occupancy or per-batch state
    another thread changes launches a wrong grid."""

    # each C launcher by the kernels it launches
    NAMES = {"tt_scan_k1": "K1", "tt_coalesced_scan": "K4",
             "tt_structural_mask": "K6", "tt_agg_counts": "K7",
             "tt_analytics_count": "K8", "tt_dict_probe": "K3"}

    def __init__(self):
        from tempo_tpu_torch.search.kernels import (agg, probe, scan,
                                                    structural)

        self.mods = (scan, structural, agg, probe)
        self.calls = []

    def start(self):
        for mod in self.mods:
            mod.on_device = self._recorder(mod.on_device)
        return self

    def _recorder(self, real):
        def on_device(dev, fn, *args):
            name = self.NAMES.get(getattr(fn, "__name__", ""), "other")
            self.calls.append((name, dev, fn, args, sys._getframe(1)))
            return real(dev, fn, *args)
        on_device.real = real
        return on_device

    def stop(self):
        for mod in self.mods:
            mod.on_device = mod.on_device.real

    def replay(self, reps: int = 4000, threads: int = 8) -> dict:
        """Each thread calls `reps` recorded launchers in turn; raises on
        any launch error. Returns {launcher: calls}."""
        import torch

        from tempo_tpu_torch.search.kernels import build

        errs, lock = {}, threading.Lock()
        torch.cuda.synchronize()

        def loop(i):
            for r in range(reps):
                name, dev, fn, args, _frame = self.calls[
                    (i * 7 + r) % len(self.calls)]
                rc = fn(*args, build._raw_stream(dev.index))
                if rc:
                    with lock:
                        errs[(name, rc)] = errs.get((name, rc), 0) + 1

        with concurrent.futures.ThreadPoolExecutor(threads) as ex:
            list(ex.map(loop, range(threads)))
        torch.cuda.synchronize()
        if errs:
            raise AssertionError(
                f"launchers called from {threads} threads at once failed: "
                + ", ".join(f"{n} CUDA error {rc} x{k}"
                            for (n, rc), k in sorted(errs.items())))
        names = [c[0] for c in self.calls]
        return {n: names.count(n) for n in sorted(set(names))}


def kernels_per_call(fn, reps: int = 5) -> dict:
    """The CUDA kernels, memsets and copies torch.profiler saw per call of
    fn (short name -> count a call). The profiler sometimes keeps no
    launch record late in a long run, so it profiles up to three times;
    {} means that none kept one (not measured)."""
    for _ in range(3):
        out: dict = {}
        for e in device_events(profiled(fn, reps)):
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            name = name.strip() or e.key[:40]
            out[name] = out.get(name, 0) + e.count / reps
        if out:
            return out
    return {}


def host_us(fn, reps: int = 1000) -> float:
    """Host microseconds a call of fn takes to issue (time.perf_counter
    over `reps` calls, no synchronise between them)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def kernel_row(name, source, replaces, launches, err, ms, plain_ms,
               bound_bytes, library_ms, shape, fn=None) -> dict:
    """A kernels-line row; with `fn` (one call of the kernel's wrapper)
    the report's shape also gets its device time: ``event_ms``, the
    median of 20 single synchronised calls between CUDA events (no
    profiler record)."""
    if fn is not None:
        from tempo_tpu_torch.search.kernels.bench_structural import event_ms

        shape["device_ms"] = event_ms(fn)
        shape["device_source"] = DEVICE_SOURCE
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": library_ms, "shape": shape}


def largest_batch(db):
    """The staged batch with the most block pages, ties broken by group
    key, so an unpacked and a packed database over the same blocks pick
    the same group."""
    return max(db.batcher._cache.items(),
               key=lambda kv: (sum(b.n_pages for b in kv[1].batch.blocks),
                               kv[0]))[1].batch


def k1_row(db, name: str, replaces: str, tags: dict, kw: dict,
           launches: dict, hits: bool) -> tuple:
    """K1 against its plain version on the largest staged batch of `db`
    (in the batch's layout, packed or not), with the request compiled as
    the engine compiles it; exact equality. Returns (kernel row, the
    kernel's scores)."""
    import torch

    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search.kernels import scan
    from tempo_tpu_torch.search.kernels.bench_coalesced import k1_bytes
    from tempo_tpu_torch.search.multiblock import compile_multi

    eng = db.batcher.engine
    batch = largest_batch(db)
    d = batch.device
    mq = compile_multi(list(batch.blocks),
                       SearchRequest(tags=dict(tags), **kw),
                       memo=batch.memo, cache=eng.compile_cache,
                       staged_dicts=batch.staged_dicts, packed=eng.packed)
    if (mq.val_hits is not None) != hits:
        raise AssertionError(f"{name}: the request compiled "
                             f"{'no' if hits else 'a'} hit mask")
    bg = (None if mq.block_group is None
          else torch.from_numpy(mq.block_group).to(db.device))
    res = d.get("entry_dur_res")
    args = (d["kv_key"], d["kv_val"], d["entry_start"], d["entry_end"],
            d["entry_dur"], d["entry_valid"], d["page_block"],
            torch.from_numpy(mq.term_keys).to(db.device),
            torch.from_numpy(mq.val_ranges).to(db.device), mq.n_terms,
            mq.dur_lo, min(mq.dur_hi, 0xFFFFFFFF), mq.win_start,
            min(mq.win_end, 0xFFFFFFFF))
    extra = (mq.val_hits, bg, batch.widths, res)
    scores, counts = scan.multi_scan(*args, *extra)
    err = require_equal(name, (scores, counts),
                        scan.multi_scan_plain(*args, *extra))
    need = k1_bytes(args, scores, mq.val_hits, bg, widths=batch.widths,
                    res=res)
    ms = cuda_ms(lambda: scan.multi_scan(*args, *extra), 50)
    plain = cuda_ms(lambda: scan.multi_scan_plain(*args, *extra), 3)
    shape = {"pages": batch.n_pages, "entries": scores.numel(),
             "kv_dtypes": [str(d["kv_key"].dtype), str(d["kv_val"].dtype)],
             "widths": batch.widths, "C": int(d["kv_key"].shape[2]),
             "n_terms": mq.n_terms, "R": int(mq.val_ranges.shape[2]),
             "val_hits": (None if mq.val_hits is None else
                          [list(mq.val_hits.shape), str(mq.val_hits.dtype)]),
             "match_count": int(counts[0]), "inspected": int(counts[1]),
             "bytes_needed": need}
    return (k1_ptxas(kernel_row(name, "tempo_tpu_torch/csrc/scan.cu",
                                replaces, launches, err, ms, plain, need,
                                None, shape,
                                lambda: scan.multi_scan(*args, *extra)),
                     d["kv_key"], d["kv_val"], batch.widths,
                     mq.n_terms > 0), scores)


def k1s_row(bsb, name: str, replaces: str, launches: dict) -> dict:
    """K1s against its plain version on a BackendSearchBlock's staged
    block (in its layout) with the bench request, through the device
    probe; exact equality."""
    import torch

    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search.kernels import scan
    from tempo_tpu_torch.search.kernels.bench_coalesced import k1_bytes
    from tempo_tpu_torch.search.pipeline import compile_query

    sp = bsb.staged()
    engine = bsb.engine()
    dev = engine.device
    cq = compile_query(sp.pages.key_dict, sp.pages.val_dict,
                       SearchRequest(tags=dict(BENCH), limit=20),
                       cache_on=sp.pages, cache=engine.compile_cache,
                       staged_dict=sp.staged_dict, packed=engine.packed)
    if cq.val_hits is None:
        raise AssertionError(f"{name}: the single block compiled no hit "
                             "mask")
    tk, vr = engine._tables(cq)
    sd = sp.device
    res = sd.get("entry_dur_res")
    cols = (sd["kv_key"], sd["kv_val"], sd["entry_start"], sd["entry_end"],
            sd["entry_dur"], sd["entry_valid"])
    bounds = (cq.dur_lo, min(cq.dur_hi, 0xFFFFFFFF), cq.win_start,
              min(cq.win_end, 0xFFFFFFFF))
    s_args = (*cols, tk, vr, cq.n_terms, *bounds, cq.val_hits, sp.widths,
              res)
    s_scores, s_counts = scan.scan_single(*s_args)
    err = require_equal(name, (s_scores, s_counts),
                        scan.scan_single_plain(*s_args))
    P = sd["kv_key"].shape[0]
    as_multi = (*cols, torch.zeros(P, dtype=torch.int32, device=dev),
                tk[None], vr[None], cq.n_terms, *bounds)
    need = k1_bytes(as_multi, s_scores, cq.val_hits[None],
                    torch.zeros(1, dtype=torch.int32, device=dev),
                    single=True, widths=sp.widths, res=res)
    ms = cuda_ms(lambda: scan.scan_single(*s_args), 50)
    plain = cuda_ms(lambda: scan.scan_single_plain(*s_args), 3)
    shape = {"pages": P, "entries": s_scores.numel(),
             "widths": sp.widths, "C": int(sd["kv_key"].shape[2]),
             "n_terms": cq.n_terms,
             "val_hits": [list(cq.val_hits.shape), str(cq.val_hits.dtype)],
             "match_count": int(s_counts[0]),
             "inspected": int(s_counts[1]), "bytes_needed": need}
    return k1_ptxas(kernel_row(name, "tempo_tpu_torch/csrc/scan.cu",
                               replaces, launches, err, ms, plain, need,
                               None, shape,
                               lambda: scan.scan_single(*s_args)),
                    sd["kv_key"], sd["kv_val"], sp.widths, cq.n_terms > 0)


def topk_columns(n: int, dev) -> list:
    """(name, int32 column, k) adversarial K2 inputs on the card, made from
    a seed: all -1 (no match), all equal, the tag cell's narrow window
    (1 in 50 a match, block b's starts in [b * 600, b * 600 + 600) after
    BASE_S) at k = 128, 1,024 and 4,096 and past the cooperative route,
    every entry a match, uniform over int31, INT32_MAX scores among
    uniform ones, fewer matches than k, k = n, k > n, n = 1 and n one
    past the cooperative sort's smallest capacity (2,049)."""
    import torch

    g = torch.Generator().manual_seed(9)

    def ints(lo, hi, size):
        return torch.randint(lo, hi, size, generator=g)

    start = BASE_S + (torch.arange(n) // 65_536) * BLOCK_SPAN_S \
        + ints(0, BLOCK_SPAN_S, (n,))
    narrow = torch.where(ints(0, 50, (n,)) == 0, start,
                         torch.full_like(start, -1))
    uniform = ints(0, 2**31 - 1, (n,))
    top = torch.where(torch.rand(n, generator=g) < 0.001,
                      torch.full_like(uniform, 2**31 - 1), uniform)
    few = torch.full((n,), -1, dtype=torch.int64)
    few[ints(0, n, (50,))] = start[:50]

    def c(t):
        return t.to(torch.int32).to(dev)

    return [("all -1", c(torch.full((n,), -1)), 128),
            ("all -1", c(torch.full((n,), -1)), 1024),
            ("all equal", c(torch.full((n,), BASE_S)), 128),
            ("narrow window", c(narrow), 128),
            ("narrow window", c(narrow), 1024),
            ("narrow window", c(narrow), 4096),
            ("narrow window, past the cooperative route", c(narrow), 8192),
            ("every entry a match", c(start), 128),
            ("uniform over int31", c(uniform), 128),
            ("INT32_MAX scores", c(top), 128),
            ("fewer matches than k", c(few), 128),
            ("k = n", c(narrow[:3000]), 3000),
            ("k > n", c(narrow[:3000]), 4096),
            ("n = 1", c(start[:1]), 128),
            ("n = 2,049", c(narrow[:2049]), 128)]


def topk_check(what: str, fn, plain, k_eff: int) -> tuple:
    """A K2/K2r call against its plain version, exactly, and the CUDA
    kernels and memsets the profiler saw per call (at most 3 for k_eff
    <= 4,096, the cooperative route). Returns (max abs err, per call)."""
    from tempo_tpu_torch.search.kernels import topk

    err = require_equal(what, fn(), plain())
    per = kernels_per_call(fn)
    if k_eff <= topk.COOP_MAX_K and sum(per.values()) > 3:
        raise AssertionError(f"{what}: {per} a call, more than 3 launches")
    print(f"{what}: equal to its plain version; per call "
          + (json.dumps(per) if per else "not measured (the profiler kept "
             "no launch record)"), flush=True)
    return err, per


def kernel_phase(db, reqs: dict, launches: dict) -> list:
    """K1 (range mode) and K2 against their plain versions on one staged
    batch of the tag-search cell (the largest), at the main path's
    shapes and on the adversarial columns of ``topk_columns``; exact
    equality, indices included."""
    import torch

    from tempo_tpu_torch.search.engine import resolve_top_k
    from tempo_tpu_torch.search.kernels import topk

    tags, kw = reqs["bench_and"]
    k1, scores = k1_row(db, "multi_scan",
                        "tempo_tpu/search/multiblock.py:855", tags, kw,
                        launches, False)
    k1["shape"]["edges"], e = k1_edges(scores.device, 20261018)
    k1["max_abs_err"] = max(k1["max_abs_err"], e)
    k2_err = 0
    k = resolve_top_k(128, kw["limit"])
    # the main path's k, a limit-1000 request's k, a k past the shared-
    # memory sort (global bitonic stages), and k > N on a short column
    short = scores[:1000].contiguous()
    cases = [("the tag batch", scores, k), ("the tag batch", scores, 1024),
             ("the tag batch", scores, 8192),
             ("its first 1,000 scores", short, 4096)]
    checked = []
    for name, col, kk in cases + topk_columns(scores.numel(),
                                              scores.device):
        what = f"K2 {name} (n={col.numel()}, k={kk})"
        err, per = topk_check(what, lambda: topk.topk(col, kk),
                              lambda: topk.topk_plain(col, kk),
                              min(kk, col.numel()))
        k2_err = max(k2_err, err)
        checked.append({"column": name, "n": col.numel(), "k": kk,
                        "kernels_per_call": per})
        s, _i = topk.topk(col, kk)
        ls, _li = torch.topk(col, min(kk, col.numel()))
        if not torch.equal(torch.sort(ls).values, torch.sort(s).values):
            raise AssertionError(f"{what}: scores differ from torch.topk's")
    n = scores.numel()
    k2_bytes = n * 4 + k * 8                       # scores read, top-k written
    k2_ms = cuda_ms(lambda: topk.topk(scores, k), 50)
    k2_plain = cuda_ms(lambda: topk.topk_plain(scores, k), 10)
    k2_lib = cuda_ms(lambda: torch.topk(scores, k), 50)
    k2_host = host_us(lambda: topk.topk(scores, k))
    print(f"K2 (n={n}, k={k}): {k2_ms:.4f} ms a call back to back, "
          f"torch.topk {k2_lib:.4f} ({k2_ms / k2_lib:.2f}x), wrapper host "
          f"{k2_host:.1f} us a call", flush=True)
    return [k1, kernel_row("topk", "tempo_tpu_torch/csrc/topk.cu",
                           "tempo_tpu/search/engine.py:295", launches,
                           k2_err, k2_ms, k2_plain, k2_bytes, k2_lib,
                           {"n": n, "k": k, "host_us": k2_host,
                            "kernels_per_call": checked[0][
                                "kernels_per_call"],
                            "checked": checked},
                           lambda: topk.topk(scores, k))]


def hc_kernel_phase(db, bsb, launches: dict) -> list:
    """K3, K1 in hit-mask mode and K1s against their plain versions on the
    high-cardinality cell's staged data, at the main path's shapes: K3 on
    one staged dictionary with the scattered needle "77", in bool rows
    and in words (the packed route's form), and the whole probe call from
    the needle's bytes (``probe_value_hits``: card ms, the host's issue
    time, and the device operations of a call by the profiler: one
    ``probe_kernel`` launch, no fill, no copy); K3 at its design's edges
    (``k3_edges``); K1 on the largest staged group with the exhaustive
    request's hit masks, K1s on the single-block path's block with the
    bench request."""
    from tempo_tpu_torch.search import dict_probe
    from tempo_tpu_torch.search.kernels import pack, probe
    from tempo_tpu_torch.search.kernels.bench_probe import k3_bytes
    from tempo_tpu_torch.search.kernels.bench_structural import event_ms

    batch = largest_batch(db)
    dd = next(iter(batch.staged_dicts.values()))
    needles, lens = dict_probe.needle_tensors([b"77"])
    p_args = (dd.buf, dd.off, needles, lens)
    want = probe.dict_probe_plain(*p_args)
    k3_err = require_equal("K3", probe.dict_probe(*p_args), want)
    want_w = (pack.pack_mask_words_plain(want[0]), want[1])
    k3_err = max(k3_err, require_equal(
        "K3 words", probe.dict_probe(*p_args, True), want_w))
    T, V = want[0].shape
    k3_ms = cuda_ms(lambda: probe.dict_probe(*p_args), 50)
    k3_plain = cuda_ms(lambda: probe.dict_probe_plain(*p_args), 3)

    def words():
        return probe.dict_probe(*p_args, True)

    def call():
        return dict_probe.probe_value_hits(dd, [b"77"])

    k3_err = max(k3_err, require_equal("K3 probe call", call(), want))
    # the profiler may keep fewer records than calls (C1), never more:
    # each kept record must be the kernel, at most one a call
    per_call = kernels_per_call(call)
    if per_call and (sum(per_call.values()) > 1
                     or not all("probe_kernel" in k for k in per_call)):
        raise AssertionError(f"a probe call ran {per_call} on the card, not "
                             "one probe_kernel launch")
    edges, e = k3_edges(db.device, 20261018)
    k3_shape = {
        "values": V, "dict_bytes": int(dd.buf.numel()), "T": T,
        "needle": "77", "hits": int(want[0].sum()), "edges": edges,
        "words": {"ms": cuda_ms(words, 50), "device_ms": event_ms(words),
                  "plain_ms": cuda_ms(lambda: pack.pack_mask_words_plain(
                      probe.dict_probe_plain(*p_args)[0]), 3),
                  "bound_ms": k3_bytes(dd.buf, dd.off, T, True)
                  / HBM_BYTES_PER_S * 1e3, "shape": [T, -(-V // 32)]},
        "probe_call": {"ms": cuda_ms(call, 50), "host_us": host_us(call),
                       "device_ms": event_ms(call),
                       "per_call": per_call or "not measured (no profile)"}}
    print(f"K3 probe call (probe_value_hits, needle bytes to hits): "
          f"{k3_shape['probe_call']['ms']:.4f} ms a call back to back, "
          f"{k3_shape['probe_call']['host_us']:.1f} us of host issue time, "
          f"{k3_shape['probe_call']['device_ms']:.4f} ms device; device "
          f"operations a call (profiler): {k3_shape['probe_call']['per_call']}"
          f"; words {k3_shape['words']['ms']:.4f} ms back to back, "
          f"{k3_shape['words']['device_ms']:.4f} ms device", flush=True)
    tags, kw = hc_requests()["hc_exhaustive_77"]
    k1h, _scores = k1_row(db, "multi_scan_hits",
                          "tempo_tpu/search/multiblock.py:855", tags, kw,
                          launches, True)
    return [
        k1h,
        k1s_row(bsb, "scan_single", "tempo_tpu/search/engine.py:331",
                launches),
        kernel_row("dict_probe", "tempo_tpu_torch/csrc/probe.cu",
                   "tempo_tpu/search/dict_probe.py:283", launches,
                   max(k3_err, e), k3_ms, k3_plain,
                   k3_bytes(dd.buf, dd.off, T, False), None, k3_shape,
                   lambda: probe.dict_probe(*p_args)),
    ]


def k3_edges(dev, seed: int) -> tuple:
    """K3 held exactly against its plain version on `dev`, through its
    wrapper, in both output forms (bool rows; words against
    ``pack_mask_words_plain``), at the edges of its design: the seeded
    cases the CPU tests hold its rule to (``bench_probe.K3_CASES``): V =
    1, 31, 32, 33 and 4,097; session ids with a prefix; empty values; a
    value longer than a chunk with matches across its seams; a match
    that would cross a value boundary and one in the last bytes of buf;
    needles of 1, 2, 16 and 64 bytes, one equal to a value and one
    longer than every value; the empty needle and a None term; T = 1,
    2, 33, 40 and 60 (two launches); non-ASCII UTF-8; buf off a 16-byte
    boundary. On the card every launcher call is then replayed from 8
    host threads at once (``LauncherReplay``), and no ``probe.cu`` build
    may spill in ptxas's report of the library loaded (this process's
    build or the cached one's saved log). On the CPU (a rehearsal) the
    wrapper takes the plain version. Returns (report, max abs err)."""
    from tempo_tpu_torch.search.kernels import build, pack, probe
    from tempo_tpu_torch.search.kernels.bench_coalesced import ptxas_usage
    from tempo_tpu_torch.search.kernels.bench_probe import K3_CASES, k3_case

    report, err = {}, 0
    replay = LauncherReplay().start()
    try:
        for name in K3_CASES:
            c = k3_case(seed, name, dev)
            args = (c["buf"], c["off"], c["arr"], c["lens"])
            hits, any_hits = probe.dict_probe_plain(*args)
            err = max(err, require_equal(f"K3 edge {name}",
                                         probe.dict_probe(*args),
                                         (hits, any_hits)))
            err = max(err, require_equal(
                f"K3 edge {name}, words", probe.dict_probe(*args, True),
                (pack.pack_mask_words_plain(hits), any_hits)))
            report[name] = {"V": len(c["vals"]), "N": int(c["buf"].numel()),
                            "T": len(c["needles"]),
                            "buf_mod_16": c["buf"].data_ptr() % 16,
                            "hits": int(hits.sum())}
    finally:
        replay.stop()
    replayed = replay.replay() if dev.type == "cuda" else {}
    usage = ptxas_usage(build.BUILD_LOG.get("probe", ""))
    if dev.type == "cuda" and not usage:
        raise AssertionError("K3 edges: no ptxas report of the loaded "
                             "probe.cu library")
    spills = {k: v for k, v in usage.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    if spills:
        raise AssertionError(f"probe.cu builds spill: {spills}")
    print(f"K3 edges: {len(report)} cases, bool and words, each equal to "
          f"its plain version ({replayed.get('K3', 0)} launcher calls "
          f"replayed from 8 threads); {len(usage)} probe.cu builds in "
          "ptxas's report, none spills, registers "
          f"{sorted({v.get('registers') for v in usage.values()})}",
          flush=True)
    return report, err


def k5_row(db, launches: dict) -> dict:
    """K5 against its plain version on the card: the probe's bool output
    for "77" over one staged dictionary of the packed high-cardinality
    cell ([1, 1,050,711] at full size), and a seeded [8, 2,135] mask (V
    not a multiple of 32); exact equality. No main path launches K5 any
    longer (K3 writes the packed route's words itself), so its launches
    are 0 (``OFF_PATH``)."""
    import torch

    from tempo_tpu_torch.search import dict_probe
    from tempo_tpu_torch.search.kernels import pack, probe

    batch = largest_batch(db)
    dd = next(iter(batch.staged_dicts.values()))
    needles, lens = dict_probe.needle_tensors([b"77"])
    hits, _any = probe.dict_probe(dd.buf, dd.off, needles, lens)
    err = require_equal("K5", (pack.pack_mask_words(hits),),
                        (pack.pack_mask_words_plain(hits),))
    g = torch.Generator(device=db.device).manual_seed(2135)
    small = torch.rand((8, 2_135), generator=g, device=db.device) < 0.3
    err = max(err, require_equal(
        "K5 [8, 2135]", (pack.pack_mask_words(small),),
        (pack.pack_mask_words_plain(small),)))
    R, V = hits.shape
    W = -(-V // 32)
    need = R * V + R * W * 4                     # bools read, words written
    ms = cuda_ms(lambda: pack.pack_mask_words(hits), 50)
    plain = cuda_ms(lambda: pack.pack_mask_words_plain(hits), 5)
    small_ms = cuda_ms(lambda: pack.pack_mask_words(small), 50)
    shape = {"rows": R, "V": V, "words": W, "also_checked": [8, 2_135],
             "small_ms": small_ms,
             "small_bound_ms": (8 * 2_135 + 8 * 67 * 4) / HBM_BYTES_PER_S
             * 1e3}
    return kernel_row("pack_mask_words", "tempo_tpu_torch/csrc/pack.cu",
                      "tempo_tpu/search/packing.py:289", launches, err, ms,
                      plain, need, None, shape,
                      lambda: pack.pack_mask_words(hits))


def coalesced_phase(db, reqs: list, label: str, launches: dict,
                    with_rows: bool) -> list:
    """K4 against its plain version on the largest staged batch of `db`,
    with `reqs` ((tags, fields) pairs) stacked along the query axis; the
    fused dispatch (K4 + K2r) against each member's solo dispatch (K1 +
    K2), exactly, indices included; with `with_rows`, K2r against its
    plain version at the group's k and at k = 1024 (a limit-1000
    request's), and torch.topk's scores."""
    import numpy as np
    import torch

    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search.engine import (fetch_coalesced_out,
                                               fetch_scan_out, resolve_top_k)
    from tempo_tpu_torch.search.kernels import scan, topk
    from tempo_tpu_torch.search.kernels.bench_coalesced import k4_bytes
    from tempo_tpu_torch.search.multiblock import compile_multi, \
        stack_queries

    eng = db.batcher.engine
    batch = largest_batch(db)
    d = batch.device
    mqs = []
    for tags, kw in reqs:
        mq = compile_multi(list(batch.blocks),
                           SearchRequest(tags=dict(tags), **kw),
                           memo=batch.memo, cache=eng.compile_cache,
                           staged_dicts=batch.staged_dicts,
                           packed=eng.packed)
        if mq is None:
            raise AssertionError(f"{label}: a member prunes every block")
        mq.limit = kw.get("limit") or 20
        mqs.append(mq)
    cq = stack_queries(mqs)
    page = (d["kv_key"], d["kv_val"], d["entry_start"], d["entry_end"],
            d["entry_dur"], d["entry_valid"], d["page_block"])
    tables = eng.coalesced_tables(cq)
    res = d.get("entry_dur_res")
    layout = (batch.widths, res)
    scores, counts, inspected = scan.coalesced_scan(*page, *tables, *layout)
    err = require_equal(f"K4 ({label})", (scores, counts, inspected),
                        scan.coalesced_scan_plain(*page, *tables, *layout))
    k = max(resolve_top_k(eng.top_k, mq.limit) for mq in mqs)
    fc, fins, fs, fi = fetch_coalesced_out(
        eng.coalesced_scan_async(batch, cq, k))
    for qi, mq in enumerate(mqs):
        c, ins, s1, i1 = fetch_scan_out(eng.scan_async(batch, mq))
        kq = len(s1)
        if (int(fc[qi]), fins) != (c, ins) \
                or not np.array_equal(fs[qi][:kq], s1) \
                or not np.array_equal(fi[qi][:kq], i1):
            raise AssertionError(f"{label}: fused member {qi} differs from "
                                 "its solo dispatch")
    need = k4_bytes(page, tables, scores, *layout)
    ms = cuda_ms(lambda: scan.coalesced_scan(*page, *tables, *layout), 50)
    plain = cuda_ms(
        lambda: scan.coalesced_scan_plain(*page, *tables, *layout), 3)
    Q, n = scores.shape
    hits = cq.val_hits is not None
    shape = {"pages": batch.n_pages, "entries": n, "Q": Q,
             "members": cq.n_queries, "T": cq.n_terms,
             "R": int(cq.val_ranges.shape[3]), "B": int(cq.term_keys.shape[1]),
             "kv_dtypes": [str(d["kv_key"].dtype), str(d["kv_val"].dtype)],
             "widths": batch.widths, "C": int(d["kv_key"].shape[2]),
             "probed_members": (sum(h is not None for h in cq.val_hits)
                                if hits else 0),
             "counts": counts.tolist(), "inspected": int(inspected),
             "bytes_needed": need, "fused_equals_solo": True}
    print(f"K4 {label}: Q = {Q} ({cq.n_queries} members), equal to its "
          f"plain version and the fused dispatch to the solo ones; "
          f"{ms:.4f} ms, bound {need / HBM_BYTES_PER_S * 1e3:.4f} ms",
          flush=True)
    name = "coalesced_scan" + ("_packed" if batch.widths else "") \
        + ("_hits" if hits else "")
    replaces = ("tempo_tpu/search/multiblock.py:1028" if not batch.widths
                else "tempo_tpu/search/packing.py:249" if hits
                else "tempo_tpu/search/packing.py:196")
    if with_rows:
        shape["edges"], e = k4_edges(scores.device, 20261018)
        err = max(err, e)
    rows = [k4_ptxas(kernel_row(
        name, "tempo_tpu_torch/csrc/scan.cu", replaces, launches, err, ms,
        plain, need, None, shape,
        lambda: scan.coalesced_scan(*page, *tables, *layout)), page,
        batch.widths, cq.val_hits)]
    if not with_rows:
        return rows
    r_err = 0
    # K4's rows, and rows that stop on different passes: the first of
    # K4's rows beside the adversarial columns at full width
    by_name = {name: col for name, col, _k in topk_columns(n, scores.device)
               if col.numel() == n}
    mixed = torch.stack([scores[0]] + [by_name[c] for c in (
        "all -1", "all equal", "narrow window", "every entry a match",
        "uniform over int31", "INT32_MAX scores", "fewer matches than k")])
    checked = []
    for what, mat, kk in (("K4's rows", scores, k),
                          ("K4's rows", scores, 1024),
                          ("mixed rows", mixed, k),
                          ("mixed rows", mixed, 1024),
                          ("mixed rows", mixed, 4096)):
        label = f"K2r {what} ({list(mat.shape)}, k={kk})"
        err, per = topk_check(label, lambda: topk.topk_rows(mat, kk),
                              lambda: topk.topk_rows_plain(mat, kk),
                              min(kk, n))
        r_err = max(r_err, err)
        checked.append({"rows": what, "shape": list(mat.shape), "k": kk,
                        "kernels_per_call": per})
        s2, _i2 = topk.topk_rows(mat, kk)
        ls = torch.topk(mat, kk, dim=1).values
        if not torch.equal(torch.sort(ls, dim=1).values,
                           torch.sort(s2, dim=1).values):
            raise AssertionError(f"{label}: scores differ from torch.topk's")
    r_ms = cuda_ms(lambda: topk.topk_rows(scores, k), 50)
    r_plain = cuda_ms(lambda: topk.topk_rows_plain(scores, k), 5)
    r_lib = cuda_ms(lambda: torch.topk(scores, k, dim=1), 50)
    print(f"K2r ({Q} x {n}, k={k}): {r_ms:.4f} ms a call back to back, "
          f"torch.topk(dim=1) {r_lib:.4f} ({r_ms / r_lib:.2f}x)", flush=True)
    rows.append(kernel_row("topk_rows", "tempo_tpu_torch/csrc/topk.cu",
                           "tempo_tpu/search/multiblock.py:1084", launches,
                           r_err, r_ms, r_plain, Q * n * 4 + Q * k * 8,
                           r_lib, {"rows": Q, "n": n, "k": k,
                                   "kernels_per_call": checked[0][
                                       "kernels_per_call"],
                                   "checked": checked},
                           lambda: topk.topk_rows(scores, k)))
    return rows


def pct(xs: list, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def concurrent_rounds(db, tenant: str, reqs: list, rounds: int,
                      serial: list) -> dict:
    """CLIENTS barrier-started threads, one request each per round: one
    warm-up round, then `rounds` timed ones. Every response must equal
    `serial` (the same requests answered one at a time). Launch counters
    set to 0 just before the first round and read after the last; the
    coalescer's counters over the timed rounds. Then BUSY_ROUNDS more
    rounds give a round's device ms (the median of their sums over
    ``KernelTimer``'s launches) and its idle share of the round p50."""
    from tempo_tpu_torch.model.types import SearchRequest

    requests = [SearchRequest(tags=dict(t), **kw) for t, kw in reqs]
    barrier = threading.Barrier(len(requests))

    def one(i):
        barrier.wait(timeout=120)
        t0 = time.perf_counter()
        resp = canon(db.search(tenant, requests[i]).response())
        return time.perf_counter() - t0, resp

    co = db.batcher.coalescer
    walls, lat = [], []
    st0 = None
    reset_counts()
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=len(requests)) as ex:
        for r in range(rounds + 1):
            if r == 1 and co is not None:
                st0 = co.stats()
            t0 = time.perf_counter()
            futs = [ex.submit(one, i) for i in range(len(requests))]
            outs = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
            for i, (_dt, resp) in enumerate(outs):
                if resp != serial[i]:
                    raise AssertionError(f"concurrent request {i} differs "
                                         "from its serial response")
            if r:
                walls.append(wall * 1e3)
                lat += [dt * 1e3 for dt, _ in outs]
        st1 = None if co is None else co.stats()
        counts = read_counts()
        # the device time of a round: BUSY_ROUNDS more rounds with each
        # kernel between CUDA events (``KernelTimer``)
        busy = []
        with KernelTimer() as timer:
            for _r in range(BUSY_ROUNDS):
                futs = [ex.submit(one, i) for i in range(len(requests))]
                for i, f in enumerate(futs):
                    if f.result(timeout=600)[1] != serial[i]:
                        raise AssertionError(f"concurrent request {i} "
                                             "differs from its serial "
                                             "response (timed dispatches)")
                busy.append(timer.take())
    round_p50 = pct(walls, 0.5)
    dev_ms = sorted(b["device_ms"] for b in busy)[len(busy) // 2]
    row = {"round_ms": sorted(walls), "lat_ms": sorted(lat),
           "round_p50_ms": round_p50, "round_p95_ms": pct(walls, 0.95),
           "lat_p50_ms": pct(lat, 0.5), "lat_p95_ms": pct(lat, 0.95),
           "launches": counts, "coalesce": None,
           "device_ms": dev_ms,
           "idle_share_of_round_p50": max(0.0, 1 - dev_ms / round_p50),
           "device_rounds": busy, "device_source": REQUEST_DEVICE_SOURCE}
    if co is not None:
        disp = st1["dispatches"] - st0["dispatches"]
        queries = st1["queries"] - st0["queries"]
        row["coalesce"] = {
            "dispatches": disp, "queries": queries,
            "fused_dispatches": st1["fused_dispatches"]
            - st0["fused_dispatches"],
            "queries_per_dispatch": queries / max(1, disp),
            "pending": st1["pending"], "window_ms": st1["window_ms"]}
    print(f"  device per round: {dev_ms:.3f} ms (CUDA events, "
          f"{[b['launches'] for b in busy]} launches, "
          f"{sum(b['uncovered'] for b in busy)} uncovered) of "
          f"{round_p50:.3f} ms round p50, idle share "
          f"{row['idle_share_of_round_p50']:.2f}", flush=True)
    return row


def concurrent_phase(label: str, co_db, serial_db, tenant: str,
                     sets: dict, rounds: int, launches: dict) -> dict:
    """Each set of CLIENTS requests answered serially on `serial_db`, then
    concurrently through `co_db` (the default coalescer) and through
    `serial_db` (coalescing off). Adds the launches to `launches`."""
    from tempo_tpu_torch.model.types import SearchRequest

    out = {}
    for set_name, reqs in sets.items():
        serial = [canon(serial_db.search(
            tenant, SearchRequest(tags=dict(t), **kw)).response())
                  for t, kw in reqs]
        for db_name, db in (("coalescing", co_db),
                            ("no_coalescing", serial_db)):
            row = concurrent_rounds(db, tenant, reqs, rounds, serial)
            add_counts(launches, row["launches"])
            fused_k4 = (row["launches"]["coalesced_scan"]
                        + row["launches"]["coalesced_scan_hits"])
            if db is serial_db and (fused_k4 or row["launches"]["topk_rows"]):
                raise AssertionError(f"{label} {set_name}: coalescing off "
                                     "but a fused dispatch ran")
            co = row["coalesce"]
            print(f"concurrent {label} {set_name} ({db_name}): round p50 "
                  f"{row['round_p50_ms']:.3f} ms, p95 "
                  f"{row['round_p95_ms']:.3f} ms; request p50 "
                  f"{row['lat_p50_ms']:.3f} ms, p95 {row['lat_p95_ms']:.3f} "
                  f"ms; launches {json.dumps(row['launches'])}; coalescer "
                  f"{json.dumps(co)}", flush=True)
            out[f"{set_name}/{db_name}"] = row
    return out


def solo_again(db, tenant: str, name: str, tags: dict, kw: dict,
               before: dict, reps: int, launches: dict) -> dict:
    """The single-request bench again after the concurrent phase: no peer
    counter or parked query may be left, and its p50 must stay within the
    earlier run's spread plus half a window (a leaked peer counter would
    add a whole window to every solo dispatch)."""
    from tempo_tpu_torch.model.types import SearchRequest

    b = db.batcher
    dbg = b.debug_stats()
    if dbg["peers"] != {"interest": {}, "unplanned": 0} \
            or dbg["coalesce"]["pending"]:
        raise AssertionError(f"{name}: state left by the concurrent "
                             f"phase: {dbg}")
    req = SearchRequest(tags=dict(tags), **kw)
    r = drive(lambda: db.search(tenant, req), reps, True)
    add_counts(launches, r["launches"])
    p50 = r["lat"][len(r["lat"]) // 2] * 1e3
    lo, hi = before["lat"][0] * 1e3, before["lat"][-1] * 1e3
    allowed = hi + b.coalescer.window_s * 1e3 / 2
    row = {"p50_ms": p50, "before_p50_ms":
           before["lat"][len(before["lat"]) // 2] * 1e3,
           "before_spread_ms": [lo, hi], "within_spread": p50 <= hi,
           "launches": r["launches"]}
    print(f"{name} alone after the concurrent phase: p50 {p50:.3f} ms "
          f"(before: p50 {row['before_p50_ms']:.3f} ms, spread "
          f"{lo:.3f}-{hi:.3f} ms); coalescer pending 0, no peer left",
          flush=True)
    if p50 > allowed:
        raise AssertionError(f"{name}: p50 {p50:.3f} ms after the "
                             f"concurrent phase, over {allowed:.3f} ms")
    return row


def latency_row(r: dict, resp) -> dict:
    lat = r["lat"]
    p50 = lat[len(lat) // 2]
    p95 = lat[min(len(lat) - 1, int(len(lat) * 0.95))]
    m = resp.metrics
    return {"p50_ms": p50 * 1e3, "p95_ms": p95 * 1e3,
            "first_ms": r["first_s"] * 1e3,
            "traces_per_s": m.inspected_traces / p50 if p50 else None,
            "inspected_traces": m.inspected_traces,
            "inspected_blocks": m.inspected_blocks,
            "skipped_blocks": m.skipped_blocks,
            "results": len(resp.traces),
            "dispatches": r.get("dispatches"),
            "launches_cold": r["launches_cold"],
            "launches": r["launches"],
            "lat_ms": [x * 1e3 for x in lat],
            "gc_pauses_ms": r["gc_ms"]}


def print_row(name: str, row: dict) -> None:
    print(f"search {name}: first {row['first_ms']:.2f} ms, p50 "
          f"{row['p50_ms']:.2f} ms, p95 {row['p95_ms']:.2f} ms, "
          f"{row['inspected_traces']} traces inspected "
          f"({row['traces_per_s']:.4g} traces/s), "
          f"{row['inspected_blocks']} blocks, {row['skipped_blocks']} "
          f"skipped, {row['results']} results, {row['dispatches']} "
          f"dispatches, launches cold {json.dumps(row['launches_cold'])}, "
          f"in all {json.dumps(row['launches'])}; collector pauses in the "
          f"timed runs {len(row['gc_pauses_ms'])}, longest "
          f"{max(row['gc_pauses_ms'], default=0):.2f} ms", flush=True)


def tag_search_cell(args, work: str, report: dict, dbs: list,
                    launches: dict) -> list:
    """The tag-search cell (step 2 of the module docstring). Returns its
    kernel rows."""
    import torch

    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.model.types import SearchRequest

    n_total = args.blocks * args.traces_per_block
    reqs = requests(args.blocks)
    root = os.path.join(work, "blocks")
    t0 = time.perf_counter()
    nbytes = write_corpus(root, "smoke", args.blocks, args.traces_per_block,
                          ENTRIES_PER_PAGE, args.seed)
    report["corpus"] = {"blocks": args.blocks, "traces": n_total,
                        "compressed_bytes": nbytes,
                        "write_s": time.perf_counter() - t0}
    print(f"corpus: {args.blocks} blocks, {n_total} traces, "
          f"{nbytes / 1e6:.1f} MB zlib, "
          f"{report['corpus']['write_s']:.1f} s", flush=True)

    cfg = TempoDBConfig(search_max_batch_pages=4096)
    gpu = TempoDB(LocalBackend(root), cfg, device="cuda")
    dbs.append(gpu)
    gpu.poll()
    torch.cuda.reset_peak_memory_stats()
    res = run_queries(gpu, "smoke", reqs, args.reps)       # the main path
    path = {}
    for r in res.values():
        add_counts(path, r["launches"])
    report["launches"] = path
    report["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    report["staged_device_bytes"] = gpu.batcher._cache_total
    if path["multi_scan"] == 0 or path["topk"] == 0:
        raise AssertionError(f"main path launched no kernel: {path}")
    if path["dict_probe"] or path["multi_scan_hits"]:
        raise AssertionError(f"the tag-search cell probed: {path}")
    add_counts(launches, path)
    lat_report = {}
    for name, r in res.items():
        tags, kw = reqs[name]
        check_response(name, r["resp"], tags, kw, n_total)
        lat_report[name] = latency_row(r, r["resp"])
        print_row(name, lat_report[name])
    report["search"] = lat_report
    print("launches during the searches: " + json.dumps(path), flush=True)

    busy = device_busy(gpu, "smoke", reqs, ("exhaustive_bench", "bench_and",
                                            "limit_1000"), args.reps)
    report["device_busy"] = busy
    print_busy(busy, lat_report)

    t0 = time.perf_counter()
    cpu = TempoDB(LocalBackend(root), cfg, device="cpu")
    dbs.append(cpu)
    cpu.poll()
    cres = run_queries(cpu, "smoke", reqs, 0)
    for name in reqs:
        if cres[name]["resp"] != res[name]["resp"]:
            raise AssertionError(f"{name}: card and CPU responses differ")
    report["cpu_check_s"] = time.perf_counter() - t0
    print(f"cpu check: {len(reqs)} responses identical "
          f"({report['cpu_check_s']:.1f} s)", flush=True)
    # both stay staged for the attribution cell (closed at the run's end)
    STAGED["tag"] = {"gpu": gpu, "cpu": cpu, "reqs": reqs,
                     "tenant": "smoke", "root": root, "busy": busy}
    rows = kernel_phase(gpu, reqs, launches)
    rows += coalesced_phase(gpu, [(t, {"limit": 20})
                                  for t in CONCURRENT_TAGS],
                            "range mode, tag search", launches, True)

    serial = TempoDB(LocalBackend(root), TempoDBConfig(
        search_max_batch_pages=4096, search_coalesce_max_queries=1),
        device="cuda")
    dbs.append(serial)
    serial.poll()
    tags, kw = reqs["exhaustive_bench"]
    serial.search("smoke", SearchRequest(tags=dict(tags), **kw))  # stage
    torch.cuda.reset_peak_memory_stats()
    report["concurrent"] = concurrent_phase(
        "tag search", gpu, serial, "smoke",
        {"bench": [(t, {"limit": 20}) for t in CONCURRENT_TAGS],
         "exhaustive": [(dict(t, **EXHAUSTIVE), {"limit": 20})
                        for t in CONCURRENT_TAGS]}, args.rounds, launches)
    report["concurrent_peak_device_bytes"] = torch.cuda.max_memory_allocated()
    require_fusion(report["concurrent"]["exhaustive/coalescing"],
                   "coalesced_scan")
    tags, kw = reqs["bench_and"]
    report["solo_again"] = solo_again(gpu, "smoke", "bench_and", tags, kw,
                                      res["bench_and"], args.reps, launches)
    rows += packed_tag_phase(args, root, reqs, res, gpu, report, dbs,
                             launches)
    serial.close()
    dbs.remove(serial)
    return rows


def staged_bytes(label: str, plain_db, packed_db) -> dict:
    """The staged caches' bytes of an unpacked and a packed database over
    the same blocks, physical and logical (debug_stats); the packed one
    holds fewer physical bytes, and its logical bytes are the unpacked
    one's."""
    us = plain_db.batcher.debug_stats()["cache"]
    ps = packed_db.batcher.debug_stats()["cache"]
    widths = sorted({str(c.batch.widths)
                     for c in packed_db.batcher._cache.values()})
    print(f"staged bytes, {label}: unpacked {us['bytes']} physical, "
          f"{us['logical_bytes']} logical; packed {ps['bytes']} physical, "
          f"{ps['logical_bytes']} logical (of which dictionaries "
          f"{ps['dict_bytes']}); widths {widths}", flush=True)
    if not (ps["bytes"] < us["bytes"] == us["logical_bytes"]
            == ps["logical_bytes"]):
        raise AssertionError(f"{label}: staged bytes {us} unpacked, {ps} "
                             "packed")
    return {"unpacked": us, "packed": ps, "widths": widths}


def same_responses(label: str, got: dict, want: dict) -> None:
    for name, r in got.items():
        if r["resp"] != want[name]["resp"]:
            raise AssertionError(f"{label} {name}: the packed database's "
                                 "response differs from the unpacked one's")
    print(f"{label}: {len(got)} packed responses equal the unpacked ones",
          flush=True)


def require_launched(label: str, path: dict, want: tuple,
                     never: tuple) -> None:
    for k in want:
        if not path[k]:
            raise AssertionError(f"{label} launched no {k}: {path}")
    for k in never:
        if path[k]:
            raise AssertionError(f"{label} launched {k}: {path}")


def packed_tag_phase(args, root: str, reqs: dict, res: dict, plain_db,
                     report: dict, dbs: list, launches: dict) -> list:
    """The packed tag cell: a second TempoDB with
    search_packed_residency=True over the same blocks answers the six
    requests (its main path: counters set to 0 just before each, read
    just after) and the 8-client exhaustive set, every response equal to
    the unpacked database's; its staged bytes against the unpacked
    database's; then K1 (packed range mode) and K4 (packed range mode,
    Q = 8) against their plain versions."""
    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.model.types import SearchRequest

    packed = TempoDB(LocalBackend(root), TempoDBConfig(
        search_max_batch_pages=4096, search_packed_residency=True),
        device="cuda")
    dbs.append(packed)
    packed.poll()
    pres = run_queries(packed, "smoke", reqs, args.reps)   # the main path
    path = {}
    for r in pres.values():
        add_counts(path, r["launches"])
    require_launched("packed tag search", path,
                     ("multi_scan_packed", "topk"),
                     ("multi_scan", "multi_scan_hits", "dict_probe"))
    add_counts(launches, path)
    same_responses("packed tag search", pres, res)
    lat = {}
    for name, r in pres.items():
        lat[name] = latency_row(r, r["resp"])
        print_row(f"packed {name}", lat[name])
    report["packed_search"] = lat
    report["packed_launches"] = path
    pc, kc = search_calls(plain_db, "smoke", reqs), \
        search_calls(packed, "smoke", reqs)
    report["packed_paired"] = paired_latency(
        "tag search", {n: (pc[n], kc[n]) for n in reqs}, args.reps)
    report["packed_staged"] = staged_bytes("tag search", plain_db, packed)
    busy = device_busy(packed, "smoke", reqs, ("exhaustive_bench",
                                               "bench_and"), args.reps)
    report["packed_device_busy"] = busy
    print_busy(busy, lat)

    exh = [(dict(t, **EXHAUSTIVE), {"limit": 20}) for t in CONCURRENT_TAGS]
    serial = [canon(plain_db.search(
        "smoke", SearchRequest(tags=dict(t), **kw)).response())
              for t, kw in exh]
    row = concurrent_rounds(packed, "smoke", exh, args.rounds, serial)
    add_counts(launches, row["launches"])
    require_fusion(row, "coalesced_scan_packed")
    print(f"concurrent packed tag search exhaustive (coalescing): round p50 "
          f"{row['round_p50_ms']:.3f} ms, p95 {row['round_p95_ms']:.3f} ms; "
          f"request p50 {row['lat_p50_ms']:.3f} ms, p95 "
          f"{row['lat_p95_ms']:.3f} ms; launches "
          f"{json.dumps(row['launches'])}; coalescer "
          f"{json.dumps(row['coalesce'])}", flush=True)
    report["packed_concurrent"] = row

    tags, kw = reqs["bench_and"]
    k1, _scores = k1_row(packed, "multi_scan_packed",
                         "tempo_tpu/search/packing.py:196", tags, kw,
                         launches, False)
    rows = [k1]
    rows += coalesced_phase(packed, [(t, {"limit": 20})
                                     for t in CONCURRENT_TAGS],
                            "packed range mode, tag search", launches, False)
    packed.close()
    dbs.remove(packed)
    return rows


def long_requests() -> dict:
    """The long-duration corpus's requests; the exhaustive one runs first
    and stages every group."""
    return {
        "long_exhaustive_3599000": ({"x-dbg-exhaustive": ""},
                                    {"min_duration_ms": 3_599_000,
                                     "limit": 20}),
        "long_59000_59999": ({}, {"min_duration_ms": 59_000,
                                  "max_duration_ms": 59_999, "limit": 20}),
        "long_65536_131071": ({}, {"min_duration_ms": 65_536,
                                   "max_duration_ms": 131_071,
                                   "limit": 20}),
        "long_600000": ({}, {"min_duration_ms": 600_000, "limit": 20}),
    }


def long_duration_cell(args, work: str, report: dict, dbs: list,
                       launches: dict) -> list:
    """The long-duration corpus: blocks like the tag cell's, except that 1
    trace in 64 lasts 60,000-3,600,000 ms, so the packed layout stores
    durations as u16 buckets (q6) plus a u8 residual. An unpacked and a
    packed TempoDB answer the four requests (the packed one's run is its
    main path), every packed response equal to the unpacked one; then K1
    in packed range mode with bucketed durations against its plain
    version, with the bucket-aligned request."""
    import torch

    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig

    n_per = args.traces_per_block
    n_total = args.long_blocks * n_per
    root = os.path.join(work, "long_blocks")
    t0 = time.perf_counter()
    nbytes = write_corpus(root, "long", args.long_blocks, n_per,
                          ENTRIES_PER_PAGE, args.seed + 1, long_every=64)
    report["long_corpus"] = {"blocks": args.long_blocks, "traces": n_total,
                             "compressed_bytes": nbytes,
                             "write_s": time.perf_counter() - t0}
    print(f"long-duration corpus: {args.long_blocks} blocks, {n_total} "
          f"traces, {nbytes / 1e6:.1f} MB zlib, "
          f"{report['long_corpus']['write_s']:.1f} s", flush=True)
    reqs = long_requests()
    out = {}
    for label, packed in (("unpacked", False), ("packed", True)):
        db = TempoDB(LocalBackend(root), TempoDBConfig(
            search_max_batch_pages=4096, search_packed_residency=packed),
            device="cuda")
        dbs.append(db)
        db.poll()
        out[label] = (db, run_queries(db, "long", reqs, args.reps))
    plain_db, pres = out["unpacked"]
    packed_db, kres = out["packed"]
    for label, (_db, r) in out.items():
        path = {}
        for x in r.values():
            add_counts(path, x["launches"])
        add_counts(launches, path)
        report[f"long_launches_{label}"] = path
    require_launched("packed long-duration search",
                     report["long_launches_packed"],
                     ("multi_scan_packed_q", "topk"),
                     ("multi_scan", "multi_scan_packed"))
    same_responses("long-duration search", kres, pres)
    lat = {}
    for name, r in kres.items():
        tags, kw = reqs[name]
        check_response(name, r["resp"], tags, kw, n_total)
        lat[f"unpacked/{name}"] = latency_row(pres[name], pres[name]["resp"])
        lat[f"packed/{name}"] = latency_row(r, r["resp"])
        print_row(f"unpacked {name}", lat[f"unpacked/{name}"])
        print_row(f"packed {name}", lat[f"packed/{name}"])
    report["long_search"] = lat
    pc, kc = search_calls(plain_db, "long", reqs), \
        search_calls(packed_db, "long", reqs)
    report["long_paired"] = paired_latency(
        "long-duration", {n: (pc[n], kc[n]) for n in reqs}, args.reps)
    report["long_staged"] = staged_bytes("long-duration", plain_db,
                                         packed_db)
    if any(not str(c.batch.widths[2]).startswith("q")
           for c in packed_db.batcher._cache.values()):
        raise AssertionError("a long-duration batch kept u16 durations")
    tags, kw = reqs["long_65536_131071"]
    k1, _scores = k1_row(packed_db, "multi_scan_packed_q",
                         "tempo_tpu/search/packing.py:213", tags, kw,
                         launches, False)
    for db in (plain_db, packed_db):
        db.close()
        dbs.remove(db)
    gc.collect()
    torch.cuda.empty_cache()
    return [k1]


def packed_hc_cell(args, work: str, report: dict, dbs: list,
                   launches: dict) -> list:
    """The packed high-cardinality cell: the hc corpus's first
    `--hc-packed-blocks` blocks (one 4,096-page group at full size),
    written again into a backend of their own, answered by an unpacked
    and a packed TempoDB through the three entry points (hc_paths; the
    packed one's run is its main path), every packed response equal to
    the unpacked one; word-mask bytes per cached tag-set against bool
    bytes; the 8-client exhaustive session set through the packed one,
    each response equal to the unpacked one's serial response; then K1 (packed, word hit tables), K1s (packed, word hits),
    K4 (packed, word hits, 6 probed + 2 host-compiled) and K5 against
    their plain versions."""
    import torch

    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search import packing
    from tempo_tpu_torch.search.backend_search_block import \
        BackendSearchBlock

    n_per = args.hc_traces_per_block
    blocks = min(args.hc_packed_blocks, args.hc_blocks)
    root = os.path.join(work, "hc_packed_blocks")
    t0 = time.perf_counter()
    nbytes = write_corpus(root, "hc", blocks, n_per, ENTRIES_PER_PAGE,
                          args.seed, sessions=True)
    report["hc_packed_corpus"] = {"blocks": blocks, "traces": blocks * n_per,
                                  "compressed_bytes": nbytes,
                                  "write_s": time.perf_counter() - t0}
    print(f"packed hc corpus: the first {blocks} blocks, {blocks * n_per} "
          f"traces, {report['hc_packed_corpus']['write_s']:.1f} s",
          flush=True)
    be = LocalBackend(root)
    out = {}
    bsbs = {}
    calls = {}
    for label, packed in (("unpacked", False), ("packed", True)):
        db = TempoDB(be, TempoDBConfig(search_max_batch_pages=4096,
                                       search_packed_residency=packed),
                     device="cuda")
        dbs.append(db)
        db.poll()

        def bsb_of(meta, label=label, packed=packed):
            bsbs[label] = BackendSearchBlock(be, meta, device="cuda",
                                             packed=packed)
            return bsbs[label]

        calls[label] = {}
        out[label] = (db, hc_paths(db, bsb_of, n_per, args.reps, True,
                                   calls[label]))
    plain_db, pres = out["unpacked"]
    packed_db, kres = out["packed"]
    for label, (_db, r) in out.items():
        path = {}
        for x in r.values():
            add_counts(path, x["launches"])
        add_counts(launches, path)
        report[f"hc_packed_launches_{label}"] = path
    require_launched("packed hc search", report["hc_packed_launches_packed"],
                     ("multi_scan_packed_hits", "scan_single_packed",
                      "dict_probe", "dict_probe_words", "topk"),
                     ("multi_scan_hits", "scan_single", "multi_scan",
                      "pack_mask_words"))
    same_responses("packed hc search", kres, pres)
    lat = {}
    for name in kres:
        lat[f"unpacked/{name}"] = latency_row(pres[name], pres[name]["resp"])
        lat[f"packed/{name}"] = latency_row(kres[name], kres[name]["resp"])
        print_row(f"unpacked hc4 {name}", lat[f"unpacked/{name}"])
        print_row(f"packed hc4 {name}", lat[f"packed/{name}"])
    report["hc_packed_search"] = lat
    report["hc_packed_paired"] = paired_latency(
        "hc4", {n: (calls["unpacked"][n], calls["packed"][n])
                for n in calls["packed"]}, args.reps)
    report["hc_packed_staged"] = staged_bytes("high cardinality", plain_db,
                                              packed_db)
    masks = {}
    for label, (db, _r) in out.items():
        sizes = [int(o[2].numel() * o[2].element_size())
                 for d in db.batcher.engine.compile_cache._by_dict.values()
                 for o in d.values()
                 if not isinstance(o, str) and o[2] is not None]
        masks[label] = sizes
    if not masks["packed"] or not all(
            packing.is_packed_mask(o[2])
            for d in packed_db.batcher.engine.compile_cache._by_dict.values()
            for o in d.values() if not isinstance(o, str)
            and o[2] is not None):
        raise AssertionError("the packed hc cache holds no word masks")
    report["hc_mask_bytes"] = {k: sorted(set(v)) for k, v in masks.items()}
    print(f"hit-mask bytes per cached tag-set: bool "
          f"{report['hc_mask_bytes']['unpacked']}, words "
          f"{report['hc_mask_bytes']['packed']}", flush=True)
    sessions = [(dict(EXHAUSTIVE, **{SESSION_KEY: v}), {"limit": 20})
                for v in HC_SESSIONS]
    serial = [canon(plain_db.search(
        "hc", SearchRequest(tags=dict(t), **kw)).response())
              for t, kw in sessions]
    row = concurrent_rounds(packed_db, "hc", sessions, args.rounds, serial)
    add_counts(launches, row["launches"])
    require_fusion(row, "coalesced_scan_packed_hits")
    if row["launches"].get("pack_mask_words"):
        raise AssertionError(f"the packed hc sessions launched K5: "
                             f"{row['launches']}")
    print(f"concurrent packed high cardinality sessions (coalescing): round "
          f"p50 {row['round_p50_ms']:.3f} ms, p95 {row['round_p95_ms']:.3f} "
          f"ms; request p50 {row['lat_p50_ms']:.3f} ms, p95 "
          f"{row['lat_p95_ms']:.3f} ms; launches "
          f"{json.dumps(row['launches'])}; coalescer "
          f"{json.dumps(row['coalesce'])}", flush=True)
    report["hc_packed_concurrent"] = row
    tags, kw = hc_requests()["hc_exhaustive_77"]
    k1, _scores = k1_row(packed_db, "multi_scan_packed_hits",
                         "tempo_tpu/search/packing.py:249", tags, kw,
                         launches, True)
    rows = [k1, k1s_row(bsbs["packed"], "scan_single_packed",
                        "tempo_tpu/search/packing.py:237", launches)]
    rows += coalesced_phase(
        packed_db, [(dict(EXHAUSTIVE, **{SESSION_KEY: v}), {"limit": 20})
                    for v in HC_SESSIONS[:6]]
        + [({}, {"min_duration_ms": 59_000, "limit": 20}),
           ({}, {"start": BASE_S + 300, "end": BASE_S + 900, "limit": 20})],
        "packed hit-mask mode, 6 probed + 2 host-compiled", launches, False)
    rows.append(k5_row(packed_db, launches))
    for db in (plain_db, packed_db):
        db.close()
        dbs.remove(db)
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def require_fusion(row: dict, kernel: str) -> None:
    """The exhaustive concurrent rounds fused: more than one query per
    dispatch, through K4 in the cell's mode."""
    co = row["coalesce"]
    if co["queries_per_dispatch"] <= 1 or not row["launches"][kernel]:
        raise AssertionError(f"the concurrent exhaustive rounds did not "
                             f"fuse: {co}, launches {row['launches']}")


def hc_paths(db, bsb_of, n_per: int, reps: int, sync: bool,
             calls: dict | None = None) -> dict:
    """The high-cardinality cell's requests through the three entry
    points, in order; the one-block requests go to the block holding the
    point lookup's session (blocks of `n_per` traces). `bsb_of` gives the
    single-block path's BackendSearchBlock. Returns name -> drive()
    result; `calls`, when given, receives name -> the request's call."""
    from tempo_tpu_torch.model.types import SearchBlockRequest, \
        SearchRequest

    out = {}
    calls = {} if calls is None else calls
    for name, (tags, kw) in hc_requests().items():
        req = SearchRequest(tags=dict(tags), **kw)
        calls[name] = lambda req=req: db.search("hc", req)
        out[name] = drive(calls[name], reps, sync)
        out[name]["dispatches"] = db.batcher.last_dispatches
    meta = next(m for m in db.blocklist.metas("hc")
                if m.block_id == block_id(POINT_SESSION // n_per))
    point = SearchRequest(tags=dict(hc_requests()["hc_point"][0]), limit=20)
    job = SearchBlockRequest(
        search_req=point, tenant_id="hc", block_id=meta.block_id,
        encoding=meta.encoding, version=meta.version,
        data_encoding=meta.data_encoding, start_time=meta.start_time,
        end_time=meta.end_time)
    calls["hc_search_block_point"] = lambda: db.search_block(job)
    out["hc_search_block_point"] = drive(calls["hc_search_block_point"],
                                         reps, sync)
    out["hc_search_block_point"]["dispatches"] = db.batcher.last_dispatches
    bsb = bsb_of(meta)
    for name, req in (("single_point", point),
                      ("single_bench", SearchRequest(tags=dict(BENCH),
                                                     limit=20))):
        calls[name] = lambda req=req: bsb.search(req)
        out[name] = drive(calls[name], reps, sync)
        out[name]["dispatches"] = 1
    return out


def paired_latency(label: str, calls: dict, reps: int) -> dict:
    """The unpacked and the packed database's warm latency, request by
    request, in turns within this process (unpacked, packed, then packed,
    unpacked, ...), so both sides see the same clocks and host. `calls`:
    name -> (unpacked call, packed call). Host clock, synchronised; p50
    of each side."""
    import torch

    out = {}
    for name, (plain, packed) in calls.items():
        lat = {"unpacked": [], "packed": []}
        for i in range(reps):
            order = [("unpacked", plain), ("packed", packed)]
            for side, call in (order if i % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                canon(call().response())
                torch.cuda.synchronize()
                lat[side].append((time.perf_counter() - t0) * 1e3)
        row = {f"{side}_p50_ms": pct(v, 0.5) for side, v in lat.items()}
        row["lat_ms"] = {side: sorted(v) for side, v in lat.items()}
        out[name] = row
        print(f"paired {label} {name}: p50 unpacked "
              f"{row['unpacked_p50_ms']:.3f} ms, packed "
              f"{row['packed_p50_ms']:.3f} ms ({reps} turns each)",
              flush=True)
    return out


def search_calls(db, tenant: str, reqs: dict) -> dict:
    """name -> a call of db.search with the named request."""
    from tempo_tpu_torch.model.types import SearchRequest

    return {name: (lambda req=SearchRequest(tags=dict(t), **kw):
                   db.search(tenant, req))
            for name, (t, kw) in reqs.items()}


def hc_cell(args, work: str, report: dict, dbs: list, launches: dict
            ) -> list:
    """The high-cardinality cell (step 4 of the module docstring).
    Returns its kernel rows."""
    import torch

    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search.backend_search_block import \
        BackendSearchBlock

    n_per = args.hc_traces_per_block
    n_total = args.hc_blocks * n_per
    root = os.path.join(work, "hc_blocks")
    t0 = time.perf_counter()
    nbytes = write_corpus(root, "hc", args.hc_blocks, n_per,
                          ENTRIES_PER_PAGE, args.seed, sessions=True)
    report["hc_corpus"] = {"blocks": args.hc_blocks, "traces": n_total,
                           "compressed_bytes": nbytes,
                           "write_s": time.perf_counter() - t0}
    print(f"hc corpus: {args.hc_blocks} blocks, {n_total} traces, "
          f"{nbytes / 1e6:.1f} MB zlib, "
          f"{report['hc_corpus']['write_s']:.1f} s", flush=True)

    cfg = TempoDBConfig(search_max_batch_pages=4096)
    be = LocalBackend(root)
    gpu = TempoDB(be, cfg, device="cuda")
    dbs.append(gpu)
    gpu.poll()
    groups = gpu.batcher.plan(gpu._jobs("hc", gpu.blocklist.epoch())[0])
    report["hc_plan"] = [len(g) for g in groups]
    gc.collect()        # free the tag-search cell's closed databases first
    torch.cuda.reset_peak_memory_stats()
    bsbs = {}

    def bsb_gpu(meta):
        bsbs["gpu"] = BackendSearchBlock(be, meta, device="cuda")
        return bsbs["gpu"]

    res = hc_paths(gpu, bsb_gpu, n_per, args.reps, True)  # the main path
    path = {}
    for r in res.values():
        add_counts(path, r["launches"])
    report["hc_launches"] = path
    report["hc_peak_device_bytes"] = torch.cuda.max_memory_allocated()
    report["hc_staged_device_bytes"] = gpu.batcher._cache_total
    report["hc_staged_dict_bytes"] = gpu.batcher._probe_dict_total
    for name in hc_requests():
        cold = res[name]["launches_cold"]
        if not cold["dict_probe"]:
            raise AssertionError(f"{name}: cold request launched no K3")
    for k in ("multi_scan_hits", "scan_single", "topk", "dict_probe"):
        if not path[k]:
            raise AssertionError(f"high-cardinality path launched no {k}: "
                                 f"{path}")
    if path["multi_scan"]:
        raise AssertionError(f"a probed block took the range mode: {path}")
    if path["dict_probe_words"] or path["pack_mask_words"]:
        raise AssertionError(f"the unpacked hc path asked for words: {path}")
    add_counts(launches, path)
    lat_report = {}
    expect = {"hc_point": 1, "hc_prefix": 10, "hc_search_block_point": 1,
              "single_point": 1}
    reqs = hc_requests()
    for name, r in res.items():
        tags, kw = reqs.get(name, ({}, {"limit": 20}))
        check_response(name, r["resp"], tags, kw,
                       n_total if name in reqs else n_per)
        if name in expect and len(r["resp"].traces) != expect[name]:
            raise AssertionError(f"{name}: {len(r['resp'].traces)} results, "
                                 f"want {expect[name]}")
        lat_report[name] = latency_row(r, r["resp"])
        print_row(name, lat_report[name])
    report["hc_search"] = lat_report
    print("hc plan (blocks per group): " + json.dumps(report["hc_plan"]) +
          f"; staged {report['hc_staged_device_bytes']} B of which "
          f"dictionaries {report['hc_staged_dict_bytes']} B; launches: "
          + json.dumps(path), flush=True)

    busy = device_busy(gpu, "hc", reqs, ("hc_exhaustive_77", "hc_point",
                                         "hc_77_and_svc"), args.reps)
    report["hc_device_busy"] = busy
    print_busy(busy, lat_report)

    t0 = time.perf_counter()
    cpu = TempoDB(be, cfg, device="cpu")
    dbs.append(cpu)
    cpu.poll()
    cres = hc_paths(cpu, lambda m: BackendSearchBlock(be, m, device="cpu"),
                    n_per, 0, False)
    for name in res:
        if cres[name]["resp"] != res[name]["resp"]:
            raise AssertionError(f"{name}: card and CPU responses differ")
    report["hc_cpu_check_s"] = time.perf_counter() - t0
    print(f"hc cpu check: {len(res)} responses identical "
          f"({report['hc_cpu_check_s']:.1f} s)", flush=True)
    cpu.close()
    dbs.remove(cpu)
    rows = hc_kernel_phase(gpu, bsbs["gpu"], launches)
    rows += coalesced_phase(
        gpu, [(dict(EXHAUSTIVE, **{SESSION_KEY: v}), {"limit": 20})
              for v in HC_SESSIONS[:6]]
        + [({}, {"min_duration_ms": 59_000, "limit": 20}),
           ({}, {"start": BASE_S + 300, "end": BASE_S + 900, "limit": 20})],
        "hit-mask mode, 6 probed + 2 host-compiled", launches, False)

    serial = TempoDB(be, TempoDBConfig(search_max_batch_pages=4096,
                                       search_coalesce_max_queries=1),
                     device="cuda")
    dbs.append(serial)
    serial.poll()
    tags, kw = reqs["hc_exhaustive_77"]
    serial.search("hc", SearchRequest(tags=dict(tags), **kw))     # stage
    torch.cuda.reset_peak_memory_stats()
    report["hc_concurrent"] = concurrent_phase(
        "high cardinality", gpu, serial, "hc",
        {"sessions": [(dict(EXHAUSTIVE, **{SESSION_KEY: v}), {"limit": 20})
                      for v in HC_SESSIONS]}, args.rounds, launches)
    report["hc_concurrent_peak_device_bytes"] = \
        torch.cuda.max_memory_allocated()
    require_fusion(report["hc_concurrent"]["sessions/coalescing"],
                   "coalesced_scan_hits")
    tags, kw = reqs["hc_point"]
    report["hc_solo_again"] = solo_again(gpu, "hc", "hc_point", tags, kw,
                                         res["hc_point"], args.reps,
                                         launches)
    report["hc_host_route"] = hc_host_route(gpu, bsbs["gpu"])
    # the corpus and the planner-off answers, for the planner cell
    STAGED["hc"] = {"root": root, "max_batch_pages":
                    cfg.search_max_batch_pages,
                    "resp": {n: res[n]["resp"] for n in hc_requests()}}
    for db in (gpu, serial):
        db.close()
        dbs.remove(db)
    return rows


# a session.id needle longer than K3 takes (dict_probe.MAX_NEEDLE_BYTES):
# it matches no value, so the scan runs over every byte of a dictionary
HC_LONG_NEEDLE = "session-00123456/" * 5


def hc_host_route(db, bsb) -> dict:
    """One request whose needle K3 cannot take, so each block's dictionary
    goes through the host route (``pipeline.substring_value_ids``: the host
    library's memmem scan from 50,000 values on); the scan must run and
    the request return nothing. Then block 0's dictionary (1,050,711
    values at full size) through the scan and through numpy
    (``substring_value_ids_plain``) for that needle and three short ones:
    equal value ids, both timed (the scan warm: its packing is kept)."""
    import numpy as np

    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.ops import native
    from tempo_tpu_torch.search import dict_probe, pipeline

    if len(HC_LONG_NEEDLE.encode()) <= dict_probe.MAX_NEEDLE_BYTES:
        raise AssertionError("the long needle fits K3")
    scans = []
    scan = native.substr_scan

    def counted(*a):
        scans.append(len(a[1]) - 1)
        return scan(*a)

    native.substr_scan = counted
    try:
        t0 = time.perf_counter()
        resp = canon(db.search("hc", SearchRequest(
            tags={SESSION_KEY: HC_LONG_NEEDLE}, limit=20)).response())
        request_ms = (time.perf_counter() - t0) * 1e3
    finally:
        native.substr_scan = scan
    if not scans or resp.traces:
        raise AssertionError(f"hc host route: {len(scans)} scans, "
                             f"{len(resp.traces)} results")
    vals = bsb.pages().val_dict
    t0 = time.perf_counter()
    pipeline.packed_val_dict(vals)
    out = {"request_ms": request_ms, "scans": len(scans),
           "values_scanned": sum(scans), "dict_values": len(vals),
           "pack_ms": (time.perf_counter() - t0) * 1e3, "needles": {}}
    for needle in (HC_LONG_NEEDLE, "77", "123456", "session-0000"):
        t0 = time.perf_counter()
        got = pipeline.substring_value_ids(vals, needle)
        t1 = time.perf_counter()
        want = pipeline.substring_value_ids_plain(vals, needle)
        t2 = time.perf_counter()
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"hc host route {needle!r}: the scan's "
                                 "value ids differ from numpy's")
        out["needles"][needle] = {"ids": int(got.size),
                                  "scan_ms": (t1 - t0) * 1e3,
                                  "numpy_ms": (t2 - t1) * 1e3}
    long = out["needles"][HC_LONG_NEEDLE]
    print(f"hc host route: a {len(HC_LONG_NEEDLE)}-byte needle, "
          f"{out['scans']} dictionaries ({out['values_scanned']} values) "
          f"scanned by the host library, no result, {request_ms:.1f} ms; "
          f"block 0's {len(vals)} values (packed once, "
          f"{out['pack_ms']:.1f} ms): "
          + ", ".join(f"{n[:12]!r} {r['ids']} ids, scan {r['scan_ms']:.2f} "
                      f"ms, numpy {r['numpy_ms']:.1f} ms"
                      for n, r in out["needles"].items())
          + f" (the long needle: scan {long['scan_ms']:.2f} ms, numpy "
          f"{long['numpy_ms']:.1f} ms; ids equal)", flush=True)
    return out


# ---------------------------------------------------------------------------
# the structural cell

ST_PLANS = {
    "child": {"child": {"parent": {"tag": {"k": "service.name",
                                           "v": "svc-007"}},
                        "child": {"dur": {"min_ms": 500}}}},
    "desc": {"desc": {"anc": {"tag": {"k": "service.name", "v": "svc-001"}},
                      "span": {"kind": "client"}}},
    "count": {"count": {"of": {"tag": {"k": "name", "v": "op-1"}},
                        "op": ">", "n": 3}},
    "quantile": {"quantile": {"of": {"dur": {"min_ms": 0}}, "q": "0.9",
                              "op": ">=", "ms": 500}},
    "and_not": {"and": [{"tag": {"k": "http.status_code", "v": "500"}},
                        {"not": {"exists": {"kind": 2}}}]},
}
# eight plans of one canonical bucket ("bucket", 4, 2, True): a relation
# over two span leaves, each plan different
ST_BUCKET_PLANS = [
    {"child": {"parent": {"tag": {"k": "service.name", "v": "svc-000"}},
               "child": {"dur": {"min_ms": 500}}}},
    {"desc": {"anc": {"tag": {"k": "service.name", "v": "svc-001"}},
              "span": {"kind": 3}}},
    {"child": {"parent": {"kind": 2}, "child": {"tag": {"k": "name",
                                                        "v": "op-1"}}}},
    {"desc": {"anc": {"dur": {"min_ms": 1500}},
              "span": {"tag": {"k": "service.name", "v": "svc-003"}}}},
    {"child": {"parent": {"tag": {"k": "service.name", "v": "svc-004"}},
               "child": {"kind": 1}}},
    {"desc": {"anc": {"kind": 4}, "span": {"dur": {"min_ms": 1000}}}},
    {"child": {"parent": {"dur": {"max_ms": 10}},
               "child": {"tag": {"k": "name", "v": "op-7"}}}},
    {"desc": {"anc": {"tag": {"k": "service.name", "v": "svc-007"}},
              "span": {"tag": {"k": "name", "v": "op-3"}}}},
]


def st_tag(plan: dict, exhaustive: bool) -> dict:
    from tempo_tpu_torch.search import ir, structural

    tags = {structural.STRUCTURAL_QUERY_TAG:
            ir.quote(ir.to_json(ir.parse(json.dumps(plan))))}
    if exhaustive:
        tags.update(EXHAUSTIVE)
    return tags


def st_requests() -> dict:
    """The structural cell's requests, each exhaustive (these run first
    and stage every group) and at limit 20."""
    out = {f"st_{n}_exhaustive": (st_tag(p, True), {"limit": 20})
           for n, p in ST_PLANS.items()}
    out.update({f"st_{n}": (st_tag(p, False), {"limit": 20})
                for n, p in ST_PLANS.items()})
    return out


def k6_bytes(d: dict, spans: dict | None, lanes, n_out: int) -> int:
    """The bytes K6's function must move: per real span the span columns
    the lanes' programs read (span_trace always; span_block and kv slots
    for a tag leaf, durations for a dur leaf or a quantile, kind for a
    kind leaf, parents for child/desc), every entry's valid flag and span
    run (begin, count), the page ids, the entry columns a trace leaf
    reads (kv slots, durations), the programs and tables, and the
    verdicts written, one byte per entry and lane."""
    import numpy as np

    sops = set(np.unique(lanes.span_prog[:, :, 0]).tolist())
    tops = set(np.unique(lanes.trace_prog[:, :, 0]).tolist())
    P, E = d["entry_valid"].shape
    total = P * E + P * 4 + n_out
    total += sum(int(a.nbytes) for a in (
        lanes.span_prog, lanes.trace_prog, lanes.term_keys,
        lanes.val_ranges, lanes.dur_params, lanes.kind_params,
        lanes.agg_params))
    if spans is not None:
        S = int(spans["entry_span_count"].sum())
        per = 4
        if 1 in sops:
            per += 4 + 2 * 4 * int(spans["span_kv_key"].shape[1])
        if 2 in sops or 5 in tops:
            per += 4
        if 3 in sops:
            per += 1
        if sops & {7, 8}:
            per += 4
        total += S * per + P * E * 8
    if 1 in tops:
        total += sum(t.numel() * t.element_size()
                     for t in (d["kv_key"], d["kv_val"]))
    if 2 in tops:
        total += d["entry_dur"].numel() * d["entry_dur"].element_size()
        if "entry_dur_res" in d:
            total += d["entry_dur_res"].numel()
    return total


def st_compile(db, batch, plans: list):
    """MultiQueries of exhaustive structural requests over `batch`,
    compiled as the batcher compiles them."""
    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search import ir, structural
    from tempo_tpu_torch.search.multiblock import compile_multi

    eng = db.batcher.engine
    out = []
    for plan in plans:
        req = SearchRequest(tags=st_tag(plan, True), limit=20)
        mq = compile_multi(list(batch.blocks), req, memo=batch.memo,
                           cache=eng.compile_cache,
                           staged_dicts=batch.staged_dicts, packed=eng.packed)
        mq.structural = structural.compile_structural(
            ir.parse(json.dumps(plan)), list(batch.blocks),
            staged_dicts=batch.staged_dicts, packed=eng.packed,
            memo=batch.memo)
        out.append(mq)
    return out


def k6_measure(db, batch, lanes) -> tuple:
    """K6 over `lanes` on `batch` against its plain version: (verdicts,
    max abs err, card ms, device ms (``event_ms``: the median of 20
    single calls), plain ms, bound bytes, the kernel's builds launched)."""
    from tempo_tpu_torch.search.kernels import structural as k6
    from tempo_tpu_torch.search.kernels.bench_structural import event_ms

    d = batch.device
    args = (d["kv_key"], d["kv_val"], d["entry_dur"], d["entry_valid"],
            d["page_block"], batch.span_device, batch.span_max_run,
            lanes.device(db.device), lanes.val_hits, batch.widths,
            d.get("entry_dur_res"))
    v, builds = k6_variants(lambda: k6.structural_mask(*args))
    err = require_equal("K6", (v,), (k6.structural_mask_plain(*args),))
    ms = cuda_ms(lambda: k6.structural_mask(*args), 20)
    dev = event_ms(lambda: k6.structural_mask(*args))
    plain = cuda_ms(lambda: k6.structural_mask_plain(*args), 3)
    need = k6_bytes(d, batch.span_device, lanes, v.numel())
    return v, err, ms, dev, plain, need, builds


def shuffle_span_runs(b, seed: int) -> None:
    """Reorder block `b`'s span axis so that its entries' runs lie in a
    seeded random order (each run stays contiguous, parents and begins
    remapped): the runs of one page are then no longer adjacent."""
    import numpy as np

    begin = b.entry_span_begin.reshape(-1).astype(np.int64)
    count = b.entry_span_count.reshape(-1).astype(np.int64)
    live = np.flatnonzero(count > 0)
    order = np.random.default_rng(seed).permutation(live)
    c = count[order]
    perm = np.repeat(begin[order] - (np.cumsum(c) - c), c) \
        + np.arange(int(c.sum()))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    par = b.span_parent[perm]
    b.span_parent = np.where(par >= 0, inv[np.clip(par, 0, None)],
                             -1).astype(b.span_parent.dtype)
    for name in ("span_trace", "span_dur", "span_kind", "span_kv_key",
                 "span_kv_val"):
        setattr(b, name, getattr(b, name)[perm])
    nb = np.where(count > 0, inv[np.clip(begin, 0, perm.size - 1)], 0)
    b.entry_span_begin = nb.astype(b.entry_span_begin.dtype).reshape(
        b.entry_span_begin.shape)


def k6_out_of_order(eng, pages) -> tuple:
    """K6 on 8 pages of `pages` whose span runs were put out of entry
    order (each page's span range then spans the slice), staged on the
    card, against its plain version for the desc and quantile plans:
    (report, max abs err)."""
    from tempo_tpu_torch.search import ir, structural
    from tempo_tpu_torch.search.kernels import structural as k6
    from tempo_tpu_torch.search.multiblock import place_batch

    import numpy as np

    blk = pages.slice_pages(0, 8)
    n_in_order = int(blk.entry_span_count.sum(axis=1).max())
    shuffle_span_runs(blk, 7)
    cnt = blk.entry_span_count.astype(np.int64)
    beg = blk.entry_span_begin.astype(np.int64)
    live = cnt > 0
    widest = int((np.where(live, beg + cnt, 0).max(axis=1)
                  - np.where(live, beg, np.iinfo(np.int64).max).min(axis=1)
                  )[live.any(axis=1)].max())
    batch = place_batch(eng.stage_host([blk]), eng.device)
    d = batch.device
    err, hits = 0, {}
    for name in ("desc", "quantile"):
        st = structural.compile_structural(
            ir.parse(json.dumps(ST_PLANS[name])), [blk],
            staged_dicts=batch.staged_dicts, packed=eng.packed,
            memo=batch.memo)
        args = (d["kv_key"], d["kv_val"], d["entry_dur"], d["entry_valid"],
                d["page_block"], batch.span_device, batch.span_max_run,
                st.lanes().device(eng.device), st.lanes().val_hits,
                batch.widths, d.get("entry_dur_res"))
        v = k6.structural_mask(*args)
        err = max(err, require_equal(f"K6 out of order ({name})", (v,),
                                     (k6.structural_mask_plain(*args),)))
        hits[name] = int(v.sum())
    if widest <= n_in_order:
        raise AssertionError("shuffled runs did not widen a page's range")
    print(f"K6 on runs out of entry order: a page's span range up to "
          f"{widest} (its spans at most {n_in_order}); equal to its plain "
          "version", flush=True)
    return {"pages": batch.n_pages, "widest_page_range": widest,
            "most_spans_of_a_page": n_in_order, "verdicts": hits}, err


def k6_lanes(blocks: list, batch, packed: bool) -> dict:
    """K6's lane sets over `blocks` staged as `batch`: each of the cell's
    five plans alone (Q = 1), the eight bucket plans (Q = 8), the bucket
    five times over (Q = 40: two launches of at most 32 lanes) and
    ``wide_lanes``."""
    from tempo_tpu_torch.search import ir, structural

    def comp(plan):
        return structural.compile_structural(
            ir.parse(json.dumps(plan)), blocks,
            staged_dicts=batch.staged_dicts, packed=packed, memo=batch.memo)

    out = {name: comp(p).lanes() for name, p in ST_PLANS.items()}
    sts = [comp(p) for p in ST_BUCKET_PLANS]
    desc = structural.canonical_bucket(sts[0].plan, 16)
    out["bucket Q=8"] = structural.stack_bucketed(sts, desc).lanes
    out["bucket Q=40"] = structural.stack_bucketed(sts * 5, desc).lanes
    out["wide NS=40 NT=140"] = wide_lanes(len(blocks))
    for name in ("desc", "bucket Q=8", "wide NS=40 NT=140"):
        out[f"{name}, {IN_PLACE}"] = tables_in_place(out[name])
    return out


# the suffix of a lane set whose tables K6 must read in place
IN_PLACE = "tables in place"


def tables_in_place(lanes, words: int = 1 << 16):
    """`lanes` with inert block rows (term key -1, the empty range [1, 0],
    block group -1) appended until one launch's lane tables take more
    than `words` words, past what shared memory holds beside a tile, so
    that K6 reads them in place. No page names the added rows: the
    verdicts are those of `lanes`."""
    import numpy as np

    from tempo_tpu_torch.search import structural

    Q, _B, T = lanes.term_keys.shape
    R = lanes.val_ranges.shape[3]
    add = words // (min(Q, 32) * T * (1 + 2 * R)) + 1
    bg = lanes.block_group
    return structural.Lanes(
        span_prog=lanes.span_prog, trace_prog=lanes.trace_prog,
        term_keys=np.concatenate(
            [lanes.term_keys, np.full((Q, add, T), -1, np.int32)], 1),
        val_ranges=np.concatenate(
            [lanes.val_ranges, np.broadcast_to(
                np.array([1, 0], np.int32), (Q, add, T, R, 2))], 1),
        dur_params=lanes.dur_params, kind_params=lanes.kind_params,
        agg_params=lanes.agg_params, val_hits=lanes.val_hits,
        block_group=None if bg is None else np.concatenate(
            [bg, np.full((Q, add), -1, np.int32)], 1))


def k6_variants(fn):
    """(fn's result, K6's launches by build while it ran: name -> n)."""
    from tempo_tpu_torch.search.kernels import structural as k6

    before = {v: c.n for v, c in k6.VARIANT_LAUNCHES.items()}
    out = fn()
    return out, {v: c.n - before[v] for v, c in k6.VARIANT_LAUNCHES.items()
                 if c.n > before[v]}


def wide_lanes(B: int):
    """One lane by hand past what the IR's 64 nodes reach: 40 span slots
    (two register words: dur leaves, and/or over them, a desc) and 140
    trace slots (exists, count and quantile over them, then and/or/not
    chains: five words of trace registers)."""
    import numpy as np

    from tempo_tpu_torch.search import structural

    NS, NT = 40, 140
    sp = np.zeros((1, NS, 4), dtype=np.int32)
    for i in range(20):
        sp[0, i] = (2, i % 2, 0, 0)
    for i in range(20, NS - 1):
        sp[0, i] = (5 if i % 2 else 4, i, i - 7, 0)
    sp[0, NS - 1] = (8, 25, 30, 0)
    tp = np.zeros((1, NT, 4), dtype=np.int32)
    tp[0, 0] = (3, NS, 0, 0)
    tp[0, 1] = (4, 30, 0, 1)
    tp[0, 2] = (5, 20, 1, 3)
    for t in range(3, NT - 1):
        tp[0, t] = (6 + t % 3, t, t - 2, 0)
    tp[0, NT - 1] = (7, NT - 1, NT - 2, 0)
    return structural.Lanes(
        span_prog=sp, trace_prog=tp,
        term_keys=np.full((1, B, 1), -1, dtype=np.int32),
        val_ranges=np.tile(np.array([1, 0], dtype=np.int32),
                           (1, B, 1, 1, 1)),
        dur_params=np.array([[[0, 600], [1500, 2000]]], dtype=np.uint32),
        kind_params=np.zeros((1, 1), dtype=np.int32),
        agg_params=np.array([[[3, 1, 0], [9, 10, 900]]], dtype=np.uint32))


def k6_check(what: str, d: dict, spans, max_run: int, lanes_of: dict,
             widths, dev) -> tuple:
    """K6 against its plain version for every lane set on one staged
    batch's columns (`d`, `spans`), and on the card through the build the
    set names (its tables in place, or in shared memory; span words by
    its program): (verdicts set and builds launched per lane set, max
    abs err)."""
    from tempo_tpu_torch.search.kernels import structural as k6

    hits, err = {}, 0
    for name, lanes in lanes_of.items():
        args = (d["kv_key"], d["kv_val"], d["entry_dur"], d["entry_valid"],
                d["page_block"], spans, max_run, lanes.device(dev),
                lanes.val_hits, widths, d.get("entry_dur_res"))
        v, ran = k6_variants(lambda: k6.structural_mask(*args))
        err = max(err, require_equal(f"K6 {what} ({name})", (v,),
                                     (k6.structural_mask_plain(*args),)))
        words = "1 word" if lanes.span_prog.shape[1] < 32 else "8 words"
        if v.is_cuda and (not ran or any(
                not r.startswith(words)
                or r.endswith(IN_PLACE) != name.endswith(IN_PLACE)
                for r in ran)):
            raise AssertionError(f"K6 {what} ({name}) ran {ran}")
        hits[name] = {"verdicts": int(v.sum()), "builds": ran}
    return hits, err


def k4_inputs(seed: int, dev, *, P: int, C: int, B: int, Q: int, T: int,
              R: int, kv=("int8", "int16"), widths=None, hits=None,
              v_rows=None, E: int = ENTRIES_PER_PAGE) -> tuple:
    """Seeded K4 inputs on `dev`: (page arrays, per-query tables, the
    layout arguments (widths, residual, verdicts)), K4's positional
    arguments in order. Keys 0-5 and pads, value ids up to 14 (a u4
    value column) or 120, 1 entry in 10 invalid, the last page a pad
    page (block -1); each odd query repeats the query before it (its
    tables and hit tables), the last query is a pad query; `hits`
    ("bytes" or "words"): two block groups a member, member 0 compiled on
    the host, each member's table narrower than the largest id (ids past
    it clamp to its last element); `v_rows`: that many verdict rows. The
    kv columns are `kv`'s dtypes, or packed at `widths` (kw, vw, dw)."""
    import numpy as np
    import torch

    from tempo_tpu_torch.search import packing

    rng = np.random.default_rng(seed)
    vmax = 14 if widths is not None and widths[1] == "u4" else 120
    kk = rng.integers(-1, 6, size=(P, E, C))
    vv = rng.integers(-1, vmax + 1, size=(P, E, C))
    vv[kk < 0] = -1
    valid = rng.random((P, E)) < 0.9
    start = rng.integers(2**31 - 40, 2**31 + 40, size=(P, E)).astype(
        np.uint32)
    end = np.minimum(start.astype(np.int64) + rng.integers(0, 30, (P, E)),
                     0xFFFFFFFF).astype(np.uint32)
    dur = rng.integers(0, 60_000, size=(P, E)).astype(np.uint32)
    page_block = rng.integers(0, B, size=P).astype(np.int32)
    page_block[-1] = -1
    res = None
    if widths is None:
        cols = [kk.astype(kv[0]), vv.astype(kv[1]), dur.view(np.int32)]
    else:
        q, res = packing.pack_duration(dur, widths[2])
        cols = [packing.device_view(packing.pack_ids_array(kk, widths[0])),
                packing.device_view(packing.pack_ids_array(vv, widths[1])),
                packing.device_view(q)]
        res = None if res is None else packing.device_view(res)
    term_keys = rng.integers(0, 6, size=(Q, B, T)).astype(np.int32)
    term_keys[rng.random((Q, B, T)) < 0.1] = -1
    lo = rng.integers(0, vmax, size=(Q, B, T, R))
    hi = lo + rng.integers(0, 8, size=(Q, B, T, R))
    val_ranges = np.stack([lo, hi], axis=-1).astype(np.int32)
    val_ranges[rng.random((Q, B, T, R)) < 0.3] = (1, 0)
    term_active = rng.random((Q, T)) < 0.8
    term_active[:, 0] = True
    dur_lo = rng.integers(0, 20_000, size=Q).astype(np.uint32)
    dur_hi = np.full(Q, 0xFFFFFFFF, dtype=np.uint32)
    dur_hi[0] = 50_000
    win_start = np.zeros(Q, dtype=np.uint32)
    win_start[Q // 2] = 2**31
    win_end = np.full(Q, 0xFFFFFFFF, dtype=np.uint32)
    win_end[-1 if Q < 3 else 2] = 2**31 + 10
    block_group = rng.integers(-1, 2, size=(Q, B)).astype(np.int32)
    block_group[0] = -1
    tables = None
    if hits is not None:
        tables = [torch.from_numpy(rng.random(
            (2, T, int(rng.integers(vmax // 2, vmax)))) < 0.4)
            for _q in range(Q)]
        if hits == "words":
            tables = [packing.pack_mask_words(h) for h in tables]
    for a in (term_keys, val_ranges, term_active, dur_lo, dur_hi, win_start,
              win_end, block_group):
        a[1::2] = a[0:Q - 1:2]
    if tables is not None:
        tables[1::2] = tables[0:Q - 1:2]
    if Q > 1:
        dur_lo[-1], dur_hi[-1] = 1, 0
    val_hits = bg = None
    if tables is not None:
        val_hits = tuple(None if (block_group[q] < 0).all()
                         else tables[q].to(dev) for q in range(Q))
        bg = torch.from_numpy(block_group).to(dev)
    verdicts = None
    if v_rows is not None:
        verdicts = torch.from_numpy(
            (rng.random((v_rows, P * E)) < 0.7).astype(np.uint8)).to(dev)

    def t(a):
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    page = (t(cols[0]), t(cols[1]), t(start), t(end), t(cols[2]), t(valid),
            t(page_block))
    tabs = (t(term_keys), t(val_ranges), t(term_active), t(dur_lo),
            t(dur_hi), t(win_start), t(win_end), val_hits, bg)
    return page, tabs, (widths, None if res is None else t(res), verdicts)


def k4_edges(dev, seed: int) -> tuple:
    """K4 held exactly against its plain version on the card at the edges
    of its design, over ``k4_inputs``: every reader pair (the 9 unpacked
    at C = 9, the 16 packed at C = 10, one with q6 durations and a
    residual) in range mode and with byte and word hit tables; Q = 1;
    Q = 64 (T = 2: two chunks of distinct terms); Q x T = 256 (Q = 32,
    T = 8); T = 16 (queries that need more than 7 terms of a chunk: the
    per-query test); C = 17; C = 80 (its tile past shared memory: the
    slots read in place); R = 512 (the endpoint tables past their cap: the
    ranges tested in place); pages of 100 entries; fewer verdict rows
    than queries. Every case holds repeated
    members, ids past a member's hit table, a pad page and a pad query.
    Every case's launcher call is then replayed from 8 host threads at
    once (``LauncherReplay``). Then ptxas's report: no build of K4's two
    kernels may spill. Returns (report, max abs err)."""
    from tempo_tpu_torch.search.kernels import build, scan
    from tempo_tpu_torch.search.kernels.bench_coalesced import k4_usage

    ids = ("int8", "int16", "int32")
    codes = ("u4", "u8", "u16", "u32")
    base = dict(P=6, B=3, Q=8, T=2, R=4)
    cases = []
    for kd in ids:
        for vd in ids:
            cases += [(f"{kd}/{vd} {h or 'ranges'}",
                       dict(base, C=9, kv=(kd, vd), hits=h))
                      for h in (None, "bytes", "words")]
    for kw in codes:
        for vw in codes:
            dw = "q6" if (kw, vw) == ("u4", "u16") else "u16"
            cases += [(f"{kw}/{vw}/{dw} {h or 'ranges'}",
                       dict(base, C=10, widths=(kw, vw, dw), hits=h))
                      for h in (None, "bytes", "words")]
    cases += [
        ("Q=1", dict(base, C=8, Q=1, hits="bytes")),
        ("Q=64", dict(base, C=8, Q=64, hits="bytes")),
        ("Q=64 ranges", dict(base, C=8, Q=64)),
        ("Q=32 T=8", dict(base, C=9, Q=32, T=8, kv=("int16", "int32"),
                          hits="words")),
        ("T=16", dict(base, C=12, Q=4, T=16, hits="bytes")),
        ("C=17", dict(base, C=17, kv=("int32", "int32"), hits="bytes")),
        ("C=80", dict(base, P=3, C=80, kv=("int32", "int32"))),
        ("R=512", dict(base, P=3, C=8, R=512)),
        ("E=100", dict(base, C=9, E=100, hits="words")),
        ("verdicts", dict(base, C=8, v_rows=5, hits="bytes")),
        ("verdicts Q=64", dict(base, C=8, Q=64, v_rows=40)),
    ]
    report, err = {}, 0
    replay = LauncherReplay().start()
    for i, (what, kw_) in enumerate(cases):
        page, tabs, layout = k4_inputs(seed + i, dev, **kw_)
        got = scan.coalesced_scan(*page, *tabs, *layout)
        err = max(err, require_equal(f"K4 edge {what}", got,
                                     scan.coalesced_scan_plain(
                                         *page, *tabs, *layout)))
        report[what] = {"Q": int(got[0].shape[0]),
                        "counts": got[1].tolist(),
                        "inspected": int(got[2])}
    replay.stop()
    replayed = replay.replay() if dev.type == "cuda" else {}
    usage = k4_usage(build.BUILD_LOG.get("scan", ""))
    spills = {k: v for k, v in usage.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    if spills:
        raise AssertionError(f"K4 builds spill: {spills}")
    print(f"K4 edges: {len(cases)} cases, each equal to its plain version "
          f"({replayed.get('K4', 0)} launcher calls replayed from 8 "
          "threads); "
          f"{len(usage)} K4 builds in ptxas's report, none spills, "
          "registers "
          f"{sorted({v.get('registers') for v in usage.values()})}",
          flush=True)
    return report, err


def k4_ptxas(row: dict, page, widths, val_hits) -> dict:
    """A K4 row of the kernels line gains the ptxas registers and spill
    bytes (stores + loads) of the build its call launched (None when this
    process built no kernel)."""
    import torch

    from tempo_tpu_torch.search.kernels import build
    from tempo_tpu_torch.search.kernels.bench_coalesced import (k4_build,
                                                                k4_usage)

    words = None if val_hits is None else next(
        (int(h.dtype == torch.int32) for h in val_hits if h is not None), 0)
    name = k4_build(page[0], page[1], widths, words)
    use = k4_usage(build.BUILD_LOG.get("scan", "")).get(name, {})
    row["build"] = name
    row["registers"] = use.get("registers")
    row["spill_bytes"] = (None if "spill_stores" not in use
                          else use["spill_stores"] + use["spill_loads"])
    return row


def k1_edges(dev, seed: int) -> tuple:
    """K1 and K1s held exactly against their plain versions on the card at
    the edges of their design, over one member of ``k4_inputs`` (its own
    tables, hit tables narrower than the largest id, a window bound, a
    pad page): every unpacked reader pair at C = 9 in range mode and with
    byte and word hit tables; every packed pair at C = 10 (q6 durations
    with a residual on u4/u16); C = 8, 17 and 80 (the kv runs too wide
    for the stages: read in place); T = 0, 16 and 40 (terms past the key
    table's 32); term keys past the table's ids (int16 keys of 300-305);
    R = 512; pages of 100 entries; 3,000 pages of 64 entries over 7
    blocks (runs of many tiles a CTA, the key table rebuilt on most); a
    verdict row. K1s takes each case's first block alone wherever its
    layout allows (int32 ids or packed). Every launcher call is then
    replayed from 8 host threads at once (``LauncherReplay``), and no K1
    build may spill in ptxas's report. Returns (report, max abs err)."""
    import torch

    from tempo_tpu_torch.search.kernels import build, scan
    from tempo_tpu_torch.search.kernels.bench_scan import k1_usage

    ids = ("int8", "int16", "int32")
    codes = ("u4", "u8", "u16", "u32")
    base = dict(P=6, B=3, Q=4, T=2, R=4)
    cases = []
    for kd in ids:
        for vd in ids:
            cases += [(f"{kd}/{vd} {h or 'ranges'}",
                       dict(base, C=9, kv=(kd, vd), hits=h))
                      for h in (None, "bytes", "words")]
    for i, kw in enumerate(codes):
        for j, vw in enumerate(codes):
            dw = "q6" if (kw, vw) == ("u4", "u16") else "u16"
            h = (None, "bytes", "words")[(i + j) % 3]
            cases.append((f"{kw}/{vw}/{dw} {h or 'ranges'}",
                          dict(base, C=10, widths=(kw, vw, dw), hits=h)))
    cases += [
        ("C=8", dict(base, C=8, hits="bytes")),
        ("C=17", dict(base, C=17, kv=("int32", "int32"), hits="words")),
        ("C=80", dict(base, P=3, C=80, kv=("int32", "int32"),
                      hits="bytes")),
        ("T=0", dict(base, C=8, T=0)),
        ("T=16", dict(base, C=12, T=16)),
        ("T=40", dict(base, C=12, T=40)),
        ("keys past the table", dict(base, C=9, kv=("int16", "int16"))),
        ("R=512", dict(base, P=3, C=8, R=512)),
        ("E=100", dict(base, C=9, E=100, hits="words")),
        ("3,000 pages of 64", dict(base, P=3000, B=7, C=9, E=64,
                                   kv=("int32", "int32"), hits="bytes")),
        ("verdicts", dict(base, C=8, v_rows=3, hits="bytes")),
    ]
    report, err, q = {}, 0, 2
    replay = LauncherReplay().start()
    for i, (what, kw_) in enumerate(cases):
        T = kw_["T"]
        page, tabs, (widths, res, verdicts) = k4_inputs(
            seed + i, dev, **dict(kw_, T=max(1, T)))
        tk, vr = tabs[0][q].contiguous(), tabs[1][q].contiguous()
        if T > 8:           # terms that entries can meet all at once
            tk[:] = torch.arange(T, dtype=tk.dtype, device=dev) % 3
            vr[:, :, 0, 0], vr[:, :, 0, 1] = 0, 120
        if what == "keys past the table":
            kk = page[0].clone()
            kk[:, :, :6] = torch.arange(300, 306, dtype=kk.dtype,
                                        device=dev)
            page = (kk,) + page[1:]
            tk[:, 0] = 301
            vr[:, 0, 0, 0], vr[:, 0, 0, 1] = 0, 120
        bounds = [int(x[q]) & 0xFFFFFFFF for x in tabs[3:7]]
        vh = None if tabs[7] is None else tabs[7][q]
        bg = None if vh is None else tabs[8][q].contiguous()
        v = None if verdicts is None else verdicts[q].contiguous()
        args = (*page, tk, vr, T, *bounds, vh, bg, widths, res, v)
        got = scan.multi_scan(*args)
        err = max(err, require_equal(f"K1 edge {what}", got,
                                     scan.multi_scan_plain(*args)))
        report[what] = {"counts": got[1].tolist()}
        if widths is not None or page[0].dtype == torch.int32 == \
                page[1].dtype:
            g = -1 if bg is None else int(bg[0])
            s_args = (*page[:6], tk[0].contiguous(), vr[0].contiguous(), T,
                      *bounds, None if g < 0 else vh[g].contiguous(),
                      widths, res, v)
            got = scan.scan_single(*s_args)
            err = max(err, require_equal(f"K1s edge {what}", got,
                                         scan.scan_single_plain(*s_args)))
            report[what]["single"] = got[1].tolist()
    replay.stop()
    replayed = replay.replay() if dev.type == "cuda" else {}
    usage = k1_usage(build.BUILD_LOG.get("scan", ""))
    spills = {k: v for k, v in usage.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    if spills:
        raise AssertionError(f"K1 builds spill: {spills}")
    print(f"K1 edges: {len(cases)} cases, K1 and K1s each equal to its "
          f"plain version ({replayed.get('K1', 0)} launcher calls replayed "
          f"from 8 threads); {len(usage)} K1 builds in ptxas's report, none "
          "spills, registers "
          f"{sorted({v.get('registers') for v in usage.values()})}",
          flush=True)
    return report, err


def k1_ptxas(row: dict, kv_key, kv_val, widths, terms: bool) -> dict:
    """A K1/K1s row of the kernels line gains the ptxas registers and
    spill bytes (stores + loads) of the build its call launched (None when
    this process built no kernel): ``k1_kernel`` for the row's layouts
    when its request has terms, else the vector build of
    ``k1_cols_kernel``."""
    from tempo_tpu_torch.search.kernels import build
    from tempo_tpu_torch.search.kernels.bench_coalesced import READERS
    from tempo_tpu_torch.search.kernels.bench_scan import k1_usage

    kw, vw = (None, None) if widths is None else widths[:2]
    name = (f"k1_kernel<{READERS[kw or str(kv_key.dtype).split('.')[-1]]}, "
            f"{READERS[vw or str(kv_val.dtype).split('.')[-1]]}>"
            if terms else "k1_cols_kernel<true>")
    usage = {k.replace(" ", ""): v
             for k, v in k1_usage(build.BUILD_LOG.get("scan", "")).items()}
    use = usage.get(name.replace(" ", ""), {})
    row["build"] = name
    row["registers"] = use.get("registers")
    row["spill_bytes"] = (None if "spill_stores" not in use
                          else use["spill_stores"] + use["spill_loads"])
    return row


def k6_edges(dev, seed: int) -> tuple:
    """K6 held exactly against its plain version on the card at the edges
    of its design, each over small batches made from the seed (3 blocks
    of 3,000 traces: a partly filled last page, pad pages to the staged
    power of two), every lane set of ``k6_lanes``: parent cycles (a
    self-parent and an A -> B -> A pair in every trace of 3+ spans); a run
    longer than a tile holds (traces of 3,000 and 1,500 chained spans,
    through the scratch path); a batch without spans; the packed layout;
    probed lanes with bool (unpacked) and word (packed) hit tables; and a
    2-rank mesh's shards (whole span axis with span_trace rebased to the
    rank, and the sharded-span layout). Each case also takes three lane
    sets whose tables are too large for shared memory
    (``tables_in_place``), at 1 and 8 span words: every one of the
    kernel's four builds must have run. Every launcher call is then
    replayed from 8 host threads at once (``LauncherReplay``). Returns
    (report, max abs err)."""
    import numpy as np

    from tempo_tpu_torch.parallel import mesh
    from tempo_tpu_torch.search import structural
    from tempo_tpu_torch.search.kernels import structural as k6
    from tempo_tpu_torch.search.multiblock import (MultiBlockEngine,
                                                   place_batch, shard_host)

    E, n = ENTRIES_PER_PAGE, 3000
    rng = np.random.default_rng([seed, 11])
    long_counts = rng.integers(1, 32, size=n)
    long_counts[:2] = (3000, 1500)
    sets = {
        "cycles": [make_block(seed, b, n, E, spans=True, cycles=True)
                   for b in range(3)],
        "long_run": [make_block(seed, 3, n, E, spans=True,
                                counts=long_counts, cycles=True)],
        "no_spans": [make_block(seed, b, n, E) for b in range(2)],
    }
    if int(long_counts.max()) <= k6.tile_cap(4):
        raise AssertionError("the long runs fit a tile")
    report, err = {}, 0
    replay = LauncherReplay().start()
    for what, blocks, packed, probe in (
            ("cycles", sets["cycles"], False, 0),
            ("long_run", sets["long_run"], False, 0),
            ("no_spans", sets["no_spans"], False, 0),
            ("packed", sets["cycles"], True, 0),
            ("probed bool hits", sets["cycles"], False, 1),
            ("probed word hits", sets["cycles"], True, 1)):
        eng = MultiBlockEngine(dev, device_probe_min_vals=probe,
                               packed=packed,
                               structural_cfg=structural.StructuralConfig(
                                   True))
        batch = place_batch(eng.stage_host(blocks), dev)
        lanes_of = k6_lanes(blocks, batch, packed)
        if probe and not any(lanes.val_hits is not None
                             for lanes in lanes_of.values()):
            raise AssertionError(f"K6 {what}: no lane probed")
        hits, e = k6_check(what, batch.device, batch.span_device,
                           batch.span_max_run, lanes_of, batch.widths, dev)
        err = max(err, e)
        report[what] = {"pages": batch.n_pages,
                        "max_run": batch.span_max_run, "verdicts": hits}
    for shard_spans in (False, True):
        cfg = structural.StructuralConfig(True, shard_spans=shard_spans)
        eng = MultiBlockEngine(dev, structural_cfg=cfg,
                               exchange=mesh.LocalExchange(2))
        host = eng.stage_host(sets["cycles"])
        lanes_of = k6_lanes(sets["cycles"], place_batch(host, dev), False)
        what = "sharded spans" if host.span_sharded else "rebased spans"
        for r in range(2):
            b = place_batch(shard_host(host, r, 2), dev)
            hits, e = k6_check(f"{what} rank {r}", b.device, b.span_device,
                               b.span_max_run, lanes_of, b.widths, dev)
            err = max(err, e)
            report[f"{what} rank {r}"] = {"pages": b.n_pages,
                                          "verdicts": hits}
    replay.stop()
    replayed = replay.replay() if dev.type == "cuda" else {}
    builds = edge_builds(report)
    if dev.type == "cuda" and builds != sorted(k6.VARIANTS):
        raise AssertionError(f"K6 edges ran the builds {builds}, "
                             f"not all of {k6.VARIANTS}")
    print(f"K6 edges: {', '.join(report)}; each lane set (Q = 1, 8, 40, "
          "40 span / 140 trace slots, and three with their tables in "
          "place) equal to its plain version; builds run: "
          f"{builds}; {replayed.get('K6', 0)} launcher calls replayed "
          "from 8 threads", flush=True)
    return report, err


def edge_builds(report: dict) -> list:
    """The K6 builds that ran over ``k6_edges``' report, sorted."""
    return sorted({b for case in report.values()
                   for h in case["verdicts"].values() for b in h["builds"]})


def structural_kernel_phase(db, bsb, launches: dict) -> list:
    """K6 (an exact desc plan, an exact quantile plan, 8 bucketed plans),
    then K1, K4 and K1s with its verdicts, each against its plain version
    on the largest staged batch (K1s: the single-block path's block);
    the fused dispatch against the members' solo ones."""
    import numpy as np
    import torch

    from tempo_tpu_torch.search import ir, structural
    from tempo_tpu_torch.search.engine import (fetch_coalesced_out,
                                               fetch_scan_out, resolve_top_k)
    from tempo_tpu_torch.search.kernels import scan
    from tempo_tpu_torch.search.kernels.bench_coalesced import (k1_bytes,
                                                                k4_bytes)
    from tempo_tpu_torch.search.multiblock import stack_queries
    from tempo_tpu_torch.search.pipeline import compile_query

    eng = db.batcher.engine
    batch = largest_batch(db)
    d = batch.device
    res = d.get("entry_dur_res")
    mq_desc, mq_q = st_compile(db, batch, [ST_PLANS["desc"],
                                           ST_PLANS["quantile"]])
    shape = {"pages": batch.n_pages, "entries": batch.n_pages *
             int(d["kv_key"].shape[1]), "span_axis":
             int(batch.span_device["span_trace"].numel()),
             "spans": int(batch.span_device["entry_span_count"].sum()),
             "max_run": batch.span_max_run, "widths": batch.widths}
    v_desc, err, ms, dev, plain, need, builds = k6_measure(
        db, batch, mq_desc.structural.lanes())
    shape["device_ms"] = dev
    shape["device_source"] = DEVICE_SOURCE
    shape["desc"] = {"verdicts": int(v_desc.sum()), "bytes_needed": need,
                     "builds": builds}
    _v, e2, q_ms, q_dev, q_plain, q_need, q_builds = k6_measure(
        db, batch, mq_q.structural.lanes())
    shape["quantile"] = {"ms": q_ms, "plain_ms": q_plain,
                         "bound_ms": q_need / HBM_BYTES_PER_S * 1e3,
                         "device_ms": q_dev,
                         "verdicts": int(_v.sum()),
                         "bytes_needed": q_need, "builds": q_builds}
    mqs = st_compile(db, batch, ST_BUCKET_PLANS)
    cq = stack_queries(mqs, eng.structural_cfg.bucket_max_nodes)
    if not isinstance(cq.structural, structural.BucketedStructural):
        raise AssertionError("the bucket plans did not stack as a bucket")
    v8, e3, b_ms, b_dev, b_plain, b_need, b_builds = k6_measure(
        db, batch, cq.structural.lanes)
    shape["bucketed"] = {"Q": int(v8.shape[0]), "desc": cq.structural.plan,
                         "ms": b_ms, "plain_ms": b_plain,
                         "bound_ms": b_need / HBM_BYTES_PER_S * 1e3,
                         "device_ms": b_dev,
                         "bytes_needed": b_need, "builds": b_builds}
    shape["out_of_order"], e4 = k6_out_of_order(eng, bsb.staged().pages)
    shape["edges"], e5 = k6_edges(db.device, 20261018)
    k6_row = kernel_row("structural_mask",
                        "tempo_tpu_torch/csrc/structural.cu",
                        "tempo_tpu/search/structural.py:1109", launches,
                        max(err, e2, e3, e4, e5), ms, plain, need, None,
                        shape)
    # the builds each plan ran, and those the edges ran: the kernels line
    # shows them beside K6's numbers
    k6_row["builds"] = {"desc": builds, "quantile": q_builds,
                        "bucketed": b_builds,
                        "edges": edge_builds(shape["edges"])}
    print(f"K6: desc {ms:.4f} ms (bound {need / HBM_BYTES_PER_S * 1e3:.4f}),"
          f" quantile {q_ms:.4f} ms, bucketed Q = {v8.shape[0]} {b_ms:.4f} "
          f"ms; each equal to its plain version; device (median of 20 "
          f"single calls) desc {dev:.4f}, quantile {q_dev:.4f}, bucketed "
          f"{b_dev:.4f} ms", flush=True)

    # K1 with the desc plan's verdicts, as the main path launches it
    page = (d["kv_key"], d["kv_val"], d["entry_start"], d["entry_end"],
            d["entry_dur"], d["entry_valid"], d["page_block"])
    bg = (None if mq_desc.block_group is None
          else torch.from_numpy(mq_desc.block_group).to(db.device))
    args = (*page, torch.from_numpy(mq_desc.term_keys).to(db.device),
            torch.from_numpy(mq_desc.val_ranges).to(db.device),
            mq_desc.n_terms, mq_desc.dur_lo, min(mq_desc.dur_hi, 0xFFFFFFFF),
            mq_desc.win_start, min(mq_desc.win_end, 0xFFFFFFFF))
    vrow = v_desc[0]
    extra = (mq_desc.val_hits, bg, batch.widths, res, vrow)
    s1, c1 = scan.multi_scan(*args, *extra)
    err1 = require_equal("K1 with verdicts", (s1, c1),
                         scan.multi_scan_plain(*args, *extra))
    need1 = k1_bytes(args, s1, mq_desc.val_hits, bg, widths=batch.widths,
                     res=res, verdicts=vrow)
    k1_row_ = k1_ptxas(kernel_row(
        "multi_scan_verdicts", "tempo_tpu_torch/csrc/scan.cu",
        "tempo_tpu/search/multiblock.py:870", launches, err1,
        cuda_ms(lambda: scan.multi_scan(*args, *extra), 50),
        cuda_ms(lambda: scan.multi_scan_plain(*args, *extra), 3), need1,
        None, {"pages": batch.n_pages, "entries": s1.numel(),
               "match_count": int(c1[0]), "inspected": int(c1[1]),
               "bytes_needed": need1},
        lambda: scan.multi_scan(*args, *extra)), d["kv_key"], d["kv_val"],
        batch.widths, mq_desc.n_terms > 0)

    # K4 with the bucketed group's verdicts; fused against solo
    tables = eng.coalesced_tables(cq)
    s4, c4, i4 = scan.coalesced_scan(*page, *tables, batch.widths, res, v8)
    err4 = require_equal("K4 with verdicts", (s4, c4, i4),
                         scan.coalesced_scan_plain(*page, *tables,
                                                   batch.widths, res, v8))
    k = max(resolve_top_k(eng.top_k, mq.limit) for mq in mqs)
    fc, fins, fs, fi = fetch_coalesced_out(
        eng.coalesced_scan_async(batch, cq, k))
    for qi, mq in enumerate(mqs):
        c, ins, so, io = fetch_scan_out(eng.scan_async(batch, mq))
        kq = len(so)
        if (int(fc[qi]), fins) != (c, ins) \
                or not np.array_equal(fs[qi][:kq], so) \
                or not np.array_equal(fi[qi][:kq], io):
            raise AssertionError(f"structural fused member {qi} differs "
                                 "from its solo dispatch")
    need4 = k4_bytes(page, tables, s4, batch.widths, res, v8)
    k4_row = k4_ptxas(kernel_row(
        "coalesced_scan_verdicts", "tempo_tpu_torch/csrc/scan.cu",
        "tempo_tpu/search/multiblock.py:1060", launches, err4,
        cuda_ms(lambda: scan.coalesced_scan(*page, *tables, batch.widths,
                                            res, v8), 50),
        cuda_ms(lambda: scan.coalesced_scan_plain(*page, *tables,
                                                  batch.widths, res, v8), 3),
        need4, None, {"Q": int(s4.shape[0]), "members": cq.n_queries,
                      "entries": int(s4.shape[1]), "counts": c4.tolist(),
                      "bytes_needed": need4, "fused_equals_solo": True},
        lambda: scan.coalesced_scan(*page, *tables, batch.widths, res, v8)),
        page, batch.widths, cq.val_hits)

    # K1s with verdicts on the single-block path's block
    sp = bsb.staged()
    se = bsb.engine()
    pages = sp.pages
    req_tags = st_tag(ST_PLANS["desc"], True)
    from tempo_tpu_torch.model.types import SearchRequest

    cq1 = compile_query(pages.key_dict, pages.val_dict,
                        SearchRequest(tags=req_tags, limit=20),
                        cache_on=pages, cache=se.compile_cache,
                        staged_dict=sp.staged_dict, packed=se.packed)
    st1 = structural.compile_structural(ir.parse(json.dumps(
        ST_PLANS["desc"])), [pages], packed=se.packed)
    vs = se.structural_verdicts(sp, st1.lanes())[0]
    tk, vr = se._tables(cq1)
    sd = sp.device
    cols = (sd["kv_key"], sd["kv_val"], sd["entry_start"], sd["entry_end"],
            sd["entry_dur"], sd["entry_valid"])
    bounds = (cq1.dur_lo, min(cq1.dur_hi, 0xFFFFFFFF), cq1.win_start,
              min(cq1.win_end, 0xFFFFFFFF))
    s_args = (*cols, tk, vr, cq1.n_terms, *bounds, None, sp.widths,
              sd.get("entry_dur_res"), vs)
    ss, sc = scan.scan_single(*s_args)
    errs = require_equal("K1s with verdicts", (ss, sc),
                         scan.scan_single_plain(*s_args))
    P = sd["kv_key"].shape[0]
    as_multi = (*cols, torch.zeros(P, dtype=torch.int32, device=db.device),
                tk[None], vr[None], cq1.n_terms, *bounds)
    needs = k1_bytes(as_multi, ss, single=True, widths=sp.widths,
                     res=sd.get("entry_dur_res"), verdicts=vs)
    k1s_row = k1_ptxas(kernel_row(
        "scan_single_verdicts", "tempo_tpu_torch/csrc/scan.cu",
        "tempo_tpu/search/engine.py:351", launches, errs,
        cuda_ms(lambda: scan.scan_single(*s_args), 50),
        cuda_ms(lambda: scan.scan_single_plain(*s_args), 3), needs, None,
        {"pages": P, "entries": ss.numel(), "match_count": int(sc[0]),
         "bytes_needed": needs}, lambda: scan.scan_single(*s_args)),
        sd["kv_key"], sd["kv_val"], sp.widths, cq1.n_terms > 0)
    return [k6_row, k1_row_, k4_row, k1s_row]


def st_single_paths(db, bsb, tenant: str, reps: int, sync: bool) -> dict:
    """The structural plans, exhaustive and at limit 20, through
    ``TempoDB.search_block`` and ``BackendSearchBlock.search`` on block
    0."""
    from tempo_tpu_torch.model.types import SearchBlockRequest, \
        SearchRequest

    meta = next(m for m in db.blocklist.metas(tenant)
                if m.block_id == block_id(0))
    out = {}
    for name, (tags, kw) in st_requests().items():
        req = SearchRequest(tags=dict(tags), **kw)
        job = SearchBlockRequest(
            search_req=req, tenant_id=tenant, block_id=meta.block_id,
            encoding=meta.encoding, version=meta.version,
            data_encoding=meta.data_encoding, start_time=meta.start_time,
            end_time=meta.end_time)
        out[f"search_block/{name}"] = drive(lambda: db.search_block(job),
                                            reps, sync)
        out[f"single/{name}"] = drive(lambda: bsb.search(req), reps, sync)
    return out


def structural_cell(args, work: str, report: dict, dbs: list,
                    launches: dict) -> list:
    """The structural cell (step 6 of the module docstring). Returns its
    kernel rows."""
    import torch

    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search.backend_search_block import \
        BackendSearchBlock

    n_per = args.st_traces_per_block
    n_total = args.st_blocks * n_per
    root = os.path.join(work, "st_blocks")
    t0 = time.perf_counter()
    nbytes = write_corpus(root, "st", args.st_blocks, n_per,
                          ENTRIES_PER_PAGE, args.seed + 3, spans=True)
    report["st_corpus"] = {"blocks": args.st_blocks, "traces": n_total,
                           "compressed_bytes": nbytes,
                           "write_s": time.perf_counter() - t0}
    print(f"structural corpus: {args.st_blocks} blocks, {n_total} traces "
          f"with 1-31 spans each, {nbytes / 1e6:.1f} MB zlib, "
          f"{report['st_corpus']['write_s']:.1f} s", flush=True)
    be = LocalBackend(root)
    cfg = TempoDBConfig(search_max_batch_pages=4096,
                        search_structural_enabled=True,
                        search_analytics_enabled=True)
    gpu = TempoDB(be, cfg, device="cuda")
    dbs.append(gpu)
    gpu.poll()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reqs = st_requests()
    res = run_queries(gpu, "st", reqs, args.reps)         # the main path
    bsbs = {}

    def bsb_for(meta, device, c=cfg):
        return BackendSearchBlock(be, meta, device=device,
                                  structural_cfg=c.structural())

    meta0 = next(m for m in gpu.blocklist.metas("st")
                 if m.block_id == block_id(0))
    bsbs["gpu"] = bsb_for(meta0, "cuda")
    res.update(st_single_paths(gpu, bsbs["gpu"], "st", args.reps, True))
    path = {}
    for r in res.values():
        add_counts(path, r["launches"])
    require_launched("structural search", path,
                     ("structural_mask", "multi_scan_verdicts",
                      "scan_single_verdicts", "topk"),
                     ("dict_probe",))
    add_counts(launches, path)
    report["st_launches"] = path
    report["st_peak_device_bytes"] = torch.cuda.max_memory_allocated()
    groups = [{"blocks": len(c.batch.blocks), "pages": c.batch.n_pages,
               "bytes": c.nbytes, "span_bytes": c.batch.span_nbytes,
               "span_axis": int(c.batch.span_device["span_trace"].numel()),
               "spans": int(c.batch.span_device["entry_span_count"].sum())}
              for c in gpu.batcher._cache.values()]
    report["st_staged"] = groups
    for g in groups:
        print(f"structural staged group of {g['blocks']} block(s), "
              f"{g['pages']} pages: {g['bytes']} B, of which spans "
              f"{g['span_bytes']} B ({g['spans']} spans on an axis of "
              f"{g['span_axis']}) and the rest {g['bytes'] - g['span_bytes']}"
              " B", flush=True)
    lat = {}
    for name, r in res.items():
        tags, kw = reqs.get(name.split("/")[-1], ({}, {"limit": 20}))
        check_response(name, r["resp"], tags, kw,
                       n_total if name in reqs else n_per)
        lat[name] = latency_row(r, r["resp"])
        lat[name]["dispatches"] = r.get("dispatches")
        print_row(name, lat[name])
    report["st_search"] = lat
    if not any(res[f"st_{n}_exhaustive"]["resp"].traces for n in ST_PLANS):
        raise AssertionError("no structural request matched anything")
    busy = device_busy(gpu, "st", reqs, ("st_desc_exhaustive",
                                         "st_quantile_exhaustive",
                                         "st_child"), args.reps)
    report["st_device_busy"] = busy
    print_busy(busy, lat)

    t0 = time.perf_counter()
    cpu = TempoDB(be, cfg, device="cpu")
    dbs.append(cpu)
    cpu.poll()
    cres = run_queries(cpu, "st", reqs, 0)
    cres.update(st_single_paths(cpu, bsb_for(meta0, "cpu"), "st", 0, False))
    for name in res:
        if cres[name]["resp"] != res[name]["resp"]:
            raise AssertionError(f"{name}: card and CPU responses differ")
    report["st_cpu_check_s"] = time.perf_counter() - t0
    print(f"structural cpu check: {len(res)} responses identical "
          f"({report['st_cpu_check_s']:.1f} s)", flush=True)
    # an ?agg=red request with the desc plan: K6, K1 with its verdicts,
    # then K7 over K1's scores; the card's answer equals the CPU path's
    areq = {"st_desc_agg": (dict(st_tag(ST_PLANS["desc"], False), **AGG),
                            {"limit": 20})}
    ares = run_queries(gpu, "st", areq, args.reps)
    apath = ares["st_desc_agg"]["launches"]
    require_launched("structural agg search", apath,
                     ("structural_mask", "multi_scan_verdicts",
                      "agg_counts"), ())
    add_counts(launches, apath)
    want = run_queries(cpu, "st", areq, 0)["st_desc_agg"]["resp"]
    got = ares["st_desc_agg"]["resp"]
    if got != want or not got.metrics.agg_json:
        raise AssertionError("st_desc_agg: card and CPU responses differ")
    report["st_agg"] = latency_row(ares["st_desc_agg"], got)
    print_row("st_desc_agg", report["st_agg"])
    STAGED["st"] = {"gpu": gpu, "cpu": cpu, "reqs": reqs, "tenant": "st"}
    del cres
    gc.collect()

    rows = structural_kernel_phase(gpu, bsbs["gpu"], launches)

    # concurrency: 8 clients, 8 plans of one bucket; stacking and
    # bucketing on (a second database over the same blocks) and off
    stacked = TempoDB(be, TempoDBConfig(
        search_max_batch_pages=4096, search_structural_enabled=True,
        search_structural_stack_enabled=True,
        search_structural_bucket_enabled=True), device="cuda")
    dbs.append(stacked)
    stacked.poll()
    creqs = [(st_tag(p, True), {"limit": 20}) for p in ST_BUCKET_PLANS]
    serial = [canon(gpu.search("st", SearchRequest(tags=dict(t),
                                                   **kw)).response())
              for t, kw in creqs]
    conc = {}
    for label, db in (("stacked_bucketed", stacked), ("solo", gpu)):
        st0 = db.batcher.coalescer.stats()
        row = concurrent_rounds(db, "st", creqs, args.rounds, serial)
        st1 = db.batcher.coalescer.stats()
        for k in ("structural_queries", "structural_stacked",
                  "structural_bucketed"):
            row["coalesce"][k] = st1[k] - st0[k]
        add_counts(launches, row["launches"])
        conc[label] = row
        print(f"concurrent structural ({label}): round p50 "
              f"{row['round_p50_ms']:.3f} ms, p95 {row['round_p95_ms']:.3f} "
              f"ms; request p50 {row['lat_p50_ms']:.3f} ms, p95 "
              f"{row['lat_p95_ms']:.3f} ms; launches "
              f"{json.dumps(row['launches'])}; coalescer "
              f"{json.dumps(row['coalesce'])}", flush=True)
    report["st_concurrent"] = conc
    co = conc["stacked_bucketed"]
    require_fusion(co, "coalesced_scan_verdicts")
    if not co["coalesce"]["structural_bucketed"]:
        raise AssertionError(f"no bucketed fusion: {co['coalesce']}")
    if conc["solo"]["coalesce"]["structural_stacked"]:
        raise AssertionError("stacking off, but structural queries fused")
    stacked.close()
    dbs.remove(stacked)

    # packed: the first blocks, an unpacked and a packed database
    k = min(args.st_packed_blocks, args.st_blocks)
    root4 = os.path.join(work, "st4_blocks")
    write_corpus(root4, "st4", k, n_per, ENTRIES_PER_PAGE, args.seed + 3,
                 spans=True)
    both = {}
    for label, packed in (("unpacked", False), ("packed", True)):
        db = TempoDB(LocalBackend(root4), TempoDBConfig(
            search_max_batch_pages=4096, search_structural_enabled=True,
            search_packed_residency=packed), device="cuda")
        dbs.append(db)
        db.poll()
        both[label] = (db, run_queries(db, "st4", reqs, 0))
    ppath = {}
    for r in both["packed"][1].values():
        add_counts(ppath, r["launches"])
    require_launched("packed structural search", ppath,
                     ("structural_mask", "multi_scan_verdicts"), ())
    add_counts(launches, ppath)
    same_responses("packed structural search", both["packed"][1],
                   both["unpacked"][1])
    report["st_packed"] = {
        "blocks": k, "launches": ppath,
        "staged": staged_bytes("structural", both["unpacked"][0],
                               both["packed"][0])}
    for label in both:
        both[label][0].close()
        dbs.remove(both[label][0])
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the RED cell (?agg=red aggregates, kernels K7 and K8)

AGG = {"x-agg-q": "red"}        # the tag analytics.attach_agg(req, "red") sets
RED_TENANT = "red"
AGG_PACKED_BLOCKS = 64          # blocks of the RED corpus in its packed phase


def red_requests(blocks: int) -> dict:
    """The RED cell's requests, in the order they run: five ask for the
    aggregate, the last is red_svc's plain twin. red_all (a whole-tenant
    RED panel) runs first and stages every group."""
    mid = BASE_S + (blocks // 2) * BLOCK_SPAN_S
    svc = {"service.name": "svc-007"}
    return {
        "red_all": (dict(AGG), {"limit": 20}),
        "red_svc": (dict(AGG, **svc), {"limit": 20}),
        "red_slow": (dict(AGG), {"min_duration_ms": 1000, "limit": 20}),
        "red_500_window": (dict(AGG, **{"http.status_code": "500"}),
                           {"start": BASE_S, "end": mid, "limit": 20}),
        "red_all_limit_1": (dict(AGG), {"limit": 1}),
        "red_svc_plain": (dict(svc), {"limit": 20}),
    }


def corpus_blocks(db) -> list:
    """The containers of every block staged by `db`, each once."""
    out = {}
    for c in db.batcher._cache.values():
        for b in c.batch.blocks:
            out[id(b)] = b
    return list(out.values())


def red_host_series(blocks: list) -> dict:
    """red_all's series computed on the host with numpy alone, from the
    containers: per root service name ("" for none), calls, the traces
    carrying the exact pair error=true, and the bisect_left bins of the
    duration on MS_BUCKETS."""
    import numpy as np

    from tempo_tpu_torch.search.analytics import MS_BUCKETS

    nb1 = len(MS_BUCKETS) + 1
    acc: dict = {}
    for b in blocks:
        v = b.entry_valid
        names = list(b.val_dict) + [""]            # id -1 -> ""
        svc = np.where(b.entry_root_svc[v] < 0, len(b.val_dict),
                       b.entry_root_svc[v])
        bins = np.searchsorted(np.asarray(MS_BUCKETS),
                               b.entry_dur[v].astype(np.int64), side="left")
        kid = b.key_dict.index("error")
        vid = b.val_dict.index("true")
        err = ((b.kv_key == kid) & (b.kv_val == vid)).any(-1)[v]
        ids, inv = np.unique(svc, return_inverse=True)
        hist = np.bincount(inv * nb1 + bins, minlength=len(ids) * nb1
                           ).reshape(len(ids), nb1)
        errs = np.bincount(inv, weights=err, minlength=len(ids))
        for j, i in enumerate(ids.tolist()):
            d = acc.setdefault(names[i], {"calls": 0, "errors": 0,
                                          "hist": [0] * nb1})
            d["calls"] += int(hist[j].sum())
            d["errors"] += int(errs[j])
            d["hist"] = [x + int(y) for x, y in zip(d["hist"], hist[j])]
    return acc


def red_ingest_batches(blocks: list, seed: int) -> dict:
    """Two micro-batches of the ingest side's count made from the
    corpus's traces: 8,192 rows by root service (64 series) and
    1,048,576 rows by (service, operation, status 500 or not) (4,096
    series; fewer where the corpus is smaller); durations in
    nanoseconds (ms x 1e6 plus a seeded sub-millisecond part, the first
    rows on every threshold and one either side of it). "services" /
    "operations" -> (series ids int32, durations int64, n_keys)."""
    import numpy as np

    from tempo_tpu_torch.search.analytics import (LATENCY_BUCKETS_S,
                                                  _dur_thresholds_full)

    rng = np.random.default_rng([seed, 8])
    want = min(1_048_576, sum(int(b.entry_valid.sum()) for b in blocks))
    cols = {k: [] for k in ("svc", "name", "s500", "dur")}
    have = 0
    for b in blocks:
        v = b.entry_valid
        for col, key, vals in (("svc", "service.name",
                                KEYS["service.name"]),
                               ("name", "name", KEYS["name"]),
                               ("s500", "http.status_code", ["500"])):
            kid = b.key_dict.index(key)
            slot = int(np.flatnonzero(b.kv_key[0, 0] == kid)[0])
            lut = np.full(len(b.val_dict) + 1, -1, dtype=np.int64)
            for i, x in enumerate(vals):
                lut[b.val_dict.index(x)] = i
            cols[col].append(lut[b.kv_val[:, :, slot][v]])
        cols["dur"].append(b.entry_dur[v].astype(np.int64) * 1_000_000)
        have += int(v.sum())
        if have >= want:
            break
    c = {k: np.concatenate(x)[:want] for k, x in cols.items()}
    dur = c["dur"] + rng.integers(0, 1_000_000, size=want)
    edges = np.asarray([t + d for t in
                        _dur_thresholds_full(LATENCY_BUCKETS_S)
                        for d in (-1, 0, 1)], dtype=np.int64)
    dur[:edges.size] = edges
    s500 = (c["s500"] == 0).astype(np.int64)
    return {"services": (c["svc"][:8192].astype(np.int32),
                         dur[:8192].copy(), 64),
            "operations": (((c["svc"] * 32 + c["name"]) * 2 + s500)
                           .astype(np.int32), dur, 4096)}


def host_dense_counts(sidx, dur, n_keys: int):
    """The ingest count on the host: bisect by the whole-nanosecond
    thresholds, bincount the composite keys."""
    import numpy as np

    from tempo_tpu_torch.search.analytics import (LATENCY_BUCKETS_S,
                                                  _dur_thresholds_full)

    thr = np.asarray(_dur_thresholds_full(LATENCY_BUCKETS_S), dtype=np.int64)
    b = np.searchsorted(thr, dur, side="right")
    K = n_keys * (thr.size + 1)
    return np.bincount(sidx.astype(np.int64) * (thr.size + 1) + b,
                       minlength=K)[:K]


def red_scores(db, batch, reqs: list):
    """The score rows K1 (one request) or K4 (several) write over `batch`
    for (tags, fields) requests compiled as the engine compiles them."""
    import torch

    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search.kernels import scan
    from tempo_tpu_torch.search.multiblock import compile_multi, \
        stack_queries

    eng = db.batcher.engine
    d = batch.device
    mqs = [compile_multi(list(batch.blocks),
                         SearchRequest(tags=dict(t), **kw), memo=batch.memo,
                         cache=eng.compile_cache,
                         staged_dicts=batch.staged_dicts, packed=eng.packed)
           for t, kw in reqs]
    page = (d["kv_key"], d["kv_val"], d["entry_start"], d["entry_end"],
            d["entry_dur"], d["entry_valid"], d["page_block"])
    layout = (batch.widths, d.get("entry_dur_res"))
    if len(mqs) == 1:
        mq = mqs[0]
        bg = (None if mq.block_group is None
              else torch.from_numpy(mq.block_group).to(db.device))
        scores, _c = scan.multi_scan(
            *page, torch.from_numpy(mq.term_keys).to(db.device),
            torch.from_numpy(mq.val_ranges).to(db.device), mq.n_terms,
            mq.dur_lo, min(mq.dur_hi, 0xFFFFFFFF), mq.win_start,
            min(mq.win_end, 0xFFFFFFFF), mq.val_hits, bg, *layout)
        return scores
    cq = stack_queries(mqs)
    scores, _c, _i = scan.coalesced_scan(*page, *eng.coalesced_tables(cq),
                                         *layout)
    return scores


def k7_measure(label: str, scores, keys, K: int) -> dict:
    """K7 on score rows [Q, N] against its plain version, its CUDA-event
    time, the plain version's and torch.bincount's (``bench_agg.
    k7_library``: one call for all rows with a row offset), and its bound
    (``bench_agg.k7_bytes``: the score rows read, the keys of the entries
    some row accepts (32-byte sectors) and the counts written)."""
    import torch

    from tempo_tpu_torch.search.kernels import agg
    from tempo_tpu_torch.search.kernels.bench_agg import (k7_bytes,
                                                          k7_library)

    Q, n = scores.shape
    if Q == 1:
        def fn():
            return agg.agg_counts(scores[0], keys, K)[None]
    else:
        def fn():
            return agg.agg_counts_rows(scores, keys, K)
    out = fn()
    err = require_equal(f"K7 ({label})", (out,),
                        (agg.agg_counts_rows_plain(scores, keys, K),))

    def lib():
        return k7_library(scores, keys, K)

    if not torch.equal(lib(), out):
        raise AssertionError(f"K7 ({label}) differs from torch.bincount")
    need = k7_bytes(scores, keys, K)
    return {"fn": fn, "err": err, "ms": cuda_ms(fn, 50),
            "plain_ms": cuda_ms(
                lambda: agg.agg_counts_rows_plain(scores, keys, K), 5),
            "library_ms": cuda_ms(lib, 50), "bytes_needed": need,
            "bound_ms": need / HBM_BYTES_PER_S * 1e3,
            "shape": {"Q": Q, "N": n, "K": K,
                      "route": agg.route(K), "counted": int(out.sum())}}


def k8_measure(label: str, sidx, dur, n_keys: int, device) -> dict:
    """K8 on one micro-batch against its plain version and the host's
    count, its CUDA-event time, the plain version's and torch.bucketize +
    torch.bincount's (``bench_agg.k8_library``), and its bound: series ids
    and durations read, counts written (the thresholds ride in the
    launch's parameters)."""
    import numpy as np
    import torch

    from tempo_tpu_torch.search.analytics import (LATENCY_BUCKETS_S,
                                                  thresholds_tensor)
    from tempo_tpu_torch.search.kernels import agg
    from tempo_tpu_torch.search.kernels.bench_agg import k8_library

    thr = thresholds_tensor(LATENCY_BUCKETS_S, torch.device("cpu"))
    thr_dev = thresholds_tensor(LATENCY_BUCKETS_S, device)
    s = torch.from_numpy(sidx).to(device)
    d = torch.from_numpy(dur).to(device)
    K = n_keys * (thr.numel() + 1)

    def fn():
        return agg.analytics_count(s, d, thr, n_keys)

    out = fn()
    err = require_equal(f"K8 ({label})", (out,),
                        (agg.analytics_count_plain(s, d, thr, n_keys),))

    def lib():
        return k8_library(s, d, thr_dev, n_keys)

    if not np.array_equal(out.cpu().numpy(),
                          host_dense_counts(sidx, dur, n_keys)) \
            or not torch.equal(lib(), out):
        raise AssertionError(f"K8 ({label}) differs from the host's count "
                             "or torch.bincount")
    need = s.numel() * 12 + K * 4
    return {"fn": fn, "err": err, "ms": cuda_ms(fn, 50),
            "plain_ms": cuda_ms(
                lambda: agg.analytics_count_plain(s, d, thr, n_keys), 5),
            "library_ms": cuda_ms(lib, 50), "bytes_needed": need,
            "bound_ms": need / HBM_BYTES_PER_S * 1e3,
            "shape": {"rows": s.numel(), "series": n_keys, "K": K,
                      "route": agg.count_route(K)}}


def k8_edges(dev, seed: int) -> tuple:
    """K8 held exactly against its plain version and torch.bincount on the
    card, through its public wrapper, at the edges of its design: the
    seeded cases the CPU tests hold its rule to (``bench_agg.K8_CASES``):
    n = 0, 1, 3, 2,053, 4,097 and 4,096 x 5 + 3; series ids and durations
    off a 16-byte boundary, in phase with each other and not; K = 15, 960,
    61,440, either side of the CTA route's limit and far past it; series
    ids past n_keys and negative; durations on every threshold and one
    either side, 0 and 2^62 - 1 up to 2^63 - 1; one hot bin on both
    routes. Every launcher call is then
    replayed from 8 host threads at once (``LauncherReplay``), and no
    ``agg.cu`` build may spill in ptxas's report of the library loaded.
    Returns (report, max abs err)."""
    import torch

    from tempo_tpu_torch.search.kernels import agg, build
    from tempo_tpu_torch.search.kernels.bench_agg import (K8_CASES, k8_case,
                                                          k8_library)
    from tempo_tpu_torch.search.kernels.bench_coalesced import ptxas_usage

    report, err = {}, 0
    replay = LauncherReplay().start()
    for name in K8_CASES:
        s, d, thr, n_keys, _b = k8_case(seed, name, dev)
        got = agg.analytics_count(s, d, thr, n_keys)
        want = agg.analytics_count_plain(s, d, thr, n_keys)
        err = max(err, require_equal(f"K8 edge {name}", (got,), (want,)))
        if not torch.equal(k8_library(s, d, thr.to(dev), n_keys), got):
            raise AssertionError(f"K8 edge {name} differs from "
                                 "torch.bincount")
        K = got.numel()
        report[name] = {"n": s.numel(), "K": K, "route": agg.count_route(K),
                        "counted": int(got.sum())}
    replay.stop()
    replayed = replay.replay() if dev.type == "cuda" else {}
    usage = ptxas_usage(build.BUILD_LOG.get("agg", ""))
    if dev.type == "cuda" and not any("count_kernel" in k for k in usage):
        raise AssertionError("K8 edges: no ptxas report of count_kernel in "
                             "the loaded agg.cu library")
    spills = {k: v for k, v in usage.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    if spills:
        raise AssertionError(f"agg.cu builds spill: {spills}")
    routes = sorted({r["route"] for r in report.values()})
    print(f"K8 edges: {len(report)} cases ({', '.join(routes)} routes), "
          f"each equal to its plain version and torch.bincount "
          f"({replayed.get('K8', 0)} launcher calls replayed from 8 "
          f"threads); {len(usage)} agg.cu builds in ptxas's report, none "
          "spills", flush=True)
    return report, err


def k7_edges(dev, seed: int) -> tuple:
    """K7 held exactly against its plain version and torch.bincount on the
    card, through its wrappers, at the edges of its design: the seeded
    cases the CPU tests hold its rule to (``bench_agg.K7_CASES``): N = 0,
    1, 3, 2,053, 4,095 and 4,096 k + 1; score rows and keys starting off a
    16-byte boundary, in phase with each other and not; K = 1, 33, 30,720
    and either side of the shared route's limit; keys past K and
    negative; all rejected, all accepted, ~90% and red_svc's
    ~10% accepted; one hot bin on both routes; [8, N] rows at odd phases,
    [3, N] from element 1, 200 rows of 64 (more rows than CTAs). Every
    launcher call is then replayed from 8 host threads at once
    (``LauncherReplay``), and no ``agg.cu`` build (K8's included) may
    spill in ptxas's report of the library loaded (this process's build or
    the cached one's saved log). Returns (report, max abs err)."""
    import torch

    from tempo_tpu_torch.search.kernels import agg, build
    from tempo_tpu_torch.search.kernels.bench_agg import (K7_CASES, k7_case,
                                                          k7_library)
    from tempo_tpu_torch.search.kernels.bench_coalesced import ptxas_usage

    report, err = {}, 0
    replay = LauncherReplay().start()
    for name in K7_CASES:
        scores, keys, K = k7_case(seed, name, dev)
        Q, n = scores.shape
        got = (agg.agg_counts(scores[0], keys, K)[None] if Q == 1
               else agg.agg_counts_rows(scores, keys, K))
        err = max(err, require_equal(
            f"K7 edge {name}", (got,),
            (agg.agg_counts_rows_plain(scores, keys, K),)))
        if not torch.equal(k7_library(scores, keys, K), got):
            raise AssertionError(f"K7 edge {name} differs from "
                                 "torch.bincount")
        report[name] = {"Q": Q, "N": n, "K": K, "route": agg.route(K),
                        "counted": int(got.sum())}
    replay.stop()
    replayed = replay.replay() if dev.type == "cuda" else {}
    usage = ptxas_usage(build.BUILD_LOG.get("agg", ""))
    if dev.type == "cuda" and not usage:
        raise AssertionError("K7 edges: no ptxas report of the loaded "
                             "agg.cu library")
    spills = {k: v for k, v in usage.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    if spills:
        raise AssertionError(f"agg.cu builds spill: {spills}")
    print(f"K7 edges: {len(report)} cases, each equal to its plain version "
          f"and torch.bincount ({replayed.get('K7', 0)} launcher calls "
          f"replayed from 8 threads); {len(usage)} agg.cu builds in ptxas's "
          "report, none spills, registers "
          f"{sorted({v.get('registers') for v in usage.values()})}",
          flush=True)
    return report, err


def red_kernel_phase(db, ingest: dict, launches: dict) -> list:
    """K7 and K8 against their plain versions on the card, timed, with
    bound and library times: K7 over red_all's K1 scores on the largest
    staged group ([1, N], K = 3,840 at full size), over the same scores
    with keys spread to 1,024 services (K = 30,720, still in shared
    memory) and to 2,048 (K = 61,440, the global route), and over
    K4's rows of 8 svc-00i requests ([8, N]); the device operations of
    one K7 call (the profiler: one ``agg_kernel`` launch and nothing
    else, no zeroing memset); K7 at its edges (``k7_edges``); K8 on the
    two ingest micro-batches (K = 960, one CTA's shared memory; K =
    61,440, global atomics), one call of each one
    ``count_kernel`` launch and nothing else (the profiler), and K8 at its
    edges (``k8_edges``)."""
    import torch

    from tempo_tpu_torch.search.kernels.bench_agg import spread_keys

    batch = largest_batch(db)
    stage = batch.agg_stage
    keys = stage.device(db.device).reshape(-1)
    K = stage.n_keys
    s1 = red_scores(db, batch, [({}, {"limit": 20})])[None]
    one = k7_measure("[1, N]", s1, keys, K)
    k30 = k7_measure("[1, N], 1,024 services", s1, spread_keys(keys, 1024),
                     1024 * 30)
    glob = k7_measure("[1, N], 2,048 services", s1, spread_keys(keys, 2048),
                      2048 * 30)
    s8 = red_scores(db, batch, [({"service.name": f"svc-00{i}"},
                                 {"limit": 20}) for i in range(CLIENTS)])
    rows8 = k7_measure("[8, N]", s8, keys, K)
    k8 = {name: k8_measure(name, sidx, dur, nk, db.device)
          for name, (sidx, dur, nk) in ingest.items()}
    if not (one["shape"]["route"] == rows8["shape"]["route"]
            == k30["shape"]["route"] == "shared"
            and glob["shape"]["route"] == "global"
            and k8["services"]["shape"]["route"] == "cta"
            and k8["operations"]["shape"]["route"] == "global"):
        raise AssertionError("the kernel phases missed a route of K7 or K8")
    # the profiler may keep fewer records than calls (C1), never more:
    # each kept record must be the kernel, at most one a call
    per_call = kernels_per_call(one["fn"])
    if per_call and (sum(per_call.values()) > 1
                     or not all("agg_kernel" in k for k in per_call)):
        raise AssertionError(f"a K7 call ran {per_call} on the card, not "
                             "one agg_kernel launch")
    one["shape"]["per_call"] = per_call or "not measured (no profile)"
    print(f"K7 per call on the card (profiler): {one['shape']['per_call']}",
          flush=True)
    one["shape"]["edges"], e = k7_edges(db.device, 20261018)
    one["err"] = max(one["err"], e)
    # one K8 call: the count kernel alone, no memset, on either route
    for m in k8.values():
        per_call = kernels_per_call(m["fn"])
        if per_call and (sum(per_call.values()) > 1
                         or not all("count_kernel" in k for k in per_call)):
            raise AssertionError(f"a K8 call ran {per_call} on the card, "
                                 "not one count_kernel launch")
        m["shape"]["per_call"] = per_call or "not measured (no profile)"
    print("K8 per call on the card (profiler): "
          + "; ".join(f"{k} {m['shape']['per_call']}" for k, m in k8.items()),
          flush=True)
    k8["operations"]["shape"]["edges"], e = k8_edges(db.device, 20261018)
    k8["operations"]["err"] = max(k8["operations"]["err"], e)
    for label, m in (("K7 [1, N]", one), ("K7 1,024 services", k30),
                     ("K7 2,048 services", glob),
                     ("K7 [8, N]", rows8)) + tuple(
            (f"K8 {k}", v) for k, v in k8.items()):
        shape = {k: v for k, v in m["shape"].items() if k != "edges"}
        print(f"{label}: {shape}, equal to its plain version; "
              f"{m['ms']:.4f} ms, bound {m['bound_ms']:.4f} ms, plain "
              f"{m['plain_ms']:.3f} ms, library {m['library_ms']:.4f} ms",
              flush=True)

    def row(name, m, *also):
        from tempo_tpu_torch.search.kernels.bench_structural import event_ms

        shape = dict(m["shape"], bytes_needed=m["bytes_needed"])
        err = m["err"]
        for label, a in also:
            shape[label] = {k: a[k] for k in ("ms", "plain_ms",
                                              "library_ms", "bound_ms",
                                              "bytes_needed", "shape")}
            shape[label]["device_ms"] = event_ms(a["fn"])
            err = max(err, a["err"])
        return kernel_row(name, "tempo_tpu_torch/csrc/agg.cu",
                          ("tempo_tpu/search/multiblock.py:838"
                           if name.startswith("agg") else
                           "tempo_tpu/search/analytics.py:123"),
                          launches, err, m["ms"], m["plain_ms"],
                          m["bytes_needed"], m["library_ms"], shape, m["fn"])

    return [row("agg_counts", one, ("services_1024", k30),
                ("global_route", glob)),
            row("agg_counts_rows", rows8),
            row("analytics_count", k8["operations"],
                ("cta_route", k8["services"]))]


def red_cell(args, work: str, report: dict, dbs: list,
             launches: dict) -> list:
    """The RED cell (step 7 of the module docstring). Returns its kernel
    rows."""
    import numpy as np
    import torch

    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.model.types import (BlockSearchJob, SearchRequest,
                                             SearchBlocksRequest)
    from tempo_tpu_torch.search import analytics, batcher

    n_per = args.traces_per_block
    n_total = args.agg_blocks * n_per
    reqs = red_requests(args.agg_blocks)
    root = os.path.join(work, "red_blocks")
    t0 = time.perf_counter()
    nbytes = write_corpus(root, RED_TENANT, args.agg_blocks, n_per,
                          ENTRIES_PER_PAGE, args.seed + 5, red=True)
    report["red_corpus"] = {"blocks": args.agg_blocks, "traces": n_total,
                            "compressed_bytes": nbytes,
                            "write_s": time.perf_counter() - t0}
    print(f"RED corpus: {args.agg_blocks} blocks, {n_total} traces, "
          f"{nbytes / 1e6:.1f} MB zlib, "
          f"{report['red_corpus']['write_s']:.1f} s", flush=True)
    be = LocalBackend(root)
    cfg = TempoDBConfig(search_max_batch_pages=4096,
                        search_analytics_enabled=True)
    gpu = TempoDB(be, cfg, device="cuda")
    dbs.append(gpu)
    gpu.poll()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    res = run_queries(gpu, RED_TENANT, reqs, args.reps)   # the main path
    path = {}
    for r in res.values():
        add_counts(path, r["launches"])
    require_launched("RED search", path, ("multi_scan", "agg_counts",
                                          "topk"), ("dict_probe",))
    add_counts(launches, path)
    report["red_launches"] = path
    report["red_peak_device_bytes"] = torch.cuda.max_memory_allocated()
    report["red_staged"] = gpu.batcher.debug_stats()["cache"]
    lat = {}
    for name, r in res.items():
        tags, kw = reqs[name]
        check_response(name, r["resp"], tags, kw, n_total, rootless=True)
        lat[name] = latency_row(r, r["resp"])
        print_row(name, lat[name])
    report["red_search"] = lat
    blocks = corpus_blocks(gpu)
    agg = {n: r["resp"].metrics.agg_json for n, r in res.items()}
    want = json.dumps(analytics.agg_response(red_host_series(blocks)),
                      sort_keys=True)
    if agg["red_all"] != want or agg["red_all_limit_1"] != want \
            or len(res["red_all_limit_1"]["resp"].traces) != 1 \
            or agg["red_svc_plain"] != "" \
            or not all(agg[n] for n in reqs if n != "red_svc_plain"):
        raise AssertionError("RED: an aggregate differs from the host's "
                             "count, or limit 1's from limit 20's")
    series = json.loads(agg["red_all"])["series"]
    groups = [len(c.batch.blocks) for c in gpu.batcher._cache.values()]
    errors = sum(s["errors"] for s in series.values())
    print(f"RED groups: {groups} blocks; red_all = the host's count over "
          f"{len(blocks)} blocks ({len(series)} series, {errors} errors, "
          f"'' series {series.get('', {}).get('calls')} calls); limit 1 "
          f"gives the same aggregate; staged "
          f"{json.dumps(report['red_staged'])}", flush=True)
    busy = device_busy(gpu, RED_TENANT, reqs, ("red_all", "red_svc",
                                               "red_svc_plain"), args.reps)
    report["red_device_busy"] = busy
    print_busy(busy, lat)

    # the ingest side's count on its micro-batches (K8's main path)
    ingest = red_ingest_batches(blocks, args.seed)
    reset_counts()
    for name, (sidx, dur, nk) in ingest.items():
        got = analytics.dense_counts(sidx, dur, nk, device=gpu.device)
        if not np.array_equal(got, host_dense_counts(sidx, dur, nk)):
            raise AssertionError(f"dense_counts {name} differs from the "
                                 "host's count")
    ipath = read_counts()
    require_launched("ingest count", ipath, ("analytics_count",), ())
    add_counts(launches, ipath)
    print(f"ingest count: {', '.join(ingest)} equal to the host's count; "
          f"launches {json.dumps(ipath)}", flush=True)

    t0 = time.perf_counter()
    cpu = TempoDB(be, cfg, device="cpu")
    dbs.append(cpu)
    cpu.poll()
    cres = run_queries(cpu, RED_TENANT, reqs, 0)
    for name in reqs:
        if cres[name]["resp"] != res[name]["resp"]:
            raise AssertionError(f"{name}: card and CPU responses differ")
    report["red_cpu_check_s"] = time.perf_counter() - t0
    print(f"RED cpu check: {len(reqs)} responses identical "
          f"({report['red_cpu_check_s']:.1f} s)", flush=True)
    STAGED["red"] = {"gpu": gpu, "cpu": cpu, "reqs": reqs,
                     "tenant": RED_TENANT}
    del cres
    gc.collect()

    rows = red_kernel_phase(gpu, ingest, launches)
    del ingest

    # packed: the first blocks through search_blocks, a packed database
    # against the unpacked one
    k = min(AGG_PACKED_BLOCKS, args.agg_blocks)
    metas = sorted(gpu.blocklist.metas(RED_TENANT),
                   key=lambda m: m.block_id)[:k]
    jobs = [BlockSearchJob(block_id=m.block_id, encoding=m.encoding,
                           version=m.version, data_encoding=m.data_encoding,
                           start_time=m.start_time, end_time=m.end_time)
            for m in metas]
    packed = TempoDB(be, TempoDBConfig(search_max_batch_pages=4096,
                                       search_analytics_enabled=True,
                                       search_packed_residency=True),
                     device="cuda")
    dbs.append(packed)
    packed.poll()
    ppath, plat = {}, {}
    for name, (tags, kw) in reqs.items():
        breq = SearchBlocksRequest(
            search_req=SearchRequest(tags=dict(tags), **kw),
            tenant_id=RED_TENANT, jobs=jobs)
        want = canon(gpu.search_blocks(breq).response())
        r = drive(lambda: packed.search_blocks(breq), args.reps, True)
        if r["resp"] != want:
            raise AssertionError(f"packed {name}: the packed database's "
                                 "response differs from the unpacked one's")
        add_counts(ppath, r["launches"])
        plat[name] = latency_row(r, r["resp"])
        print_row(f"packed {k} blocks {name}", plat[name])
    require_launched("packed RED search", ppath,
                     ("multi_scan_packed", "agg_counts"), ("multi_scan",))
    add_counts(launches, ppath)
    report["red_packed"] = {"blocks": k, "launches": ppath, "search": plat,
                            "staged": packed.batcher.debug_stats()["cache"]}
    print(f"packed RED search: {len(reqs)} responses over {k} blocks equal "
          f"the unpacked database's; staged "
          f"{json.dumps(report['red_packed']['staged'])}", flush=True)
    packed.close()
    dbs.remove(packed)

    # 8 clients: svc-00i with the aggregate, then 4 agg + 4 plain; agg
    # members never share a fused dispatch with plain ones
    serial = TempoDB(be, TempoDBConfig(search_max_batch_pages=4096,
                                       search_analytics_enabled=True,
                                       search_coalesce_max_queries=1),
                     device="cuda")
    dbs.append(serial)
    serial.poll()
    serial.search(RED_TENANT, SearchRequest(tags=dict(AGG), limit=20))
    svc = [{"service.name": f"svc-00{i}"} for i in range(CLIENTS)]
    mixed = []
    real_stack = batcher.stack_queries

    def spy(mqs, *a):
        mixed.append(sorted({mq.agg_stage is not None for mq in mqs}))
        return real_stack(mqs, *a)

    batcher.stack_queries = spy
    try:
        conc = concurrent_phase(
            "RED", gpu, serial, RED_TENANT,
            {"svc_agg": [(dict(t, **AGG), {"limit": 20}) for t in svc],
             "mixed": [(dict(t, **AGG) if i % 2 else dict(t),
                        {"limit": 20}) for i, t in enumerate(svc)]},
            args.rounds, launches)
    finally:
        batcher.stack_queries = real_stack
    report["red_concurrent"] = conc
    require_fusion(conc["svc_agg/coalescing"], "agg_counts_rows")
    if any(len(m) != 1 for m in mixed) or [True] not in mixed:
        raise AssertionError(f"a fused RED dispatch mixed agg and plain "
                             f"members, or none fused: {mixed}")
    print(f"RED fused dispatches: {len(mixed)}, each all agg or all plain",
          flush=True)
    serial.close()
    dbs.remove(serial)
    gc.collect()
    torch.cuda.empty_cache()
    return rows


LIVE_TENANT = "live"
LIVE_BASE_S = BASE_S + 86_400   # live traces start a day after the corpora
LIVE_PER_S = 64                 # live traces a second, one push batch
LIVE_BATCH = 64                 # traces per push micro-batch


def live_tid(j: int) -> bytes:
    """Trace j's id: an odd multiplier mod 2^128 is a bijection, so ids
    are distinct and their order is not arrival order."""
    return (j * 0x9E3779B97F4A7C15F39CC0605CEDC835 % (1 << 128)).to_bytes(
        16, "big")


def trace_data(seed: int, first: int, n: int, spans: bool) -> list:
    """(trace id, SearchData) of traces first .. first+n-1 from the seed:
    the tag cell's 8 tags, one value each (2,135 values over the keys),
    root service and name from the tags, LIVE_PER_S traces a second from
    LIVE_BASE_S, durations 1-59,999 ms; with `spans`, 1-31 span rows as
    ``span_segment`` makes them (span 0 the root, each later span's
    parent an earlier one or, 1 in 20, none; service.name, name op-0..
    op-15, http.status_code; 1-2,000 ms; kind 0-5)."""
    import numpy as np

    from tempo_tpu_torch.search.data import SearchData, SpanData

    rng = np.random.default_rng([seed, first, n])
    keys = sorted(KEYS)
    pick = {k: rng.integers(0, len(KEYS[k]), size=n).tolist() for k in keys}
    dur = rng.integers(1, 60_000, size=n).tolist()
    n_spans = rng.integers(1, 32, size=n).tolist() if spans else [0] * n
    out = []
    for i in range(n):
        j = first + i
        kvs = {k: {KEYS[k][pick[k][i]]} for k in keys}
        start = LIVE_BASE_S + j // LIVE_PER_S
        sd = SearchData(trace_id=live_tid(j), start_s=start,
                        end_s=start + dur[i] // 1000, dur_ms=dur[i],
                        root_service=KEYS["service.name"][
                            pick["service.name"][i]],
                        root_name=KEYS["name"][pick["name"][i]], kvs=kvs)
        c = n_spans[i]
        if c:
            par = rng.random(c)
            lost = rng.random(c) < 0.05
            svc = rng.integers(0, len(KEYS["service.name"]), size=c)
            op = rng.integers(0, len(SPAN_OPS), size=c)
            code = rng.integers(0, len(KEYS["http.status_code"]), size=c)
            sdur = rng.integers(1, 2001, size=c)
            kind = rng.integers(0, 6, size=c)
            sd.spans = [SpanData(
                parent=-1 if s == 0 or lost[s] else int(par[s] * s),
                dur_ms=int(sdur[s]), kind=int(kind[s]),
                kvs={"service.name": {KEYS["service.name"][svc[s]]},
                     "name": {SPAN_OPS[op[s]]},
                     "http.status_code": {KEYS["http.status_code"][
                         code[s]]}}) for s in range(c)]
        out.append((sd.trace_id, sd))
    return out


def live_members(seed: int, first: int, n: int, spans: bool) -> list:
    """trace_data as push members: (trace id, encoded SearchData)."""
    from tempo_tpu_torch.search.data import encode_search_data

    return [(tid, encode_search_data(sd))
            for tid, sd in trace_data(seed, first, n, spans)]


def live_requests() -> dict:
    """The live stage's requests: the tag cell's kinds over the live
    traces' second range, a request its dictionaries prune, and the
    structural cell's desc plan."""
    return {
        "live_bench": (BENCH, {"limit": 20}),
        "live_substring": ({"host.name": "host-01"}, {"limit": 20}),
        "live_duration": ({}, {"min_duration_ms": 59_000,
                               "max_duration_ms": 59_999, "limit": 20}),
        "live_window": ({}, {"start": LIVE_BASE_S + 16,
                             "end": LIVE_BASE_S + 32, "limit": 20}),
        "live_exhaustive": (dict(BENCH, **EXHAUSTIVE), {"limit": 20}),
        "live_pruned": ({"service.name": "svc-999"}, {"limit": 20}),
        "live_desc": (st_tag(ST_PLANS["desc"], False), {"limit": 20}),
    }


WAL_REQUESTS = {
    "wal_exhaustive": (dict(BENCH, **EXHAUSTIVE), {"limit": 20}),
    "wal_bench": (BENCH, {"limit": 20}),
}


def answer(search, tags: dict, kw: dict):
    """A call answering one request through `search(req, results)`,
    which must return True or None (the live tier's decline is an
    error here)."""
    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search.results import SearchResults

    req = SearchRequest(tags=dict(tags), **kw)

    def call():
        res = SearchResults.for_request(req)
        if search(req, res) is False:
            raise AssertionError(f"the live tier declined {tags} {kw}")
        return res
    return call


def live_path(label: str, calls: dict, reqs: dict, n_total: int,
              reps: int, launches: dict, pruned=()) -> tuple:
    """Each call cold then `reps` warm (drive), its launches required:
    one B9 call (K1s and K2) per search, none for a pruned request, K6
    before K1s for a structural one. Returns (results, latency rows)."""
    res, lat, path = {}, {}, {}
    for name, call in calls.items():
        r = res[name] = drive(call, reps, True)
        n = r["launches"]
        tags, kw = reqs[name]
        want = 0 if name in pruned else reps + 1
        st = any(k.startswith("x-structural") for k in tags)
        k1s = n["scan_single_verdicts" if st else "scan_single"]
        if n["hot_scan"] != want or k1s != want or n["topk"] != want \
                or n["structural_mask"] != (want if st else 0) \
                or n["multi_scan"] or n["dict_probe"]:
            raise AssertionError(f"{label} {name}: launches {n}, want "
                                 f"{want} B9 calls")
        check_response(name, r["resp"], tags, kw, n_total)
        lat[name] = latency_row(r, r["resp"])
        print_row(f"{label} {name}", lat[name])
        add_counts(path, n)
    add_counts(launches, path)
    return res, lat, path


def hot_scan_row(lt, rec, tags: dict, launches: dict) -> dict:
    """B9 (``kernels.live.hot_scan``: K1s then K2 over the live prefix)
    against its plain version on a stage record, with the request
    compiled as the live tier compiles it; exact equality of the counts
    and of the kernel's top-k rows with the plain version's first rows.
    Bound: K1s's bytes on the prefix (k1_bytes) less its score column
    (an intermediate of B9) plus the top-k written."""
    import torch

    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search.kernels import live
    from tempo_tpu_torch.search.kernels.bench_coalesced import k1_bytes
    from tempo_tpu_torch.search.kernels.scan import scan_single
    from tempo_tpu_torch.search.pipeline import compile_query

    eng = lt.engine
    pages = rec.pages
    n = pages.n_pages
    cq = compile_query(pages.key_dict, pages.val_dict,
                       SearchRequest(tags=dict(tags), limit=20),
                       cache_on=pages, cache=eng.compile_cache)
    got = live.hot_scan(eng, rec.staged, n, cq)
    want = live.hot_scan_plain(eng, rec.staged, n, cq)
    k = got[1].numel()
    err = require_equal("hot_scan", got, (want[0], want[1][:k],
                                          want[2][:k]))
    view = live.live_prefix(rec.staged, n).device
    tk, vr = eng._tables(cq)
    as_multi = (view["kv_key"], view["kv_val"], view["entry_start"],
                view["entry_end"], view["entry_dur"], view["entry_valid"],
                torch.zeros(n, dtype=torch.int32, device=eng.device),
                tk[None], vr[None], cq.n_terms, cq.dur_lo,
                min(cq.dur_hi, 0xFFFFFFFF), cq.win_start,
                min(cq.win_end, 0xFFFFFFFF))
    scores, _ = scan_single(*as_multi[:6], tk, vr, *as_multi[9:])
    need = k1_bytes(as_multi, scores, single=True) - 4 * scores.numel() \
        + 8 * k
    ms = cuda_ms(lambda: live.hot_scan(eng, rec.staged, n, cq), 50)
    plain = cuda_ms(lambda: live.hot_scan_plain(eng, rec.staged, n, cq), 3)
    shape = {"pages": n, "tier": rec.tier, "entries": n * ENTRIES_PER_PAGE,
             "C": int(view["kv_key"].shape[2]), "n_terms": cq.n_terms,
             "k": k, "match_count": int(got[0][0]),
             "inspected": int(got[0][1]), "bytes_needed": need,
             "cuda_sources": ["tempo_tpu_torch/csrc/scan.cu",
                              "tempo_tpu_torch/csrc/topk.cu"]}
    return kernel_row("hot_scan", "tempo_tpu_torch/search/kernels/live.py",
                      "tempo_tpu/search/live_tier.py:83", launches, err, ms,
                      plain, need, None, shape,
                      lambda: live.hot_scan(eng, rec.staged, n, cq))


def stale_check(lt, rec, n_live: int, reqs: dict) -> dict:
    """B9's kernel route against its plain version on a stage record of
    more pages than `n_live`: the pages past it hold valid entries (a
    stage from before a cut), which both must ignore. The plain version
    over every page must count more for the match-all request."""
    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search import structural
    from tempo_tpu_torch.search.kernels import live
    from tempo_tpu_torch.search.pipeline import compile_query

    eng = lt.engine
    pages = rec.pages
    out = {}
    for name, (tags, kw) in reqs.items():
        req = SearchRequest(tags=dict(tags), **kw)
        cq = compile_query(pages.key_dict, pages.val_dict, req,
                           cache_on=pages, cache=eng.compile_cache)
        expr = structural.structural_query(req, lt.structural_cfg)
        if expr is not None:
            cq.structural = structural.compile_structural(expr, [pages])
        got = live.hot_scan(eng, rec.staged, n_live, cq)
        want = live.hot_scan_plain(eng, rec.staged, n_live, cq)
        every = live.hot_scan_plain(eng, rec.staged, pages.n_pages, cq)
        k = got[1].numel()
        require_equal(f"stale {name}", got, (want[0], want[1][:k],
                                             want[2][:k]))
        out[name] = {"live_pages": n_live, "stage_pages": pages.n_pages,
                     "count": int(got[0][0]),
                     "inspected": int(got[0][1]),
                     "count_all_pages": int(every[0][0])}
    if out["all"]["count_all_pages"] <= out["all"]["count"]:
        raise AssertionError(f"stale check: the pages past the live count "
                             f"hold no match: {out}")
    return out


def live_cell(args, work: str, report: dict, dbs: list,
              launches: dict) -> list:
    """The live cell (step 8 of the module docstring). Returns its kernel
    row."""
    import collections

    import torch

    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.search.live_tier import (LiveTier, _HotStage,
                                                  scan_search_data)
    from tempo_tpu_torch.search.streaming import StreamingSearchBlock

    n_live = args.live_traces
    cfg = TempoDBConfig(search_live_tier_enabled=True,
                        search_structural_enabled=True)
    gpu = TempoDB(LocalBackend(os.path.join(work, "live_blocks")), cfg,
                  device="cuda")
    dbs.append(gpu)
    lt = gpu.live_tier
    cpu = LiveTier("cpu", cfg.structural(), enabled=True,
                   max_entries=cfg.search_live_tier_max_entries)
    out: dict = {"traces": n_live, "max_entries": lt.max_entries}
    t0 = time.perf_counter()
    members = live_members(args.seed, 0, n_live, spans=True)
    out["make_s"] = time.perf_counter() - t0
    arrived = collections.deque()
    t0 = time.perf_counter()
    for b in range(0, n_live, LIVE_BATCH):
        for tid, raw in members[b:b + LIVE_BATCH]:
            lt.absorb(LIVE_TENANT, tid, raw)
            arrived.append(tid)
    out["absorb_s"] = time.perf_counter() - t0
    for tid, raw in members:
        cpu.absorb(LIVE_TENANT, tid, raw)
    print(f"live stage: {n_live} traces with spans absorbed in "
          f"{n_live // LIVE_BATCH} push batches of {LIVE_BATCH} "
          f"({out['absorb_s']:.2f} s; made in {out['make_s']:.2f} s)",
          flush=True)

    # quiet stage: each request cold (the first builds the stage) and warm
    reqs = live_requests()
    calls = {name: answer(lambda q, r: lt.search(LIVE_TENANT, q, r), *rq)
             for name, rq in reqs.items()}
    res, lat, path = live_path("live", calls, reqs, n_live, args.reps,
                               launches, pruned=("live_pruned",))
    rec = lt.stage_record(LIVE_TENANT)
    out.update(search=lat, launches=path, pages=rec.pages.n_pages,
               tier=rec.tier, build_s=rec.build_s, copy_s=rec.copy_s)
    busy = {n: call_busy(calls[n], args.reps)
            for n in ("live_bench", "live_exhaustive", "live_desc")}
    print_busy(busy, lat)
    out["device_busy"] = busy
    t0 = time.perf_counter()
    for name, rq in reqs.items():
        c = answer(lambda q, r: cpu.search(LIVE_TENANT, q, r), *rq)()
        if canon(c.response()) != res[name]["resp"]:
            raise AssertionError(f"{name}: card and CPU responses differ")
    out["cpu_check_s"] = time.perf_counter() - t0
    print(f"live stage: {rec.pages.n_pages} pages, tier {rec.tier}, built "
          f"in {rec.build_s * 1e3:.1f} ms, copied in "
          f"{rec.copy_s * 1e3:.2f} ms; {len(reqs)} responses equal the "
          f"CPU path's ({out['cpu_check_s']:.1f} s)", flush=True)

    # push -> searchable: cut the oldest batch, absorb a new one, search
    newest = answer(lambda q, r: lt.search(LIVE_TENANT, q, r), {},
                    {"limit": LIVE_BATCH})
    fresh = live_members(args.seed, n_live, (args.rounds + 1) * LIVE_BATCH,
                         spans=True)
    rounds = []
    for i in range(args.rounds + 1):
        batch = fresh[i * LIVE_BATCH:(i + 1) * LIVE_BATCH]
        cut = [arrived.popleft() for _ in range(LIVE_BATCH)]
        reset_counts()
        t0 = time.perf_counter()
        lt.mark_cut(LIVE_TENANT, cut)
        for tid, raw in batch:
            lt.absorb(LIVE_TENANT, tid, raw)
        t1 = time.perf_counter()
        got = newest()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        n = read_counts()
        arrived.extend(tid for tid, _ in batch)
        cpu.mark_cut(LIVE_TENANT, cut)
        for tid, raw in batch:
            cpu.absorb(LIVE_TENANT, tid, raw)
        ids = {m.trace_id for m in canon(got.response()).traces}
        if ids != {tid.hex() for tid, _ in batch} or n["hot_scan"] != 1:
            raise AssertionError(f"push round {i}: the new batch is not "
                                 f"the newest answer, or launches {n}")
        r = lt.stage_record(LIVE_TENANT)
        if i:                                # the first is a warm-up
            rounds.append({
                "total_ms": (t2 - t0) * 1e3, "absorb_ms": (t1 - t0) * 1e3,
                "search_ms": (t2 - t1) * 1e3, "build_ms": r.build_s * 1e3,
                "copy_ms": r.copy_s * 1e3,
                "device_ms": call_busy(newest, 1)["device_ms"]})
    out["push_rounds"] = rounds

    def p50(key):
        xs = sorted(x[key] for x in rounds if x[key] is not None)
        return xs[len(xs) // 2] if xs else None

    out["push_p50_ms"] = {k: p50(k) for k in rounds[0]}
    print("push to searchable, p50 of " + str(len(rounds)) + " rounds: "
          + ", ".join(f"{k} {v:.3f}" if v is not None else f"{k} not "
                      "measured" for k, v in out["push_p50_ms"].items()),
          flush=True)

    # a cut that leaves pages past the live count: responses against the
    # CPU path, then B9 on the stage from before the cut
    desc = reqs["live_desc"]
    answer(lambda q, r: lt.search(LIVE_TENANT, q, r), *desc)()
    before = lt.stage_record(LIVE_TENANT)
    half = [arrived.popleft() for _ in range(n_live // 2)]
    lt.mark_cut(LIVE_TENANT, half)
    cpu.mark_cut(LIVE_TENANT, half)
    for name in ("live_bench", "live_exhaustive", "live_desc"):
        tags, kw = reqs[name]
        g = answer(lambda q, r: lt.search(LIVE_TENANT, q, r), tags, kw)()
        c = answer(lambda q, r: cpu.search(LIVE_TENANT, q, r), tags, kw)()
        if canon(g.response()) != canon(c.response()) \
                or g.metrics.inspected_traces != n_live - len(half):
            raise AssertionError(f"after the cut, {name}: card and CPU "
                                 "responses differ")
    after = lt.stage_record(LIVE_TENANT)
    out["stale"] = stale_check(
        lt, before, after.pages.n_pages,
        {"all": ({}, {"limit": 20}), "live_bench": reqs["live_bench"],
         "live_desc": desc})
    print(f"cut of {len(half)}: {after.pages.n_pages} of "
          f"{before.pages.n_pages} pages live; responses equal the CPU "
          f"path's; B9 on the stage from before the cut equals its plain "
          f"version: {json.dumps(out['stale'])}", flush=True)

    # a tenant past max_entries: the tier declines, nothing launches
    over = live_members(args.seed + 1, 0, lt.max_entries + 1, spans=False)
    for tid, raw in over:
        lt.absorb("live-overflow", tid, raw)
    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search.results import SearchResults

    reset_counts()
    declined = not lt.search("live-overflow", SearchRequest(limit=20),
                             SearchResults())
    n = read_counts()
    stats = lt.stats()
    if not declined or n["hot_scan"] or n["scan_single"] \
            or stats.get('live_tier_scans{result="fallback_overflow"}') != 1:
        raise AssertionError(f"overflow: declined {declined}, launches "
                             f"{n}, stats {stats}")
    lt.drop_tenant("live-overflow")
    out["stats"] = stats
    print(f"overflow: {len(over)} traces > {lt.max_entries}, the tier "
          f"declines with no launch; stats {json.dumps(stats)}", flush=True)

    # the WAL head: appended to its sidecar file, replayed, searched
    path = os.path.join(work, "wal-head.search")
    n_wal = args.wal_traces
    blk = StreamingSearchBlock(path, live=lt)
    t0 = time.perf_counter()
    chunk = 16_384
    for first in range(0, n_wal, chunk):
        for tid, sd in trace_data(args.seed + 2, first,
                                  min(chunk, n_wal - first), spans=False):
            blk.append(tid, sd)
    blk.close()
    t1 = time.perf_counter()
    blk = StreamingSearchBlock.rescan(path, live=lt)
    t2 = time.perf_counter()
    if len(blk) != n_wal:
        raise AssertionError(f"rescan found {len(blk)} of {n_wal} traces")
    wal = {"traces": n_wal, "sidecar_bytes": os.path.getsize(path),
           "append_s": t1 - t0, "rescan_s": t2 - t1}
    calls = {name: answer(blk.search, *rq)
             for name, rq in WAL_REQUESTS.items()}
    wres, wlat, wpath = live_path("wal", calls, WAL_REQUESTS, n_wal,
                                  args.reps, launches)
    wrec = blk._stage.record
    wal.update(search=wlat, launches=wpath, pages=wrec.pages.n_pages,
               tier=wrec.tier, build_s=wrec.build_s, copy_s=wrec.copy_s)
    wbusy = {n: call_busy(c, args.reps) for n, c in calls.items()}
    print_busy(wbusy, wlat)
    wal["device_busy"] = wbusy
    t0 = time.perf_counter()
    cstage = _HotStage()
    for name, rq in WAL_REQUESTS.items():
        c = answer(lambda q, r: scan_search_data(
            blk.entries(), q, r, cstage, 0, cpu), *rq)()
        if canon(c.response()) != wres[name]["resp"]:
            raise AssertionError(f"{name}: card and CPU responses differ")
    wal["cpu_check_s"] = time.perf_counter() - t0
    print(f"WAL head: {n_wal} traces, sidecar "
          f"{wal['sidecar_bytes'] / 1e6:.1f} MB (append {wal['append_s']:.1f}"
          f" s, rescan {wal['rescan_s']:.1f} s); {wrec.pages.n_pages} pages,"
          f" tier {wrec.tier}, built in {wrec.build_s:.2f} s, copied in "
          f"{wrec.copy_s * 1e3:.1f} ms; responses equal the CPU path's "
          f"({wal['cpu_check_s']:.1f} s)", flush=True)
    out["wal"] = wal
    row = hot_scan_row(lt, wrec, BENCH, launches)
    blk.clear()
    report["live"] = out
    gpu.close()
    dbs.remove(gpu)
    del blk, wrec, before, after, cstage
    gc.collect()
    torch.cuda.empty_cache()
    return [row]


# ---------------------------------------------------------------------------
# step 10: the mesh cell


MESH_KERNELS = {   # kernels-line name -> (source, the TPU kernel replaced)
    "dist_multi_scan": ("tempo_tpu_torch/search/multiblock.py",
                        "tempo_tpu/search/multiblock.py:894"),
    "dist_coalesced_scan": ("tempo_tpu_torch/search/multiblock.py",
                            "tempo_tpu/search/multiblock.py:1094"),
    "dist_scan_single": ("tempo_tpu_torch/parallel/dist_search.py",
                         "tempo_tpu/parallel/dist_search.py:153"),
    "dist_probe": ("tempo_tpu_torch/search/dict_probe.py",
                   "tempo_tpu/search/dict_probe.py:301"),
}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def grouped_phase(label: str, root: str, tenant: str, cfg, reqs: dict,
                  reps: int, mesh, dbs: list, launches: dict) -> tuple:
    """`reqs` through an ungrouped TempoDB (cold, once) and through one
    given `mesh` (the main path: cold, then `reps` timed), every grouped
    response equal to the ungrouped one, each with collectives launched
    (a request the probe prunes everywhere dispatches no scan) and K9 on
    the phase. Returns (the grouped database, its results, the main
    path's launches)."""
    import dataclasses

    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.db import TempoDB

    # auto_mesh leaves a world-1 database unsharded; False says so twice
    one = TempoDB(LocalBackend(root), dataclasses.replace(cfg, auto_mesh=False),
                  device="cuda")
    dbs.append(one)
    one.poll()
    want = run_queries(one, tenant, reqs, 0)
    if one.mesh is not None:
        raise AssertionError(f"{label}: the ungrouped database sharded")
    one.close()
    dbs.remove(one)
    del one
    gc.collect()
    grp = TempoDB(LocalBackend(root), cfg, device="cuda", mesh=mesh)
    dbs.append(grp)
    grp.poll()
    res = run_queries(grp, tenant, reqs, reps)            # the main path
    path = {}
    for name, r in res.items():
        if r["resp"] != want[name]["resp"]:
            raise AssertionError(f"{label} {name}: the grouped response "
                                 "differs from the ungrouped one")
        if not r["launches"]["collectives"]:
            raise AssertionError(f"{label} {name}: no collective on the "
                                 f"grouped path: {r['launches']}")
        add_counts(path, r["launches"])
        print(f"mesh {label} {name}: first {r['first_s'] * 1e3:.2f} ms, p50 "
              f"{r['lat'][len(r['lat']) // 2] * 1e3:.3f} ms, equal to the "
              f"ungrouped response; launches per request "
              f"{json.dumps({k: v // (reps + 1) for k, v in r['launches'].items() if v})}",
              flush=True)
    if not path["shard_topk"]:
        raise AssertionError(f"{label}: no K9 on the grouped path: {path}")
    add_counts(launches, path)
    return grp, res, path


def mesh_attribution(db, launches: dict) -> dict:
    """A grouped request with ``explain`` whose needle is new, so the
    probe runs through the mesh: its query stats carry the collective
    lock's wait (``lock_wait``) and its h2d bytes, and the profiler's
    aggregates the sharded staging's h2d (mode mesh)."""
    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.observability import profile

    reset_counts()
    d = json.loads(db.search("hc", SearchRequest(
        tags={SESSION_KEY: "session-0007"}, explain=True, limit=20))
        .response().metrics.query_stats_json)
    add_counts(launches, read_counts())
    h2d = profile.snapshot(0)["aggregates"].get("mesh", {}).get("h2d", {})
    out = {"device_stages_ms": d["device_stages_ms"],
           "h2d_bytes": d["h2d_bytes"], "staging_h2d": h2d}
    if "lock_wait" not in d["device_stages_ms"] or not d["h2d_bytes"] \
            or not h2d.get("bytes"):
        raise AssertionError(f"the mesh attribution lacks lock_wait or "
                             f"h2d: {out}")
    print(f"mesh attribution: lock_wait "
          f"{d['device_stages_ms']['lock_wait']:.4f} ms, h2d "
          f"{d['h2d_bytes']} B in the query stats; the sharded staging's "
          f"h2d {h2d['count']} puts, {h2d['bytes']} B", flush=True)
    return out


def emulated_batches(blocks: list, S: int, cfg, probe_min_vals=None):
    """(engine, ShardedBatch) over a LocalExchange of S ranks on the card,
    and (engine, BlockBatch) of the same stacked layout on one device."""
    from tempo_tpu_torch.device import resolve_device
    from tempo_tpu_torch.parallel import mesh
    from tempo_tpu_torch.search.multiblock import (MultiBlockEngine,
                                                   place_batch, stack_host)

    dev = resolve_device("cuda")
    st = cfg.structural()
    pm = (cfg.search_device_probe_min_vals if probe_min_vals is None
          else probe_min_vals)
    eng = MultiBlockEngine(dev, device_probe_min_vals=pm, structural_cfg=st,
                           exchange=mesh.LocalExchange(S))
    batch = eng.place(eng.stage_host(blocks))
    one = MultiBlockEngine(dev, device_probe_min_vals=pm, structural_cfg=st)
    single = place_batch(stack_host(blocks, pad_to=batch.n_pages,
                                    probe_min_vals=pm, spans=st.enabled), dev)
    return eng, batch, one, single


def compile_for(eng, batch, tags: dict, kw: dict, agg: bool = False):
    """A MultiQuery as the batcher compiles it, structural predicate and
    aggregate included."""
    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search import analytics, structural
    from tempo_tpu_torch.search.multiblock import compile_multi

    req = SearchRequest(tags=dict(tags), **kw)
    mq = compile_multi(list(batch.blocks), req, memo=batch.memo,
                       cache=eng.compile_cache,
                       staged_dicts=batch.staged_dicts, packed=eng.packed)
    if mq is None:
        return None
    mq.limit = kw.get("limit", 20)
    expr = structural.structural_query(req, eng.structural_cfg)
    if expr is not None:
        mq.structural = structural.compile_structural(
            expr, list(batch.blocks), staged_dicts=batch.staged_dicts,
            packed=eng.packed, memo=batch.memo)
    if agg:
        mq.agg_stage = analytics.stage_for_batch(batch)
    return mq


def require_same(what: str, got: tuple, want: tuple) -> None:
    import torch

    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or not torch.equal(g.long(), w.long()):
            raise AssertionError(f"{what}: the emulated dispatch differs "
                                 "from the single-device one")


def emulated_phase(label: str, blocks: list, cfg, reqs: list, S: int,
                   fused: bool = False) -> dict:
    """The S-rank arithmetic on the card (a LocalExchange): each request's
    dispatch, and with `fused` the stacked requests' fused dispatch, equal
    the single-device dispatch over the same stacked layout exactly (counts,
    inspected, aggregates, top-k scores and indices)."""
    from tempo_tpu_torch.search.multiblock import stack_queries

    eng, batch, one, single = emulated_batches(blocks, S, cfg)
    mqs = []
    for tags, kw in reqs:
        agg = "x-agg-q" in tags
        mq = compile_for(eng, batch, tags, kw, agg)
        smq = compile_for(one, single, tags, kw, agg)
        if (mq is None) != (smq is None):
            raise AssertionError(f"{label} S={S}: one side pruned")
        if mq is None:
            continue
        require_same(f"{label} S={S} {tags}", eng.scan_async(batch, mq),
                     one.scan_async(single, smq))
        mqs.append((mq, smq))
    if fused:
        require_same(f"{label} S={S} fused",
                     eng.coalesced_scan_async(
                         batch, stack_queries([m for m, _ in mqs]), 128),
                     one.coalesced_scan_async(
                         single, stack_queries([s for _, s in mqs]), 128))
    out = {"S": S, "pages": batch.n_pages, "requests": len(mqs),
           "span_sharded": batch.span_sharded,
           "probe_dicts": len(batch.staged_dicts)}
    print(f"emulated {label}: {json.dumps(out)}, equal to one device",
          flush=True)
    return out


# the mesh cell's K9 shapes (S, Q, k', local, seed, top)
K9_SHAPES = ((1, 1, 128, 65_536 * 16, 1, 1000), (8, 8, 1024, 8192, 2, 1000),
             (4, 1, 128, 4096, 3, 1000), (3, 3, 1024, 4096, 4, 20),
             (8, 3, 128, 1024, 5, 4), (1, 3, 128, 4096, 6, 4))


def k9_inputs(S: int, Q: int, kp: int, local: int, seed: int, top: int):
    """(scores [S, Q, local] in [-1, top) from the seed, their per-shard
    K2r outputs gathered as the exchange gathers them, [S, 2, Q, kp])."""
    import torch

    from tempo_tpu_torch.device import resolve_device
    from tempo_tpu_torch.search.kernels import topk

    g = torch.Generator().manual_seed(seed)
    dev = resolve_device("cuda")
    scores = torch.randint(-1, top, (S, Q, local), dtype=torch.int32,
                           generator=g).to(dev)
    parts = [topk.topk_rows(scores[s].contiguous(), kp) for s in range(S)]
    return scores, torch.stack([torch.stack(p) for p in parts])


def k9_early_profiles() -> dict:
    """K9's gathered entry launches K9 alone (no copy first) at each of
    K9_SHAPES: the profiler's kernels per call, up to three profiles each
    (``kernels_per_call``), taken before the cells run, since late in a
    full run the profiler may keep no device record of a whole session
    (ROADMAP C1). A profile may keep fewer records than calls (a count
    below 1), never more: no K9 record in three profiles, any other
    kernel, or more than one K9 a call, fails. Returns "S,Q,k'" ->
    kernels per call."""
    from tempo_tpu_torch.search.kernels import dist as dist_k

    out = {}
    for S, Q, kp, local, seed, top in K9_SHAPES:
        _scores, cand = k9_inputs(S, Q, kp, local, seed, top)
        per = kernels_per_call(lambda cand=cand, local=local, kp=kp:
                               dist_k.shard_topk_gathered(cand, local, kp))
        if set(per) != {"shard_topk_kernel"} \
                or per["shard_topk_kernel"] > 1:
            raise AssertionError(f"K9 [{S}, {Q}, {kp}]: the gathered entry "
                                 f"launched {per}, not K9 alone")
        out[f"{S},{Q},{kp}"] = per
    print(f"K9 kernels per call (profiled first): {json.dumps(out)}",
          flush=True)
    return out


def k9_measure(S: int, Q: int, kp: int, local: int, seed: int,
               top: int = 1000) -> dict:
    """K9 against its plain version and the single-device K2 at
    [S, Q, kp]: per-shard K2r outputs of random scores in [-1, top) (ties
    within and across shards), gathered as the exchange gathers them
    ([S, 2, Q, kp]); the gathered entry (the main path's) and the
    two-tensor form over the gathered halves (strided views, read in
    place) equal the plain version exactly; then CUDA-event times of the
    gathered entry, its plain version and torch.topk over the gathered
    [Q, S * kp] scores, and the wrapper's host microseconds a call. That
    the gathered entry launches K9 alone is ``k9_early_profiles``'
    check."""
    import torch

    from tempo_tpu_torch.search.kernels import dist as dist_k
    from tempo_tpu_torch.search.kernels import topk

    scores, cand = k9_inputs(S, Q, kp, local, seed, top)
    want = dist_k.shard_topk_plain(cand[:, 0].contiguous(),
                                   cand[:, 1].contiguous(), local, kp)
    what = f"K9 [{S}, {Q}, {kp}]"
    got = dist_k.shard_topk_gathered(cand, local, kp)
    err = require_equal(what, got, want)
    require_equal(f"{what} two-tensor form", dist_k.shard_topk(
        cand[:, 0], cand[:, 1], local, kp), want)
    require_equal(f"{what} vs K2", got, topk.topk_rows(
        scores.permute(1, 0, 2).reshape(Q, S * local).contiguous(), kp))

    def fn():
        return dist_k.shard_topk_gathered(cand, local, kp)

    flat = cand[:, 0].permute(1, 0, 2).reshape(Q, S * kp).contiguous()
    kk = min(kp, S * kp)
    out = {"S": S, "Q": Q, "kp": kp, "err": err,
           "ms": cuda_ms(fn, 200),
           "plain_ms": cuda_ms(
               lambda: dist_k.shard_topk_plain(cand[:, 0], cand[:, 1],
                                               local, kp), 50),
           "library_ms": cuda_ms(lambda: torch.topk(flat, kk, dim=1), 200),
           "host_us": host_us(fn),
           "bytes": 8 * S * Q * kp + 8 * Q * kk, "fn": fn}
    print(f"{what}: equal to its plain version and K2; "
          f"{out['ms']:.4f} ms back to back, torch.topk "
          f"{out['library_ms']:.4f} ({out['ms'] / out['library_ms']:.2f}x), "
          f"wrapper host {out['host_us']:.1f} us a call", flush=True)
    return out


def nccl_times(ex, k: int) -> dict:
    """CUDA-event times of the world-1 collectives at the sizes a
    dispatch exchanges: the counts all_reduce (int64 [2]) and the
    candidates' all_gather (int32 [2, k] and [2, 8, k])."""
    import torch

    from tempo_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    red = torch.zeros(2, dtype=torch.int64, device=dev)
    one = torch.zeros((2, k), dtype=torch.int32, device=dev)
    rows = torch.zeros((2, 8, k), dtype=torch.int32, device=dev)
    return {"all_reduce_int64x2_ms": cuda_ms(lambda: ex.all_reduce([red]),
                                             200),
            f"all_gather_int32x2x{k}_ms": cuda_ms(
                lambda: ex.all_gather([one]), 200),
            f"all_gather_int32x2x8x{k}_ms": cuda_ms(
                lambda: ex.all_gather([rows]), 200)}


def chain_rows(tag_db, hc_db, pages, mesh_obj, launches: dict) -> list:
    """The B10 chains against their plain versions on the card, over the
    world-1 group: the plain version of a chain is the single-device
    function it computes, the kernels' plain versions over the same
    staged tensors. Exact equality; CUDA-event times; bound = the bytes
    its kernels must move (K1 or K4 or K1s, or K3, plus the top-k)."""
    import torch

    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.parallel import mesh
    from tempo_tpu_torch.parallel.dist_search import DistributedScanEngine
    from tempo_tpu_torch.search import dict_probe
    from tempo_tpu_torch.search.engine import resolve_top_k
    from tempo_tpu_torch.search.kernels import probe, scan, topk
    from tempo_tpu_torch.search.kernels.bench_coalesced import (k1_bytes,
                                                                k4_bytes)
    from tempo_tpu_torch.search.multiblock import stack_queries

    dev = tag_db.device
    rows = []
    # dist_multi_scan on the largest grouped tag batch, the bench request
    eng = tag_db.batcher.engine
    batch = largest_batch(tag_db)
    sh = batch.shards[0]
    d = sh.device
    mq = compile_for(eng, batch, BENCH, {"limit": 20})
    k = resolve_top_k(eng.top_k, 20)
    tk, vr = (torch.from_numpy(mq.term_keys).to(dev),
              torch.from_numpy(mq.val_ranges).to(dev))
    args = (d["kv_key"], d["kv_val"], d["entry_start"], d["entry_end"],
            d["entry_dur"], d["entry_valid"], d["page_block"], tk, vr,
            mq.n_terms, mq.dur_lo, min(mq.dur_hi, 0xFFFFFFFF), mq.win_start,
            min(mq.win_end, 0xFFFFFFFF))
    bg = (None if mq.block_group is None
          else torch.from_numpy(mq.block_group).to(dev))
    extra = (mq.val_hits, bg, sh.widths, d.get("entry_dur_res"))

    def multi_plain():
        s, c = scan.multi_scan_plain(*args, *extra)
        return (c,) + topk.topk_plain(s, k)

    got = eng.dist_scan_async(batch, mq)
    err = require_equal("dist_multi_scan", got, multi_plain())
    scores, _c = scan.multi_scan(*args, *extra)
    need = k1_bytes(args, scores, mq.val_hits, bg, widths=sh.widths,
                    res=extra[3]) + scores.numel() * 4 + k * 8
    rows.append(kernel_row(
        "dist_multi_scan", *MESH_KERNELS["dist_multi_scan"], launches, err,
        cuda_ms(lambda: eng.dist_scan_async(batch, mq), 50),
        cuda_ms(multi_plain, 3), need, None,
        {"world": 1, "pages": batch.n_pages, "entries": scores.numel(),
         "k": k, "bytes_needed": need}))
    # dist_coalesced_scan: the 8 concurrent bench requests, stacked
    mqs = [compile_for(eng, batch, t, {"limit": 20}) for t in CONCURRENT_TAGS]
    cq = stack_queries(mqs)
    tables = eng.coalesced_tables(cq)

    def coalesced_plain():
        s, c, n = scan.coalesced_scan_plain(*args[:7], *tables, *extra[2:])
        return (c, n) + topk.topk_rows_plain(s, k)

    got = eng.dist_coalesced_scan_async(batch, cq, k)
    err = require_equal("dist_coalesced_scan", got, coalesced_plain())
    c_scores, _c, _n = scan.coalesced_scan(*args[:7], *tables, *extra[2:])
    need = k4_bytes(args[:7], tables, c_scores, *extra[2:]) \
        + c_scores.numel() * 4 + c_scores.shape[0] * k * 8
    rows.append(kernel_row(
        "dist_coalesced_scan", *MESH_KERNELS["dist_coalesced_scan"],
        launches, err,
        cuda_ms(lambda: eng.dist_coalesced_scan_async(batch, cq, k), 20),
        cuda_ms(coalesced_plain, 3), need, None,
        {"world": 1, "Q": int(c_scores.shape[0]), "pages": batch.n_pages,
         "k": k, "bytes_needed": need}))
    # dist_scan_single: one tag block through DistributedScanEngine
    de = DistributedScanEngine(mesh.ShardExchange(mesh_obj, dev), dev)
    sp = de.stage(pages)
    cq1 = de.compile(sp, SearchRequest(tags=dict(BENCH), limit=20))
    s1 = sp.shards[0].device
    tk1, vr1 = de.local._tables(cq1)
    a1 = (s1["kv_key"], s1["kv_val"], s1["entry_start"], s1["entry_end"],
          s1["entry_dur"], s1["entry_valid"], tk1, vr1, cq1.n_terms,
          cq1.dur_lo, min(cq1.dur_hi, 0xFFFFFFFF), cq1.win_start,
          min(cq1.win_end, 0xFFFFFFFF), cq1.val_hits if cq1.n_terms else None)

    def single_plain():
        s, c = scan.scan_single_plain(*a1)
        return (c,) + topk.topk_plain(s, k)

    got = de.scan_staged_async(sp, cq1)
    err = require_equal("dist_scan_single", got, single_plain())
    s_scores, _c = scan.scan_single(*a1)
    P = s1["kv_key"].shape[0]
    as_multi = (*a1[:6], torch.zeros(P, dtype=torch.int32, device=dev),
                tk1[None], vr1[None], *a1[8:13])
    need = k1_bytes(as_multi, s_scores, single=True) \
        + s_scores.numel() * 4 + k * 8
    rows.append(kernel_row(
        "dist_scan_single", *MESH_KERNELS["dist_scan_single"], launches,
        err, cuda_ms(lambda: de.scan_staged_async(sp, cq1), 50),
        cuda_ms(single_plain, 3), need, None,
        {"world": 1, "pages": P, "entries": s_scores.numel(), "k": k,
         "bytes_needed": need}))
    # dist_probe: one staged hc dictionary, the scattered needle "77"
    hb = largest_batch(hc_db)
    sd = next(iter(hb.staged_dicts.values()))
    dd = sd.shards[0]
    needles, lens = dict_probe.needle_tensors([b"77"])

    def probe_plain():
        return probe.dict_probe_plain(dd.buf, dd.off, needles, lens)

    got = dict_probe.probe_value_hits(sd, [b"77"])
    want = probe_plain()
    err = require_equal("dist_probe", (got[0][:, :want[0].shape[1]],
                                       got[1]), want)
    T, V = got[0].shape
    need = dd.buf.numel() + dd.off.numel() * 4 + T * V + T + 1 + 4
    rows.append(kernel_row(
        "dist_probe", *MESH_KERNELS["dist_probe"], launches, err,
        cuda_ms(lambda: dict_probe.probe_value_hits(sd, [b"77"]), 20),
        cuda_ms(probe_plain, 3), need, None,
        {"world": 1, "values": V, "dict_bytes": int(dd.buf.numel()),
         "T": T, "bytes_needed": need}))
    return rows


def mesh_cell(args, work: str, report: dict, dbs: list,
              launches: dict) -> list:
    """The mesh cell (step 9 of the module docstring). Returns its
    kernel rows."""
    import torch
    import torch.distributed as dist

    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.db import TempoDBConfig
    from tempo_tpu_torch.device import resolve_device
    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.parallel import mesh
    from tempo_tpu_torch.parallel.dist_search import DistributedScanEngine
    from tempo_tpu_torch.search.backend_search_block import \
        BackendSearchBlock

    dev = resolve_device("cuda")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=dev)
    out: dict = {}
    report["mesh"] = out
    try:
        m = mesh.make_mesh()
        try:
            mesh.ShardExchange(m, torch.device(
                "cpu" if dev.type == "cuda" else "cuda"))
        except ValueError:
            pass
        else:
            raise AssertionError("a database took a process group that "
                                 "cannot carry its tensors")
        # 2. the grouped databases, world 1, over the earlier corpora
        tag_cfg = TempoDBConfig(search_max_batch_pages=4096)
        tag_root = os.path.join(work, "blocks")
        tag_db, tres, out["tag_launches"] = grouped_phase(
            "tag", tag_root, "smoke", tag_cfg, requests(args.blocks),
            args.reps, m, dbs, launches)
        out["tag_search"] = {n: latency_row(r, r["resp"])
                             for n, r in tres.items()}
        out["tag_device_busy"] = device_busy(
            tag_db, "smoke", requests(args.blocks),
            ("exhaustive_bench", "bench_and", "limit_1000"), args.reps)
        print_busy(out["tag_device_busy"], out["tag_search"])
        exh = [(dict(t, **EXHAUSTIVE), {"limit": 20})
               for t in CONCURRENT_TAGS]
        serial = [canon(tag_db.search(
            "smoke", SearchRequest(tags=dict(t), **kw)).response())
                  for t, kw in exh]
        row = concurrent_rounds(tag_db, "smoke", exh, args.rounds, serial)
        add_counts(launches, row["launches"])
        require_fusion(row, "coalesced_scan")
        if not row["launches"]["dist_coalesced_scan"]:
            raise AssertionError("the grouped rounds fused through no "
                                 "dist_coalesced_scan chain")
        out["tag_concurrent"] = row
        print(f"mesh tag concurrent exhaustive: round p50 "
              f"{row['round_p50_ms']:.3f} ms; coalescer "
              f"{json.dumps(row['coalesce'])}; launches "
              f"{json.dumps(row['launches'])}", flush=True)
        hc_cfg = TempoDBConfig(search_max_batch_pages=4096)
        hc_db, hres, out["hc_launches"] = grouped_phase(
            "hc", os.path.join(work, "hc_blocks"), "hc", hc_cfg,
            hc_requests(), args.reps, m, dbs, launches)
        if not out["hc_launches"]["dist_probe"]:
            raise AssertionError("the grouped hc requests probed through no "
                                 "dist_probe chain")
        out["attribution"] = mesh_attribution(hc_db, launches)
        st_cfg = TempoDBConfig(search_max_batch_pages=4096,
                               search_structural_enabled=True,
                               search_structural_shard_spans=True,
                               search_structural_remainder_pages=True)
        st_reqs = {n: r for n, r in st_requests().items()
                   if n.endswith("_exhaustive")}
        st_db, _sres, out["st_launches"] = grouped_phase(
            "structural", os.path.join(work, "st_blocks"), "st", st_cfg,
            st_reqs, args.reps, m, dbs, launches)
        red_cfg = TempoDBConfig(search_max_batch_pages=4096,
                                search_analytics_enabled=True)
        red_reqs = {"red_all": red_requests(args.agg_blocks)["red_all"]}
        red_db, _rres, out["red_launches"] = grouped_phase(
            "RED", os.path.join(work, "red_blocks"), RED_TENANT, red_cfg,
            red_reqs, args.reps, m, dbs, launches)
        # the single-block engine through its own entry points
        meta = sorted(tag_db.blocklist.metas("smoke"),
                      key=lambda x: x.block_id)[0]
        pages = BackendSearchBlock(LocalBackend(tag_root), meta,
                                   device="cuda").pages()
        reset_counts()
        de = DistributedScanEngine(mesh.ShardExchange(m, dev), dev)
        sp = de.stage(pages)
        sreq = SearchRequest(tags=dict(BENCH), limit=20)
        cq = de.compile(sp, sreq)
        _c, n_insp, s, i = de.scan_staged(sp, cq)
        hits = de.results(sp, cq, s, i)
        path = read_counts()
        if not path["dist_scan_single"] or not path["shard_topk"]:
            raise AssertionError(f"the single-block engine launched no "
                                 f"chain: {path}")
        add_counts(launches, path)
        out["single_launches"] = path
        print(f"mesh single-block engine: {n_insp} inspected, {len(hits)} "
              f"results; launches {json.dumps(path)}", flush=True)
        # 3. the S-rank arithmetic on the card
        emu = []
        tag_blocks = largest_batch(tag_db).blocks
        hc_blocks = largest_batch(hc_db).blocks
        st_blocks = largest_batch(st_db).blocks
        red_blocks = largest_batch(red_db).blocks
        tag_reqs = [(t, kw) for t, kw in requests(args.blocks).values()]
        for S in (3, 4):
            emu.append(emulated_phase("tag", tag_blocks, tag_cfg, tag_reqs,
                                      S))
            emu.append(emulated_phase(
                "tag fused", tag_blocks, tag_cfg,
                [(t, {"limit": 20}) for t in CONCURRENT_TAGS], S, True))
            emu.append(emulated_phase(
                "hc", hc_blocks, hc_cfg,
                [(t, kw) for t, kw in hc_requests().values()], S))
            for shard_spans in (False, True):
                cfg = TempoDBConfig(
                    search_structural_enabled=True,
                    search_structural_shard_spans=shard_spans,
                    search_structural_remainder_pages=S == 3)
                emu.append(emulated_phase(
                    f"structural shard_spans={shard_spans}", st_blocks, cfg,
                    list(st_reqs.values()), S))
            emu.append(emulated_phase(
                "RED", red_blocks, red_cfg,
                [red_requests(args.agg_blocks)["red_all"],
                 red_requests(args.agg_blocks)["red_svc"]], S))
            de_s = DistributedScanEngine(mesh.LocalExchange(S), dev)
            got = de_s.scan_staged(de_s.stage(pages), cq)
            want = de.scan_staged(sp, cq)
            if got[:2] != want[:2] or not (got[2] == want[2]).all() \
                    or not (got[3] == want[3]).all():
                raise AssertionError(f"emulated single-block S={S} differs")
        out["emulated"] = emu
        # 4. K9 and the collectives, timed
        k9 = [k9_measure(*shape) for shape in K9_SHAPES]
        out["k9"] = [{k: v for k, v in r.items() if k != "fn"} for r in k9]
        out["nccl"] = nccl_times(mesh.ShardExchange(m, dev), 128)
        print("K9 " + json.dumps(out["k9"]) + "; NCCL world 1 "
              + json.dumps(out["nccl"]), flush=True)
        main = k9[0]
        rows = [kernel_row("shard_topk", "tempo_tpu_torch/csrc/dist.cu",
                           "tempo_tpu/search/multiblock.py:984", launches,
                           max(r["err"] for r in k9), main["ms"],
                           main["plain_ms"], main["bytes"],
                           main["library_ms"],
                           {"S": 1, "Q": 1, "kp": 128,
                            "host_us": main["host_us"],
                            "also": out["k9"][1:]}, main["fn"])]
        rows += chain_rows(tag_db, hc_db, pages, m, launches)
        for db in (tag_db, hc_db, st_db, red_db):
            db.close()
            dbs.remove(db)
    finally:
        dist.destroy_process_group()
    return rows


TBI_TENANT = "tbi"
TBI_SPANS = 8                   # spans of a trace object
TBI_PARTIAL_EVERY = 64          # 1 trace in 64 of blocks 0-3 has a partial
TBI_PARTIAL_BLOCKS = 4
TBI_LOOKUPS = 1024              # present ids, and absent ids, looked up
TBI_LIMIT = 64                  # results of the search that comes first
TBI_TRACES = 16_384             # traces a block, unless cut
TBI_INDEX_RECORDS = 1024        # records of a full index page (the default)


def tbi_times(start_s, dur_ms):
    """Every span's (start, end) in unix ns, two ``[..., TBI_SPANS]``
    int64 arrays: the root from start_s for dur_ms, child i inside it,
    i/16 of the root's length in from each end."""
    import numpy as np

    t0 = np.asarray(start_s, dtype=np.int64)[..., None] * 1_000_000_000
    t1 = t0 + np.asarray(dur_ms, dtype=np.int64)[..., None] * 1_000_000
    cut = (t1 - t0) * np.arange(TBI_SPANS, dtype=np.int64) // 16
    return t0 + cut, t1 - cut


def tbi_trace(tid: bytes, svc: str, starts, ends, span_ids: bytes):
    """One trace object's proto: TBI_SPANS spans under `svc`, span 0 the
    root and the parent of the others, span i named SPAN_OPS[i]."""
    from tempo_tpu_torch import tempopb

    t = tempopb.Trace()
    rs = t.batches.add()
    kv = rs.resource.attributes.add()
    kv.key = "service.name"
    kv.value.string_value = svc
    ss = rs.scope_spans.add()
    ss.scope.name = "chip-smoke"
    for i in range(TBI_SPANS):
        s = ss.spans.add()
        s.trace_id = tid
        s.span_id = span_ids[8 * i:8 * i + 8]
        s.name = SPAN_OPS[i]
        s.kind = 2 if i == 0 else 3
        if i:
            s.parent_span_id = span_ids[:8]
        s.start_time_unix_nano = int(starts[i])
        s.end_time_unix_nano = int(ends[i])
    return t


def tbi_partial(orig, span_ids: bytes):
    """A second partial of `orig`: two new spans and a duplicate of its
    span 1, under the same resource and scope."""
    from tempo_tpu_torch import tempopb

    t = tempopb.Trace()
    rs = t.batches.add()
    rs.resource.CopyFrom(orig.batches[0].resource)
    ss = rs.scope_spans.add()
    ss.scope.CopyFrom(orig.batches[0].scope_spans[0].scope)
    root = orig.batches[0].scope_spans[0].spans[0]
    for i in range(2):
        s = ss.spans.add()
        s.CopyFrom(root)
        s.span_id = span_ids[8 * i:8 * i + 8]
        s.parent_span_id = root.span_id
        s.name = "partial"
    ss.spans.append(orig.batches[0].scope_spans[0].spans[1])
    return t


def tbi_template() -> tuple:
    """The v2 object of one ``tbi_trace`` with seeded placeholder fields,
    and the offsets of every field that differs between traces. Every
    such field has a fixed width (ids, a 7-byte service name, fixed64
    times, the header), so a trace's object is this one with those bytes
    replaced: ``tbi_objects`` builds a block's objects so, and checks a
    sample against the proto's own serialization."""
    import numpy as np

    from tempo_tpu_torch.model.codec import codec_for

    rng = np.random.default_rng(0x7B1)
    tid, sids, svc = rng.bytes(16), rng.bytes(8 * TBI_SPANS), "Zq#Wx!Y"
    st, en = (rng.integers(1 << 40, 1 << 62, size=TBI_SPANS)
              for _ in range(2))
    obj = codec_for("v2").marshal(tbi_trace(tid, svc, st, en, sids), 0, 0)

    def where(pat: bytes, count: int = 1) -> list:
        out, pos = [], obj.find(pat)
        while pos >= 0:
            out.append(pos)
            pos = obj.find(pat, pos + 1)
        if len(out) != count:
            raise AssertionError(f"template: {len(out)} placeholders")
        return out

    root = where(sids[:8], TBI_SPANS)   # span 0's id, then 7 parent ids
    offs = {"tid": where(tid, TBI_SPANS), "svc": where(svc.encode()),
            "sid": root[:1] + [where(sids[8 * i:8 * i + 8])[0]
                               for i in range(1, TBI_SPANS)],
            "parent": root[1:],
            "start": [where(int(v).to_bytes(8, "little"))[0] for v in st],
            "end": [where(int(v).to_bytes(8, "little"))[0] for v in en]}
    return obj, offs


def tbi_objects(tpl: tuple, rows: dict, val_dict: list, sids):
    """A block's v2 objects, ``[n, L]`` uint8, row j the object of
    ``tbi_trace`` for entry j of `rows` with span ids ``sids[j]``
    (``[n, TBI_SPANS, 8]`` uint8) and header (start, end)."""
    import numpy as np

    obj, offs = tpl
    n = len(rows["tid"])
    arr = np.empty((n, len(obj)), dtype=np.uint8)
    arr[:] = np.frombuffer(obj, dtype=np.uint8)
    for k, col in ((0, "start"), (4, "end")):
        arr[:, k:k + 4] = rows[col].astype("<u4").reshape(n, 1).view(
            np.uint8)
    for o in offs["tid"]:
        arr[:, o:o + 16] = rows["tid"]
    names = [v.encode() for v in val_dict]
    used = np.unique(rows["svc"])
    if any(len(names[int(i)]) != 7 for i in used):
        raise AssertionError("service names of the template's width only")
    table = np.zeros((len(names), 7), dtype=np.uint8)
    for i in used:
        table[int(i)] = np.frombuffer(names[int(i)], dtype=np.uint8)
    o = offs["svc"][0]
    arr[:, o:o + 7] = table[rows["svc"]]
    for i, o in enumerate(offs["sid"]):
        arr[:, o:o + 8] = sids[:, i]
    for o in offs["parent"]:
        arr[:, o:o + 8] = sids[:, 0]
    st, en = tbi_times(rows["start"], rows["dur"])
    for col, key in ((st, "start"), (en, "end")):
        b8 = col.astype("<u8").view(np.uint8).reshape(n, TBI_SPANS, 8)
        for i, o in enumerate(offs[key]):
            arr[:, o:o + 8] = b8[:, i]
    return arr


def tbi_rows(pages) -> dict:
    """The valid entries of a block's pages as flat columns."""
    import numpy as np

    valid = np.asarray(pages.entry_valid).reshape(-1)
    idx = np.flatnonzero(valid)
    return {"idx": idx,
            "tid": np.asarray(pages.trace_ids).reshape(-1, 16)[idx],
            "start": np.asarray(pages.entry_start).reshape(-1)[idx],
            "end": np.asarray(pages.entry_end).reshape(-1)[idx],
            "dur": np.asarray(pages.entry_dur).reshape(-1)[idx],
            "svc": np.asarray(pages.entry_root_svc).reshape(-1)[idx]}


def tbi_write_block(be, b: int, pages, objects: list) -> None:
    """Block b through the port's writers: its search container
    (``write_search_objects``), then its trace objects (``StreamingBlock``,
    zlib, 1 MiB pages), meta.json last, once, with both sets of fields.
    `objects`: (id, object, start, end) in any order."""
    from tempo_tpu_torch.backend.types import BlockMeta
    from tempo_tpu_torch.encoding.v2.streaming_block import StreamingBlock
    from tempo_tpu_torch.search.backend_search_block import \
        write_search_objects

    meta = BlockMeta(tenant_id=TBI_TENANT, block_id=block_id(b),
                     encoding="zlib", data_encoding="v2")
    write_search_objects(be, meta, pages, "zlib")
    sb = StreamingBlock(meta, page_size=1 << 20, backend=be)
    try:
        for tid, obj, s, e in sorted(objects, key=lambda o: o[0]):
            sb.add_object(tid, obj, s, e)
        sb.complete()
    except BaseException:
        sb.abort()
        raise


def tbi_corpus(root: str, blocks: int, n: int, seed: int) -> dict:
    """Writes `blocks` blocks of n traces (the tag corpus's shapes, seed
    `seed`) and one block of partials. Returns the written objects of
    TBI_LOOKUPS seeded ids, each partial's id with its two objects, and
    the count of traces in the search containers."""
    import numpy as np

    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.model.codec import codec_for
    from tempo_tpu_torch.search.columnar import ColumnarPages

    be = LocalBackend(root)
    codec = codec_for("v2")
    tpl = tbi_template()
    rng = np.random.default_rng([seed, 1])
    total = blocks * n
    sample = set(rng.choice(total, size=min(TBI_LOOKUPS, total),
                            replace=False).tolist())
    expect: dict = {}      # sampled id -> object
    part_rows = []         # (pages, entry position) of the partials
    part_objects = []      # (id, partial object, start, end, object)
    lock = threading.Lock()

    def one(b):
        pages = make_block(seed, b, n, ENTRIES_PER_PAGE)
        rows = tbi_rows(pages)
        m = len(rows["idx"])
        sids = np.frombuffer(np.random.default_rng([seed, b, 2]).bytes(
            m * TBI_SPANS * 8), dtype=np.uint8).reshape(m, TBI_SPANS, 8)
        arr = tbi_objects(tpl, rows, pages.val_dict, sids)
        objs = [arr[j].tobytes() for j in range(m)]
        tids = [rows["tid"][j].tobytes() for j in range(m)]
        part = np.flatnonzero(np.random.default_rng([seed, b, 3]).integers(
            0, TBI_PARTIAL_EVERY, size=m) == 0) if b < TBI_PARTIAL_BLOCKS \
            else np.zeros(0, dtype=np.int64)
        psids = np.random.default_rng([seed, b, 4]).bytes(16 * len(part))
        mine_rows, mine_parts = [], []
        st, en = tbi_times(rows["start"], rows["dur"])
        # the template's objects against the proto's own bytes: the first
        # entries and every one with a partial
        for j in sorted(set(range(min(8, m))) | set(part.tolist())):
            s, e = int(rows["start"][j]), int(rows["end"][j])
            t = tbi_trace(tids[j], pages.val_dict[int(rows["svc"][j])],
                          st[j], en[j], sids[j].tobytes())
            if codec.marshal(t, s, e) != objs[j]:
                raise AssertionError(f"block {b} entry {j}: template object "
                                     "differs from the proto's bytes")
            if j in part:
                k = int(np.searchsorted(part, j))
                p = codec.marshal(tbi_partial(t, psids[16 * k:16 * k + 16]),
                                  s, e)
                mine_parts.append((tids[j], p, s, e, objs[j]))
                mine_rows.append((pages, int(rows["idx"][j])))
        mine = {tids[j]: objs[j] for j in range(m) if b * n + j in sample}
        tbi_write_block(be, b, pages,
                        [(tids[j], objs[j], int(rows["start"][j]),
                          int(rows["end"][j])) for j in range(m)])
        with lock:
            expect.update(mine)
            part_rows.extend(mine_rows)
            part_objects.extend(mine_parts)

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(os.cpu_count() or 4, 8)) as ex:
        list(ex.map(one, range(blocks)))
    # the partials' block: their search entries copied from their blocks'
    # pages (one dictionary for every block of this corpus), and objects
    E = ENTRIES_PER_PAGE
    m = len(part_rows)
    P = max(1, -(-m // E))
    first = part_rows[0][0] if part_rows else make_block(seed, 0, 1, E)
    cols = {}
    for name in ("kv_key", "kv_val", "entry_start", "entry_end",
                 "entry_dur", "entry_valid", "entry_root_svc",
                 "entry_root_name", "trace_ids"):
        src = np.asarray(getattr(first, name))
        flat = np.zeros((P * E,) + src.shape[2:], dtype=src.dtype)
        if name in ("kv_key", "kv_val", "entry_root_svc",
                    "entry_root_name"):
            flat[...] = -1
        for k, (pg, pos) in enumerate(part_rows):
            flat[k] = np.asarray(getattr(pg, name)).reshape(
                (-1,) + src.shape[2:])[pos]
        cols[name] = flat.reshape((P, E) + src.shape[2:])
    pages = ColumnarPages.from_arrays(
        first.key_dict, first.val_dict, cols["kv_key"], cols["kv_val"],
        cols["entry_start"], cols["entry_end"], cols["entry_dur"],
        cols["entry_valid"], cols["entry_root_svc"], cols["entry_root_name"],
        cols["trace_ids"])
    tbi_write_block(be, blocks, pages, [o[:4] for o in part_objects])
    return {"expect": expect,
            "partials": {o[0]: (o[4], o[1]) for o in part_objects},
            "n_total": total + m, "n_partials": m}


def tbi_timed(fn, reps: int) -> dict:
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        lat.append(time.perf_counter() - t0)
    lat.sort()
    return {"p50_ms": lat[len(lat) // 2] * 1e3,
            "p95_ms": pct(lat, 0.95) * 1e3, "lat_ms": [x * 1e3 for x in lat]}


def trace_by_id_cell(args, work: str, report: dict, dbs: list,
                     launches: dict, device: str = "cuda") -> list:
    """The trace-by-ID cell (step 10 of the module docstring): search on
    the card, then open every trace it returned, then present and absent
    ids. Returns no kernel rows (its kernels are the tag cell's)."""
    import numpy as np
    import torch

    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.backend.types import bloom_name
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.encoding.v2.bloom import ShardedBloom
    from tempo_tpu_torch.encoding.v2.index import (IndexReader, IndexWriter,
                                                   Record)
    from tempo_tpu_torch.model.codec import codec_for
    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.utils.xxh64 import xxh64, xxh64_plain

    blocks, n = args.tbi_blocks, args.tbi_traces_per_block
    if blocks < TBI_PARTIAL_BLOCKS:
        raise ValueError(f"--tbi-blocks must be >= {TBI_PARTIAL_BLOCKS}")
    root = os.path.join(work, "tbi")
    seed = args.seed + 17
    out: dict = {"blocks": blocks, "traces_per_block": n,
                 "traces_per_block_asked": TBI_TRACES}
    report["trace_by_id"] = out
    if n < TBI_TRACES:
        print(f"trace-by-id: cut to {n} traces a block ({TBI_TRACES} "
              "asked)", flush=True)
    t0 = time.perf_counter()
    c = tbi_corpus(root, blocks, n, seed)
    out["write_s"] = time.perf_counter() - t0
    out["partials"] = c["n_partials"]
    print(f"trace-by-id corpus: {blocks} blocks x {n} traces and a block of "
          f"{c['n_partials']} partials written (search containers, data, "
          f"index, blooms; zlib) in {out['write_s']:.1f} s", flush=True)

    codec = codec_for("v2")
    db = TempoDB(LocalBackend(root),
                 TempoDBConfig(search_max_batch_pages=4096), device=device)
    dbs.append(db)
    db.poll()
    if len(db.blocklist.metas(TBI_TENANT)) != blocks + 1:
        raise AssertionError("trace-by-id: blocklist misses blocks")
    tags = dict(BENCH, **EXHAUSTIVE)
    req = SearchRequest(tags=dict(tags), limit=TBI_LIMIT)
    reset_counts()
    t0 = time.perf_counter()
    resp = canon(db.search(TBI_TENANT, req).response())
    if device != "cpu":
        torch.cuda.synchronize()
    out["search_ms"] = (time.perf_counter() - t0) * 1e3
    path = read_counts()
    if device != "cpu" and (path["multi_scan"] == 0 or path["topk"] == 0):
        raise AssertionError(f"trace-by-id search launched no kernel: {path}")
    add_counts(launches, path)
    out["launches"] = {k: v for k, v in path.items() if v}
    check_response("tbi_search", resp, tags, {"limit": TBI_LIMIT},
                   c["n_total"])
    t0 = time.perf_counter()
    cpu = TempoDB(LocalBackend(root),
                  TempoDBConfig(search_max_batch_pages=4096), device="cpu")
    dbs.append(cpu)
    cpu.poll()
    if canon(cpu.search(TBI_TENANT, SearchRequest(tags=dict(tags),
                                            limit=TBI_LIMIT)).response()) \
            != resp:
        raise AssertionError("trace-by-id search: card and CPU differ")
    cpu.close()
    dbs.remove(cpu)
    out["cpu_check_s"] = time.perf_counter() - t0
    if not resp.traces or (n >= TBI_TRACES
                           and len(resp.traces) != TBI_LIMIT):
        raise AssertionError(f"trace-by-id search: {len(resp.traces)} "
                             "results")

    def find(tid):
        obj, failed = db.find_trace_by_id(TBI_TENANT, tid)
        if failed:
            raise AssertionError(f"{tid.hex()}: {failed} blocks failed")
        return obj

    # search, then open every trace it returned
    t_open = time.perf_counter()
    first = None
    for r in resp.traces:
        tid = bytes.fromhex(r.trace_id)
        t0 = time.perf_counter()
        obj = find(tid)
        if first is None:
            first = (time.perf_counter() - t0) * 1e3
        if obj is None:
            raise AssertionError(f"searched trace {r.trace_id} not found")
        s = r.start_time_unix_nano // 1_000_000_000
        if codec.fast_range(obj) != (s, s + r.duration_ms // 1000):
            raise AssertionError(f"{r.trace_id}: header "
                                 f"{codec.fast_range(obj)}")
        t = codec.prepare_for_read(obj)
        svc = t.batches[0].resource.attributes[0].value.string_value
        spans = sum(len(ss.spans) for b in t.batches for ss in b.scope_spans)
        if svc != r.root_service_name or spans not in (TBI_SPANS,
                                                       TBI_SPANS + 2):
            raise AssertionError(f"{r.trace_id}: {svc}, {spans} spans")
    out["first_lookup_ms"] = first
    out["opened"] = len(resp.traces)
    out["open_s"] = time.perf_counter() - t_open
    # present ids: the written object, or the combine of both partials in
    # either order (the pool returns partials as its threads finish); then
    # the first TBI_LIMIT partials' ids; then absent ids, None with no
    # failed block. From CLIENTS threads: a lookup is mostly thread
    # starts, file opens and inflating a page, which overlap
    def check(tid, obj):
        got = find(tid)
        if tid in c["partials"]:
            a, p = c["partials"][tid]
            if got not in (codec.combine(a, p), codec.combine(p, a)):
                raise AssertionError(f"{tid.hex()}: partials not combined")
            return 1
        if got != obj:
            raise AssertionError(f"{tid.hex()}: wrong object")
        return 0

    checked = list(c["partials"].items())[:TBI_LIMIT]
    rng = np.random.default_rng([seed, 4])
    absent = [rng.bytes(16) for _ in range(TBI_LOOKUPS)]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=CLIENTS) as ex:
        partial_hits = sum(ex.map(lambda kv: check(*kv),
                                  c["expect"].items()))
        list(ex.map(lambda kv: check(kv[0], kv[1][0]), checked))
        for tid, got in zip(absent, ex.map(find, absent)):
            if got is not None:
                raise AssertionError(f"absent id {tid.hex()} found")
    out["checks_s"] = time.perf_counter() - t0
    out["present"] = len(c["expect"])
    out["present_partials"] = partial_hits
    out["partials_checked"] = len(checked)
    # the absent ids' bloom passes, over every block's shard
    t0 = time.perf_counter()
    be = LocalBackend(root)
    blooms = [(m, [be.read(TBI_TENANT, m.block_id, bloom_name(s))
                   for s in range(m.bloom_shard_count)])
              for m in db.blocklist.metas(TBI_TENANT)]
    passed = 0
    for tid in absent:
        for m, shards in blooms:
            passed += ShardedBloom.test_marshalled(
                shards[ShardedBloom.shard_for(tid, m.bloom_shard_count)],
                tid)
    out["bloom_count_s"] = time.perf_counter() - t0
    out["absent"] = len(absent)
    out["absent_bloom_passes"] = passed
    out["absent_block_tests"] = len(absent) * len(blooms)
    hit = next(t for t in c["expect"] if t not in c["partials"])
    part = next(iter(c["partials"]))
    for name, tid in (("hit", hit), ("miss", absent[0]), ("partial", part)):
        out[name] = tbi_timed(lambda tid=tid: find(tid), args.reps)
    # a full index page of TBI_INDEX_RECORDS records, as a block of about a
    # GiB holds: a lookup checksums and parses each page of a block's index
    # afresh, a cost the cell's one-page indexes hide
    rng_ix = np.random.default_rng([seed, 5])
    ix = IndexWriter(TBI_INDEX_RECORDS).write(
        [Record(k, 1000 * i, 1000) for i, k in enumerate(
            sorted(rng_ix.bytes(16) for _ in range(TBI_INDEX_RECORDS)))])
    body = ix[12:]
    out["index_page_bytes"] = len(body)
    if xxh64(body) != xxh64_plain(body):
        raise AssertionError("xxh64: the host library and the plain "
                             "version differ")
    out["xxh64_page"] = tbi_timed(lambda: xxh64(body), args.reps)
    out["xxh64_plain_page"] = tbi_timed(lambda: xxh64_plain(body), 3)
    out["index_reader_page"] = tbi_timed(lambda: IndexReader(ix), args.reps)
    print(f"trace-by-id: search (limit {TBI_LIMIT}) {out['search_ms']:.2f} "
          f"ms, launches {json.dumps(out['launches'])}; opened "
          f"{out['opened']} of {len(resp.traces)} results, first lookup "
          f"{first:.2f} ms; {out['present']} present ids found "
          f"({partial_hits} combined from 2 partials), {len(checked)} "
          f"partial ids combined, {len(absent)} absent "
          f"ids none found ({out['checks_s']:.1f} s from {CLIENTS} "
          f"threads), {passed} of {out['absent_block_tests']} block "
          f"bloom tests passed; p50/p95 over {args.reps}: hit "
          f"{out['hit']['p50_ms']:.2f}/{out['hit']['p95_ms']:.2f} ms, miss "
          f"{out['miss']['p50_ms']:.2f}/{out['miss']['p95_ms']:.2f} ms, "
          f"partial {out['partial']['p50_ms']:.2f}/"
          f"{out['partial']['p95_ms']:.2f} ms; a {TBI_INDEX_RECORDS}-record "
          f"index page ({len(body)} B): xxh64 p50/p95 "
          f"{out['xxh64_page']['p50_ms']:.4f}/"
          f"{out['xxh64_page']['p95_ms']:.4f} ms (plain Python "
          f"{out['xxh64_plain_page']['p50_ms']:.2f} ms), IndexReader "
          f"{out['index_reader_page']['p50_ms']:.2f}/"
          f"{out['index_reader_page']['p95_ms']:.2f} ms", flush=True)
    db.close()
    dbs.remove(db)
    return []


ING_TENANT = "ingest"
ING_BASE_S = BASE_S + 2 * 86_400   # the ingest cell's traces, two days on
ING_SPANS = 8                   # spans a trace: 4 under each of 2 services
ING_PUSH_SPANS = 8192           # spans a push (the OTLP collector's batch)
ING_SPLIT_EVERY = 64            # 1 trace in 64 spans two pushes
ING_SKEW_EVERY = 256            # 1 trace in 256 has a span ending early
ING_TRACES = 16_384             # traces a head block, unless cut
ING_BARE = 1024                 # traces of the block with no container
ING_LIMIT = 1000                # the exhaustive request's limit
# the downstream services a trace's spans 4-7 sit under
ING_DEPS = [f"dep-{i:02d}" for i in range(16)]


def ing_requests(blocks: int) -> dict:
    """The ingest cell's requests, the exhaustive one first (it stages
    every group, and its matches are counted on the host)."""
    w0 = ING_BASE_S + (blocks // 2) * BLOCK_SPAN_S
    return {
        "ing_exhaustive": (dict(BENCH, **EXHAUSTIVE), {"limit": ING_LIMIT}),
        "ing_service": ({"service.name": "svc-007"}, {"limit": 20}),
        "ing_and": ({"service.name": "svc-01", "http.method": "GET"},
                    {"limit": 20}),
        "ing_error": ({"error": "true", "region": "eu"}, {"limit": 50}),
        "ing_duration": ({}, {"min_duration_ms": 30_000,
                              "max_duration_ms": 59_999, "limit": 20}),
        "ing_window": ({"name": "op-3"}, {"start": w0 + 120,
                                          "end": w0 + 240, "limit": 20}),
    }


def ing_columns(seed: int, b: int, n: int) -> dict:
    """Block b's n traces as numpy columns: ids, span ids, the root's
    service (of KEYS) and the downstream one (of ING_DEPS), start second, root duration (log-uniform over
    1-60,000 ms), status and method, and which traces are split over two
    pushes or carry a span that ends before it starts."""
    import numpy as np

    rng = np.random.default_rng([seed, b])
    ids = rng.integers(0, 256, size=(n, 16), dtype=np.uint8)
    ids[:, 0] = b   # distinct across blocks
    return {
        "tid": ids,
        "sid": rng.integers(0, 256, size=(n, ING_SPANS, 8), dtype=np.uint8),
        "svc": rng.integers(0, 64, size=n),
        "svc2": rng.integers(0, len(ING_DEPS), size=n),
        "start": ING_BASE_S + b * BLOCK_SPAN_S
        + rng.integers(0, BLOCK_SPAN_S, size=n),
        "dur": np.exp(rng.uniform(0, np.log(60_000), size=n)).astype(
            np.int64),
        "status": rng.integers(0, len(KEYS["http.status_code"]), size=n),
        "method": rng.integers(0, len(KEYS["http.method"]), size=n),
        "split": rng.integers(0, ING_SPLIT_EVERY, size=n) == 0,
        "skew": rng.integers(0, ING_SKEW_EVERY, size=n) == 0,
        "skew_ms": rng.integers(1, 5_000, size=n),
    }


def ing_resource(tempopb, name: str, k: int):
    """Service `name`'s resource: its name, and a host, region and
    namespace that follow from its number `k` (a collector batches spans
    by resource)."""
    rs = tempopb.ResourceSpans()
    for key, val in (("service.name", name),
                     ("host.name", KEYS["host.name"][k * 31 % 2000]),
                     ("region", KEYS["region"][k % 6]),
                     ("k8s.namespace", KEYS["k8s.namespace"][k % 16])):
        kv = rs.resource.attributes.add()
        kv.key = key
        kv.value.string_value = val
    ss = rs.scope_spans.add()
    ss.scope.name = "chip-smoke-ingest"
    ss.scope.version = "1.0"
    return rs


def ing_pushes(cols: dict, per_push: int) -> list:
    """The block's pushes, each a list of ResourceSpans, one a service.
    A trace's spans 0-3 (the root and 3 children) sit under its service,
    spans 4-7 under the downstream one, the root's attributes carry
    http.method and http.status_code (int), the children component; a
    split trace's spans 4-7 come in the next push (none in a block's last
    push is split). Returns (pushes, split mask, skew mask)."""
    import numpy as np

    from tempo_tpu_torch import tempopb

    n = len(cols["tid"])
    n_push = -(-n // per_push)
    split = cols["split"] & (np.arange(n) // per_push < n_push - 1)
    st, en = tbi_times(cols["start"], cols["dur"])
    en[cols["skew"], ING_SPANS - 1] = (st[cols["skew"], ING_SPANS - 1]
                                       - cols["skew_ms"][cols["skew"]]
                                       * 1_000_000)
    kv = tempopb.KeyValue
    av = tempopb.AnyValue
    methods = [kv(key="http.method", value=av(string_value=m))
               for m in KEYS["http.method"]]
    codes = [kv(key="http.status_code", value=av(int_value=int(c)))
             for c in KEYS["http.status_code"]]
    comps = [[kv(key="component", value=av(string_value=c))]
             for c in KEYS["component"]]
    pushes = [dict() for _ in range(n_push)]
    for j in range(n):
        p = j // per_push
        tid = cols["tid"][j].tobytes()
        sids = cols["sid"][j]
        root = sids[0].tobytes()
        status = int(cols["status"][j])
        for i in range(ING_SPANS):
            svc = (KEYS["service.name"][int(cols["svc"][j])] if i < 4
                   else ING_DEPS[int(cols["svc2"][j])])
            q = p + 1 if (i >= 4 and split[j]) else p
            rs = pushes[q].get(svc)
            if rs is None:
                rs = pushes[q][svc] = ing_resource(
                    tempopb, svc, int(cols["svc"][j] if i < 4
                                      else 64 + cols["svc2"][j]))
            if i == 0:
                attrs = [methods[int(cols["method"][j])], codes[status]]
            else:
                attrs = comps[i % 4]
            sp = rs.scope_spans[0].spans.add(
                trace_id=tid, span_id=sids[i].tobytes(),
                parent_span_id=b"" if i == 0 else root,
                name=SPAN_OPS[i], kind=2 if i == 0 else 3,
                start_time_unix_nano=int(st[j, i]),
                end_time_unix_nano=int(en[j, i]), attributes=attrs)
            if i == 0 and KEYS["http.status_code"][status] >= "500":
                sp.status.code = tempopb.Status.STATUS_CODE_ERROR
    return [list(p.values()) for p in pushes], split, cols["skew"]


class IngTimes:
    """Seconds spent in the parts of ``complete_block``: the streaming
    writer's complete() (the last page, index, bloom shards, meta.json)
    and the search container's build and write, by wrapping both for the
    cell's duration; the rest of a completion is the trace objects."""

    def __init__(self):
        self.complete_s = 0.0
        self.container_s = 0.0

    def __enter__(self):
        from tempo_tpu_torch.db import tempodb
        from tempo_tpu_torch.encoding.v2.streaming_block import \
            StreamingBlock

        self._saved = (tempodb.write_search_block, StreamingBlock.complete)
        write, complete = self._saved

        def timed_write(*a, **kw):
            t0 = time.perf_counter()
            try:
                return write(*a, **kw)
            finally:
                self.container_s += time.perf_counter() - t0

        def timed_complete(sb, *a, **kw):
            t0 = time.perf_counter()
            try:
                return complete(sb, *a, **kw)
            finally:
                self.complete_s += time.perf_counter() - t0

        tempodb.write_search_block = timed_write
        StreamingBlock.complete = timed_complete
        return self

    def __exit__(self, *exc):
        from tempo_tpu_torch.db import tempodb
        from tempo_tpu_torch.encoding.v2.streaming_block import \
            StreamingBlock

        tempodb.write_search_block, StreamingBlock.complete = self._saved
        return False


def ingest_cell(args, work: str, report: dict, dbs: list,
                launches: dict, device: str = "cuda") -> list:
    """The ingest cell (step 11 of the module docstring): OTLP pushes
    through the port's write path into head blocks, a crash and its
    replay, completion with and without a search container, then
    searches on the card held against the CPU path and a host count, and
    every result opened. Returns no kernel rows (its kernels, K1, K1s
    and K2, have the tag cell's rows); their launches are added."""
    import numpy as np
    import torch

    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.backend.types import NAME_SEARCH
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.encoding.compression import compress
    from tempo_tpu_torch.model import matches
    from tempo_tpu_torch.model.codec import codec_for
    from tempo_tpu_torch.model.types import (SearchBlockRequest,
                                             SearchRequest)
    from tempo_tpu_torch.modules import distributor
    from tempo_tpu_torch.modules.distributor import (push_items,
                                                     push_items_plain)
    from tempo_tpu_torch.search import structural
    from tempo_tpu_torch.search.backend_search_block import \
        BackendSearchBlock
    from tempo_tpu_torch.search.data import (clone_search_data,
                                             decode_search_data,
                                             encode_search_data,
                                             search_data_matches)
    from tempo_tpu_torch.search.streaming import StreamingSearchBlock

    blocks, n = args.ingest_blocks, args.ingest_traces_per_block
    n_bare, per_push = args.ingest_bare_traces, args.ingest_push_spans
    if blocks < 2:
        raise ValueError("--ingest-blocks must be >= 2")
    seed = args.seed + 18
    root = os.path.join(work, "ingest")
    wal_dir = os.path.join(work, "ingest-wal")
    out: dict = {"blocks": blocks, "traces_per_block": n,
                 "traces_per_block_asked": ING_TRACES, "bare_traces": n_bare,
                 "push_spans": per_push}
    report["ingest"] = out
    if n < ING_TRACES:
        print(f"ingest: cut to {n} traces a block ({ING_TRACES} asked)",
              flush=True)
    cfg = TempoDBConfig(block_encoding="zlib", search_encoding="zlib",
                        wal_encoding="auto", search_max_batch_pages=4096)
    reset_counts()
    db = TempoDB(LocalBackend(root), cfg, device=device, wal_dir=wal_dir)
    dbs.append(db)
    out["wal_encoding"] = db.wal.encoding
    print(f"ingest: the WAL's codec auto resolved to {db.wal.encoding}",
          flush=True)
    distributor.NATIVE_WALKS.reset()
    codec = codec_for("v2")
    sync = (torch.cuda.synchronize if device != "cpu" else (lambda: None))

    pushed_sd: dict = {}      # tid -> merged pushed SearchData (containers)
    bare_traces: dict = {}    # tid -> pushed Trace (the bare block)
    expect: dict = {}         # tid -> AppendBlock.find bytes, pre-completion
    t = {"gen": 0.0, "extract": 0.0, "append": 0.0, "head": 0.0}
    n_spans = n_traces = wal_bytes = seg_bytes = n_pushes = n_records = 0
    n_split = n_skew = 0
    complete_s = []
    # the first head's pushes through both walks: seconds, spans
    both = {"native_s": 0.0, "plain_s": 0.0, "spans": 0, "pushes": 0,
            "codec_s": 0.0, "segments": 0}

    def ingest(blk, ssb, pushes, bare: bool, plain: bool = False):
        nonlocal n_spans, n_traces, wal_bytes, seg_bytes, n_pushes, n_records
        for batches in pushes:
            t0 = time.perf_counter()
            items, ns = push_items(batches)
            t1 = time.perf_counter()
            n_pushes += 1
            if plain:
                want = push_items_plain(batches)
                both["plain_s"] += time.perf_counter() - t1
                both["native_s"] += t1 - t0
                both["spans"] += ns
                both["pushes"] += 1
                if (items, ns) != want:
                    raise AssertionError("ingest: the native walker's items "
                                         "differ from the Python walk's")
                tc = time.perf_counter()     # the WAL codec alone
                for it in items:
                    compress(it[3], db.wal.encoding)
                both["codec_s"] += time.perf_counter() - tc
                both["segments"] += len(items)
            t["extract"] += t1 - t0
            t1 = time.perf_counter()
            before = blk.data_length
            for tid, s, e, seg, _ in items:
                blk.append(tid, seg, s, e)
            t2 = time.perf_counter()
            for tid, _, _, seg, sd in items:
                ssb.append(tid, decode_search_data(sd, tid))
            t3 = time.perf_counter()
            t["append"] += t2 - t1
            t["head"] += t3 - t2
            wal_bytes += blk.data_length - before
            n_records += len(items)
            seg_bytes += sum(len(it[3]) for it in items)
            n_spans += ns
            for tid, _, _, seg, sd in items:
                if bare:
                    tr = codec.prepare_for_read(seg)
                    if tid in bare_traces:
                        bare_traces[tid].MergeFrom(tr)
                    else:
                        bare_traces[tid] = tr
                    continue
                part = decode_search_data(sd, tid)
                cur = pushed_sd.get(tid)
                if cur is None:
                    pushed_sd[tid] = part
                else:
                    cur = clone_search_data(cur)
                    cur.merge(part)
                    pushed_sd[tid] = cur

    def complete(blk, ssb, entries):
        t0 = time.perf_counter()
        meta = db.complete_block(blk, entries)
        complete_s.append(time.perf_counter() - t0)
        blk.clear()
        ssb.clear()
        return meta

    times = IngTimes()
    with times:
        for b in range(blocks + 1):
            bare = b == blocks
            t0 = time.perf_counter()
            cols = ing_columns(seed, b, n_bare if bare else n)
            pushes, split, skew = ing_pushes(cols, per_push // ING_SPANS)
            t["gen"] += time.perf_counter() - t0
            n_split += int(split.sum())
            n_skew += int(skew.sum())
            n_traces += len(cols["tid"])
            blk = db.wal.new_block(ING_TENANT,
                                   block_id=f"00000000-0000-4000-8018-"
                                   f"{b:012d}")
            ssb = StreamingSearchBlock(blk.path + ".search")
            t_last = time.perf_counter()
            ingest(blk, ssb, pushes[:-1], bare, plain=b == 0)
            t_last = time.perf_counter()
            ingest(blk, ssb, pushes[-1:], bare, plain=b == 0)
            if b == 0:
                both["traces"] = len(cols["tid"])
            last_tid = cols["tid"][-1].tobytes()
            for tid, obj in blk.iterator():
                expect[tid] = obj
            if len(blk) != len(cols["tid"]) + int(split.sum()):
                raise AssertionError(f"ingest block {b}: {len(blk)} records")
            if b == blocks - 1:
                # the crash: the head's objects dropped without a close
                # (every append was flushed), then replayed
                path = blk.path
                orig = list(blk.iterator())
                orig_entries = [encode_search_data(e) for e in ssb.entries()]
                del blk, ssb
                gc.collect()
                t0 = time.perf_counter()
                replayed, removed = db.wal.replay_all()
                ssb = StreamingSearchBlock.rescan(path + ".search")
                out["replay"] = {"s": time.perf_counter() - t0,
                                 "bytes": db.wal.last_replay["bytes"],
                                 "objects": len(orig),
                                 "records": sum(len(r) for r in replayed)}
                if removed or len(replayed) != 1 or replayed[0].path != path:
                    raise AssertionError(f"replay: {removed}, "
                                         f"{[r.path for r in replayed]}")
                blk = replayed[0]
                if list(blk.iterator()) != orig:
                    raise AssertionError("replay: objects differ")
                if [encode_search_data(e) for e in ssb.entries()] != \
                        orig_entries:
                    raise AssertionError("replay: search entries differ")
            meta = complete(blk, ssb, None if bare else ssb.entries())
            if bare:
                db.poll()
                # the last push, searchable: a search that returns its last
                # trace (the block's own window, its root service)
                s = int(cols["start"][-1])
                req = SearchRequest(tags={"service.name": KEYS[
                    "service.name"][int(cols["svc"][-1])]},
                                    start=s, end=s, limit=100)
                for tries in range(1, 4):
                    resp = canon(db.search(ING_TENANT, req).response())
                    sync()
                    if last_tid.hex() in {r.trace_id for r in resp.traces}:
                        break
                else:
                    raise AssertionError("ingest: the last push's trace "
                                         "was not found")
                out["ingest_to_searchable_s"] = time.perf_counter() - t_last
                out["ingest_to_searchable_tries"] = tries
            if bare == bool(meta.search_pages):
                raise AssertionError(f"ingest block {b}: search pages "
                                     f"{meta.search_pages}")
    if distributor.NATIVE_WALKS.n != n_pushes:
        raise AssertionError(f"ingest: {distributor.NATIVE_WALKS.n} of "
                             f"{n_pushes} pushes went through the native "
                             "walker")
    out["pushes"] = n_pushes
    out["native_walks"] = distributor.NATIVE_WALKS.n
    out["first_head_walks"] = {
        "traces": both["traces"], "spans": both["spans"],
        "pushes": both["pushes"], "items_equal": True,
        "native_us_per_trace": both["native_s"] / both["traces"] * 1e6,
        "plain_us_per_trace": both["plain_s"] / both["traces"] * 1e6,
        "native_spans_per_s": both["spans"] / both["native_s"],
        "plain_spans_per_s": both["spans"] / both["plain_s"]}
    out["traces"] = n_traces
    out["spans"] = n_spans
    out["split_traces"] = n_split
    out["skewed_traces"] = n_skew
    out["gen_s"] = t["gen"]
    out["extract_s"] = t["extract"]
    out["extract_us_per_trace"] = t["extract"] / n_traces * 1e6
    out["spans_per_s"] = n_spans / t["extract"]
    out["wal_append_s"] = t["append"]
    out["wal_bytes"] = wal_bytes
    out["segment_bytes"] = seg_bytes
    out["wal_append_mb_per_s"] = wal_bytes / t["append"] / 1e6
    out["wal_records"] = n_records
    out["wal_append_us_per_record"] = t["append"] / n_records * 1e6
    out["wal_codec_us_per_segment"] = both["codec_s"] / both["segments"] \
        * 1e6
    out["search_head_append_s"] = t["head"]
    nb = blocks + 1
    out["complete_block_s"] = complete_s
    out["complete"] = {
        "per_block_s": sum(complete_s) / nb,
        "objects_s": (sum(complete_s) - times.complete_s
                      - times.container_s) / nb,
        "index_bloom_s": times.complete_s / nb,
        "container_s": times.container_s / blocks}
    be = LocalBackend(root)
    metas = db.blocklist.metas(ING_TENANT)
    if len(metas) != nb or sum(
            NAME_SEARCH in os.listdir(os.path.join(root, ING_TENANT,
                                                   m.block_id))
            for m in metas) != blocks:
        raise AssertionError("ingest: blocks or containers missing")
    # the WAL's files (its host-state subdirectory holds the search
    # headers' snapshot, not WAL records)
    left = [n for n in os.listdir(wal_dir)
            if os.path.isfile(os.path.join(wal_dir, n))]
    if left:
        raise AssertionError(f"ingest: WAL left {left}")
    w = out["first_head_walks"]
    print(f"ingest: {n_pushes} of {n_pushes} pushes through the native "
          f"walker; the first head's {w['pushes']} pushes through both "
          f"walks, items byte-equal: native {w['native_us_per_trace']:.1f} "
          f"us a trace ({w['native_spans_per_s']:.0f} spans/s), Python "
          f"{w['plain_us_per_trace']:.1f} us a trace "
          f"({w['plain_spans_per_s']:.0f} spans/s)", flush=True)
    print(f"ingest: {nb} blocks ({blocks} x {n} traces, {n_bare} without a "
          f"container), {n_traces} traces, {n_spans} spans in pushes of "
          f"{per_push} spans ({n_split} traces split over two pushes, "
          f"{n_skew} with a span ending before it starts); generated in "
          f"{t['gen']:.1f} s; regroup and extraction {t['extract']:.1f} s "
          f"({out['extract_us_per_trace']:.1f} us a trace, "
          f"{out['spans_per_s']:.0f} spans/s); WAL ({db.wal.encoding}) append "
          f"{wal_bytes} B, {n_records} records, in "
          f"{t['append']:.2f} s ({out['wal_append_mb_per_s']:.1f} MB/s, "
          f"{out['wal_append_us_per_record']:.1f} us a record, of which "
          f"the codec {out['wal_codec_us_per_segment']:.1f} us), "
          f"search head {t['head']:.2f} s; replay "
          f"{out['replay']['s']:.2f} s; complete_block "
          f"{out['complete']['per_block_s']:.2f} s a block (objects "
          f"{out['complete']['objects_s']:.2f}, index and bloom "
          f"{out['complete']['index_bloom_s']:.3f}, container "
          f"{out['complete']['container_s']:.2f} s); ingest to searchable "
          f"{out['ingest_to_searchable_s']:.2f} s", flush=True)

    # searches on the card, each against the CPU path; the exhaustive one
    # first (it stages every group) and against a host count
    reqs = ing_requests(blocks)
    db.poll()
    cpu = TempoDB(LocalBackend(root), cfg, device="cpu")
    dbs.append(cpu)
    cpu.poll()
    resps = {}
    for name, (tags, kw) in reqs.items():
        t0 = time.perf_counter()
        resp = canon(db.search(ING_TENANT, SearchRequest(tags=dict(tags), **kw)
                         ).response())
        sync()
        if name == "ing_exhaustive":
            out["first_search_ms"] = (time.perf_counter() - t0) * 1e3
        want = canon(cpu.search(ING_TENANT, SearchRequest(tags=dict(tags),
                                                          **kw)).response())
        if resp != want:
            raise AssertionError(f"ingest {name}: card and CPU differ")
        check_response(name, resp, tags, kw, n_traces)
        resps[name] = resp
    tags, kw = reqs["ing_exhaustive"]
    req = SearchRequest(tags=dict(tags), **kw)
    host = {tid.hex() for tid, sd in pushed_sd.items()
            if search_data_matches(sd, req, structural.OFF)}
    host |= {tid.hex() for tid, tr in bare_traces.items()
             if matches(tr, req, structural.OFF)}
    got = {r.trace_id for r in resps["ing_exhaustive"].traces}
    if not host or len(host) >= ING_LIMIT or got != host:
        raise AssertionError(f"ingest exhaustive: {len(got)} results, host "
                             f"count {len(host)}")
    out["exhaustive_matches"] = len(got)
    out["host_matches"] = len(host)
    for name, resp in resps.items():
        if not resp.traces and name != "ing_window":
            raise AssertionError(f"ingest {name}: no result")
    name = "ing_service"
    tags, kw = reqs[name]
    lat = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        r = db.search(ING_TENANT, SearchRequest(tags=dict(tags), **kw))
        sync()
        lat.append(time.perf_counter() - t0)
        if canon(r.response()) != resps[name]:
            raise AssertionError("ingest warm search differs")
    lat.sort()
    out["warm"] = {"request": name, "p50_ms": lat[len(lat) // 2] * 1e3,
                   "p95_ms": pct(lat, 0.95) * 1e3,
                   "lat_ms": [x * 1e3 for x in lat]}
    # one written block through search_block (the batcher, K1) and the
    # single-block engine (K1s); the bare block through search_block
    for m in (metas[0], metas[-1]):
        sbr = dict(tenant_id=ING_TENANT, block_id=m.block_id,
                   encoding=m.encoding, version=m.version,
                   data_encoding=m.data_encoding, start_time=m.start_time,
                   end_time=m.end_time)
        for nm in ("ing_service", "ing_exhaustive"):
            tags, kw = reqs[nm]
            got_b = db.search_block(SearchBlockRequest(
                search_req=SearchRequest(tags=dict(tags), **kw), **sbr))
            want_b = cpu.search_block(SearchBlockRequest(
                search_req=SearchRequest(tags=dict(tags), **kw), **sbr))
            if canon(got_b.response()) != canon(want_b.response()):
                raise AssertionError(f"ingest search_block {nm}: card and "
                                     "CPU differ")
    tags, kw = reqs["ing_exhaustive"]
    single = canon(BackendSearchBlock(be, metas[0], device=device).search(
        SearchRequest(tags=dict(tags), **kw)).response())
    single_cpu = canon(BackendSearchBlock(be, metas[0], device="cpu").search(
        SearchRequest(tags=dict(tags), **kw)).response())
    if single != single_cpu or not {r.trace_id for r in single.traces} \
            <= got:
        raise AssertionError("ingest single-block search differs")
    sync()
    path = read_counts()
    cpu.close()
    dbs.remove(cpu)
    if device != "cpu" and not (path["multi_scan"] and path["topk"]
                                and path["scan_single"]):
        raise AssertionError(f"ingest: kernels not launched: {path}")
    add_counts(launches, path)
    out["launches"] = {k: v for k, v in path.items() if v}
    # every result opened, byte-equal to its WAL bytes before completion
    ids = sorted({r.trace_id for resp in resps.values()
                  for r in resp.traces})
    t0 = time.perf_counter()

    def open_one(h):
        obj, failed = db.find_trace_by_id(ING_TENANT, bytes.fromhex(h))
        if failed or obj != expect[bytes.fromhex(h)]:
            raise AssertionError(f"ingest: {h} opened differs from the WAL")
        return 1

    with concurrent.futures.ThreadPoolExecutor(max_workers=CLIENTS) as ex:
        out["opened"] = sum(ex.map(open_one, ids))
    out["open_s"] = time.perf_counter() - t0
    print(f"ingest searches: exhaustive {len(got)} matches (= the host "
          f"count), first search {out['first_search_ms']:.1f} ms, "
          f"{name} warm p50/p95 {out['warm']['p50_ms']:.2f}/"
          f"{out['warm']['p95_ms']:.2f} ms over {args.reps}; launches "
          f"{json.dumps(out['launches'])}; {out['opened']} results opened, "
          f"each its WAL bytes ({out['open_s']:.1f} s)", flush=True)
    db.close()
    dbs.remove(db)
    ingest_zstd_block(args, work, out, dbs, launches, device)
    return []


def ingest_zstd_block(args, work: str, out: dict, dbs: list,
                      launches: dict, device: str) -> None:
    """Where the host has libzstd: one more head block, of the ingest
    cell's shapes, under ``TempoDBConfig()``'s default codecs (zstd blocks
    and containers, the WAL's ``auto``): pushed, completed, searched on
    the card against the CPU path, and each result opened, byte-equal to
    its WAL bytes."""
    import torch

    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.modules.distributor import push_items
    from tempo_tpu_torch.ops import native
    from tempo_tpu_torch.search.data import decode_search_data
    from tempo_tpu_torch.search.streaming import StreamingSearchBlock

    if "zstd" not in native.codecs():
        out["zstd_block"] = None
        print("ingest: this host has no libzstd.so.1, so no zstd block",
              flush=True)
        return
    cfg = TempoDBConfig()
    if (cfg.block_encoding, cfg.search_encoding) != ("zstd", "zstd"):
        raise AssertionError("TempoDBConfig's default codecs moved")
    root = os.path.join(work, "ingest-zstd")
    reset_counts()
    db = TempoDB(LocalBackend(root), cfg, device=device,
                 wal_dir=os.path.join(work, "ingest-zstd-wal"))
    dbs.append(db)
    b = args.ingest_blocks + 1          # other trace ids than the cell's
    cols = ing_columns(args.seed + 18, b, args.ingest_traces_per_block)
    pushes, _split, _skew = ing_pushes(cols,
                                       args.ingest_push_spans // ING_SPANS)
    blk = db.wal.new_block(ING_TENANT,
                           block_id=f"00000000-0000-4000-8019-{b:012d}")
    ssb = StreamingSearchBlock(blk.path + ".search")
    for batches in pushes:
        for tid, s, e, seg, sd in push_items(batches)[0]:
            blk.append(tid, seg, s, e)
            ssb.append(tid, decode_search_data(sd, tid))
    expect = dict(blk.iterator())
    t0 = time.perf_counter()
    meta = db.complete_block(blk, ssb.entries())
    complete_s = time.perf_counter() - t0
    blk.clear()
    ssb.clear()
    hdr = json.loads(LocalBackend(root).read(ING_TENANT, meta.block_id,
                                             "search-header.json"))
    if meta.encoding != "zstd" or hdr.get("encoding") != "zstd":
        raise AssertionError(f"zstd block: {meta.encoding}, container "
                             f"{hdr.get('encoding')}")
    db.poll()
    cpu = TempoDB(LocalBackend(root), cfg, device="cpu")
    dbs.append(cpu)
    cpu.poll()
    reqs = ing_requests(1)
    ids = set()
    try:
        for name in ("ing_exhaustive", "ing_service", "ing_error"):
            tags, kw = reqs[name]
            resp = canon(db.search(ING_TENANT, SearchRequest(tags=dict(tags),
                                                       **kw)).response())
            if device != "cpu":
                torch.cuda.synchronize()
            if resp != canon(cpu.search(ING_TENANT, SearchRequest(
                    tags=dict(tags), **kw)).response()):
                raise AssertionError(f"zstd block {name}: card and CPU "
                                     "differ")
            if not resp.traces:
                raise AssertionError(f"zstd block {name}: no result")
            ids |= {r.trace_id for r in resp.traces}
    finally:
        cpu.close()
        dbs.remove(cpu)
    path = read_counts()
    if device != "cpu" and not (path["multi_scan"] and path["topk"]):
        raise AssertionError(f"zstd block: kernels not launched: {path}")
    add_counts(launches, path)
    for h in sorted(ids):
        obj, failed = db.find_trace_by_id(ING_TENANT, bytes.fromhex(h))
        if failed or obj != expect[bytes.fromhex(h)]:
            raise AssertionError(f"zstd block: {h} opened differs from the "
                                 "WAL")
    out["zstd_block"] = {"traces": len(cols["tid"]), "wal": db.wal.encoding,
                         "complete_s": complete_s, "opened": len(ids),
                         "launches": {k: v for k, v in path.items() if v}}
    print(f"ingest zstd block: {len(cols['tid'])} traces, WAL "
          f"{db.wal.encoding}, zstd block and container completed in "
          f"{complete_s:.2f} s; 3 searches equal to the CPU path's, "
          f"{len(ids)} results opened, each its WAL bytes; launches "
          f"{json.dumps(out['zstd_block']['launches'])}", flush=True)
    db.close()
    dbs.remove(db)


# ---------------------------------------------------------------------------
# the attribution cell (per-query stats and the dispatch profiler)

# the fields of query_stats_json that measure no time (the CPU tests hold
# them against the reference's too)
ATTRIB_FIELDS = ("blocks_inspected", "skipped_blocks", "bytes_inspected",
                 "dispatches", "fused_dispatches", "cache", "staged_bytes",
                 "query")
ATTRIB_TIMED = ("exhaustive_bench", "bench_and", "limit_1000")


def untimed(resp):
    """canon(resp) without the explain breakdown either."""
    import dataclasses

    resp = canon(resp)
    return dataclasses.replace(resp, metrics=dataclasses.replace(
        resp.metrics, query_stats_json=""))


def same_stats(name: str, got: dict, want: dict) -> None:
    """A card database's explain dict against the CPU database's, in every
    field that measures no time."""
    def nodes(d):
        return [{k: n.get(k) for k in ("id", "op", "detail", "est_bytes")}
                for n in (d.get("structural") or {}).get("nodes", [])]

    def probe(d):
        hp = d.get("host_probe") or {}
        return hp.get("count"), hp.get("bytes")

    bad = [k for k in ATTRIB_FIELDS if got.get(k) != want.get(k)]
    if sorted(got) != sorted(want):
        bad.append("keys")
    if probe(got) != probe(want):
        bad.append("host_probe")
    if nodes(got) != nodes(want):
        bad.append("structural")
    if bad:
        raise AssertionError(f"{name}: card and CPU query stats differ in "
                             f"{bad}: card {got}, CPU {want}")


def attribution_cell(args, report: dict, launches: dict) -> None:
    """The attribution cell (step 12 of the module docstring), over the
    tag, structural and RED databases the earlier cells left staged."""
    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.model.types import SearchRequest
    from tempo_tpu_torch.search import batcher, query_stats

    t_cell = time.perf_counter()
    tag, st, red = STAGED["tag"], STAGED["st"], STAGED["red"]
    out: dict = {}
    reset_counts()
    # the same stats on the card and on the CPU, and each explain
    # response equal to its twin without explain
    cases = ([(tag, n) for n in tag["reqs"]]
             + [(st, "st_desc_exhaustive"), (red, "red_all")])
    for cell, name in cases:
        tags, kw = cell["reqs"][name]
        req = SearchRequest(tags=dict(tags), explain=True, **kw)
        got = cell["gpu"].search(cell["tenant"], req).response()
        want = cell["cpu"].search(cell["tenant"], req).response()
        same_stats(name, json.loads(got.metrics.query_stats_json),
                   json.loads(want.metrics.query_stats_json))
        twin = cell["gpu"].search(cell["tenant"], SearchRequest(
            tags=dict(tags), **kw)).response()
        if untimed(got) != untimed(twin) or untimed(got) != untimed(want) \
                or twin.metrics.query_stats_json:
            raise AssertionError(f"{name}: the explain response differs "
                                 "from its twin or from the CPU path's")
    out["stats_equal"] = [name for _c, name in cases]

    # device_seconds (CUDA events) against KernelTimer's device ms (the
    # tag cell's pass, the hold kernels off here) and the wall p50
    timed = {}
    for name in ATTRIB_TIMED:
        tags, kw = tag["reqs"][name]
        req = SearchRequest(tags=dict(tags), explain=True, **kw)
        tag["gpu"].search("smoke", req)
        dev, wall = [], []
        for _ in range(10):
            t0 = time.perf_counter()
            r = tag["gpu"].search("smoke", req).response()
            wall.append((time.perf_counter() - t0) * 1e3)
            d = json.loads(r.metrics.query_stats_json)
            dev.append(d["device_seconds"] * 1e3)
        row = {"device_seconds_ms_p50": pct(dev, 0.5),
               "wall_p50_ms": pct(wall, 0.5),
               "kernel_timer_ms": tag["busy"][name]["device_ms"],
               "stages_ms": d["device_stages_ms"]}
        timed[name] = row
        if not (0.9 * row["kernel_timer_ms"] <= row["device_seconds_ms_p50"]
                <= row["wall_p50_ms"]):
            raise AssertionError(f"{name}: device_seconds p50 "
                                 f"{row['device_seconds_ms_p50']:.4f} ms "
                                 f"outside [0.9 x KernelTimer "
                                 f"{row['kernel_timer_ms']:.4f}, wall p50 "
                                 f"{row['wall_p50_ms']:.4f}]")
    out["events_vs_kernel_timer"] = timed

    # the 8-client exhaustive rounds, coalescing on: every dispatch's
    # stage totals against the shares its members' stats received
    shares = threading.local()
    splits: list = []
    real_attr = batcher.QueryCoalescer._attribute
    real_add = query_stats.QueryStats.add_device_stages

    def add_spy(self, stages, *a, **kw):
        got = getattr(shares, "got", None)
        if got is not None:
            got.append(dict(stages))
        return real_add(self, stages, *a, **kw)

    def attr_spy(stats, weights, totals, h2d):
        shares.got = []
        try:
            real_attr(stats, weights, totals, h2d)
        finally:
            got, shares.got = shares.got, None
        splits.append((len(stats), dict(totals), got))

    exh = [SearchRequest(tags=dict(t, **EXHAUSTIVE), limit=20)
           for t in CONCURRENT_TAGS]
    serial = [untimed(tag["gpu"].search("smoke", r).response())
              for r in exh]
    barrier = threading.Barrier(len(exh))

    def one(i):
        barrier.wait(timeout=120)
        return untimed(tag["gpu"].search("smoke", exh[i]).response())

    batcher.QueryCoalescer._attribute = staticmethod(attr_spy)
    query_stats.QueryStats.add_device_stages = add_spy
    try:
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=len(exh)) as ex:
            for _r in range(4):
                futs = [ex.submit(one, i) for i in range(len(exh))]
                if [f.result(timeout=600) for f in futs] != serial:
                    raise AssertionError("attribution rounds: a response "
                                         "differs from its serial one")
    finally:
        batcher.QueryCoalescer._attribute = staticmethod(real_attr)
        query_stats.QueryStats.add_device_stages = real_add
    worst = 0.0
    for n, totals, got in splits:
        if len(got) != n:
            raise AssertionError(f"a dispatch of {n} members booked "
                                 f"{len(got)} shares")
        for stage, total in totals.items():
            err = abs(sum(g.get(stage, 0.0) for g in got) - total) * 1e3
            worst = max(worst, err)
    if worst > 1e-6:
        raise AssertionError(f"a fused dispatch's shares miss its stage "
                             f"totals by {worst} ms")
    fused = sum(1 for n, _t, _g in splits if n > 1)
    if not fused:
        raise AssertionError("the attribution rounds fused no dispatch")
    out["rounds"] = {"dispatches": len(splits), "fused": fused,
                     "max_share_error_ms": worst}

    # the fence on the stats database: the stream synchronised after each
    # dispatch's launches (its gate is the database's, flipped for these
    # requests only), the same answers and device seconds
    tags, kw = tag["reqs"]["bench_and"]
    req = SearchRequest(tags=dict(tags), explain=True, **kw)
    base = untimed(tag["gpu"].search("smoke", req).response())
    gate = tag["gpu"].profiling
    fenced = []
    gate.fence = True
    try:
        for _ in range(10):
            r = tag["gpu"].search("smoke", req).response()
            if untimed(r) != base:
                raise AssertionError("bench_and with the fence answered "
                                     "differently")
            fenced.append(r.metrics.device_seconds * 1e3)
    finally:
        gate.fence = False
    out["fence_device_seconds_ms_p50"] = pct(fenced, 0.5)
    if not out["fence_device_seconds_ms_p50"] > 0:
        raise AssertionError("the fenced requests booked no device time")

    # the bench request, interleaved turns over three databases: both
    # gates on, the profiler alone (stats off), both off
    def tag_db(**gates):
        db = TempoDB(LocalBackend(tag["root"]), TempoDBConfig(
            search_max_batch_pages=4096, **gates), device="cuda")
        db.poll()
        tags, kw = tag["reqs"]["exhaustive_bench"]
        db.search("smoke", SearchRequest(tags=dict(tags), **kw))  # stage
        return db

    sides = {"on": tag["gpu"]}
    try:
        sides["profiler"] = tag_db(search_query_stats_enabled=False)
        sides["off"] = tag_db(search_query_stats_enabled=False,
                              search_profiling_enabled=False)
        tags, kw = tag["reqs"]["bench_and"]
        req = SearchRequest(tags=dict(tags), **kw)
        lat = {k: [] for k in sides}
        order = list(sides)
        for i in range(21):
            resp = {}
            for side in order[i % 3:] + order[:i % 3]:
                t0 = time.perf_counter()
                resp[side] = sides[side].search("smoke", req).response()
                lat[side].append((time.perf_counter() - t0) * 1e3)
            if untimed(resp["profiler"]) != untimed(resp["on"]) \
                    or untimed(resp["off"]) != untimed(resp["on"]) \
                    or resp["profiler"].metrics.device_seconds \
                    or resp["off"].metrics.device_seconds:
                raise AssertionError("the gates answered differently")
    finally:
        for side in ("profiler", "off"):
            if side in sides:
                sides[side].close()
    out["on_off_p50_ms"] = {k: pct(v, 0.5) for k, v in lat.items()}
    path = read_counts()
    add_counts(launches, path)
    out["launches"] = path
    out["s"] = time.perf_counter() - t_cell
    report["attribution"] = out
    t = out["events_vs_kernel_timer"]
    print("attribution: card and CPU query stats equal over "
          f"{len(cases)} requests (explain twins equal); device_seconds "
          "p50 / KernelTimer / wall p50 ms: "
          + ", ".join(f"{n} {r['device_seconds_ms_p50']:.4f} / "
                      f"{r['kernel_timer_ms']:.4f} / {r['wall_p50_ms']:.3f}"
                      for n, r in t.items())
          + f"; 8-client exhaustive rounds: {fused} fused of "
          f"{len(splits)} dispatches, shares conserved (worst "
          f"{worst:.3g} ms); fenced bench_and device_seconds p50 "
          f"{out['fence_device_seconds_ms_p50']:.4f} ms; bench_and p50 "
          "stats and profiler / profiler alone / both off "
          f"{out['on_off_p50_ms']['on']:.3f} / "
          f"{out['on_off_p50_ms']['profiler']:.3f} / "
          f"{out['on_off_p50_ms']['off']:.3f} ms; launches "
          f"{json.dumps(path)}; {out['s']:.1f} s", flush=True)


def host_tier_requests(reqs: dict) -> dict:
    """The tag cell's six requests, each exhaustive."""
    return {n: (dict(t, **EXHAUSTIVE), kw) for n, (t, kw) in reqs.items()}


def staged_ms(db, group, cold: bool, reps: int = 3) -> float:
    """Median ms of one group's re-stage after its device batch is
    dropped: from the host tier, or (`cold`) with its host batch dropped
    too (IO, decompression and stacking again)."""
    import torch

    b = db.batcher
    key = tuple(j.key for j in group)
    ids = {j.key[0] for j in group}
    live = {m.block_id for m in db.blocklist.metas("smoke")}
    ms = []
    for _ in range(reps):
        if cold:
            b.invalidate(live - ids)
        else:
            with b._lock:
                if key in b._cache:
                    b._drop_locked(key)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b._staged(group)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return pct(ms, 0.5)


def decisions_since(planner, seq0: int) -> list:
    return [d for d in planner.snapshot(256)["recent"] if d["seq"] > seq0]


def planner_requests(db, tenant: str, reqs: dict, want: dict,
                     launches: dict) -> dict:
    """`reqs` with ``explain`` through a database whose planner is on,
    each response equal to the planner-off one (`want`); per request the
    verdicts by site and target and K3's launches: at least one where a
    compile-site verdict was the device, none where every one was the
    host."""
    from tempo_tpu_torch.model.types import SearchRequest

    out = {}
    for name, (tags, kw) in reqs.items():
        seq0 = db.planner._seq
        reset_counts()
        r = db.search(tenant, SearchRequest(tags=dict(tags), explain=True,
                                            **kw)).response()
        path = read_counts()
        add_counts(launches, path)
        if untimed(r) != want[name]:
            raise AssertionError(f"planner {name}: the response differs "
                                 "from the planner-off one")
        ds = decisions_since(db.planner, seq0)
        verdicts = {}
        for d in ds:
            k = f"{d['site']}/{d['target']}"
            verdicts[k] = verdicts.get(k, 0) + 1
        compile_targets = {d["target"] for d in ds if d["site"] == "compile"}
        k3 = path["dict_probe"]
        if "device" in compile_targets and not k3:
            raise AssertionError(f"planner {name}: a device verdict and no "
                                 f"K3 launch: {verdicts}")
        if compile_targets == {"host"} and k3:
            raise AssertionError(f"planner {name}: every verdict host and "
                                 f"{k3} K3 launches")
        out[name] = {"verdicts": verdicts, "k3_launches": k3,
                     "planner": json.loads(r.metrics.query_stats_json)
                     .get("planner")}
    return out


SEED_CHILD = """
import json, sys, time
sys.path.insert(0, {here!r})
import torch
from tempo_tpu_torch.search.planner import OffloadPlanner
p = OffloadPlanner(enabled=True, device=torch.device("cuda"))
p.decide_probe(n_vals=1, dict_bytes=1, site="offline")
print(json.dumps(p.snapshot(0)))
"""


def seeded_rates(snap: dict) -> dict:
    cm = snap["cost_model"]
    out = {k: cm["rates"][k]["seconds_per_byte"]
           for k in ("host_probe", "device_probe", "pack", "h2d")}
    out.update({k: cm["fixed"][k]["seconds"]
                for k in ("dispatch", "compile")})
    return out


def host_tier_cell(args, work: str, report: dict, launches: dict) -> None:
    """The host-tier and planner cell (step 13 of the module docstring),
    over the tag and high-cardinality corpora."""
    import statistics

    import torch

    from tempo_tpu_torch.backend.local import LocalBackend
    from tempo_tpu_torch.backend.types import NAME_SEARCH_HEADER
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.model.types import SearchRequest

    t_cell = time.perf_counter()
    tag = STAGED["tag"]
    root = tag["root"]
    out: dict = {}
    report["host_tier"] = out
    full = tag["gpu"].batcher.debug_stats()["cache"]["bytes"]
    mbp = tag["gpu"].cfg.search_max_batch_pages       # the tag cell's
    reqs = host_tier_requests(tag["reqs"])
    want = {n: canon(tag["gpu"].search("smoke", SearchRequest(
        tags=dict(t), **kw)).response()) for n, (t, kw) in reqs.items()}

    # 1. the host tier: a third of the staged bytes on the device, all of
    # them in host RAM, two exhaustive rounds of the six requests
    db = TempoDB(LocalBackend(root), TempoDBConfig(
        search_max_batch_pages=mbp, search_batch_cache_bytes=full // 3,
        search_host_cache_bytes=32 << 30), device="cuda")
    try:
        db.poll()
        rounds = []
        for rnd in (1, 2):
            events: dict = {}
            reset_counts()
            for name, (t, kw) in reqs.items():
                r = db.search("smoke", SearchRequest(tags=dict(t),
                                                     explain=True, **kw))
                r = r.response()
                if untimed(r) != want[name]:
                    raise AssertionError(f"host tier round {rnd} {name}: "
                                         "the response differs from the "
                                         "all-resident database's")
                for k, v in json.loads(r.metrics.query_stats_json)[
                        "cache"].items():
                    events[k] = events.get(k, 0) + v
            add_counts(launches, read_counts())
            rounds.append(events)
        stats = db.batcher.debug_stats()
        groups = db.batcher.plan(db._jobs("smoke", db.blocklist.epoch())[0])
        # with more than one group a third of the bytes evicts: round 2
        # re-stages, each time from the host tier
        if rounds[1].get("hbm_miss_cold") or (
                len(groups) > 1 and not rounds[1].get("hbm_miss_host_hit")):
            raise AssertionError(f"round 2 re-staged otherwise than from "
                                 f"the host tier: {rounds[1]}")
        g = max(groups, key=lambda gr: sum(j.n_pages for j in gr))
        out["host_tier"] = {
            "staged_bytes_all": full, "device_budget": full // 3,
            "rounds": rounds, "groups": len(groups),
            "device_cache": stats["cache"], "host_cache": stats["host_cache"],
            "restage_ms_host_hit": staged_ms(db, g, cold=False),
            "restage_ms_cold": staged_ms(db, g, cold=True),
            "group_pages": sum(j.n_pages for j in g)}
    finally:
        db.close()
        del db
        gc.collect()
    h = out["host_tier"]
    print(f"host tier: {h['groups']} groups, {full} B staged in all, a "
          f"device budget of {full // 3} B; cache events round 1 "
          f"{json.dumps(rounds[0])}, round 2 {json.dumps(rounds[1])}; "
          f"every response equal to the all-resident database's; re-stage "
          f"a {h['group_pages']}-page group: hbm_miss_cold "
          f"{h['restage_ms_cold']:.1f} ms, hbm_miss_host_hit "
          f"{h['restage_ms_host_hit']:.1f} ms", flush=True)

    # 2. prewarm, and a restart on the same host state
    state = os.path.join(work, "host-state")
    bench = SearchRequest(tags=dict(BENCH), limit=20)
    bench_want = canon(tag["gpu"].search("smoke", bench).response())
    first = {}
    pw = TempoDB(LocalBackend(root), TempoDBConfig(
        search_max_batch_pages=mbp, search_prewarm_on_poll=True,
        host_state_dir=state), device="cuda")
    try:
        reset_counts()
        t0 = time.perf_counter()
        pw.poll()
        pw._prewarm_thread.join()
        out["prewarm_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = canon(pw.search("smoke", bench).response())
        torch.cuda.synchronize()
        first["prewarm"] = (time.perf_counter() - t0) * 1e3
        add_counts(launches, read_counts())
        if r != bench_want:
            raise AssertionError("the prewarmed database answered "
                                 "differently")
    finally:
        pw.close()
        del pw
        gc.collect()
    rs = TempoDB(LocalBackend(root), TempoDBConfig(
        search_max_batch_pages=mbp, host_state_dir=state), device="cuda")
    header_reads = []
    real_read = rs.backend.read

    def counting(tenant, block, name):
        if name == NAME_SEARCH_HEADER:
            header_reads.append(block)
        return real_read(tenant, block, name)

    rs.backend.read = counting
    try:
        reset_counts()
        t0 = time.perf_counter()
        rs.poll()
        out["restart_poll_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        r = canon(rs.search("smoke", bench).response())
        torch.cuda.synchronize()
        first["cold"] = (time.perf_counter() - t0) * 1e3
        add_counts(launches, read_counts())
        if r != bench_want:
            raise AssertionError("the restarted database answered "
                                 "differently")
    finally:
        rs.close()
        del rs
        gc.collect()
    if header_reads:
        raise AssertionError(f"the restarted database read "
                             f"{len(header_reads)} headers")
    out["first_query_ms"] = first
    out["restart_header_reads"] = len(header_reads)
    print(f"prewarm: poll and prewarm {out['prewarm_s']:.2f} s, then the "
          f"first bench_and {first['prewarm']:.2f} ms; a restart on the "
          f"same host state: 0 header reads, poll "
          f"{out['restart_poll_ms']:.1f} ms, first bench_and without "
          f"prewarm {first['cold']:.2f} ms", flush=True)

    # 3. the planner: its seed in a fresh process (compile is a kernel
    # library's load), then the hc corpus and the tag corpus with it on
    child = subprocess.run(
        [sys.executable, "-c", SEED_CHILD.format(here=HERE)],
        capture_output=True, text=True, timeout=300, check=True)
    cold_seed = json.loads(child.stdout.strip().splitlines()[-1])
    out["seed_fresh_process"] = {"rates": seeded_rates(cold_seed),
                                 "seed_ms": cold_seed["seed_ms"]}
    from tempo_tpu_torch.parallel.multihost_dryrun import force_planner

    hc = STAGED["hc"]
    tag_want = {n: untimed(tag["gpu"].search("smoke", SearchRequest(
        tags=dict(t), **kw)).response()) for n, (t, kw) in tag["reqs"].items()}
    tag_kw = {"search_device_probe_min_vals": 1,
              "search_max_batch_pages": mbp}
    rows = {}
    # the planner's own verdicts over both corpora, then the tag corpus
    # with every verdict forced to each side (K3 where the device, none
    # where the host)
    for label, r_root, tenant, cfg_kw, reqs_p, want_p, force in (
            ("hc", hc["root"], "hc",
             {"search_max_batch_pages": hc["max_batch_pages"]},
             hc_requests(), hc["resp"], None),
            ("tag", root, "smoke", tag_kw, tag["reqs"], tag_want, None),
            ("tag forced device", root, "smoke", tag_kw, tag["reqs"],
             tag_want, "device"),
            ("tag forced host", root, "smoke", tag_kw, tag["reqs"],
             tag_want, "host")):
        pdb = TempoDB(LocalBackend(r_root), TempoDBConfig(
            search_offload_planner_enabled=True, **cfg_kw), device="cuda")
        try:
            pdb.poll()
            if force is None:
                pdb.planner._ensure_seeded()
            else:
                force_planner(pdb.planner, force)       # and no seed
            seed = seeded_rates(pdb.planner.snapshot(0))
            per = planner_requests(pdb, tenant, reqs_p, want_p, launches)
            snap = pdb.planner.snapshot(256)
        finally:
            pdb.close()
            del pdb
            gc.collect()
        errs = [d["abs_rel_error"] for d in snap["recent"]
                if "abs_rel_error" in d]
        by = {}
        for d in snap["recent"]:
            k = f"{d['site']}/{d['target']}"
            by[k] = by.get(k, 0) + 1
        k3 = sum(p["k3_launches"] for p in per.values())
        if force == "device" and not k3 or force == "host" and k3:
            raise AssertionError(f"planner {label}: {k3} K3 launches")
        rows[label] = {"seed": seed, "requests": per, "decisions": by,
                       "median_abs_rel_error": (statistics.median(errs)
                                                if errs else None),
                       "resolved": len(errs), "forced": force}
        print(f"planner {label}: "
              + ("seeded on the card " + ", ".join(
                  f"{k} {v:.3g}" for k, v in seed.items() if v is not None)
                 if force is None else "every verdict forced")
              + f"; decisions {json.dumps(by)}; median |predicted - "
              f"actual| / actual "
              + ("n/a" if not errs else f"{statistics.median(errs):.3f}")
              + f" over {len(errs)}; K3 launches by request "
              + json.dumps({n: p['k3_launches'] for n, p in per.items()})
              + "; every response equal to the planner-off one",
              flush=True)
    out["planner"] = rows
    fs = out["seed_fresh_process"]
    print("planner seed in a fresh process: "
          + ", ".join(f"{k} {v:.3g}" for k, v in fs["rates"].items()
                      if v is not None)
          + f" ({fs['seed_ms']} ms)", flush=True)
    out["s"] = time.perf_counter() - t_cell
    print(f"host-tier and planner cell: {out['s']:.1f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=256)
    ap.add_argument("--traces-per-block", type=int, default=65_536)
    ap.add_argument("--hc-blocks", type=int, default=10)
    ap.add_argument("--hc-traces-per-block", type=int, default=1_048_576)
    ap.add_argument("--hc-packed-blocks", type=int, default=4,
                    help="blocks of the hc corpus in the packed hc cell")
    ap.add_argument("--long-blocks", type=int, default=64,
                    help="blocks of the long-duration corpus (traces per "
                         "block as --traces-per-block)")
    ap.add_argument("--st-blocks", type=int, default=16,
                    help="blocks of the structural corpus")
    ap.add_argument("--st-traces-per-block", type=int, default=65_536)
    ap.add_argument("--st-packed-blocks", type=int, default=4,
                    help="blocks of the structural corpus in its packed "
                         "phase")
    ap.add_argument("--agg-blocks", type=int, default=128,
                    help="blocks of the RED cell's corpus (traces per "
                         "block as --traces-per-block)")
    ap.add_argument("--live-traces", type=int, default=4096,
                    help="traces of the live cell's stage (the default "
                         "search_live_tier_max_entries)")
    ap.add_argument("--wal-traces", type=int, default=262_144,
                    help="traces of the live cell's WAL head")
    ap.add_argument("--tbi-blocks", type=int, default=32,
                    help="blocks of the trace-by-ID cell's corpus (and a "
                         "block of partials)")
    ap.add_argument("--tbi-traces-per-block", type=int, default=TBI_TRACES)
    ap.add_argument("--ingest-blocks", type=int, default=4,
                    help="head blocks of the ingest cell with a search "
                         "container (and one without)")
    ap.add_argument("--ingest-traces-per-block", type=int,
                    default=ING_TRACES)
    ap.add_argument("--ingest-bare-traces", type=int, default=ING_BARE,
                    help="traces of the ingest cell's block without a "
                         "search container")
    ap.add_argument("--ingest-push-spans", type=int, default=ING_PUSH_SPANS,
                    help="spans a push of the ingest cell")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=10,
                    help="timed rounds of the concurrent phases")
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--report", default=None,
                    help="also write the full report (timings, shapes, "
                         "nvcc/ptxas output) as JSON to this path")
    args = ap.parse_args(argv)
    t_run = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from tempo_tpu_torch.search.kernels import build

    report: dict = {"args": vars(args)}

    from tempo_tpu_torch.ops import native

    t0 = time.perf_counter()
    # the host library builds while nvcc builds the kernels
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        host = ex.submit(native.lib)
        build.build_all()
        host.result()
    report["build_s"] = time.perf_counter() - t0
    report["build_log"] = dict(build.BUILD_LOG)
    report["built"] = sorted(build.BUILT)
    report["host_library"] = {"log": native.BUILD_LOG, "built": native.BUILT,
                              "codecs": native.codecs()}
    print(f"build: {report['build_s']:.1f} s "
          f"({', '.join(sorted(build.BUILT)) or 'cached'}); host library "
          f"{'built' if native.BUILT else 'cached'} by "
          f"{native.BUILD_LOG.splitlines()[0]}, codecs "
          f"{', '.join(native.codecs())}", flush=True)
    report["k9_kernels_per_call"] = k9_early_profiles()

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    dbs: list = []
    launches = {k: 0 for k in KERNELS}
    try:
        rows = tag_search_cell(args, work, report, dbs, launches)
        rows += long_duration_cell(args, work, report, dbs, launches)
        rows += hc_cell(args, work, report, dbs, launches)
        rows += packed_hc_cell(args, work, report, dbs, launches)
        rows += structural_cell(args, work, report, dbs, launches)
        rows += red_cell(args, work, report, dbs, launches)
        rows += live_cell(args, work, report, dbs, launches)
        rows += mesh_cell(args, work, report, dbs, launches)
        rows += trace_by_id_cell(args, work, report, dbs, launches)
        rows += ingest_cell(args, work, report, dbs, launches)
        attribution_cell(args, report, launches)
        host_tier_cell(args, work, report, launches)
    finally:
        for db in dbs:
            db.close()
        shutil.rmtree(work, ignore_errors=True)
    by_name = {r["name"]: r for r in rows}
    kernels = [by_name[k] for k in KERNELS]
    for r in kernels:
        r["launches"] = launches[r["name"]]
        if not r["launches"] and r["name"] not in OFF_PATH:
            raise AssertionError(f"{r['name']} was never launched on the "
                                 "main path")
        if r["launches"] and r["name"] in OFF_PATH:
            raise AssertionError(f"a main path launched {r['name']}")
    by_name["dict_probe"]["shape"]["word_launches"] = launches.get(
        "dict_probe_words", 0)
    report["kernels"] = kernels
    report["launches_all_paths"] = launches
    for r in kernels:
        dm = r["shape"].get("device_ms")
        print(f"kernel {r['name']}: {r['ms']:.4f} ms a call back to back "
              f"(CUDA events), "
              + ("device time not measured" if dm is None else
                 f"{dm:.4f} ms device time "
                 f"({r['shape']['device_source']})")
              + f", bound {r['bound_ms']:.4f} ms, plain {r['plain_ms']:.3f}"
              f" ms, {r['launches']} launches on the main path", flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    report["nvidia_smi"] = smi
    t = report["trace_by_id"]
    print(f"trace-by-id on {smi}: write {t['write_s']:.1f} s, first lookup "
          f"{t['first_lookup_ms']:.2f} ms, p50/p95 hit "
          f"{t['hit']['p50_ms']:.2f}/{t['hit']['p95_ms']:.2f} ms, miss "
          f"{t['miss']['p50_ms']:.2f}/{t['miss']['p95_ms']:.2f} ms, partial "
          f"{t['partial']['p50_ms']:.2f}/{t['partial']['p95_ms']:.2f} ms, "
          f"full index page xxh64 {t['xxh64_page']['p50_ms']:.4f} ms "
          f"(FINAL17r, pure Python: 2.85 ms; here "
          f"{t['xxh64_plain_page']['p50_ms']:.2f}), IndexReader "
          f"{t['index_reader_page']['p50_ms']:.2f} ms", flush=True)
    h = report["hc_host_route"]
    long = h["needles"][HC_LONG_NEEDLE]
    print(f"hc host route on {smi}: a {len(HC_LONG_NEEDLE)}-byte needle "
          f"over {h['dict_values']} values, scan {long['scan_ms']:.2f} ms, "
          f"numpy {long['numpy_ms']:.1f} ms, ids equal; the request "
          f"{h['request_ms']:.1f} ms over {h['scans']} dictionaries",
          flush=True)
    g = report["ingest"]
    w = g["first_head_walks"]
    print(f"ingest on {smi}: {g['native_walks']} of {g['pushes']} pushes "
          f"through the native walker; regroup and extraction "
          f"{g['extract_us_per_trace']:.1f} us a trace, "
          f"{g['spans_per_s']:.0f} spans/s (ING18a, the Python walk: 226.7 "
          f"us, 35,290 spans/s); the first head, both walks, items equal: "
          f"native {w['native_us_per_trace']:.1f}, Python "
          f"{w['plain_us_per_trace']:.1f} us a trace; WAL ({g['wal_encoding']}"
          f", auto) append {g['wal_append_mb_per_s']:.1f} MB/s (ING18a, "
          f"zlib: 4.50); replay {g['replay']['s']:.2f} s (ING18a: 0.67); "
          f"complete_block "
          f"{g['complete']['per_block_s']:.2f} s a block (objects "
          f"{g['complete']['objects_s']:.2f}, index and bloom "
          f"{g['complete']['index_bloom_s']:.3f}, container "
          f"{g['complete']['container_s']:.2f}); first search "
          f"{g['first_search_ms']:.1f} ms, warm p50/p95 "
          f"{g['warm']['p50_ms']:.2f}/{g['warm']['p95_ms']:.2f} ms; ingest "
          f"to searchable {g['ingest_to_searchable_s']:.2f} s (ING18a: "
          f"1.11); zstd block: "
          + ("none (no libzstd)" if g["zstd_block"] is None else
             f"{g['zstd_block']['opened']} results opened"), flush=True)
    report["run_s"] = time.perf_counter() - t_run
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(f"run: {report['run_s']:.1f} s on {smi}", flush=True)
    print(json.dumps({"kernels": [{k: v for k, v in kr.items()
                                   if k != "shape"} for kr in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
