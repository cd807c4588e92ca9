"""Query compilation: dictionaries in, per-block predicate tables out.

Counterpart of the reference's ``search/pipeline.py``. The substring
match (``bytes.Contains``) runs once per (block dictionary, tag-set) over
the block's sorted value dictionary, on one of two routes:

- **device probe**: the dictionary was staged on the device (it has at
  least ``dict_probe.DEVICE_PROBE_MIN_VALS`` values, or the configured
  threshold), so kernel K3 computes a ``[T, V]`` hit mask there, which
  the scan looks values up in; only ``any_hits`` comes back, for pruning;
- **host**: numpy over the value list, producing value-id sets that
  collapse to inclusive [lo, hi] id ranges the scan compares against.
  Small dictionaries take it, and so does any query with a needle longer
  than ``dict_probe.MAX_NEEDLE_BYTES`` — chosen from the needles' lengths
  before anything is launched.

A term whose key or value set is empty prunes the block before any scan.
With the engine's offload planner on (``planner.py``), a staged
dictionary's terms go to K3 only where the planner's cost model places
them; its host verdict takes the host walk, with the same answer.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ..observability import profile
from ..ops import native
from . import dict_probe, packing
from .analytics import AGG_QUERY_TAG
from .planner import dict_bytes_est, planner_of
from .structural import STRUCTURAL_QUERY_TAG

UINT32_MAX = 0xFFFFFFFF

# in-band flags, never tag predicates. A request carrying this one scans
# every page of every block (no pruning, no early quit); the other tag
# predicates still apply. The structural tag carries a structural query
# (search/structural.py), compiled on its own; the ?agg= tag asks for an
# aggregate (search/analytics.py), staged per batch, never per predicate.
EXHAUSTIVE_SEARCH_TAG = "x-dbg-exhaustive"
_RESERVED_TAGS = (EXHAUSTIVE_SEARCH_TAG, STRUCTURAL_QUERY_TAG, AGG_QUERY_TAG)


def is_exhaustive(req) -> bool:
    return EXHAUSTIVE_SEARCH_TAG in req.tags


def request_terms(req) -> list:
    """Sorted (key, value) tag predicates of a request: every tag but the
    in-band flags."""
    return sorted((k, v) for k, v in req.tags.items()
                  if k not in _RESERVED_TAGS)


@dataclass
class CompiledQuery:
    term_keys: np.ndarray   # int32 [T]
    val_ranges: np.ndarray  # int32 [T, R, 2] inclusive [lo,hi] id ranges,
                            # padded with [1,0] (never matches)
    dur_lo: int
    dur_hi: int
    win_start: int
    win_end: int
    limit: int
    # device-probe product: [T, V] value hit mask on the device, bool, or
    # int32 words [T, ceil(V/32)] for a packed engine. When set,
    # val_ranges is the never-match padding and the scan looks value ids
    # up in this mask instead.
    val_hits: object = None
    # the request's structural predicate compiled against this block
    # (structural.CompiledStructural), set by the single-block search
    structural: object = None

    @property
    def n_terms(self) -> int:
        return int(self.term_keys.shape[0])


def ids_to_ranges(ids: np.ndarray) -> np.ndarray:
    """Collapse a sorted id set into inclusive [lo,hi] runs."""
    if ids.size == 0:
        return np.zeros((0, 2), dtype=np.int32)
    breaks = np.nonzero(np.diff(ids) > 1)[0]
    lo = np.concatenate([[0], breaks + 1])
    hi = np.concatenate([breaks, [ids.size - 1]])
    return np.stack([ids[lo], ids[hi]], axis=1).astype(np.int32)


def block_header_skip_reason(header: dict, req) -> str | None:
    """Why the header rollup prunes this block — None when it doesn't."""
    if is_exhaustive(req):
        return None
    if req.start and header.get("max_end_s", UINT32_MAX) < req.start:
        return "time_range"
    if req.end and header.get("min_start_s", 0) > req.end:
        return "time_range"
    if req.min_duration_ms and header.get("max_dur_ms", UINT32_MAX) < req.min_duration_ms:
        return "duration"
    if req.max_duration_ms and header.get("min_dur_ms", 0) > req.max_duration_ms:
        return "duration"
    return None


# dictionaries of this many values or more take the host library's memmem
# scan (the reference's NATIVE_SCAN_THRESHOLD); smaller ones numpy's
NATIVE_SCAN_THRESHOLD = 50_000
# packed dictionaries are kept, the newest first, up to this many bytes
_PACKED_MAX_BYTES = 1 << 30
_packed_lock = threading.Lock()
_packed: OrderedDict = OrderedDict()   # id(val_dict) -> (val_dict, packed)


def substring_value_ids(val_dict: list, needle: str) -> np.ndarray:
    """Ids of dictionary values containing `needle` (bytes.Contains
    semantics; the empty needle matches every value), ascending. From
    ``NATIVE_SCAN_THRESHOLD`` values on, one memmem pass over the
    dictionary packed end to end (``ops/native.py`` ``substr_scan``; the
    packing is kept for the dictionary, as the reference's
    ``packed_val_dict``); below it, numpy (``substring_value_ids_plain``)."""
    if not needle:
        return np.arange(len(val_dict), dtype=np.int32)
    if len(val_dict) < NATIVE_SCAN_THRESHOLD:
        return substring_value_ids_plain(val_dict, needle)
    buf, offsets = packed_val_dict(val_dict)
    return native.substr_scan(buf, offsets, needle.encode("utf-8"))


def substring_value_ids_plain(val_dict: list, needle: str) -> np.ndarray:
    """``substring_value_ids`` by numpy."""
    if not needle:
        return np.arange(len(val_dict), dtype=np.int32)
    if not val_dict:
        return np.zeros(0, dtype=np.int32)
    arr = np.array(val_dict, dtype=np.str_)
    hits = np.char.find(arr, needle) >= 0
    return np.nonzero(hits)[0].astype(np.int32)


def pack_val_dict(val_dict: list) -> tuple:
    """(the values' utf-8 bytes end to end, int64 offsets[n+1])."""
    blobs = [v.encode("utf-8") for v in val_dict]
    offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    return b"".join(blobs), offsets


def packed_val_dict(val_dict: list) -> tuple:
    """``pack_val_dict(val_dict)``, kept for the newest dictionaries up to
    ``_PACKED_MAX_BYTES`` (by identity: a block's dictionary is one list
    for its life; the entry holds the list, so its id is not reused while
    kept)."""
    key = id(val_dict)
    with _packed_lock:
        hit = _packed.get(key)
        if hit is not None and hit[0] is val_dict:
            _packed.move_to_end(key)
            return hit[1]
    packed = pack_val_dict(val_dict)
    with _packed_lock:
        _packed[key] = (val_dict, packed)
        _packed.move_to_end(key)
        total = sum(len(p[0]) + p[1].nbytes for _, p in _packed.values())
        while len(_packed) > 1 and total > _PACKED_MAX_BYTES:
            _, (buf, offs) = _packed.popitem(last=False)[1]
            total -= len(buf) + offs.nbytes
    return packed


_PRUNED = "pruned"  # cache sentinel: block provably cannot match these tags
_COMPILE_CACHE_MAX = 128     # distinct tag-sets kept per dictionary
_COMPILE_CACHE_DICTS = 4096  # distinct dictionaries tracked
# entries whose product is a device hit mask pin device memory (V bytes
# per term), so each dictionary keeps only the newest few of them; word
# masks (a packed engine's) are 8x smaller, so 8x as many fit the same
# device memory
_PROBE_CACHE_MAX = 8
_PROBE_CACHE_MAX_PACKED = 64


class CompileCache:
    """(dictionary content, tag-set) -> probe product, bounded LRU per
    dictionary. Blocks are immutable and tenants reuse a handful of
    dictionary contents, so repeated tag-sets skip the O(dictionary)
    substring walk, and a repeated request launches no probe. Products of
    either route serve both (both are exact); a device product in the
    other mask format than the caller's is a miss. One instance per
    engine."""

    def __init__(self, profiling=None):
        self._lock = threading.Lock()
        self._by_dict: OrderedDict = OrderedDict()
        # the engine's profiling gate: the host probe's observations
        self.profiling = profiling

    def get(self, fp: bytes, sig: tuple):
        with self._lock:
            cache = self._by_dict.get(fp)
            if cache is None:
                return None
            self._by_dict.move_to_end(fp)
            hit = cache.get(sig)
            if hit is not None:
                cache.move_to_end(sig)
            return hit

    def put(self, fp: bytes, sig: tuple, value) -> None:
        with self._lock:
            cache = self._by_dict.get(fp)
            if cache is None:
                cache = self._by_dict[fp] = OrderedDict()
                while len(self._by_dict) > _COMPILE_CACHE_DICTS:
                    self._by_dict.popitem(last=False)
            self._by_dict.move_to_end(fp)
            cache[sig] = value
            while len(cache) > _COMPILE_CACHE_MAX:
                cache.popitem(last=False)
            for words, bound in ((False, _PROBE_CACHE_MAX),
                                 (True, _PROBE_CACHE_MAX_PACKED)):
                probed = [s for s, o in cache.items()
                          if o is not _PRUNED and o[2] is not None
                          and packing.is_packed_mask(o[2]) == words]
                for s in probed[:max(0, len(probed) - bound)]:
                    del cache[s]


def dict_fingerprint(cache_on, key_dict: list, val_dict: list) -> bytes:
    """Content digest of a block's dictionaries, memoized on its
    container. Containers decoded from bytes carry the digest of their
    encoded dictionary sections; in-memory ones hash the strings once."""
    fp = getattr(cache_on, "_dict_fingerprint", None)
    if fp is None:
        fp = getattr(cache_on, "_dict_section_sha", None)
        if fp is None:
            h = hashlib.sha256()
            for part in key_dict:
                h.update(part.encode("utf-8", "surrogatepass"))
                h.update(b"\x00")
            h.update(b"\x01")
            for part in val_dict:
                h.update(part.encode("utf-8", "surrogatepass"))
                h.update(b"\x00")
            fp = h.digest()
        cache_on._dict_fingerprint = fp
    return fp


def tags_sig(req) -> tuple:
    """Cache key of the dictionary-probe part of compilation: only the tag
    terms and the exhaustive flag touch the dictionaries, so a request and
    its ?agg= or structural twin share one entry."""
    return tuple(request_terms(req)), is_exhaustive(req)


def compile_query(key_dict: list, val_dict: list, req,
                  cache_on=None, cache: CompileCache | None = None,
                  staged_dict=None, packed: bool = False
                  ) -> CompiledQuery | None:
    """None when the block provably cannot match (a key absent from the
    key dictionary, or no value satisfies a term). Under the exhaustive
    flag blocks are never pruned: an unsatisfiable term compiles to an
    empty value set (scanned, matches nothing). With `cache` and
    `cache_on` (the block's container) the probe product is memoized by
    dictionary content and tag-set. `staged_dict` (a
    dict_probe.DeviceDict of this value dictionary, present when staging
    applied the size threshold) sends the substring test to the device
    probe; with `packed` (a packed engine) K3 writes its hit mask as
    words."""
    sig = fp = None
    if cache is not None and cache_on is not None:
        sig = tags_sig(req)
        fp = dict_fingerprint(cache_on, key_dict, val_dict)
        hit = cache.get(fp, sig)
        if hit is not None and not isinstance(hit, str) \
                and hit[2] is not None \
                and packing.is_packed_mask(hit[2]) != packed:
            hit = None
        if hit is not None:
            return None if isinstance(hit, str) else _from_probe(hit, req)
    out = _probe_tags(key_dict, val_dict, req, staged_dict, packed,
                      None if cache is None else cache.profiling, fp)
    if sig is not None:
        cache.put(fp, sig, _PRUNED if out is None else out)
    return None if out is None else _from_probe(out, req)


def _from_probe(probe, req) -> CompiledQuery:
    term_keys, val_ranges, val_hits = probe
    return CompiledQuery(
        term_keys=term_keys, val_ranges=val_ranges, val_hits=val_hits,
        dur_lo=req.min_duration_ms or 0,
        dur_hi=req.max_duration_ms or UINT32_MAX,
        win_start=req.start or 0,
        win_end=req.end or UINT32_MAX,
        limit=req.limit or 20)


def _probe_tags(key_dict: list, val_dict: list, req, staged_dict=None,
                packed: bool = False, profiling=None, fp=None):
    """The tags-only part of compilation: the device probe when the
    dictionary is staged, every needle fits the kernel and (with the
    offload planner on) the planner places the probe on the device; else
    the host walk. Returns (term_keys, val_ranges, val_hits) or None
    (pruned). `profiling`: the engine's gate (its observations and its
    planner); `fp`: the dictionary's digest, when known."""
    exhaustive = is_exhaustive(req)
    terms = request_terms(req)
    if profiling is None and staged_dict is not None:
        profiling = staged_dict.profiling
    pl = planner_of(profiling)
    if staged_dict is not None and terms and max(
            len(v.encode("utf-8")) for _, v in terms) \
            <= dict_probe.MAX_NEEDLE_BYTES \
            and _use_device_probe(staged_dict, terms, fp, pl):
        return _device_probe_tags(terms, key_dict, staged_dict, exhaustive,
                                  packed)
    if not terms:
        return _host_probe_tags(terms, key_dict, val_dict, exhaustive)
    # the host walk is host work this query paid for: booked as the
    # query's host probe and host bytes (the reference's estimate of the
    # dictionary's bytes), observed as stage build, mode host_probe, and
    # fed to the planner's host rate with the dictionary's digest
    from . import query_stats

    qs = query_stats.current()
    timed = qs is not None or pl.enabled or (
        profiling is not None and profiling.enabled)
    t0 = time.perf_counter() if timed else 0.0
    try:
        return _host_probe_tags(terms, key_dict, val_dict, exhaustive)
    finally:
        if timed:
            dt = time.perf_counter() - t0
            nb = len(terms) * dict_bytes_est(val_dict)
            if profiling is not None:
                profiling.observe_stage("build", "host_probe", dt, nbytes=nb)
            pl.observe("host_probe", dt, nbytes=nb, fp=fp)
            if qs is not None:
                qs.add_host_probe(dt, nb)
                qs.add_inspected(nbytes=nb, placement="host")


def _use_device_probe(staged_dict, terms, fp, planner) -> bool:
    """Placement of a staged dictionary's substring probe. With the
    planner off, staged means device (the static path). On, the cost
    model chooses, and its host verdict takes the exact host walk though
    the dictionary is staged. The verdict memoizes through the compile
    cache: one per (dictionary, tag-set), shared by every block of the
    group and every member of a fused dispatch."""
    if not planner.enabled:
        return True
    pk = staged_dict.packed
    # the dictionary's real bytes are the packed buffer's
    d = planner.decide_probe(
        n_vals=pk.n_vals, dict_bytes=int(pk.buf.nbytes), n_terms=len(terms),
        resident=True, packed=True, staged_bytes=staged_dict.nbytes,
        n_shards=pk.n_shards, fp=pk.fingerprint or fp, site="compile")
    return d.target == "device"


def _device_probe_tags(terms, key_dict, staged_dict, exhaustive,
                       packed: bool = False):
    """One K3 launch for all terms, which with `packed` writes the mask
    as words (``packing.pack_mask_words``'s form). A term whose key is
    absent prunes the block, or under the exhaustive flag gets an
    all-false row whatever its needle. Without the flag, a term whose key
    exists but whose needle hits no value prunes the block: reading
    `any_hits` is the probe's one device-to-host sync."""
    term_key_ids = []
    needles = []
    for k, v in terms:
        i = bisect.bisect_left(key_dict, k)
        if i >= len(key_dict) or key_dict[i] != k:
            if not exhaustive:
                return None
            term_key_ids.append(-1)
            needles.append(None)
            continue
        term_key_ids.append(i)
        needles.append(v.encode("utf-8"))
    hits, any_hits = dict_probe.probe_value_hits(staged_dict, needles,
                                                 packed)
    if not exhaustive:
        any_host = any_hits.cpu().numpy()
        # the read waited on the probe: its record can finish now
        profile.PROFILER.sweep()
        if any(ki >= 0 and not any_host[t]
               for t, ki in enumerate(term_key_ids)):
            return None
    T = len(term_key_ids)
    val_ranges = np.tile(np.array([1, 0], dtype=np.int32), (T, 1, 1))
    return np.asarray(term_key_ids, dtype=np.int32), val_ranges, hits


def _host_probe_tags(terms, key_dict: list, val_dict: list, exhaustive):
    """Binary-search each term's key, scan the value dictionary for its
    substring, fold the hits to ranges."""
    term_key_ids = []
    term_val_sets = []
    for k, v in terms:
        i = bisect.bisect_left(key_dict, k)
        if i >= len(key_dict) or key_dict[i] != k:
            if not exhaustive:
                return None
            term_key_ids.append(-1)
            term_val_sets.append(np.zeros(0, dtype=np.int32))
            continue
        ids = substring_value_ids(val_dict, v)
        if ids.size == 0 and not exhaustive:
            return None
        term_key_ids.append(i)
        term_val_sets.append(np.sort(ids))

    T = len(term_key_ids)
    if not T:
        return (np.zeros(0, dtype=np.int32),
                np.zeros((0, 1, 2), dtype=np.int32), None)
    range_sets = [ids_to_ranges(s) for s in term_val_sets]
    rmax = max(r.shape[0] for r in range_sets)
    R = 1
    while R < rmax:
        R *= 2
    # pad with [1,0] — an empty range no value id satisfies
    val_ranges = np.tile(np.array([1, 0], dtype=np.int32), (T, R, 1))
    for t, r in enumerate(range_sets):
        val_ranges[t, :r.shape[0]] = r
    return np.asarray(term_key_ids, dtype=np.int32), val_ranges, None
