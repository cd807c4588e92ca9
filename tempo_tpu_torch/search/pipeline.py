"""Host-side query compilation: dictionaries in, per-block predicate
tables out.

Counterpart of the reference's ``search/pipeline.py`` on its host path.
The substring match (``bytes.Contains``) runs once per (block dictionary,
tag-set) over the block's sorted value dictionary with numpy, producing
value-id sets that collapse to inclusive [lo, hi] id ranges the scan
kernel compares against. A term whose key or value set is empty prunes
the block before any device work. The reference's native memmem path and
its device dictionary probe are later slices of the port.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

UINT32_MAX = 0xFFFFFFFF

# in-band flags, never tag predicates. A request carrying this one scans
# every page of every block (no pruning, no early quit); the other tag
# predicates still apply.
EXHAUSTIVE_SEARCH_TAG = "x-dbg-exhaustive"
# the reference's structural query and ?agg= tags: their engines are not
# part of this slice, so a request carrying either is refused rather than
# answered without them
STRUCTURAL_QUERY_TAG = "x-structural-q"
AGG_QUERY_TAG = "x-agg-q"
_RESERVED_TAGS = (EXHAUSTIVE_SEARCH_TAG, STRUCTURAL_QUERY_TAG, AGG_QUERY_TAG)


def is_exhaustive(req) -> bool:
    return EXHAUSTIVE_SEARCH_TAG in req.tags


def request_terms(req) -> list:
    """Sorted (key, value) tag predicates of a request. Raises ValueError
    for the structural and aggregate tags, which this slice does not
    serve."""
    for tag in (STRUCTURAL_QUERY_TAG, AGG_QUERY_TAG):
        if tag in req.tags:
            raise ValueError(f"{tag!r} queries are not supported by the "
                             "torch port yet")
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


def substring_value_ids(val_dict: list, needle: str) -> np.ndarray:
    """Ids of dictionary values containing `needle` (bytes.Contains
    semantics; the empty needle matches every value)."""
    if not needle:
        return np.arange(len(val_dict), dtype=np.int32)
    if not val_dict:
        return np.zeros(0, dtype=np.int32)
    arr = np.array(val_dict, dtype=np.str_)
    hits = np.char.find(arr, needle) >= 0
    return np.nonzero(hits)[0].astype(np.int32)


_PRUNED = "pruned"  # cache sentinel: block provably cannot match these tags
_COMPILE_CACHE_MAX = 128     # distinct tag-sets kept per dictionary
_COMPILE_CACHE_DICTS = 4096  # distinct dictionaries tracked


class CompileCache:
    """(dictionary content, tag-set) -> probe product, bounded LRU per
    dictionary. Blocks are immutable and tenants reuse a handful of
    dictionary contents, so repeated tag-sets skip the O(dictionary)
    substring walk. One instance per TempoDB (or per test)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_dict: OrderedDict = OrderedDict()

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
    terms and the exhaustive flag touch the dictionaries."""
    return tuple(request_terms(req)), is_exhaustive(req)


def compile_query(key_dict: list, val_dict: list, req,
                  cache_on=None, cache: CompileCache | None = None
                  ) -> CompiledQuery | None:
    """None when the block provably cannot match (a key absent from the
    key dictionary, or no value satisfies a term). Under the exhaustive
    flag blocks are never pruned: an unsatisfiable term compiles to an
    empty range set (scanned, matches nothing). With `cache` and
    `cache_on` (the block's container) the probe product is memoized by
    dictionary content and tag-set."""
    sig = fp = None
    if cache is not None and cache_on is not None:
        sig = tags_sig(req)
        fp = dict_fingerprint(cache_on, key_dict, val_dict)
        hit = cache.get(fp, sig)
        if hit is not None:
            return None if isinstance(hit, str) else _from_probe(hit, req)
    out = _probe_tags(key_dict, val_dict, req)
    if sig is not None:
        cache.put(fp, sig, _PRUNED if out is None else out)
    return None if out is None else _from_probe(out, req)


def _from_probe(probe, req) -> CompiledQuery:
    term_keys, val_ranges = probe
    return CompiledQuery(
        term_keys=term_keys, val_ranges=val_ranges,
        dur_lo=req.min_duration_ms or 0,
        dur_hi=req.max_duration_ms or UINT32_MAX,
        win_start=req.start or 0,
        win_end=req.end or UINT32_MAX,
        limit=req.limit or 20)


def _probe_tags(key_dict: list, val_dict: list, req):
    """Binary-search each term's key, scan the value dictionary for its
    substring, fold the hits to ranges. Returns (term_keys, val_ranges) or
    None (pruned)."""
    exhaustive = is_exhaustive(req)
    term_key_ids = []
    term_val_sets = []
    for k, v in request_terms(req):
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
        return np.zeros(0, dtype=np.int32), np.zeros((0, 1, 2), dtype=np.int32)
    range_sets = [ids_to_ranges(s) for s in term_val_sets]
    rmax = max(r.shape[0] for r in range_sets)
    R = 1
    while R < rmax:
        R *= 2
    # pad with [1,0] — an empty range no value id satisfies
    val_ranges = np.tile(np.array([1, 0], dtype=np.int32), (T, R, 1))
    for t, r in enumerate(range_sets):
        val_ranges[t, :r.shape[0]] = r
    return np.asarray(term_key_ids, dtype=np.int32), val_ranges
