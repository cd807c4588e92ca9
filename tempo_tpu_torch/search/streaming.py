"""The WAL head's search block: appended live, scanned, replayed after a
crash.

Counterpart of the reference's ``search/streaming.py``. Each trace's
search data is appended to a sidecar file (``<wal name>.search``, object
framing of ``encoding/v2/objects.py``, the same bytes as the reference's
both ways) and merged copy-on-write into the block's entry set, bumping
its epoch. ``search`` answers from that set: with the gate on (the
database's ``LiveTier`` enabled) through ``live_tier.scan_search_data``,
B9 on the tier's device, over the entries in trace-id order; with it off
through the reference's per-entry walk (``data.search_data_matches``),
which reads the request deadline every 256 entries. The walk is a
configured route, never a fallback: a fault in the scan raises.
"""

from __future__ import annotations

import os
import struct

from ..encoding.v2.objects import marshal_object, unmarshal_objects
from ..model.types import TraceSearchMetadata
from ..robustness import deadline
from ..utils.ids import pad_trace_id
from . import structural
from .data import (SearchData, clone_search_data, decode_search_data,
                   encode_search_data, search_data_matches)
from .pipeline import UINT32_MAX


class StreamingSearchBlock:
    """`live`: the database's LiveTier, whose gate, device and structural
    config the search uses (None: the walk, structural queries off)."""

    def __init__(self, path: str, live=None, _replay: bool = False):
        self.path = path
        self.live = live
        self._entries: dict[bytes, SearchData] = {}
        # versions the entry set for the stage cache; the stage itself is
        # made at the first gate-on search
        self._epoch = 0
        self._stage = None
        # (epoch, entries in trace-id order), replaced when the epoch moves
        self._sorted: tuple = (-1, [])
        if _replay:
            self._replay()
            self._fh = open(path, "ab")
        else:
            self._fh = open(path, "wb")

    def append(self, trace_id: bytes, sd: SearchData) -> None:
        tid = pad_trace_id(trace_id)
        self._fh.write(marshal_object(tid, encode_search_data(sd)))
        self._fh.flush()
        self._merge(tid, sd)

    def _merge(self, tid: bytes, sd: SearchData) -> None:
        cur = self._entries.get(tid)
        if cur is None:
            sd.trace_id = tid
            self._entries[tid] = sd
        else:
            # copy-on-write: a published entry never changes, so a scan
            # may build from a snapshot of references
            merged = clone_search_data(cur)
            merged.merge(sd)
            self._entries[tid] = merged
        self._epoch += 1

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> list[SearchData]:
        """The merged entries in ascending trace-id order."""
        return list(self._sorted_entries())

    def _sorted_entries(self) -> list[SearchData]:
        """entries(), sorted once per epoch; the list is shared, not to be
        changed."""
        if self._sorted[0] != self._epoch:
            self._sorted = (self._epoch, [self._entries[t]
                                          for t in sorted(self._entries)])
        return self._sorted[1]

    # entries walked between reads of the request deadline
    _DEADLINE_STRIDE = 256

    def search(self, req, results) -> None:
        """Add the block's matches to `results`. An expired request
        deadline books ``metrics.partial`` before any work."""
        live = self.live
        cfg = structural.OFF if live is None else live.structural_cfg
        if deadline.expired():
            results.metrics.partial = True
            return
        if live is not None and live.enabled:
            from .live_tier import _HotStage, scan_search_data

            if self._stage is None:
                self._stage = _HotStage()
            if scan_search_data(self._sorted_entries(), req, results,
                                self._stage, self._epoch, live):
                return
        structural.structural_query(req, cfg)   # refuse before the walk
        for i, sd in enumerate(self._entries.values()):
            if i % self._DEADLINE_STRIDE == 0 and i and deadline.expired():
                results.metrics.partial = True
                return
            results.metrics.inspected_traces += 1
            if search_data_matches(sd, req, cfg):
                results.add(_meta_from_sd(sd))
                if results.complete:
                    return

    # ---- lifecycle

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def clear(self) -> None:
        self.close()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    def _replay(self) -> None:
        """Merge the sidecar's entries: a torn tail is cut off the file,
        an entry that does not decode is skipped."""
        with open(self.path, "rb") as f:
            buf = f.read()
        off = 0
        for tid, payload in unmarshal_objects(buf, tolerate_truncation=True):
            off += 8 + len(tid) + len(payload)
            try:
                sd = decode_search_data(payload, tid)
            except (struct.error, IndexError):   # skip it, keep replaying
                continue
            self._merge(tid, sd)
        if off < len(buf):
            with open(self.path, "ab") as f:
                f.truncate(off)

    @classmethod
    def rescan(cls, path: str, live=None) -> "StreamingSearchBlock":
        return cls(path, live=live, _replay=True)


def _meta_from_sd(sd: SearchData) -> TraceSearchMetadata:
    return TraceSearchMetadata(
        trace_id=sd.trace_id.hex(), start_time_unix_nano=sd.start_ns,
        duration_ms=min(sd.dur_ms, UINT32_MAX),
        root_service_name=sd.root_service, root_trace_name=sd.root_name)
