"""Columnar search pages and their container codec.

Counterpart of the reference's ``search/columnar.py``. A block's search
data is dictionary-encoded once at build time — tag keys and values become
int32 ids into per-block sorted dictionaries — and laid out densely:

  kv_key      int32 [P, E, C]  key id of each kv slot (pad -1)
  kv_val      int32 [P, E, C]  value id of each kv slot (pad -1)
  entry_start u32   [P, E]     trace start, unix seconds
  entry_end   u32   [P, E]     trace end, unix seconds
  entry_dur   u32   [P, E]     trace duration, ms
  entry_valid bool  [P, E]
  entry_root_svc/name int32 [P, E]  val-dict ids for result rendering
  trace_ids   u8    [P, E, 16] host-side, for result rendering

P = pages, E = entries per page, C = kv slots per entry. The container
bytes (``to_bytes``) are identical to the reference's for the same
entries, so each package reads the other's blocks.

The optional span segment (the structural engine's substrate) is present
only when some entry carries span rows: a flat span axis S in entry
order, each trace's spans one contiguous run, sharing the block's
dictionaries:

  span_trace    int32 [S]      flat entry index p*E+e of the span's trace
  span_parent   int32 [S]      flat span index of its parent, -1 = none
  span_dur      u32   [S]      ms
  span_kind     int8  [S]      OTLP kind
  span_kv_key/val int32 [S, Cs]  (pad -1), Cs a power of two <= 64
  entry_span_begin/count int32 [P, E]  each entry's run of spans
"""

from __future__ import annotations

import hashlib
import json
import struct
from dataclasses import dataclass, field

import numpy as np

from ..utils.ids import pad_trace_id
from .data import SearchData

_MAGIC = 0x54505553  # "TPUS"
_VERSION = 2
_HDR = struct.Struct("<IIQ")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
SPAN_KV_CAP = 64        # kv slots per span row, at most


@dataclass(frozen=True)
class PageGeometry:
    entries_per_page: int = 1024
    # cap on kv slots per entry; the build sizes the real capacity C to
    # the corpus (next pow2 of the widest entry, at most this)
    kv_per_entry: int = 64


@dataclass
class ColumnarPages:
    geometry: PageGeometry
    key_dict: list          # sorted list[str]
    val_dict: list          # sorted list[str]
    kv_key: np.ndarray      # int32 [P,E,C]
    kv_val: np.ndarray      # int32 [P,E,C]
    entry_start: np.ndarray  # uint32 [P,E]
    entry_end: np.ndarray    # uint32 [P,E]
    entry_dur: np.ndarray    # uint32 [P,E]
    entry_valid: np.ndarray  # bool [P,E]
    entry_root_svc: np.ndarray   # int32 [P,E]
    entry_root_name: np.ndarray  # int32 [P,E]
    trace_ids: np.ndarray    # uint8 [P,E,16]
    n_entries: int = 0
    header: dict = field(default_factory=dict)
    # the optional span segment (see the module docstring); None when no
    # entry carries spans
    span_trace: np.ndarray | None = None
    span_parent: np.ndarray | None = None
    span_dur: np.ndarray | None = None
    span_kind: np.ndarray | None = None
    span_kv_key: np.ndarray | None = None
    span_kv_val: np.ndarray | None = None
    entry_span_begin: np.ndarray | None = None
    entry_span_count: np.ndarray | None = None

    _ARRAYS = (
        ("kv_key", np.int32), ("kv_val", np.int32),
        ("entry_start", np.uint32), ("entry_end", np.uint32),
        ("entry_dur", np.uint32), ("entry_valid", np.bool_),
        ("entry_root_svc", np.int32), ("entry_root_name", np.int32),
        ("trace_ids", np.uint8),
    )
    # written only when the container carries spans, after _ARRAYS
    _SPAN_ARRAYS = (
        ("span_trace", np.int32), ("span_parent", np.int32),
        ("span_dur", np.uint32), ("span_kind", np.int8),
        ("span_kv_key", np.int32), ("span_kv_val", np.int32),
        ("entry_span_begin", np.int32), ("entry_span_count", np.int32),
    )

    @property
    def n_pages(self) -> int:
        return self.kv_key.shape[0]

    @property
    def has_spans(self) -> bool:
        return self.span_trace is not None and self.span_trace.size > 0

    @property
    def n_spans(self) -> int:
        return 0 if self.span_trace is None else int(self.span_trace.shape[0])

    def slice_pages(self, start: int, count: int) -> "ColumnarPages":
        """A view over pages [start, start+count): the unit of a page-range
        search job. Dictionaries are shared with the parent."""
        end = min(start + count, self.n_pages)
        start = min(start, end)
        kw = {name: getattr(self, name)[start:end] for name, _ in self._ARRAYS}
        hdr = dict(self.header)
        hdr["n_pages"] = end - start
        hdr["n_entries"] = int(kw["entry_valid"].sum())
        if self.has_spans:
            # a page range's spans are one contiguous run; entry and
            # parent indices rebase to the slice's origin
            E = self.geometry.entries_per_page
            begin = self.entry_span_begin[start:end]
            cnt = self.entry_span_count[start:end]
            live = cnt > 0
            sb = int(begin[live].min()) if live.any() else 0
            se = int((begin[live] + cnt[live]).max()) if live.any() else 0
            kw["span_trace"] = self.span_trace[sb:se] - start * E
            par = self.span_parent[sb:se].copy()
            par[par >= 0] -= sb
            kw["span_parent"] = par
            for name in ("span_dur", "span_kind", "span_kv_key",
                         "span_kv_val"):
                kw[name] = getattr(self, name)[sb:se]
            kw["entry_span_begin"] = np.where(live, begin - sb,
                                              0).astype(np.int32)
            kw["entry_span_count"] = cnt
            hdr["n_spans"] = se - sb
        out = ColumnarPages(
            geometry=self.geometry, key_dict=self.key_dict,
            val_dict=self.val_dict, n_entries=hdr["n_entries"],
            header=hdr, **kw)
        for attr in ("_dict_fingerprint", "_dict_section_sha"):
            cached = getattr(self, attr, None)
            if cached is not None:
                setattr(out, attr, cached)
        return out

    def max_dur_ms(self) -> int:
        """Upper bound on this container's durations, the packed layout's
        width input (search/packing.py): the header rollup, which the
        build records; a container without it scans its column once
        (memoized)."""
        v = self.header.get("max_dur_ms")
        if v is None:
            v = getattr(self, "_max_dur_ms", None)
            if v is None:
                v = self._max_dur_ms = (int(self.entry_dur.max())
                                        if self.entry_dur.size else 0)
        return int(v)

    # ------------------------------------------------------------------
    # build

    @classmethod
    def build(cls, entries: list[SearchData],
              geometry: PageGeometry = PageGeometry()) -> "ColumnarPages":
        """Dictionary-encode per-trace search data into pages — the same
        layout, header and slot order as the reference's build, span
        segment included (span rows share the block's dictionaries; a
        parent index outside the trace's span list becomes -1)."""
        E = geometry.entries_per_page
        keys: set[str] = set()
        vals: set[str] = set()
        total_spans = 0
        span_kv_max = 0
        for sd in entries:
            for k, vs in sd.kvs.items():
                keys.add(k)
                vals.update(vs)
            if sd.root_service:
                vals.add(sd.root_service)
            if sd.root_name:
                vals.add(sd.root_name)
            for sp in sd.spans:
                total_spans += 1
                width = 0
                for k, vs in sp.kvs.items():
                    keys.add(k)
                    vals.update(vs)
                    width += len(vs)
                span_kv_max = max(span_kv_max, width)
        key_dict = sorted(keys)
        val_dict = sorted(vals)
        kidx = {k: i for i, k in enumerate(key_dict)}
        vidx = {v: i for i, v in enumerate(val_dict)}

        widest = max((sum(len(vs) for vs in sd.kvs.values())
                      for sd in entries), default=1)
        C = 1
        while C < min(widest, geometry.kv_per_entry):
            C *= 2
        C = min(C, geometry.kv_per_entry)

        P = max(1, -(-len(entries) // E))
        kv_key = np.full((P, E, C), -1, dtype=np.int32)
        kv_val = np.full((P, E, C), -1, dtype=np.int32)
        entry_start = np.zeros((P, E), dtype=np.uint32)
        entry_end = np.zeros((P, E), dtype=np.uint32)
        entry_dur = np.zeros((P, E), dtype=np.uint32)
        entry_valid = np.zeros((P, E), dtype=bool)
        entry_root_svc = np.full((P, E), -1, dtype=np.int32)
        entry_root_name = np.full((P, E), -1, dtype=np.int32)
        trace_ids = np.zeros((P, E, 16), dtype=np.uint8)

        sa = None
        if total_spans:
            Cs = 1
            while Cs < min(span_kv_max, SPAN_KV_CAP):
                Cs *= 2
            Cs = min(Cs, SPAN_KV_CAP)
            sa = {
                "span_trace": np.full(total_spans, -1, dtype=np.int32),
                "span_parent": np.full(total_spans, -1, dtype=np.int32),
                "span_dur": np.zeros(total_spans, dtype=np.uint32),
                "span_kind": np.zeros(total_spans, dtype=np.int8),
                "span_kv_key": np.full((total_spans, Cs), -1,
                                       dtype=np.int32),
                "span_kv_val": np.full((total_spans, Cs), -1,
                                       dtype=np.int32),
                "entry_span_begin": np.zeros((P, E), dtype=np.int32),
                "entry_span_count": np.zeros((P, E), dtype=np.int32),
            }
        cursor = 0

        n_entries = 0
        truncated = 0
        min_start, max_end = 0xFFFFFFFF, 0
        min_dur, max_dur = 0xFFFFFFFF, 0
        for i, sd in enumerate(entries):
            p, e = divmod(i, E)
            if sa is not None and sd.spans:
                n = len(sd.spans)
                sa["entry_span_begin"][p, e] = cursor
                sa["entry_span_count"][p, e] = n
                for si, sp in enumerate(sd.spans):
                    row = cursor + si
                    sa["span_trace"][row] = i
                    if 0 <= sp.parent < n:
                        sa["span_parent"][row] = cursor + sp.parent
                    sa["span_dur"][row] = min(sp.dur_ms, 0xFFFFFFFF)
                    sa["span_kind"][row] = sp.kind & 0x7F
                    _put_slots(sa["span_kv_key"][row], sa["span_kv_val"][row],
                               sp.kvs, kidx, vidx)
                cursor += n
            entry_start[p, e] = sd.start_s & 0xFFFFFFFF
            entry_end[p, e] = sd.end_s & 0xFFFFFFFF
            entry_dur[p, e] = min(sd.dur_ms, 0xFFFFFFFF)
            entry_valid[p, e] = True
            if sd.root_service:
                entry_root_svc[p, e] = vidx[sd.root_service]
            if sd.root_name:
                entry_root_name[p, e] = vidx[sd.root_name]
            trace_ids[p, e] = np.frombuffer(pad_trace_id(sd.trace_id),
                                            dtype=np.uint8)
            if sum(len(vs) for vs in sd.kvs.values()) > C:
                truncated += 1
            _put_slots(kv_key[p, e], kv_val[p, e], sd.kvs, kidx, vidx)
            n_entries += 1
            if sd.start_s:
                min_start = min(min_start, sd.start_s)
            max_end = max(max_end, sd.end_s)
            min_dur = min(min_dur, sd.dur_ms)
            max_dur = max(max_dur, sd.dur_ms)

        header = {
            "n_entries": n_entries,
            "n_pages": P,
            "entries_per_page": E,
            "kv_per_entry": C,
            "n_keys": len(key_dict),
            "n_vals": len(val_dict),
            "truncated_entries": truncated,
            "min_start_s": 0 if min_start == 0xFFFFFFFF else min_start,
            "max_end_s": max_end,
            "min_dur_ms": 0 if min_dur == 0xFFFFFFFF else min_dur,
            "max_dur_ms": max_dur,
        }
        if sa is not None:
            header["n_spans"] = total_spans
            header["span_kv_per_entry"] = int(sa["span_kv_key"].shape[1])
        return cls(
            geometry=PageGeometry(E, C), key_dict=key_dict, val_dict=val_dict,
            kv_key=kv_key, kv_val=kv_val,
            entry_start=entry_start, entry_end=entry_end, entry_dur=entry_dur,
            entry_valid=entry_valid, entry_root_svc=entry_root_svc,
            entry_root_name=entry_root_name, trace_ids=trace_ids,
            n_entries=n_entries, header=header, **(sa or {}))

    @classmethod
    def from_arrays(cls, key_dict: list, val_dict: list, kv_key, kv_val,
                    entry_start, entry_end, entry_dur, entry_valid,
                    entry_root_svc, entry_root_name, trace_ids,
                    truncated_entries: int = 0,
                    spans: dict | None = None) -> "ColumnarPages":
        """Pages from already-encoded numpy columns and sorted
        dictionaries (the reference's ColumnarPages fields, or a bulk
        corpus generator's). Columns are cast to the container dtypes and
        the header rollup is computed from the valid entries the way the
        build computes it. `spans`: the span segment's arrays by name
        (``_SPAN_ARRAYS``), laid out as the build lays them out."""
        def col(a, dt):
            return np.ascontiguousarray(np.asarray(a).astype(dt, copy=False))

        kw = {name: col(a, dt) for (name, dt), a in zip(cls._ARRAYS, (
            kv_key, kv_val, entry_start, entry_end, entry_dur, entry_valid,
            entry_root_svc, entry_root_name, trace_ids))}
        P, E, C = kw["kv_key"].shape
        valid = kw["entry_valid"]
        starts = kw["entry_start"][valid]
        nz = starts[starts != 0]
        durs = kw["entry_dur"][valid]
        ends = kw["entry_end"][valid]
        n_entries = int(valid.sum())
        header = {
            "n_entries": n_entries,
            "n_pages": P,
            "entries_per_page": E,
            "kv_per_entry": C,
            "n_keys": len(key_dict),
            "n_vals": len(val_dict),
            "truncated_entries": int(truncated_entries),
            "min_start_s": int(nz.min()) if nz.size else 0,
            "max_end_s": int(ends.max()) if ends.size else 0,
            "min_dur_ms": int(durs.min()) if durs.size else 0,
            "max_dur_ms": int(durs.max()) if durs.size else 0,
        }
        if spans is not None:
            kw.update({name: col(spans[name], dt)
                       for name, dt in cls._SPAN_ARRAYS})
            if kw["span_trace"].size:
                header["n_spans"] = int(kw["span_trace"].shape[0])
                header["span_kv_per_entry"] = int(
                    kw["span_kv_key"].shape[1])
        return cls(geometry=PageGeometry(E, C), key_dict=list(key_dict),
                   val_dict=list(val_dict), n_entries=n_entries,
                   header=header, **kw)

    # ------------------------------------------------------------------
    # container codec

    def to_bytes(self) -> bytes:
        sections: dict[str, bytes] = {}
        for name, _ in self._ARRAYS:
            sections[name] = np.ascontiguousarray(getattr(self, name)).tobytes()
        if self.has_spans:
            for name, _ in self._SPAN_ARRAYS:
                sections[name] = np.ascontiguousarray(
                    getattr(self, name)).tobytes()
        sections["key_dict"] = _pack_strs(self.key_dict)
        sections["val_dict"] = _pack_strs(self.val_dict)
        offsets = {}
        body = bytearray()
        for name, blob in sections.items():
            offsets[name] = [len(body), len(blob)]
            body += blob
        hdr = dict(self.header)
        hdr["sections"] = offsets
        digest = _dict_sections_sha(sections["key_dict"],
                                    sections["val_dict"])
        hdr["dict_sha"] = digest.hex()
        self._dict_section_sha = digest
        hdr_b = json.dumps(hdr).encode()
        return _HDR.pack(_MAGIC, _VERSION, len(hdr_b)) + hdr_b + bytes(body)

    @classmethod
    def from_bytes(cls, buf: bytes) -> "ColumnarPages":
        magic, version, hdr_len = _HDR.unpack_from(buf)
        if magic != _MAGIC:
            raise ValueError("bad search container magic")
        if version != _VERSION:
            raise ValueError(f"unsupported search container version {version}")
        hdr = json.loads(buf[_HDR.size:_HDR.size + hdr_len])
        base = _HDR.size + hdr_len
        sections = hdr.pop("sections")
        P = hdr["n_pages"]
        E = hdr["entries_per_page"]
        C = hdr["kv_per_entry"]
        shapes = {
            "kv_key": (P, E, C), "kv_val": (P, E, C),
            "entry_start": (P, E), "entry_end": (P, E), "entry_dur": (P, E),
            "entry_valid": (P, E), "entry_root_svc": (P, E),
            "entry_root_name": (P, E), "trace_ids": (P, E, 16),
        }
        kw = {}
        for name, dtype in cls._ARRAYS:
            off, length = sections[name]
            arr = np.frombuffer(buf, dtype=dtype,
                                count=length // np.dtype(dtype).itemsize,
                                offset=base + off)
            kw[name] = arr.reshape(shapes[name])
        S = int(hdr.get("n_spans", 0) or 0)
        if S and "span_trace" in sections:
            Cs = int(hdr.get("span_kv_per_entry", 1))
            span_shapes = {"span_kv_key": (S, Cs), "span_kv_val": (S, Cs),
                           "entry_span_begin": (P, E),
                           "entry_span_count": (P, E)}
            for name, dtype in cls._SPAN_ARRAYS:
                off, length = sections[name]
                arr = np.frombuffer(buf, dtype=dtype,
                                    count=length // np.dtype(dtype).itemsize,
                                    offset=base + off)
                kw[name] = arr.reshape(span_shapes.get(name, (S,)))
        off, length = sections["key_dict"]
        key_sec = buf[base + off: base + off + length]
        off, length = sections["val_dict"]
        val_sec = buf[base + off: base + off + length]
        out = cls(geometry=PageGeometry(E, C),
                  key_dict=_unpack_strs(key_sec),
                  val_dict=_unpack_strs(val_sec),
                  n_entries=hdr["n_entries"], header=hdr, **kw)
        ds = hdr.get("dict_sha")
        out._dict_section_sha = (bytes.fromhex(ds) if ds
                                 else _dict_sections_sha(key_sec, val_sec))
        return out


def _put_slots(keys: np.ndarray, vals: np.ndarray, kvs: dict, kidx: dict,
               vidx: dict) -> None:
    """Fill one row's kv slots in sorted key, then value, order, up to
    the row's width (the rest stay -1)."""
    C = keys.shape[0]
    slot = 0
    for k in sorted(kvs):
        for v in sorted(kvs[k]):
            if slot >= C:
                return
            keys[slot] = kidx[k]
            vals[slot] = vidx[v]
            slot += 1


def _dict_sections_sha(key_sec: bytes, val_sec: bytes) -> bytes:
    """Content digest of the encoded dictionary sections: equal digests
    mean equal dictionaries (the encoding is injective)."""
    h = hashlib.sha256()
    h.update(key_sec)
    h.update(b"\x01")
    h.update(val_sec)
    return h.digest()


def _pack_strs(strs: list) -> bytes:
    out = bytearray(_U32.pack(len(strs)))
    for s in strs:
        b = s.encode("utf-8")[:0xFFFF]
        out += _U16.pack(len(b)) + b
    return bytes(out)


def _unpack_strs(buf: bytes) -> list:
    (n,) = _U32.unpack_from(buf)
    off = 4
    out = []
    for _ in range(n):
        (ln,) = _U16.unpack_from(buf, off)
        off += 2
        out.append(buf[off:off + ln].decode("utf-8", errors="replace"))
        off += ln
    return out
