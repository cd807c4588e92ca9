"""Host/device offload planner for the dictionary probe.

Counterpart of the reference's ``search/planner.py``. Above the static
``search_device_probe_min_vals`` floor, a cost model over the profiler's
observations chooses, per dictionary and tag-set, whether the substring
prefilter runs on the host (``pipeline.substring_value_ids``: numpy, or
the host library's memmem scan from 50,000 values) or on the device
(kernel K3, ``dict_probe.probe_value_hits``):

  host(T, B)   = T * rate(host_probe, T*B) * B
  device(...)  = T * rate(device_probe, T*S) * S       the K3 launch
               + [pack(B) + h2d(S)]  if not resident   staging
               + fixed(dispatch)                       launch overhead
               + fixed(compile)      while K3's kernel library (and on a
                                     mesh the exchange's) is not loaded
                                     in this process
               + fixed(collective)   on a mesh (the all_gather and the
                                     collective dispatch lock)

B is the dictionary's UTF-8 bytes, S its staged bytes, T the term count.
Rates are EWMAs bucketed by log-size; fixed costs are plain EWMAs. They
are fed by the finished ``dict_probe`` and scan records and the h2d
observations of the gate that carries the planner
(``observability/profile.py``), by the host probe's own wall time (with
the dictionary fingerprint, so a decision's predicted-vs-actual error
resolves), and by the packing of a dictionary (``dict_probe``).

The first decision seeds the model with a one-shot microbenchmark on the
planner's device: a 2,048-value dictionary through the host scan and
through pack, copy and K3. On a CUDA device the seed launches the real
K3 and a failure there raises; on the CPU it runs K3's plain version.

Both placements are exact (the probe is a prefilter; the scan kernels
take ranges or hit masks), so a verdict never changes an answer, only
where the time goes. With the planner off (the default) the call sites
never consult it and the static threshold alone decides.

Each ``TempoDB`` owns a planner and hands it down on its profiling gate
(``profile.Gate.planner``); ``PLANNER`` and ``configure`` serve callers
outside a database. The reference's planner is process-wide and follows
the most recent database. Its ``compile`` term charges a jit compile at
each unseen shape; the port's kernels take any shape, so the term
applies only while a kernel library is still to load (the profiler's
``compile`` stage since PR 20).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

import torch

from ..observability import metrics as obs
from ..observability import profile

# per-byte cost kinds (seconds per byte; probe kinds are per term-byte:
# observations pass nbytes = n_terms * bytes). "scan" is the scan
# dispatches' execute rate over their physical staged bytes; "analytics"
# the ingest count's (fed once A15's generator lands)
PER_BYTE_KINDS = ("host_probe", "device_probe", "pack", "h2d", "scan",
                  "analytics")
# the kinds the one-shot microbenchmark seeds: everything a probe
# decision reads. "scan" fills from the first live dispatches
SEEDED_KINDS = ("host_probe", "device_probe", "pack", "h2d")
# fixed per-event costs (seconds)
FIXED_KINDS = ("dispatch", "compile", "collective")

# cold-start priors, used only until the seed or an observation replaces
# them (the reference's values, biased towards the host: staging hundreds
# of MB on a guess is the costly mistake)
_DEFAULT_RATES = {
    "host_probe": 4e-9,
    "device_probe": 8e-9,
    "pack": 6e-9,
    "h2d": 1e-9,
    "scan": 1e-10,
    "analytics": 2e-9,
}
_DEFAULT_FIXED = {"dispatch": 1e-3, "compile": 0.5, "collective": 2e-3}

# staged bytes per dictionary byte when the packed layout does not exist
# yet (the reference's estimate; the port stages buf + int32 offsets, so
# this overestimates its S, which biases towards the host)
_STAGED_FACTOR = 7.5

_SEED_VALS = 2048   # the microbenchmark's dictionary size
_SEED_NEEDLE = "seed-value-0000512"


def dict_bytes_est(val_dict, cache_on=None) -> int:
    """Estimated UTF-8 bytes of a value dictionary, from an evenly spaced
    sample of 256 values, memoized on the immutable container when one is
    given."""
    if cache_on is not None:
        hit = getattr(cache_on, "_dict_nbytes_est", None)
        if hit is not None:
            return hit
    n = len(val_dict)
    if n == 0:
        est = 0
    elif n <= 256:
        est = sum(len(v.encode("utf-8")) for v in val_dict)
    else:
        step = n // 256
        sample = val_dict[::step][:256]
        est = int(sum(len(v.encode("utf-8")) for v in sample)
                  / len(sample) * n)
    if cache_on is not None:
        cache_on._dict_nbytes_est = est
    return est


@dataclass
class Decision:
    """One verdict, kept in the decision ring until its actual cost
    arrives."""
    seq: int
    site: str                 # "stage" | "compile" | "offline"
    target: str               # "host" | "device"
    fp: str | None            # dictionary fingerprint (hex prefix)
    inputs: dict
    predicted_host_s: float
    predicted_device_s: float
    # the chosen side's probe-only cost (what the later observation
    # measures; staging and fixed costs are observed apart)
    predicted_probe_s: float
    # the compile cost charged into predicted_device_s: a record whose
    # compile stage holds the library load and the first run resolves
    # against the probe and this together
    predicted_compile_s: float = 0.0
    actual_s: float | None = None
    error: float | None = None

    def as_dict(self) -> dict:
        d = {
            "seq": self.seq, "site": self.site, "target": self.target,
            "inputs": self.inputs,
            "predicted_host_ms": round(self.predicted_host_s * 1e3, 3),
            "predicted_device_ms": round(self.predicted_device_s * 1e3, 3),
            "predicted_probe_ms": round(self.predicted_probe_s * 1e3, 3),
        }
        if self.fp:
            d["fp"] = self.fp
        if self.actual_s is not None:
            d["actual_probe_ms"] = round(self.actual_s * 1e3, 3)
            d["abs_rel_error"] = round(self.error, 3)
        return d


class _Ewma:
    __slots__ = ("value", "n")

    def __init__(self):
        self.value = None
        self.n = 0

    def update(self, x: float, alpha: float) -> None:
        self.value = x if self.value is None else \
            alpha * x + (1 - alpha) * self.value
        self.n += 1


def _bucket(nbytes: int) -> int:
    """4x-wide log-size buckets: rates depend on size."""
    return max(0, int(nbytes).bit_length() // 2)


class OffloadPlanner:
    """The cost model, its decision ring and its feed. `device`: where the
    seed runs K3 (None: ``cuda``, as every entry point of the port; it
    raises without a card)."""

    def __init__(self, enabled: bool = False, alpha: float = 0.25,
                 ring_size: int = 256, seed: bool = True, device=None):
        self.enabled = enabled
        self.alpha = alpha
        self.seed_on_first_use = seed
        self.device = device
        self._lock = threading.Lock()
        self._rates: dict[tuple, _Ewma] = {}       # (kind, bucket)
        self._rates_global: dict[str, _Ewma] = {k: _Ewma()
                                                for k in PER_BYTE_KINDS}
        self._fixed: dict[str, _Ewma] = {k: _Ewma() for k in FIXED_KINDS}
        self._ring: deque = deque(maxlen=ring_size)
        self._seq = 0
        self._seeded = False
        # gates the feed while the seed runs, so its own launches do not
        # land on top of its direct updates
        self._seeding = False
        self._seed_ms = None
        self._decisions = {"host": 0, "device": 0}
        self._mispredict = _Ewma()

    def _device(self) -> torch.device:
        """The planner's device; a name (or None: ``cuda``) resolves once,
        raising without a card."""
        if not isinstance(self.device, torch.device):
            from ..device import resolve_device

            self.device = resolve_device(self.device)
        return self.device

    # ------------------------------------------------------------------
    # cost model

    def rate(self, kind: str, nbytes: int) -> float:
        """Seconds per byte for `kind` at this size: its bucket, the
        nearest observed bucket, the global EWMA, the prior."""
        b = _bucket(nbytes)
        with self._lock:
            e = self._rates.get((kind, b))
            if e is not None and e.value is not None:
                return e.value
            near = None
            for (k, kb), ev in self._rates.items():
                if k != kind or ev.value is None:
                    continue
                if near is None or abs(kb - b) < abs(near[0] - b):
                    near = (kb, ev.value)
            if near is not None:
                return near[1]
            g = self._rates_global[kind]
            if g.value is not None:
                return g.value
        return _DEFAULT_RATES[kind]

    def fixed(self, kind: str) -> float:
        with self._lock:
            e = self._fixed[kind]
            if e.value is not None:
                return e.value
        return _DEFAULT_FIXED[kind]

    def observe(self, kind: str, seconds: float, nbytes: int = 0,
                fp: bytes | str | None = None) -> None:
        """Feed one measurement (per-byte kinds need `nbytes`; probe kinds
        n_terms * bytes). `fp` resolves the pending decision of that
        dictionary. A no-op while the planner is off or seeding."""
        if not self.enabled or self._seeding:
            return
        self._update(kind, seconds, nbytes)
        if kind in ("host_probe", "device_probe"):
            self._resolve(kind, seconds, fp)

    def _update(self, kind: str, seconds: float, nbytes: int) -> None:
        with self._lock:
            if kind in FIXED_KINDS:
                self._fixed[kind].update(seconds, self.alpha)
                return
            if nbytes <= 0:
                return
            r = seconds / nbytes
            key = (kind, _bucket(nbytes))
            e = self._rates.get(key)
            if e is None:
                e = self._rates[key] = _Ewma()
            e.update(r, self.alpha)
            self._rates_global[kind].update(r, self.alpha)

    def _resolve(self, kind: str, seconds: float, fp: bytes | str | None,
                 include_compile: bool = False) -> None:
        """Match an observed probe to the newest unresolved decision for
        the same dictionary and side, and record the relative error.
        `include_compile`: the observation is a record's compile stage
        (the library load and the first run), so compare it with the
        decision's predicted compile cost added."""
        target = "host" if kind == "host_probe" else "device"
        fph = self._fp_hex(fp)
        err = None
        with self._lock:
            for d in reversed(self._ring):
                if d.actual_s is not None or d.target != target:
                    continue
                if fph is not None and d.fp is not None and d.fp != fph:
                    continue
                d.actual_s = seconds
                predicted = d.predicted_probe_s
                if include_compile:
                    predicted += d.predicted_compile_s
                err = d.error = abs(predicted - seconds) / max(seconds, 1e-9)
                self._mispredict.update(err, self.alpha)
                break
        if err is not None:
            obs.offload_predict_error.observe(err)

    @staticmethod
    def _fp_hex(fp) -> str | None:
        if not fp:
            return None
        return fp[:16] if isinstance(fp, str) else fp.hex()[:16]

    def _compile_pending(self, n_shards: int) -> bool:
        """Whether a device probe now would load a kernel library: K3's
        (and on a mesh the exchange's), on a CUDA device. The CPU runs
        plain versions and loads none."""
        dev = self._device()
        if dev.type != "cuda":
            return False
        from .kernels import build

        libs = ("probe", "dist") if n_shards > 1 else ("probe",)
        return any(n not in build._libs for n in libs)

    # ------------------------------------------------------------------
    # decisions

    def decide_probe(self, *, n_vals: int, dict_bytes: int,
                     n_terms: int = 1, resident: bool = False,
                     packed: bool = False, staged_bytes: int | None = None,
                     n_shards: int = 1, fp: bytes | str | None = None,
                     site: str = "compile") -> Decision:
        """Host or device for one dictionary's substring prefilter. Call
        sites ask only above the static threshold.

        `resident`: the dictionary is on the device already (a
        compile-site decision over a staged batch); `packed`: its host
        packing exists (an evicted batch re-stages without re-packing);
        `n_shards` > 1 adds the mesh's collective cost."""
        self._ensure_seeded()
        T = max(1, int(n_terms))
        B = max(1, int(dict_bytes))
        S = int(staged_bytes) if staged_bytes else int(B * _STAGED_FACTOR)

        host_s = self.rate("host_probe", T * B) * T * B

        dev_probe_s = self.rate("device_probe", T * S) * T * S
        dev_s = dev_probe_s + self.fixed("dispatch")
        if not resident:
            dev_s += self.rate("h2d", S) * S
            if not packed:
                dev_s += self.rate("pack", B) * B
        if n_shards > 1:
            dev_s += self.fixed("collective")
        jit_miss = self._compile_pending(n_shards)
        compile_s = self.fixed("compile") if jit_miss else 0.0
        dev_s += compile_s

        target = "device" if dev_s < host_s else "host"
        with self._lock:
            self._seq += 1
            d = Decision(
                seq=self._seq, site=site, target=target,
                fp=self._fp_hex(fp),
                inputs={"n_vals": int(n_vals), "dict_bytes": B,
                        "n_terms": T, "resident": bool(resident),
                        "staged_bytes": S, "n_shards": int(n_shards),
                        "jit_miss": bool(jit_miss)},
                predicted_host_s=host_s, predicted_device_s=dev_s,
                predicted_probe_s=(dev_probe_s if target == "device"
                                   else host_s),
                predicted_compile_s=(compile_s if target == "device"
                                     else 0.0),
            )
            self._ring.append(d)
            self._decisions[target] += 1
        obs.offload_decisions.inc(target=target, site=site)
        from . import query_stats

        qs = query_stats.current()
        if qs is not None:
            qs.add_planner(target, d.predicted_device_s
                           if target == "device" else d.predicted_host_s)
        return d

    # ------------------------------------------------------------------
    # seeding

    def _ensure_seeded(self) -> None:
        if self._seeded or not self.seed_on_first_use:
            return
        with self._lock:
            if self._seeded:
                return
            self._seeded = True   # first, so the seed cannot recurse
            self._seeding = True
        t0 = time.perf_counter()
        try:
            self._seed()
        finally:
            self._seeding = False
        self._seed_ms = round((time.perf_counter() - t0) * 1e3, 1)

    def _seed(self) -> None:
        """The one-shot microbenchmark on the planner's device: a small
        synthetic dictionary through the host scan and through pack,
        copy and K3, so a cold process decides from this host's and this
        card's rates. A K3 that fails raises (a device fault)."""
        from . import dict_probe, pipeline

        dev = self._device()
        cuda = dev.type == "cuda"

        def sync():
            if cuda:
                torch.cuda.synchronize(dev)

        vals = [f"seed-value-{i:07d}" for i in range(_SEED_VALS)]
        nb = sum(len(v) for v in vals)
        t0 = time.perf_counter()
        pipeline.substring_value_ids(vals, _SEED_NEEDLE)
        self._update("host_probe", time.perf_counter() - t0, nb)

        t0 = time.perf_counter()
        pd = dict_probe.pack_device_dict(vals)
        self._update("pack", time.perf_counter() - t0, nb)
        t0 = time.perf_counter()
        dd = dict_probe.place_device_dict(pd, dev)
        sync()
        self._update("h2d", time.perf_counter() - t0, pd.nbytes)

        # compile: the load of K3's library, when this process has not
        # loaded it (the port's kernels take any shape)
        if cuda:
            dt = profile._load_missing(("probe",))
            if dt is not None:
                self._update("compile", dt, 0)
        needles = [_SEED_NEEDLE.encode()]
        dict_probe.probe_value_hits(dd, needles)[1].cpu()   # a warm-up
        t0 = time.perf_counter()
        dict_probe.probe_value_hits(dd, needles)[1].cpu()
        warm = time.perf_counter() - t0
        # a 2k-value probe is nearly all launch overhead: half of it to
        # the fixed dispatch cost, half to the per-byte rate
        self._update("dispatch", warm / 2, 0)
        self._update("device_probe", warm / 2, pd.nbytes)

    # ------------------------------------------------------------------
    # the profiler's feed

    def ingest_record(self, rec: dict) -> int:
        """One finished dispatch record (``Dispatch.as_dict``). Probe
        records feed the device rate and the compile and collective
        costs; scan records the scan rate over their physical staged
        bytes. Returns the model updates made."""
        if not self.enabled or self._seeding:
            return 0
        mode = rec.get("mode")
        stages = rec.get("stages_ms") or {}
        attrs = rec.get("attrs") or {}
        if mode in ("batched", "mesh", "coalesced", "single"):
            sb = int(attrs.get("scan_bytes") or 0)
            ex = stages.get("execute")
            if ex and sb:
                self._update("scan", ex / 1e3, sb)
                return 1
            return 0
        if mode != "dict_probe":
            return 0
        n = 0
        nb = int(attrs.get("probe_bytes") or 0)
        fp = attrs.get("fp")
        ex = stages.get("execute")
        if ex and nb:
            self.observe("device_probe", ex / 1e3, nb, fp=fp)
            n += 1
        comp = stages.get("compile")
        if comp:
            self._update("compile", comp / 1e3, 0)
            if nb:
                self._resolve("device_probe", comp / 1e3, fp,
                              include_compile=True)
            n += 1
        lw = stages.get("lock_wait")
        if lw:
            self._update("collective", lw / 1e3, 0)
            n += 1
        return n

    def ingest_stage(self, stage: str, mode: str, seconds: float,
                     nbytes: int) -> int:
        """One stage observation outside a record: the h2d of a
        dictionary or a batch (physical bytes). The host probe feeds
        ``observe`` directly, with its fingerprint."""
        if not self.enabled or self._seeding:
            return 0
        if stage == "h2d" and nbytes \
                and mode in ("dict_probe", "batched", "mesh", "single"):
            self._update("h2d", seconds, nbytes)
            return 1
        return 0

    def ingest_profile_snapshot(self, snap: dict) -> int:
        """Calibration from a profiler snapshot (``profile.snapshot``):
        the recent records through ``ingest_record``, then the per-byte
        rates from the byte-carrying aggregates. Returns observations
        taken."""
        n = 0
        for rec in snap.get("recent") or []:
            n += self.ingest_record(rec)
        for mode, stages in (snap.get("aggregates") or {}).items():
            for stage, a in stages.items():
                cnt = int(a.get("count") or 0)
                nbytes = int(a.get("bytes") or 0)
                total_s = float(a.get("total_ms") or 0.0) / 1e3
                if not cnt or not nbytes:
                    continue
                kind = None
                if stage == "h2d" and mode == "dict_probe":
                    kind = "h2d"
                elif stage == "build" and mode == "host_probe":
                    kind = "host_probe"
                if kind is not None:
                    self._update(kind, total_s / cnt, nbytes // cnt)
                    n += 1
        return n

    # ------------------------------------------------------------------
    # operator surface

    def snapshot(self, recent: int = 32) -> dict:
        """Decisions, calibration state and the cost-model table."""
        with self._lock:
            rates = {}
            for kind in PER_BYTE_KINDS:
                buckets = {
                    f"2^{2 * b}B": ev.value
                    for (k, b), ev in sorted(self._rates.items())
                    if k == kind and ev.value is not None
                }
                g = self._rates_global[kind]
                rates[kind] = {"seconds_per_byte": g.value,
                               "observations": g.n, "buckets": buckets}
            fixed = {k: {"seconds": e.value, "observations": e.n}
                     for k, e in self._fixed.items()}
            ring = [d.as_dict() for d in list(self._ring)[-recent:]] \
                if recent > 0 else []
            return {
                "enabled": self.enabled,
                "seeded": self._seeded,
                "seed_ms": self._seed_ms,
                "decisions": dict(self._decisions),
                "mispredict": {
                    "observations": self._mispredict.n,
                    "ewma_abs_rel_error": self._mispredict.value,
                },
                "cost_model": {"rates": rates, "fixed": fixed},
                "recent": ring,
            }

    def reset(self) -> None:
        with self._lock:
            self._rates.clear()
            self._rates_global = {k: _Ewma() for k in PER_BYTE_KINDS}
            self._fixed = {k: _Ewma() for k in FIXED_KINDS}
            self._ring.clear()
            self._seq = 0
            self._seeded = False
            self._seeding = False
            self._seed_ms = None
            self._decisions = {"host": 0, "device": 0}
            self._mispredict = _Ewma()


# the process planner: callers outside a database, and the records and
# observations of gates that carry no planner
PLANNER = OffloadPlanner()
profile.set_default_planner(PLANNER)


def planner_of(gate) -> OffloadPlanner:
    """The planner a gate's engines consult: the database's, or the
    process planner for a gate outside a database."""
    p = getattr(gate, "planner", None)
    return PLANNER if p is None else p


def structural_node_seconds(node_bytes: dict,
                            planner: OffloadPlanner | None = None) -> dict:
    """Each structural plan node's byte estimate through the planner's
    live scan rate: predicted seconds a node."""
    p = PLANNER if planner is None else planner
    return {nid: nb * p.rate("scan", nb) for nid, nb in node_bytes.items()}


def stage_veto(block, fp, n_shards: int = 1,
               planner: OffloadPlanner | None = None) -> bool:
    """True when the enabled planner places this dictionary's prefilter
    on the host at staging time: the call site then neither packs nor
    stages it. The one stage-site decision of ``engine.stage_block_dict``,
    ``multiblock.pack_batch_dicts`` and the distributed engine's stage.
    Always False with the planner off."""
    p = PLANNER if planner is None else planner
    if not p.enabled:
        return False
    packed = getattr(block, "_device_dict_packed", None)
    d = p.decide_probe(
        n_vals=len(block.val_dict),
        dict_bytes=dict_bytes_est(block.val_dict, cache_on=block),
        resident=False, packed=packed is not None,
        staged_bytes=None if packed is None else packed.nbytes,
        n_shards=max(1, int(n_shards)), fp=fp, site="stage")
    return d.target == "host"


def configure(enabled: bool | None = None, alpha: float | None = None,
              ring_size: int | None = None, seed: bool | None = None,
              device=None, reset: bool = False) -> OffloadPlanner:
    """Set the process planner (``PLANNER``), for callers outside a
    database; a database configures its own planner."""
    if reset:
        PLANNER.reset()
    if alpha is not None:
        PLANNER.alpha = float(alpha)
    if ring_size is not None:
        with PLANNER._lock:
            PLANNER._ring = deque(PLANNER._ring, maxlen=int(ring_size))
    if seed is not None:
        PLANNER.seed_on_first_use = bool(seed)
    if device is not None:
        PLANNER.device = device
    if enabled is not None:
        PLANNER.enabled = bool(enabled)
    return PLANNER
