"""Device-path dispatch profiler: per-dispatch stage telemetry, with the
device's own time read from CUDA events.

Counterpart of the reference's ``observability/profile.py``. Every device
dispatch path (``single``, ``batched``, ``coalesced``, ``mesh`` and
``dict_probe``) opens a record whose stages are:

  build      host work before the first launch (query tables and their
             upload); ``mode=host_probe`` observations are the host
             dictionary scan
  h2d        host-to-device staging, observed outside the records (bytes
             counted separately)
  compile    the first load of a kernel library in this process (its nvcc
             build or its dlopen), booked by the first dispatch that needs
             the library. The kernels take any shape, so nothing else
             compiles; after that every dispatch books a cache hit
  execute    on a CUDA device, the time between two CUDA events on the
             launches' stream, one recorded before the first launch and
             one after the last. It encloses the host's issue gaps between
             the launches, so it is at least the kernels' own time. On the
             CPU, the wall time of the synchronous plain call
  d2h        on a CUDA device, the event time of the outputs' copy to the
             host (after their gather into one buffer), made on a side
             stream that waits for the dispatch's end event only; on the
             CPU the fetch's wall time
  lock_wait  time queued on the collective dispatch lock (mesh paths)

Nothing here adds a synchronisation to the stream. A record finishes
where its dispatch's outputs come to the host (``engine.fetch_scan_out``,
``fetch_coalesced_out``, the coalescer's fused fetch): both events have
completed there, so reading them waits for nothing. ``search_profiling_
fence`` synchronises the stream after each dispatch's launches instead,
as the reference's fence does. A record whose outputs never come to the
host (a dispatch a search abandoned after its early quit, the probe's
masks that feed a scan) is *detached*: it finishes at the next fetch of
any dispatch once its end event has completed, or when its query
settles (``QueryStats.settle``), or, if its events are still pending
then, on the reaper thread, which waits on the end event off the search
path. A record that cannot create or read its events raises: there is no
host-clock fallback on a CUDA device. On the reaper, which has no caller
to raise to, such a record is booked as a device fault and the next
sweep or query settle raises for it (``DispatchProfiler.raise_lost``).

Records land in a bounded ring (``snapshot``) and aggregate into the
metrics ``tempo_search_dispatch_stage_seconds{stage,mode}``,
``tempo_search_jit_cache_events_total{result}`` and the h2d/d2h byte
counters. A finished record is also handed to the innermost record
collector (``collect_records``) that was open on the thread that opened
the record: the query-stats attribution hook.

The gates are per database (``Gate``, built from
``TempoDBConfig.search_profiling_enabled`` and ``_fence``); the ring and
the aggregates (``PROFILER``) are process-wide, as in the reference. A
gate that is off hands out a shared noop record: no allocation, no
clock read, no event, no lock.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import deque

from . import metrics as obs

STAGES = ("build", "h2d", "compile", "execute", "d2h", "lock_wait")
_JIT_EVENTS = {r: obs.jit_cache_events.labels(result=r)
               for r in ("hit", "miss")}

# per-thread stack of record collectors (collect_records): a record opened
# on this thread is handed, when it finishes, to the collector innermost
# when it was opened. Thread-local rather than a contextvar: the
# coalescer's flush threads must not inherit a submitter's collector.
_collect_local = threading.local()


class Collector(list):
    """The dict form of every record finished that was opened under it,
    in finishing order. ``opened`` holds the records themselves as they
    open; ``on_record`` (when given) is called with each record as it
    finishes, on the finishing thread."""

    def __init__(self, on_record=None):
        super().__init__()
        self.opened: list = []
        self.on_record = on_record


@contextlib.contextmanager
def collect_records(on_record=None):
    """Collect the records opened on this thread inside the body; only
    the innermost open collector gets a record. A record finishes where
    its outputs come to the host, which may be after the body (and on
    another thread), so the collector fills as they finish; ``on_record``
    sees each. A gate that is off opens no record."""
    stack = getattr(_collect_local, "stack", None)
    if stack is None:
        stack = _collect_local.stack = []
    c = Collector(on_record)
    stack.append(c)
    try:
        yield c
    finally:
        stack.pop()


class _NoopStage:
    """Shared, immutable, free: the disabled profiler's stage context."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NOOP_STAGE = _NoopStage()


def _cat_to_host(tensors):
    import torch

    return torch.cat(tensors).cpu()


class _NoopDispatch:
    """The shared record of a gate that is off: every method is a cheap
    no-op, so call sites never branch on ``enabled`` themselves."""

    __slots__ = ()
    enabled = False

    def stage(self, name):
        return _NOOP_STAGE

    def launch(self):
        return _NOOP_STAGE

    def add_stage(self, name, seconds):
        return self

    def add_bytes(self, h2d=0, d2h=0):
        return self

    def compile_check(self, libs) -> bool:
        return False

    def set(self, **kv):
        return self

    def attach(self, out):
        return out

    def fetch(self, tensors):
        return _cat_to_host(tensors)

    def finish(self):
        pass

    def detach(self):
        pass

    def settle(self):
        pass


NOOP_DISPATCH = _NoopDispatch()


class DeviceOut(tuple):
    """A dispatch's device outputs, carrying the dispatch's record
    (``rec``) to the fetch that finishes it."""

    rec = NOOP_DISPATCH


def record_of(out):
    """The record riding a dispatch's outputs, or the noop record."""
    return getattr(out, "rec", NOOP_DISPATCH)


class _StageTimer:
    __slots__ = ("_rec", "_name", "_t0")

    def __init__(self, rec, name):
        self._rec = rec
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self._rec.add_stage(self._name, time.perf_counter() - self._t0)
        return False


class _Launch:
    """The ``execute`` window of a record: two CUDA events on the stream
    around the launches, or the wall time on the CPU."""

    __slots__ = ("_rec", "_t0", "_ev0")

    def __init__(self, rec):
        self._rec = rec

    def __enter__(self):
        rec = self._rec
        if rec._stream is None:
            self._t0 = time.perf_counter()
        else:
            import torch

            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record(rec._stream)
        return self

    def __exit__(self, exc_type, exc, tb):
        rec = self._rec
        if exc_type is not None:
            rec._dropped = True      # no outputs: the record never finishes
            return False
        if rec._stream is None:
            rec.add_stage("execute", time.perf_counter() - self._t0)
            return False
        import torch

        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record(rec._stream)
        rec._ev = (self._ev0, ev1)
        if rec._fence:
            rec._stream.synchronize()
        return False


_copy_streams: dict = {}
_copy_lock = threading.Lock()


def _copy_stream(device):
    """The side stream a device's fetches copy on (made once)."""
    cs = _copy_streams.get(device)
    if cs is None:
        import torch

        with _copy_lock:
            cs = _copy_streams.get(device)
            if cs is None:
                cs = _copy_streams[device] = torch.cuda.Stream(device)
    return cs


def _load_missing(libs) -> float | None:
    """Load every kernel library of `libs` this process has not loaded yet
    (``kernels.build.load``: its nvcc build, or the cached library's
    dlopen); the seconds it took, or None when all were loaded."""
    from ..search.kernels import build

    missing = [n for n in libs if n not in build._libs]
    if not missing:
        return None
    t0 = time.perf_counter()
    for n in missing:
        build.load(n)
    return time.perf_counter() - t0


class Dispatch:
    """One dispatch's profile record: opened before the dispatch's host
    work, its launches enclosed by ``launch()``, and finished where its
    outputs come to the host (``fetch``) or, detached, once its end event
    has completed."""

    __slots__ = ("mode", "stages", "h2d_bytes", "d2h_bytes", "jit",
                 "attrs", "t0", "_prof", "_fence", "_stream", "_ev",
                 "_sink", "_claim", "_finished", "_detached", "_dropped",
                 "__weakref__")
    enabled = True

    def __init__(self, prof, mode: str, device=None, fence: bool = False):
        self.mode = mode
        self.stages: dict[str, float] = {}
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.jit = None       # None (no kernel library), "hit" or "miss"
        self.attrs: dict = {}
        self.t0 = time.perf_counter()
        self._prof = prof
        self._fence = fence
        self._stream = None
        if device is not None and getattr(device, "type", "cpu") == "cuda":
            import torch

            self._stream = torch.cuda.current_stream(device)
        self._ev = None
        self._claim = threading.Lock()
        self._finished = False
        self._detached = False
        self._dropped = False
        stack = getattr(_collect_local, "stack", None)
        self._sink = stack[-1] if stack else None
        if self._sink is not None:
            self._sink.opened.append(self)

    @property
    def finished(self) -> bool:
        return self._finished

    def stage(self, name: str) -> _StageTimer:
        return _StageTimer(self, name)

    def launch(self) -> _Launch:
        """Enclose the dispatch's launches (one window a record)."""
        return _Launch(self)

    def add_stage(self, name: str, seconds: float) -> "Dispatch":
        self.stages[name] = self.stages.get(name, 0.0) + seconds
        return self

    def add_bytes(self, h2d: int = 0, d2h: int = 0) -> "Dispatch":
        self.h2d_bytes += int(h2d)
        self.d2h_bytes += int(d2h)
        return self

    def compile_check(self, libs) -> bool:
        """The reference's jit-cache check, for kernels that take any
        shape: on a CUDA device, the first dispatch of the process that
        needs a kernel library loads it here and books the load as
        ``compile`` (a miss); later ones book a hit. On the CPU the plain
        versions load nothing: a hit."""
        dt = None if self._stream is None else _load_missing(libs)
        miss = dt is not None
        if miss:
            self.add_stage("compile", dt)
        self.jit = "miss" if miss else "hit"
        _JIT_EVENTS[self.jit].inc()
        with self._prof._lock:
            self._prof._jit[self.jit] += 1
        return miss

    def set(self, **kv) -> "Dispatch":
        self.attrs.update(kv)
        return self

    def attach(self, out) -> DeviceOut:
        """`out` (a tuple of device tensors) carrying this record."""
        out = DeviceOut(out)
        out.rec = self
        return out

    def fetch(self, tensors):
        """The one device-to-host copy of the dispatch's outputs (`tensors`
        concatenated, a host tensor), timed as ``d2h``; then the record
        finishes."""
        if self._stream is None:
            t0 = time.perf_counter()
            host = _cat_to_host(tensors)
            self.add_stage("d2h", time.perf_counter() - t0)
        else:
            import torch

            # the copy runs on a side stream that waits for this record's
            # end event only: on the launches' stream it would queue
            # behind the dispatches issued since (the batcher pipelines),
            # and its events would time their kernels too
            cs = _copy_stream(self._stream.device)
            if self._ev is not None:
                cs.wait_event(self._ev[1])
            else:
                cs.wait_stream(self._stream)
            c0 = torch.cuda.Event(enable_timing=True)
            c1 = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(cs):
                flat = torch.cat(tensors)
                host = torch.empty(flat.shape, dtype=flat.dtype,
                                   pin_memory=True)
                # the events bracket the copy alone, not the host's work
                # to issue the gather and the buffer before it
                c0.record(cs)
                host.copy_(flat, non_blocking=True)
                c1.record(cs)
            c1.synchronize()        # the fetch's one wait, as .cpu()'s
            self.add_stage("d2h", c0.elapsed_time(c1) / 1e3)
        self.add_bytes(d2h=host.numel() * host.element_size())
        self.finish()
        self._prof.sweep()
        return host

    def finish(self) -> None:
        """Read the events (both must have completed: this raises if
        not) and publish the record. Idempotent across threads."""
        if self._finished or self._dropped \
                or not self._claim.acquire(blocking=False):
            return
        if self._ev is not None:
            ev0, ev1 = self._ev
            self.add_stage("execute", ev0.elapsed_time(ev1) / 1e3)
        self._finished = True
        self._prof._finish(self)

    def complete(self) -> bool:
        """Whether the record's launches have finished on the device."""
        return self._ev is None or self._ev[1].query()

    def detach(self) -> None:
        """No fetch will come for this record's outputs: finish it once
        its end event has completed (``DispatchProfiler.sweep``)."""
        if self._finished or self._dropped:
            return
        self._detached = True
        if self._ev is None:
            self.finish()
        else:
            self._prof._detach(self)

    def settle(self) -> None:
        """A detached record finishes now if its launches are done, else
        on the reaper thread; a record still waiting on a fetch is left
        to it."""
        if self._finished or self._dropped or not self._detached:
            return
        if self.complete():
            self.finish()
        else:
            self._prof._reap(self)

    def as_dict(self) -> dict:
        d = {
            "mode": self.mode,
            "stages_ms": {k: round(v * 1e3, 3)
                          for k, v in self.stages.items()},
            "total_ms": round(sum(self.stages.values()) * 1e3, 3),
        }
        if self.h2d_bytes:
            d["h2d_bytes"] = self.h2d_bytes
        if self.d2h_bytes:
            d["d2h_bytes"] = self.d2h_bytes
        if self.jit is not None:
            d["jit_cache"] = self.jit
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class DispatchProfiler:
    """The process-wide ring and aggregates (module singleton
    ``PROFILER``). Dispatch sites open records through their database's
    ``Gate``."""

    def __init__(self, ring_size: int = 256):
        self._ring: deque = deque(maxlen=ring_size)
        self._lock = threading.Lock()
        # values are [n, total_s, total_bytes] per (mode, stage)
        self._agg: dict[tuple, list] = {}
        self._jit = {"hit": 0, "miss": 0}
        self._bytes = {"h2d": 0, "d2h": 0}
        self._dispatches = 0
        self._listeners: list = []
        self._hists: dict = {}    # (stage, mode) -> series handle
        # unix time of the last dispatch or device stage: /status's
        # "is the card still answering" signal
        self.last_dispatch_t: float | None = None
        self._detached: list = []
        self._reaper_q: queue.SimpleQueue | None = None
        # records the reaper could not read (raise_lost surfaces them)
        self.lost = 0
        self._lost_errors: list = []

    # ---- call-site API ----

    def dispatch(self, mode: str, device=None, fence: bool = False):
        self.last_dispatch_t = time.time()
        return Dispatch(self, mode, device, fence)

    def add_listener(self, fn) -> None:
        """Subscribe to finished records (called with the dict form)."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def observe_stage(self, stage: str, mode: str, seconds: float,
                      nbytes: int = 0) -> None:
        """One stage observation outside a record (staging that serves
        many later dispatches, the host dictionary scan). `nbytes` feeds
        the transfer counters only for h2d/d2h."""
        if mode != "host_probe":
            self.last_dispatch_t = time.time()
        self._stage_hist(stage, mode).observe(seconds)
        transfer = stage in ("h2d", "d2h")
        with self._lock:
            a = self._agg.get((mode, stage))
            if a is None:
                a = self._agg[(mode, stage)] = [0, 0.0, 0]
            a[0] += 1
            a[1] += seconds
            a[2] += nbytes
            if nbytes and transfer:
                self._bytes[stage] += nbytes
        if nbytes and transfer:
            (obs.h2d_bytes if stage == "h2d" else obs.d2h_bytes).inc(nbytes)

    # ---- detached records ----

    def _detach(self, rec: Dispatch) -> None:
        with self._lock:
            self._detached.append(rec)

    def sweep(self) -> None:
        """Finish the detached records whose launches have completed
        (called after every fetch, which has just waited on its stream).
        Raises first for the records the reaper lost (``raise_lost``)."""
        if self._lost_errors:
            self.raise_lost()
        if not self._detached:
            return
        with self._lock:
            recs, self._detached = self._detached, []
        keep = []
        for rec in recs:
            if rec.finished:
                continue
            if rec.complete():
                rec.finish()
            else:
                keep.append(rec)
        if keep:
            with self._lock:
                self._detached.extend(keep)

    def _reap(self, rec: Dispatch) -> None:
        """Finish `rec` on the reaper thread once its end event completes
        (a wait that stays off the search path)."""
        with self._lock:
            if self._reaper_q is None:
                self._reaper_q = queue.SimpleQueue()
                threading.Thread(target=self._reaper, args=(self._reaper_q,),
                                 daemon=True, name="profile-reaper").start()
            q = self._reaper_q
        q.put(rec)

    def _reaper(self, q: queue.SimpleQueue) -> None:
        """The reaper thread. A record whose events cannot be read here
        has no caller to raise to: it is booked as a device fault
        (``tempo_search_device_faults_total{kind="error"}``) and counted
        in ``lost``, and the next sweep or query settle raises for it."""
        while True:
            rec = q.get()
            try:
                rec._ev[1].synchronize()
                rec.finish()
            except Exception as e:  # noqa: BLE001 -- raised by raise_lost
                obs.device_faults.inc(kind="error", mode=rec.mode)
                with self._lock:
                    self.lost += 1
                    self._lost_errors.append(e)

    def raise_lost(self) -> None:
        """Raise, once, for the records the reaper lost since the last
        call: their shares are missing, so their dispatches no longer
        conserve."""
        with self._lock:
            errs, self._lost_errors = self._lost_errors, []
        if errs:
            raise RuntimeError(
                f"{len(errs)} dispatch record(s) lost on the profiler's "
                "reaper: their CUDA events could not be read") from errs[0]

    # ---- internals ----

    def _stage_hist(self, stage: str, mode: str):
        """The stage histogram's series handle for (stage, mode),
        made once."""
        h = self._hists.get((stage, mode))
        if h is None:
            h = self._hists[(stage, mode)] = \
                obs.dispatch_stage_seconds.labels(stage=stage, mode=mode)
        return h

    def _finish(self, rec: Dispatch) -> None:
        for stage, sec in rec.stages.items():
            self._stage_hist(stage, rec.mode).observe(sec)
        if rec.h2d_bytes:
            obs.h2d_bytes.inc(rec.h2d_bytes)
        if rec.d2h_bytes:
            obs.d2h_bytes.inc(rec.d2h_bytes)
        rd = rec.as_dict()
        with self._lock:
            self._dispatches += 1
            self.last_dispatch_t = time.time()
            self._bytes["h2d"] += rec.h2d_bytes
            self._bytes["d2h"] += rec.d2h_bytes
            for stage, sec in rec.stages.items():
                a = self._agg.get((rec.mode, stage))
                if a is None:
                    a = self._agg[(rec.mode, stage)] = [0, 0.0, 0]
                a[0] += 1
                a[1] += sec
                if stage == "h2d":
                    a[2] += rec.h2d_bytes
                elif stage == "d2h":
                    a[2] += rec.d2h_bytes
            self._ring.append(rd)
            listeners = list(self._listeners)
        sink = rec._sink
        if sink is not None:
            sink.append(rd)
            if sink.on_record is not None:
                sink.on_record(rec)
        for fn in listeners:
            try:
                fn(rd)
            except Exception:  # noqa: BLE001 -- listeners never fail a scan
                pass

    # ---- operator surface ----

    def snapshot(self, recent: int = 32) -> dict:
        """Recent records and the aggregates (/debug/profile)."""
        with self._lock:
            ring = list(self._ring)[-recent:] if recent > 0 else []
            agg: dict = {}
            for (mode, stage), (n, total, nbytes) in sorted(
                    self._agg.items()):
                entry = {"count": n, "total_ms": round(total * 1e3, 3),
                         "mean_ms": round(total / n * 1e3, 3)}
                if nbytes:
                    entry["bytes"] = nbytes
                agg.setdefault(mode, {})[stage] = entry
            return {"dispatches": self._dispatches,
                    "lost": self.lost,
                    "jit_cache": dict(self._jit),
                    "bytes": dict(self._bytes),
                    "aggregates": agg,
                    "recent": ring}

    def reset(self) -> None:
        """Test hook: clear the ring and the aggregates (the metrics
        counters are process-lifetime and stay)."""
        with self._lock:
            self._ring.clear()
            self._agg.clear()
            self._jit = {"hit": 0, "miss": 0}
            self._bytes = {"h2d": 0, "d2h": 0}
            self._dispatches = 0
            self.lost = 0
            self._lost_errors = []


PROFILER = DispatchProfiler()


class Gate:
    """One database's profiling gate (``search_profiling_enabled``,
    ``search_profiling_fence``): dispatch sites open their records
    through it."""

    __slots__ = ("enabled", "fence")

    def __init__(self, enabled: bool = True, fence: bool = False):
        self.enabled = bool(enabled)
        self.fence = bool(fence)

    def dispatch(self, mode: str, device=None):
        """A recording ``Dispatch`` on `device` (its current stream), or
        the shared noop record when the gate is off."""
        PROFILER.last_dispatch_t = time.time()
        if not self.enabled:
            return NOOP_DISPATCH
        return Dispatch(PROFILER, mode, device, self.fence)

    def observe_stage(self, stage: str, mode: str, seconds: float,
                      nbytes: int = 0) -> None:
        if self.enabled:
            PROFILER.observe_stage(stage, mode, seconds, nbytes=nbytes)


OFF = Gate(enabled=False)
ON = Gate()


def configure(ring_size: int | None = None) -> DispatchProfiler:
    """The process-wide part of the profiler: the recent-record ring's
    size, set by the process owner (no database sets it; the gates are
    per database). A resize keeps the newest records."""
    if ring_size is not None:
        with PROFILER._lock:
            PROFILER._ring = deque(PROFILER._ring, maxlen=int(ring_size))
    return PROFILER


def dispatch(mode: str, device=None):
    """A recording ``Dispatch`` outside any database's gate."""
    return PROFILER.dispatch(mode, device)


def observe_stage(stage: str, mode: str, seconds: float,
                  nbytes: int = 0) -> None:
    PROFILER.observe_stage(stage, mode, seconds, nbytes=nbytes)


def snapshot(recent: int = 32) -> dict:
    return PROFILER.snapshot(recent)


def build_info() -> dict:
    """Build and runtime identity: the package version, torch and its
    CUDA, the card's name, the kernel libraries loaded and the host
    library's state and codecs. Initializes no CUDA context and builds
    nothing: reporting identity must not claim a card or start a
    compiler."""
    import os

    import tempo_tpu_torch

    info: dict = {"version": tempo_tpu_torch.__version__}
    try:
        import torch

        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda or "none"
        info["device"] = (torch.cuda.get_device_name(0)
                          if torch.cuda.is_initialized() else
                          "uninitialized")
    except Exception:  # noqa: BLE001 -- identity, never fatal
        info.setdefault("torch", "unknown")
    try:
        from ..search.kernels import build

        info["kernels"] = sorted(build._libs)
    except Exception:  # noqa: BLE001
        info["kernels"] = []
    try:
        from ..ops import native as _native

        if _native._LIB is not None:
            info["native"] = "loaded"
            info["codecs"] = list(_native.codecs())
        else:
            info["native"] = ("present" if os.path.isdir(_native.BUILD_DIR)
                              and any(_native.BUILD_DIR.glob("*.so"))
                              else "absent")
    except Exception:  # noqa: BLE001
        info["native"] = "unknown"
    return info


def device_status() -> dict:
    """The /status "device" block: the backend and its device count
    (without initializing CUDA) and the age of the last dispatch."""
    out: dict = {"dispatches": PROFILER._dispatches}
    t = PROFILER.last_dispatch_t
    out["last_dispatch_age_s"] = (round(time.time() - t, 3)
                                  if t is not None else None)
    try:
        import torch

        if not torch.cuda.is_initialized():
            out["backend"] = "uninitialized"
            return out
        out["backend"] = "cuda"
        out["device_count"] = torch.cuda.device_count()
        out["device"] = torch.cuda.get_device_name(0)
    except Exception as e:  # noqa: BLE001 -- status must never fail
        out["backend"] = "error"
        out["error"] = f"{type(e).__name__}: {e}"
    return out
