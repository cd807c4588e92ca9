"""The port's observability core against the reference's.

``tempo_tpu_torch/observability`` holds its own copies of the reference's
metrics registry and logging, and its own dispatch profiler, whose
execute stage is the device time between two CUDA events (on the CPU,
which these tests run, the wall time of the plain call; the CUDA branch
is driven here with stand-in events and a stand-in stream). The checks:
every metric family under the reference's name, type, help and buckets;
the exposition and the limiter equal to the reference's; the profiler's
noop gate, stages, collectors, detached records, the fence, and its
deliberate differences (the compile stage; a record that cannot read its
events raises, at once or, off the reaper, at the next sweep).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from tempo_tpu.observability import log as ref_log
from tempo_tpu.observability import metrics as ref_metrics

from tempo_tpu_torch.observability import log, metrics, profile

CPU = torch.device("cpu")


def _families(mod) -> dict:
    return {m.name: m for m in vars(mod).values()
            if isinstance(m, mod._Metric)}


def test_every_family_of_the_reference_under_its_name_type_and_help():
    ref, port = _families(ref_metrics), _families(metrics)
    assert len(ref) >= 70
    assert set(port) == set(ref)
    for name, m in ref.items():
        p = port[name]
        assert (p.kind, p.help) == (m.kind, m.help), name
        if m.kind == "histogram":
            assert p.buckets == m.buckets, name
    assert set(metrics.REGISTRY._metrics) >= set(ref)


def test_exposition_equals_the_reference_for_the_same_samples():
    """Fresh registries, the same observations: byte-equal text."""
    out = []
    for mod in (ref_metrics, metrics):
        reg = mod.Registry()
        c = mod.Counter("t_total", "help c", registry=reg)
        g = mod.Gauge("t_gauge", "help g", registry=reg)
        h = mod.Histogram("t_hist", "help h", buckets=(0.1, 1, 10),
                          registry=reg)
        c.inc(3, tenant="a")
        c.labels(tenant="b").inc()
        g.set(2.5, mode="mesh")
        for v in (0.05, 0.5, 5, 50):
            h.observe(v, stage="execute")
        h.labels(stage="d2h").observe(0.01)
        out.append(reg.expose())
    assert out[0] == out[1]


def test_a_family_registers_once():
    reg = metrics.Registry()
    metrics.Counter("dup_total", registry=reg)
    with pytest.raises(ValueError):
        metrics.Counter("dup_total", registry=reg)


def test_tenant_token_bucket_allows_as_the_reference(monkeypatch):
    """The same clock, the same calls: the same verdicts."""
    seq = []
    for mod in (ref_log, log):
        t = [1000.0]
        monkeypatch.setattr(mod.time, "monotonic", lambda t=t: t[0])
        b = mod.TenantTokenBucket(rate=2.0, burst=3, global_rate=4.0,
                                  global_burst=5)
        got = []
        for i in range(40):
            got.append(b.allow(f"t{i % 3}"))
            t[0] += 0.05 * (i % 4)
        seq.append(got)
    assert seq[0] == seq[1]
    assert any(seq[1]) and not all(seq[1])


def test_rate_limited_logger_drops_past_its_rate(monkeypatch):
    t = [50.0]
    monkeypatch.setattr(log.time, "monotonic", lambda: t[0])
    lg = log.RateLimitedLogger(log.get_logger("tempo_tpu_torch.test"),
                               rate=2.0)
    for _ in range(5):
        lg.log("noisy", "m")
    assert lg.dropped == 3
    t[0] += 1.0
    lg.log("noisy", "m")
    assert lg.dropped == 3


# ---------------------------------------------------------------------------
# the dispatch profiler


def test_an_off_gate_hands_out_the_shared_noop():
    for gate in (profile.OFF, profile.Gate(enabled=False)):
        rec = gate.dispatch("batched", CPU)
        assert rec is profile.NOOP_DISPATCH and not rec.enabled
        with rec.stage("build"), rec.launch():
            pass
        out = (torch.ones(1),)
        assert rec.attach(out) is out
    assert profile.record_of((torch.ones(1),)) is profile.NOOP_DISPATCH


def test_a_cpu_record_times_its_stages_and_finishes_at_the_fetch():
    prof = profile.DispatchProfiler()
    seen = []
    prof.add_listener(seen.append)
    with profile.collect_records() as recs:
        rec = prof.dispatch("single", CPU)
    with rec.stage("build"):
        time.sleep(0.002)
    assert not rec.compile_check(("scan", "topk"))   # the CPU loads nothing
    with rec.launch():
        out = rec.attach((torch.arange(4, dtype=torch.int32),
                          torch.zeros(2, dtype=torch.int32)))
    assert isinstance(out, tuple) and profile.record_of(out) is rec
    assert not rec.finished and recs.opened == [rec] and not recs
    host = rec.fetch(list(out))
    assert host.tolist() == [0, 1, 2, 3, 0, 0]
    assert rec.finished
    assert set(rec.stages) == {"build", "execute", "d2h"}
    assert rec.stages["build"] >= 0.002
    assert rec.d2h_bytes == 24 and rec.jit == "hit"
    assert len(recs) == 1 and seen == list(recs)
    snap = prof.snapshot()
    assert snap["dispatches"] == 1 and snap["jit_cache"] == {"hit": 1,
                                                             "miss": 0}
    assert set(snap["aggregates"]["single"]) == {"build", "execute", "d2h"}
    rec.finish()                                 # idempotent
    assert prof.snapshot()["dispatches"] == 1


def test_a_record_goes_to_the_innermost_collector_only():
    prof = profile.DispatchProfiler()
    got = []
    with profile.collect_records(got.append) as outer:
        with profile.collect_records() as inner:
            r1 = prof.dispatch("batched", CPU)
        r2 = prof.dispatch("batched", CPU)
    for r in (r1, r2):
        with r.launch():
            pass
        r.finish()
    assert inner.opened == [r1] and outer.opened == [r2]
    assert got == [r2] and len(inner) == 1 and len(outer) == 1


def test_collectors_do_not_cross_threads():
    prof = profile.DispatchProfiler()
    opened = []
    with profile.collect_records() as mine:
        t = threading.Thread(
            target=lambda: opened.append(prof.dispatch("coalesced", CPU)))
        t.start()
        t.join()
    assert not mine.opened and opened[0]._sink is None


def test_a_detached_cpu_record_finishes_at_once():
    prof = profile.DispatchProfiler()
    rec = prof.dispatch("dict_probe", CPU)
    with rec.launch():
        pass
    rec.detach()
    assert rec.finished and prof.snapshot()["dispatches"] == 1


class _Event:
    """A stand-in for a CUDA event: complete or not, readable or not."""

    def __init__(self, done=True, ms=0.5, readable=True):
        self.done, self.ms, self.readable = done, ms, readable

    def query(self):
        return self.done

    def elapsed_time(self, other):
        if not (self.readable and other.done):
            raise RuntimeError("event not recorded or not complete")
        return other.ms

    def synchronize(self):
        self.done = True


def _event_record(prof, done=True, readable=True):
    rec = profile.Dispatch(prof, "batched", CPU)
    rec._ev = (_Event(readable=readable), _Event(done=done, ms=1.5))
    return rec


def test_execute_is_read_from_the_events_and_unreadable_events_raise():
    prof = profile.DispatchProfiler()
    rec = _event_record(prof)
    rec.finish()
    assert rec.stages == {"execute": 0.0015}
    bad = _event_record(prof, readable=False)
    with pytest.raises(RuntimeError):
        bad.finish()
    assert "execute" not in bad.stages       # no host-clock fallback


def test_detached_records_finish_at_a_sweep_or_on_the_reaper():
    prof = profile.DispatchProfiler()
    pending = _event_record(prof, done=False)
    pending.detach()
    prof.sweep()
    assert not pending.finished               # its end event is pending
    pending._ev[1].done = True
    prof.sweep()
    assert pending.finished
    late = _event_record(prof, done=False)
    late.detach()
    late.settle()                             # not done: to the reaper
    for _ in range(200):
        if late.finished:
            break
        time.sleep(0.01)
    assert late.finished and late.stages["execute"] == 0.0015


def test_the_compile_stage_loads_each_kernel_library_once(monkeypatch):
    """Deliberate difference: the reference books a jit compile at each
    new shape; the port's kernels take any shape, so the compile stage is
    the first load of a kernel library in the process (its build or its
    dlopen), and every later dispatch books a hit."""
    from tempo_tpu_torch.search.kernels import build

    loaded = {}
    calls = []

    def fake_load(name):
        calls.append(name)
        loaded[name] = object()
        time.sleep(0.001)
        return loaded[name]

    monkeypatch.setattr(build, "_libs", loaded)
    monkeypatch.setattr(build, "load", fake_load)
    first = profile._load_missing(("scan", "topk"))
    assert first is not None and first >= 0.002
    assert calls == ["scan", "topk"]
    assert profile._load_missing(("scan", "topk")) is None
    assert profile._load_missing(("scan", "probe")) is not None
    assert calls == ["scan", "topk", "probe"]


def test_the_reference_books_compile_at_a_new_shape_and_the_cpu_port_never():
    from tempo_tpu.observability import profile as ref_profile

    ref = ref_profile.DispatchProfiler()
    r = ref.dispatch("single")
    assert r.compile_check(("k", (8,))) and not r.compile_check(("k", (8,)))
    assert ref.dispatch("single").compile_check(("k", (16,)))
    port = profile.DispatchProfiler()
    for _ in range(3):
        assert not port.dispatch("single", CPU).compile_check(("scan",))
    assert port.snapshot()["jit_cache"] == {"hit": 3, "miss": 0}


def test_the_fence_needs_a_card_and_the_gate_keeps_it():
    g = profile.Gate(enabled=True, fence=True)
    assert g.fence and g.enabled
    rec = g.dispatch("single", CPU)
    assert rec._fence and rec._stream is None


class _Stream:
    """A stand-in for the launches' CUDA stream: counts its syncs."""

    device = torch.device("cuda")

    def __init__(self):
        self.syncs = 0

    def synchronize(self):
        self.syncs += 1


class _RecordedEvent(_Event):
    """A stand-in for ``torch.cuda.Event``: remembers its stream."""

    def __init__(self, enable_timing=False):
        assert enable_timing
        super().__init__(ms=0.25)
        self.stream = None

    def record(self, stream):
        self.stream = stream


@pytest.mark.parametrize("fence", [False, True])
def test_the_fence_synchronises_the_stream_after_the_launches(monkeypatch,
                                                              fence):
    """On a CUDA device a record puts one event before its launches and
    one after, on the launches' stream; the fence then synchronises that
    stream, and only the fence does."""
    stream = _Stream()
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "Event", _RecordedEvent)
    gate = profile.Gate(enabled=True, fence=fence)
    rec = profile.Dispatch(profile.DispatchProfiler(), "single",
                           torch.device("cuda"), gate.fence)
    assert rec._stream is stream
    with rec.launch():
        assert stream.syncs == 0
    ev0, ev1 = rec._ev
    assert ev0.stream is stream and ev1.stream is stream
    assert stream.syncs == (1 if fence else 0)
    rec.finish()
    assert rec.stages == {"execute": 0.00025}


def test_a_record_the_reaper_cannot_read_is_a_fault_raised_at_a_sweep():
    """The reaper has no caller to raise to: a record whose events it
    cannot read is booked as a device fault, counted as lost, and the
    next sweep raises for it, once."""
    prof = profile.DispatchProfiler()
    before = metrics.device_faults.value(kind="error", mode="batched")
    rec = _event_record(prof, done=False, readable=False)
    rec.detach()
    rec.settle()                              # pending: to the reaper
    for _ in range(300):
        if prof.lost:
            break
        time.sleep(0.01)
    assert prof.lost == 1 and not rec.finished
    assert prof.snapshot()["lost"] == 1
    assert metrics.device_faults.value(kind="error",
                                       mode="batched") == before + 1
    with pytest.raises(RuntimeError, match="lost"):
        prof.sweep()
    prof.sweep()                              # raised once
    assert prof.snapshot()["dispatches"] == 0


def test_stage_observations_feed_the_aggregates_and_byte_counters():
    prof = profile.DispatchProfiler()
    before = metrics.h2d_bytes.value()
    prof.observe_stage("h2d", "batched", 0.01, nbytes=4096)
    prof.observe_stage("build", "host_probe", 0.02, nbytes=100)
    snap = prof.snapshot()
    assert snap["bytes"]["h2d"] == 4096
    assert snap["aggregates"]["batched"]["h2d"]["bytes"] == 4096
    assert snap["aggregates"]["host_probe"]["build"]["bytes"] == 100
    assert metrics.h2d_bytes.value() == before + 4096
    profile.Gate(enabled=False).observe_stage("h2d", "batched", 0.01,
                                              nbytes=1)
    assert profile.PROFILER.snapshot()["bytes"]["h2d"] == \
        profile.PROFILER._bytes["h2d"]


def test_configure_sizes_the_process_ring():
    old = profile.PROFILER._ring.maxlen
    try:
        profile.configure(ring_size=3)
        assert profile.PROFILER._ring.maxlen == 3
    finally:
        profile.configure(ring_size=old)


def test_build_info_and_device_status_claim_no_card():
    info = profile.build_info()
    assert info["torch"] == torch.__version__
    assert set(info) >= {"version", "torch", "cuda", "device", "kernels",
                         "native"}
    st = profile.device_status()
    assert st["backend"] in ("uninitialized", "cuda")
    assert "last_dispatch_age_s" in st
    assert not torch.cuda.is_initialized()


def test_device_out_unpacks_as_its_tuple():
    rec = profile.Dispatch(profile.DispatchProfiler(), "single", CPU)
    t = (np.int32(1), np.int32(2))
    out = rec.attach(t)
    a, b = out
    assert (a, b) == t and out == t and out.rec is rec
