"""Seeded OTLP pushes for the port's write-path tests.

``make_pushes(seed, n_traces, n_pushes)`` spreads ``n_traces`` traces
over ``n_pushes`` pushes (lists of ``ResourceSpans``), in the shapes a
collector sends: many traces share a resource batch, one trace's spans sit
under several services and scopes, and some of its spans arrive in the
next push. Among them, by trace number:

- 8-byte trace ids (i % 7 == 3);
- no parentless span (i % 6 == 5);
- one span ending before it starts (i % 8 == 1), and every span ending
  before the trace's first start (i % 16 == 9, a negative trace range);
- no span with an end (i % 29 == 13);
- tags past the 5 KiB budget (i % 9 == 4);
- a resource repeated as a second batch of one push (i % 11 == 0);
- split over two pushes (i % 5 == 2).

Attributes are strings, ints, bools and doubles; about one span in six
has an error status. The message classes are the port's ``tempopb``,
which are the reference's too.
"""

from __future__ import annotations

import numpy as np

from tempo_tpu_torch import tempopb

BASE_S = 1_700_000_000
SERVICES = ("svc-a", "svc-b", "svc-c", "frontend")
SCOPES = ("lib-a", "lib-b")
METHODS = ("GET", "POST", "PUT")
STATUS = (200, 201, 404, 500, 503)
RATIOS = (0.125, 0.1, 2.5, -1.0)


def _attr(span_or_res, key: str, value) -> None:
    kv = span_or_res.attributes.add()
    kv.key = key
    if isinstance(value, bool):
        kv.value.bool_value = value
    elif isinstance(value, int):
        kv.value.int_value = value
    elif isinstance(value, float):
        kv.value.double_value = value
    else:
        kv.value.string_value = value


def make_pushes(seed: int, n_traces: int, n_pushes: int = 3):
    """Returns (pushes, ids): each push a list of ResourceSpans, and the
    raw trace ids in trace order."""
    rng = np.random.default_rng(seed)
    # per push: (service, dup) -> ResourceSpans, and (that, scope) ->
    # ScopeSpans, kept in first-use order
    groups = [dict() for _ in range(n_pushes)]
    scopes = [dict() for _ in range(n_pushes)]
    pushes: list[list] = [[] for _ in range(n_pushes)]
    ids = []

    def scope_spans(p: int, svc: str, dup: bool, scope: str):
        key = (svc, dup)
        rs = groups[p].get(key)
        if rs is None:
            rs = tempopb.ResourceSpans()
            _attr(rs.resource, "service.name", svc)
            _attr(rs.resource, "host.name", f"host-{SERVICES.index(svc)}")
            _attr(rs.resource, "pid", 100 + SERVICES.index(svc))
            rs.schema_url = "https://opentelemetry.io/schemas/1.9.0"
            groups[p][key] = rs
            pushes[p].append(rs)
        ss = scopes[p].get((key, scope))
        if ss is None:
            ss = rs.scope_spans.add()
            ss.scope.name = scope
            ss.scope.version = "1.0"
            scopes[p][(key, scope)] = ss
        return ss

    for i in range(n_traces):
        tid = rng.bytes(8 if i % 7 == 3 else 16)
        ids.append(tid)
        n = int(rng.integers(2, 8))
        sids = [rng.bytes(8) for _ in range(n)]
        base = (BASE_S + int(rng.integers(0, 3600))) * 1_000_000_000
        p0 = int(rng.integers(0, n_pushes))
        p1 = p0 + 1 if p0 + 1 < n_pushes else p0 - 1
        svcs = rng.choice(len(SERVICES), size=min(n, 3), replace=False)
        for k in range(n):
            svc = SERVICES[int(svcs[k % len(svcs)])]
            p = p1 if (i % 5 == 2 and k >= n // 2 and n_pushes > 1) else p0
            dup = i % 11 == 0 and k == n - 1
            ss = scope_spans(p, svc, dup, SCOPES[k % 2])
            span = ss.spans.add()
            span.trace_id = tid
            span.span_id = sids[k]
            if k:
                span.parent_span_id = sids[int(rng.integers(0, k))]
            elif i % 6 == 5:
                span.parent_span_id = rng.bytes(8)   # a parent not sent
            span.name = f"op-{int(rng.integers(0, 12))}"
            span.kind = int(rng.integers(0, 6))
            st = base + int(rng.integers(0, 5_000)) * 1_000_000
            en = st + int(rng.integers(0, 30_000)) * 1_000_000
            if i % 8 == 1 and k == n - 1:
                en = st - int(rng.integers(1, 5_000)) * 1_000_000
            if i % 16 == 9:
                en = base - 1_000_000_000
            if i % 29 == 13:
                en = 0
            span.start_time_unix_nano = st
            span.end_time_unix_nano = en
            _attr(span, "http.method", METHODS[int(rng.integers(0, 3))])
            _attr(span, "http.status_code", STATUS[int(rng.integers(0, 5))])
            _attr(span, "cache.hit", bool(rng.integers(0, 2)))
            _attr(span, "ratio", RATIOS[int(rng.integers(0, 4))])
            if i % 9 == 4:
                for a in range(12):
                    _attr(span, f"attr.{a}", f"{k}-{a}-" + "x" * 200)
            r = rng.random()
            if r < 0.17:
                span.status.code = tempopb.Status.STATUS_CODE_ERROR
                span.status.message = "boom"
            elif r < 0.3:
                span.status.code = tempopb.Status.STATUS_CODE_OK
    return pushes, ids
