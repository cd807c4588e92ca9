"""Bounded worker pool for per-block fan-out (the reference's
``db/pool.py``, as its callers use it)."""

from __future__ import annotations

import concurrent.futures
import contextvars
import threading


def run_jobs(jobs, fn, workers: int = 50):
    """Run fn(job) for each job on at most `workers` threads. Returns
    (results, errors): results without the Nones, in the order the jobs
    finished, and the exceptions jobs raised. Jobs run under a copy of the
    caller's contextvars context."""
    results = []
    errors = []
    if not jobs:
        return results, errors
    lock = threading.Lock()
    caller_ctx = contextvars.copy_context()

    def _run_in_ctx(job):
        caller_ctx.copy().run(_run, job)

    def _run(job):
        try:
            r = fn(job)
        except Exception as e:  # noqa: BLE001
            # a failed block is a partial result: counted, not raised
            with lock:
                errors.append(e)
            return
        if r is not None:
            with lock:
                results.append(r)

    workers = max(1, min(workers, len(jobs)))
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(_run_in_ctx, jobs))
    return results, errors
