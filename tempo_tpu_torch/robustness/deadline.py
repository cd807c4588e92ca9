"""Request deadlines: a contextvar budget the search path honours.

A copy of the reference's ``robustness/deadline.py``. A caller installs a
deadline with ``start(timeout_s)``; every layer running in that context
reads it through ``current``, ``remaining`` or ``expired`` without the
budget being passed down as an argument. A search that finds it expired
books ``SearchMetrics.partial`` instead of doing the work.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Iterator


class DeadlineExceeded(Exception):
    """The request's deadline expired before this step could run."""


class Deadline:
    __slots__ = ("t_end", "timeout_s")

    def __init__(self, timeout_s: float):
        self.timeout_s = float(timeout_s)
        self.t_end = time.monotonic() + self.timeout_s

    def remaining(self) -> float:
        return self.t_end - time.monotonic()

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self.t_end


_ACTIVE: contextvars.ContextVar[Deadline | None] = contextvars.ContextVar(
    "tempo_request_deadline", default=None)


def current() -> Deadline | None:
    return _ACTIVE.get()


def remaining() -> float | None:
    """Seconds left on the active deadline, or None when none is set."""
    dl = _ACTIVE.get()
    return None if dl is None else dl.remaining()


def expired() -> bool:
    """True only when a deadline is set and it has passed; no deadline
    means unbounded."""
    dl = _ACTIVE.get()
    return dl is not None and dl.expired


@contextlib.contextmanager
def start(timeout_s: float | None) -> Iterator[Deadline | None]:
    """Install a request deadline for the body; None or <= 0 installs
    none."""
    if not timeout_s or timeout_s <= 0:
        yield None
        return
    dl = Deadline(timeout_s)
    token = _ACTIVE.set(dl)
    try:
        yield dl
    finally:
        _ACTIVE.reset(token)
