"""Trace id helpers (copy of the reference's ``utils/ids.py`` subset)."""

from __future__ import annotations

TRACE_ID_LEN = 16  # 128-bit


def pad_trace_id(tid: bytes) -> bytes:
    """Left-pad a short (64-bit) trace id to 128 bits."""
    if len(tid) >= TRACE_ID_LEN:
        return tid[-TRACE_ID_LEN:]
    return b"\x00" * (TRACE_ID_LEN - len(tid)) + tid
