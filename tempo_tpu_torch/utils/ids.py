"""Trace id helpers (a copy of the reference's ``utils/ids.py``, without
its random id makers)."""

from __future__ import annotations

TRACE_ID_LEN = 16  # 128-bit


def pad_trace_id(tid: bytes) -> bytes:
    """Left-pad a short (64-bit) trace id to 128 bits."""
    if len(tid) >= TRACE_ID_LEN:
        return tid[-TRACE_ID_LEN:]
    return b"\x00" * (TRACE_ID_LEN - len(tid)) + tid


def validate_trace_id(tid: bytes) -> None:
    if not tid or len(tid) > TRACE_ID_LEN:
        raise ValueError(f"invalid trace id length {len(tid) if tid else 0}")


def trace_id_to_hex(tid: bytes) -> str:
    return pad_trace_id(tid).hex()


def hex_to_trace_id(s: str) -> bytes:
    s = s.strip().lower()
    if len(s) % 2:
        s = "0" + s
    tid = bytes.fromhex(s)
    validate_trace_id(tid)
    return pad_trace_id(tid)
