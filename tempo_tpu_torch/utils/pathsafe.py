"""One rule for what may become a filesystem path component (copy of the
reference's ``utils/pathsafe.py``)."""

from __future__ import annotations

MAX_COMPONENT = 150
_FORBIDDEN = set("/\\\x00")


def check_path_component(part: str, what: str = "path component") -> str:
    """`part` unchanged, or ValueError: separators, NULs, relative
    components (. / ..), emptiness, unprintables and absurd lengths are
    rejected before any os.path.join sees the value."""
    if (not part or len(part) > MAX_COMPONENT
            or part in (".", "..")
            or any(c in _FORBIDDEN for c in part)
            or not part.isprintable()):
        raise ValueError(f"invalid {what} {part[:40]!r}")
    return part
