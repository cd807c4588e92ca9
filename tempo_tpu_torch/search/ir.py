"""Structural query IR: a small typed tree compiled onto the scan kernels.

The port's own copy of the reference's ``search/ir.py`` (pure Python,
the same node types, JSON form, limits and error paths), so that the
port imports nothing of the reference. A typed IR with

  - **span-scope leaves**: tag term (substring, the engine-wide
    semantics), duration range, span kind;
  - **combinators**: AND / OR / NOT at both span and trace scope;
  - **structural relations**: ``child`` (parent-child) and ``desc``
    (ancestor-descendant) joining two span-level sub-predicates;
  - **scopes**: span-level expressions select spans, trace-level
    expressions select traces;
  - **aggregates**: ``count(matching spans) CMP n`` and duration
    quantiles over matched spans, lowered to exact integer-count
    predicates (nearest-rank; see ``Quantile``).

Parsed from a compact JSON form. Parse failures raise
:class:`IRSyntaxError` carrying the JSON path of the offending node
(``$.and[1].count.op``).

The back half, lowering onto the device kernels, is
``search/structural.py`` (host half) and kernel K6
(``kernels/structural.py``).
"""

from __future__ import annotations

import json
import urllib.parse
from dataclasses import dataclass
from typing import Union

__all__ = [
    "IRSyntaxError",
    "SpanExpr", "SpanTag", "SpanDur", "SpanKind",
    "SpanAnd", "SpanOr", "SpanNot", "ChildOf", "DescOf",
    "TraceExpr", "TraceTag", "TraceDur",
    "Exists", "Count", "Quantile",
    "TraceAnd", "TraceOr", "TraceNot",
    "parse", "parse_quoted", "to_json", "quote", "node_count",
    "CMP_OPS", "SPAN_KINDS", "MAX_NODES", "MAX_Q_DEN",
]

# comparison operators shared by count/quantile aggregates; the device
# lowering and the host evaluator consume the same table
CMP_OPS = (">", ">=", "<", "<=", "==", "!=")

# OTLP span kinds (trace.proto SpanKind) by wire value; the JSON form
# accepts either the symbolic name or the integer
SPAN_KINDS = {
    "unspecified": 0,
    "internal": 1,
    "server": 2,
    "client": 3,
    "producer": 4,
    "consumer": 5,
}

# defensive caps — a parse-time bound so a hostile query can neither
# explode the compiled plan nor the integer math the quantile lowering
# depends on (q_den * span_count must stay within int32 on device)
MAX_NODES = 64
MAX_Q_DEN = 1000
UINT32_MAX = 0xFFFFFFFF


class IRSyntaxError(ValueError):
    """Malformed structural query: client data, mapped to HTTP 400.

    ``path`` is the JSON path of the offending node (``$.count.op``) so
    the client can locate the mistake without reading server code."""

    def __init__(self, path: str, message: str) -> None:
        self.path = path
        super().__init__(f"{message} (at {path})")


# ---------------------------------------------------------------------------
# node types — frozen, hashable, order-stable


@dataclass(frozen=True)
class SpanTag:
    """Span-scope tag term: some kv of THIS span has key ``key`` and a
    value containing ``value`` (the engine-wide substring semantics;
    empty ``value`` matches any value under the key)."""

    key: str
    value: str


@dataclass(frozen=True)
class SpanDur:
    """Span duration within [lo_ms, hi_ms] inclusive."""

    lo_ms: int
    hi_ms: int


@dataclass(frozen=True)
class SpanKind:
    """Span kind equals ``kind`` (OTLP wire value)."""

    kind: int


@dataclass(frozen=True)
class SpanAnd:
    args: tuple["SpanExpr", ...]


@dataclass(frozen=True)
class SpanOr:
    args: tuple["SpanExpr", ...]


@dataclass(frozen=True)
class SpanNot:
    arg: "SpanExpr"


@dataclass(frozen=True)
class ChildOf:
    """Spans matching ``child`` whose DIRECT parent matches ``parent``."""

    parent: "SpanExpr"
    child: "SpanExpr"


@dataclass(frozen=True)
class DescOf:
    """Spans matching ``span`` with SOME proper ancestor matching
    ``anc``."""

    anc: "SpanExpr"
    span: "SpanExpr"


SpanExpr = Union[SpanTag, SpanDur, SpanKind, SpanAnd, SpanOr, SpanNot,
                 ChildOf, DescOf]


@dataclass(frozen=True)
class TraceTag:
    """Trace-scope tag term over the per-trace rolled-up kv set (the
    legacy request's ``tags`` semantics as an IR leaf)."""

    key: str
    value: str


@dataclass(frozen=True)
class TraceDur:
    """Whole-trace duration within [lo_ms, hi_ms] inclusive."""

    lo_ms: int
    hi_ms: int


@dataclass(frozen=True)
class Exists:
    """Trace has at least one span matching ``of``."""

    of: SpanExpr


@dataclass(frozen=True)
class Count:
    """count(spans matching ``of``) CMP ``n``."""

    of: SpanExpr
    op: str
    n: int


@dataclass(frozen=True)
class Quantile:
    """Nearest-rank duration quantile over matched spans, compared to a
    millisecond threshold: with ``m`` matched spans the rank is
    ``r = max(1, ceil(q * m))`` and the quantile value is the r-th
    smallest duration. ``q`` is the exact rational ``q_num/q_den`` so
    host and device use identical integer math (no float divergence);
    zero matched spans make the predicate False."""

    of: SpanExpr
    q_num: int
    q_den: int
    op: str
    x_ms: int


@dataclass(frozen=True)
class TraceAnd:
    args: tuple["TraceExpr", ...]


@dataclass(frozen=True)
class TraceOr:
    args: tuple["TraceExpr", ...]


@dataclass(frozen=True)
class TraceNot:
    arg: "TraceExpr"


TraceExpr = Union[TraceTag, TraceDur, Exists, Count, Quantile,
                  TraceAnd, TraceOr, TraceNot]


def node_count(node: object) -> int:
    """Total nodes in the tree (the MAX_NODES budget unit)."""
    if isinstance(node, (SpanAnd, SpanOr, TraceAnd, TraceOr)):
        return 1 + sum(node_count(a) for a in node.args)
    if isinstance(node, (SpanNot, TraceNot)):
        return 1 + node_count(node.arg)
    if isinstance(node, ChildOf):
        return 1 + node_count(node.parent) + node_count(node.child)
    if isinstance(node, DescOf):
        return 1 + node_count(node.anc) + node_count(node.span)
    if isinstance(node, (Exists, Count, Quantile)):
        return 1 + node_count(node.of)
    return 1


# ---------------------------------------------------------------------------
# JSON form


def _err(path: str, msg: str) -> IRSyntaxError:
    return IRSyntaxError(path, msg)


def _one_key(doc: object, path: str) -> tuple[str, object]:
    if not isinstance(doc, dict):
        raise _err(path, f"expected an object, got {type(doc).__name__}")
    if len(doc) != 1:
        raise _err(path, "expected exactly one operator key, got "
                         f"{sorted(str(k) for k in doc)!r}")
    k, v = next(iter(doc.items()))
    if not isinstance(k, str):
        raise _err(path, "operator key must be a string")
    return k, v


def _parse_int(v: object, path: str, lo: int = 0,
               hi: int = UINT32_MAX) -> int:
    if isinstance(v, bool) or not isinstance(v, int):
        raise _err(path, f"expected an integer, got {type(v).__name__}")
    if not lo <= v <= hi:
        raise _err(path, f"value {v} out of range [{lo}, {hi}]")
    return v


def _parse_str(v: object, path: str) -> str:
    if not isinstance(v, str):
        raise _err(path, f"expected a string, got {type(v).__name__}")
    return v


def _parse_tag(v: object, path: str) -> tuple[str, str]:
    if not isinstance(v, dict):
        raise _err(path, "tag expects {\"k\": key, \"v\": substring}")
    extra = set(v) - {"k", "v"}
    if extra:
        raise _err(path, f"unknown tag field(s) {sorted(extra)!r}")
    if "k" not in v:
        raise _err(path + ".k", "tag key \"k\" is required")
    key = _parse_str(v["k"], path + ".k")
    if not key:
        raise _err(path + ".k", "tag key must be non-empty")
    val = _parse_str(v.get("v", ""), path + ".v")
    return key, val


def _parse_dur(v: object, path: str) -> tuple[int, int]:
    if not isinstance(v, dict):
        raise _err(path, "dur expects {\"min_ms\": int, \"max_ms\": int}")
    extra = set(v) - {"min_ms", "max_ms"}
    if extra:
        raise _err(path, f"unknown dur field(s) {sorted(extra)!r}")
    lo = _parse_int(v.get("min_ms", 0), path + ".min_ms")
    hi = _parse_int(v.get("max_ms", UINT32_MAX), path + ".max_ms")
    if lo > hi:
        raise _err(path, f"empty duration range [{lo}, {hi}]")
    return lo, hi


def _parse_op(v: object, path: str) -> str:
    op = _parse_str(v, path)
    if op not in CMP_OPS:
        raise _err(path, f"unknown comparison {op!r}; one of {CMP_OPS}")
    return op


def _parse_q(v: object, path: str) -> tuple[int, int]:
    """Quantile as an exact rational: accepts a decimal string
    ("0.9", "0.99") or a number. Strings are preferred — they carry the
    author's exact precision; floats round-trip through their shortest
    repr. Denominator capped at MAX_Q_DEN so the device-side integer
    rank math stays within int32."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        v = repr(float(v))
    s = _parse_str(v, path).strip()
    try:
        if "." in s:
            whole, frac = s.split(".", 1)
            if not (whole + frac).isdigit() or len(frac) == 0:
                raise ValueError
            den = 10 ** len(frac)
            num = int(whole) * den + int(frac)
        else:
            if not s.isdigit():
                raise ValueError
            num, den = int(s), 1
    except ValueError:
        raise _err(path, f"quantile {s!r} is not a decimal in (0, 1]") \
            from None
    if den > MAX_Q_DEN:
        raise _err(path, f"quantile precision beyond 1/{MAX_Q_DEN} "
                         "is not supported")
    if not 0 < num <= den:
        raise _err(path, f"quantile {s!r} must be in (0, 1]")
    return num, den


def _parse_kind(v: object, path: str) -> int:
    if isinstance(v, str):
        k = SPAN_KINDS.get(v.lower())
        if k is None:
            raise _err(path, f"unknown span kind {v!r}; one of "
                             f"{sorted(SPAN_KINDS)} or 0-5")
        return k
    return _parse_int(v, path, lo=0, hi=5)


def _parse_span(doc: object, path: str) -> SpanExpr:
    op, v = _one_key(doc, path)
    if op == "tag":
        return SpanTag(*_parse_tag(v, path + ".tag"))
    if op == "dur":
        return SpanDur(*_parse_dur(v, path + ".dur"))
    if op == "kind":
        return SpanKind(_parse_kind(v, path + ".kind"))
    if op in ("and", "or"):
        if not isinstance(v, list) or not v:
            raise _err(path + f".{op}", f"{op} expects a non-empty array")
        args = tuple(_parse_span(a, f"{path}.{op}[{i}]")
                     for i, a in enumerate(v))
        return SpanAnd(args) if op == "and" else SpanOr(args)
    if op == "not":
        return SpanNot(_parse_span(v, path + ".not"))
    if op == "child":
        if not isinstance(v, dict) or set(v) != {"parent", "child"}:
            raise _err(path + ".child",
                       "child expects {\"parent\": span, \"child\": span}")
        return ChildOf(_parse_span(v["parent"], path + ".child.parent"),
                       _parse_span(v["child"], path + ".child.child"))
    if op == "desc":
        if not isinstance(v, dict) or set(v) != {"anc", "span"}:
            raise _err(path + ".desc",
                       "desc expects {\"anc\": span, \"span\": span}")
        return DescOf(_parse_span(v["anc"], path + ".desc.anc"),
                      _parse_span(v["span"], path + ".desc.span"))
    raise _err(path, f"unknown span operator {op!r}")


def _parse_trace(doc: object, path: str) -> TraceExpr:
    op, v = _one_key(doc, path)
    if op == "tag":
        return TraceTag(*_parse_tag(v, path + ".tag"))
    if op == "dur":
        return TraceDur(*_parse_dur(v, path + ".dur"))
    if op == "exists":
        return Exists(_parse_span(v, path + ".exists"))
    if op == "count":
        if not isinstance(v, dict):
            raise _err(path + ".count", "count expects "
                       "{\"of\": span, \"op\": cmp, \"n\": int}")
        extra = set(v) - {"of", "op", "n"}
        if extra:
            raise _err(path + ".count",
                       f"unknown count field(s) {sorted(extra)!r}")
        if "of" not in v:
            raise _err(path + ".count.of", "count \"of\" is required")
        return Count(
            of=_parse_span(v["of"], path + ".count.of"),
            op=_parse_op(v.get("op", ">"), path + ".count.op"),
            n=_parse_int(v.get("n", 0), path + ".count.n",
                         hi=2**31 - 1),
        )
    if op == "quantile":
        if not isinstance(v, dict):
            raise _err(path + ".quantile", "quantile expects {\"of\": "
                       "span, \"q\": \"0.9\", \"op\": cmp, \"ms\": int}")
        extra = set(v) - {"of", "q", "op", "ms"}
        if extra:
            raise _err(path + ".quantile",
                       f"unknown quantile field(s) {sorted(extra)!r}")
        for req_field in ("of", "q", "ms"):
            if req_field not in v:
                raise _err(f"{path}.quantile.{req_field}",
                           f"quantile \"{req_field}\" is required")
        q_num, q_den = _parse_q(v["q"], path + ".quantile.q")
        return Quantile(
            of=_parse_span(v["of"], path + ".quantile.of"),
            q_num=q_num, q_den=q_den,
            op=_parse_op(v.get("op", ">="), path + ".quantile.op"),
            x_ms=_parse_int(v["ms"], path + ".quantile.ms"),
        )
    if op in ("and", "or"):
        if not isinstance(v, list) or not v:
            raise _err(path + f".{op}", f"{op} expects a non-empty array")
        args = tuple(_parse_trace(a, f"{path}.{op}[{i}]")
                     for i, a in enumerate(v))
        return TraceAnd(args) if op == "and" else TraceOr(args)
    if op == "not":
        return TraceNot(_parse_trace(v, path + ".not"))
    # a bare span operator at trace scope is sugar for exists
    if op in ("child", "desc"):
        return Exists(_parse_span(doc, path))
    raise _err(path, f"unknown trace operator {op!r}")


def parse(text: str) -> TraceExpr:
    """Parse the compact JSON form into a trace-level IR tree. Raises
    :class:`IRSyntaxError` (a ValueError subtype the API layer maps to
    400) with a JSON-path diagnostic on any malformed input."""
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        raise IRSyntaxError("$", f"invalid JSON: {e.msg} "
                                 f"(line {e.lineno} col {e.colno})") \
            from None
    expr = _parse_trace(doc, "$")
    n = node_count(expr)
    if n > MAX_NODES:
        raise _err("$", f"query has {n} nodes; the limit is {MAX_NODES}")
    return expr


# ---------------------------------------------------------------------------
# serialization — the request-tag transport (search/structural.py stows
# the percent-quoted compact JSON in a reserved tag so the IR survives
# the frontend <-> querier proto round-trip without a schema change)


def to_json(node: object) -> str:
    """Compact canonical JSON of an IR tree (inverse of :func:`parse`)."""
    return json.dumps(_unparse(node), separators=(",", ":"),
                      sort_keys=True)


def _unparse(node: object) -> dict[str, object]:
    if isinstance(node, (SpanTag, TraceTag)):
        return {"tag": {"k": node.key, "v": node.value}}
    if isinstance(node, (SpanDur, TraceDur)):
        return {"dur": {"min_ms": node.lo_ms, "max_ms": node.hi_ms}}
    if isinstance(node, SpanKind):
        return {"kind": node.kind}
    if isinstance(node, (SpanAnd, TraceAnd)):
        return {"and": [_unparse(a) for a in node.args]}
    if isinstance(node, (SpanOr, TraceOr)):
        return {"or": [_unparse(a) for a in node.args]}
    if isinstance(node, (SpanNot, TraceNot)):
        return {"not": _unparse(node.arg)}
    if isinstance(node, ChildOf):
        return {"child": {"parent": _unparse(node.parent),
                          "child": _unparse(node.child)}}
    if isinstance(node, DescOf):
        return {"desc": {"anc": _unparse(node.anc),
                         "span": _unparse(node.span)}}
    if isinstance(node, Exists):
        return {"exists": _unparse(node.of)}
    if isinstance(node, Count):
        return {"count": {"of": _unparse(node.of), "op": node.op,
                          "n": node.n}}
    if isinstance(node, Quantile):
        return {"quantile": {"of": _unparse(node.of),
                             "q": _q_decimal(node.q_num, node.q_den),
                             "op": node.op, "ms": node.x_ms}}
    raise TypeError(f"not an IR node: {type(node).__name__}")


def _q_decimal(num: int, den: int) -> str:
    """Exact decimal form of a quantile rational, guaranteed to
    re-parse: ``q=1`` must emit "1", never "1." (float-format rstrip
    produced exactly that unparseable form). Integer math throughout;
    a denominator with no short decimal expansion (only reachable from
    hand-built trees — the parser produces powers of ten) rounds to the
    parser's maximum precision."""
    if num == den:
        return "1"
    if den == 1:
        return str(num)
    for k in range(1, 10):
        scaled = num * 10 ** k
        if scaled % den == 0:
            return f"0.{scaled // den:0{k}d}"
    return f"{num / den:.3f}"


def quote(text: str) -> str:
    """Percent-encode the JSON for the reserved request tag: the tag
    wire form (api/params logfmt encoding) splits on spaces and '=' —
    quoting with no safe characters removes both."""
    return urllib.parse.quote(text, safe="")


def parse_quoted(quoted: str) -> TraceExpr:
    """Parse the percent-encoded transport form out of a request tag."""
    return parse(urllib.parse.unquote(quoted))
