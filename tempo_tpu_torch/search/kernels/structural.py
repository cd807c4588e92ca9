"""K6 ``structural_mask``: structural verdicts per entry and query lane.

Counterpart of ``tempo_tpu/search/structural.py`` ``structural_entry_mask``
(TPU kernel B8) with ``_span_mask``, ``_trace_mask``, ``_seg_count``,
``_bucket_span_regs`` and ``_bucket_trace_mask``. Every plan reaches it as
the reference's flattened slot programs (``search/structural.py``
``Lanes``): an exact plan as one lane, a same-plan or shape-bucketed
group as one lane per member. The CUDA kernel is ``csrc/structural.cu``
(its header states the opcodes); the plain PyTorch version below is the
CPU path and the reference the kernel is held against on the card.

Inputs (all on one device, contiguous):
  kv_key, kv_val, entry_dur, entry_valid, page_block, entry_dur_res
                   the batch's page arrays in K1's layouts (``widths``)
  spans            None (a batch without spans) or the staged span
                   columns by name: span_trace, span_parent, span_block
                   int32 [S]; span_dur int32 [S] (uint32 bits);
                   span_kind int8 [S]; span_kv_key/val int32 [S, Cs];
                   entry_span_begin/count int32 [P, E]
  max_run          at least the longest entry run (``max_entry_run`` at
                   staging): a run longer than a tile holds (``tile_cap``)
                   goes through scratch of that length; the kernel traps
                   on a longer one
  lanes            ``Lanes.device``'s tuple: span_prog int32 [Q, NS, 4],
                   trace_prog int32 [Q, NT, 4], term_keys int32 [Q, B, T],
                   val_ranges int32 [Q, B, T, R, 2], dur_params int32
                   [Q, D, 2] and agg_params int32 [Q, A, 3] (uint32 bits),
                   kind_params int32 [Q, K], block_group int32 [Q, B] or
                   None
  val_hits         None, or Q hit tables [G_q, T_q, V_q] (all bool or all
                   int32 words), each None for a lane compiled on the host
Output: verdicts uint8 [Q, P*E], 1 where the lane's structural predicate
holds for a valid entry of a real page.
"""

from __future__ import annotations

import ctypes

import torch

from .. import packing
from . import LaunchCount
from .build import check, load, on_device
from .scan import (_U32, _check_entries, _check_hit_table,
                   _check_same_device, _ptr)

LAUNCHES = LaunchCount()
MAX_REGS = 255          # slots per program, at most (csrc: 8 words of bits)
TILE_SPANS = 1024       # span rows a tile holds, at most (csrc kTileSpans):
                        # a longer run passes every tile
# the kernel's four builds, by span words and where the lane tables sit,
# each with the launches it took (csrc tt_structural_mask's order)
VARIANTS = ("1 word, tables in shared memory", "1 word, tables in place",
            "8 words, tables in shared memory", "8 words, tables in place")
VARIANT_LAUNCHES = {v: LaunchCount() for v in VARIANTS}

_SPAN_NAMES = ("span_trace", "span_parent", "span_block", "span_dur",
               "span_kind", "span_kv_key", "span_kv_val", "entry_span_begin",
               "entry_span_count")


def structural_mask(kv_key, kv_val, entry_dur, entry_valid, page_block,
                    spans, max_run: int, lanes: tuple, val_hits=None,
                    widths=None, entry_dur_res=None):
    """Verdicts uint8 [Q, P*E] — the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    fn = (structural_mask_plain if kv_key.device.type == "cpu"
          else _structural_mask_cuda)
    return fn(kv_key, kv_val, entry_dur, entry_valid, page_block, spans,
              max_run, lanes, val_hits, widths, entry_dur_res)


# ---------------------------------------------------------------------------
# the plain version


def _seg_count(m, seg_b, seg_n):
    """Matched spans per entry: an exclusive cumsum and two gathers."""
    c = torch.cumsum(m.to(torch.int64), 0)
    exc = torch.cat([c.new_zeros(1), c])
    return exc[seg_b + seg_n] - exc[seg_b]


def _cmp(x, y: int, code: int):
    return (x > y if code == 0 else x >= y if code == 1 else
            x < y if code == 2 else x <= y if code == 3 else
            x == y if code == 4 else x != y)


def _term(kk, vv, tk, lo, hi, table, g, t: int):
    """[..., C] slots against one term per row: key equality, then the
    value in a range or (rows with g >= 0) its bit of `table` row (g, t);
    any over the slots. tk [...], lo/hi [..., R], g [...] or None."""
    keym = kk == tk[..., None]
    valm = ((vv[..., None] >= lo[..., None, :])
            & (vv[..., None] <= hi[..., None, :])).any(-1)
    if table is not None:
        mh = packing.mask_select_grouped(
            table, g.clamp(min=0)[..., None], min(t, table.shape[1] - 1),
            vv.clamp(min=0)) & (vv >= 0)
        valm = torch.where((g >= 0)[..., None], mh, valm)
    return (keym & valm).any(-1)


def _lane_plain(q, kk, vv, entry_dur, entry_dur_res, dw, valid, safe_pb,
                spans, lanes, table):
    (sprog, tprog, tks, vrs, dps, kps, aps, bgs) = lanes
    T, D, K, A = tks.shape[2], dps.shape[1], kps.shape[1], aps.shape[1]
    tk, vr = tks[q].to(torch.int64), vrs[q].to(torch.int64)
    dp = [[int(x) & _U32 for x in row] for row in dps[q].tolist()]
    kp = kps[q].tolist()
    ap = [[int(x) & _U32 for x in row] for row in aps[q].tolist()]
    bg = None if table is None else bgs[q].to(torch.int64)
    sregs = None
    if spans is not None:
        s_valid = spans["span_trace"] >= 0
        s_block = spans["span_block"].to(torch.int64).clamp(min=0)
        s_par = spans["span_parent"].to(torch.int64)
        safe_par = s_par.clamp(min=0)
        s_dur = spans["span_dur"].to(torch.int64) & _U32
        s_kind = spans["span_kind"].to(torch.int64)
        s_kk = spans["span_kv_key"].to(torch.int64)
        s_vv = spans["span_kv_val"].to(torch.int64)
        seg_b = spans["entry_span_begin"].to(torch.int64)
        seg_n = spans["entry_span_count"].to(torch.int64)
        # pointer doubling over enough steps to reach every ancestor
        # within a trace (the reference doubles bit_length(S - 1) times
        # over the padded axis; both cover the same reachable set)
        steps = max(1, int(seg_n.max()).bit_length()) if seg_n.numel() \
            else 1
        sregs = [torch.zeros_like(s_valid)]
        for i, (opc, a, b, _c) in enumerate(sprog[q].tolist()):
            ra = sregs[min(max(a, 0), i)]
            rb = sregs[min(max(b, 0), i)]
            v = torch.zeros_like(s_valid)
            if opc == 1:
                t = min(max(a, 0), T - 1)
                v = _term(s_kk, s_vv, tk[s_block, t], vr[s_block, t, :, 0],
                          vr[s_block, t, :, 1], table,
                          None if bg is None else bg[s_block], t) & s_valid
            elif opc == 2:
                lo, hi = dp[min(max(a, 0), D - 1)]
                v = (s_dur >= lo) & (s_dur <= hi) & s_valid
            elif opc == 3:
                v = (s_kind == kp[min(max(a, 0), K - 1)]) & s_valid
            elif opc == 4:
                v = ra & rb
            elif opc == 5:
                v = ra | rb
            elif opc == 6:
                v = ~ra & s_valid
            elif opc == 7:
                v = rb & (s_par >= 0) & ra[safe_par]
            elif opc == 8:
                acc = (s_par >= 0) & ra[safe_par]
                jump = s_par
                for _ in range(steps):
                    safe_j = jump.clamp(min=0)
                    acc = acc | ((jump >= 0) & acc[safe_j])
                    jump = torch.where(jump >= 0, jump[safe_j], -1)
                v = rb & acc
            sregs.append(v)
    tregs = [torch.zeros_like(valid)]
    for s, (opc, a, b, c) in enumerate(tprog[q].tolist()):
        ra = tregs[min(max(a, 0), s)]
        rb = tregs[min(max(b, 0), s)]
        v = torch.zeros_like(valid)
        if opc == 1:
            t = min(max(a, 0), T - 1)
            v = _term(kk, vv, tk[safe_pb, t][:, None].expand(valid.shape),
                      vr[safe_pb, t, :, 0][:, None, :],
                      vr[safe_pb, t, :, 1][:, None, :], table,
                      None if bg is None
                      else bg[safe_pb][:, None].expand(valid.shape), t) \
                & valid
        elif opc == 2:
            lo, hi = dp[min(max(a, 0), D - 1)]
            v = packing.duration_ok(entry_dur, entry_dur_res, lo, hi, dw) \
                & valid
        elif opc in (3, 4, 5):
            qn, qd, x = ap[min(max(b, 0), A - 1)]
            if sregs is None:
                cnt = torch.zeros(valid.shape, dtype=torch.int64,
                                  device=valid.device)
            else:
                sm = sregs[min(max(a, 0), len(sregs) - 1)]
                cnt = _seg_count(sm, seg_b, seg_n)
            if opc == 3:
                v = (cnt > 0) & valid
            elif opc == 4:
                v = _cmp(cnt, qn, c) & valid
            elif sregs is not None:
                qd = max(qd, 1)
                r = ((qn * cnt + qd - 1) & _U32) // qd
                hi_in = s_dur > x if c == 0 else s_dur >= x
                lo_in = s_dur < x if c == 2 else s_dur <= x
                ok_hi = _seg_count(sm & hi_in, seg_b, seg_n) \
                    >= ((cnt - r + 1) & _U32)
                ok_lo = _seg_count(sm & lo_in, seg_b, seg_n) >= r
                eq = ok_hi & ok_lo
                ok = (ok_hi if c <= 1 else ok_lo if c <= 3
                      else eq if c == 4 else ~eq)
                v = ok & (cnt > 0) & valid
        elif opc == 6:
            v = ra & rb
        elif opc == 7:
            v = ra | rb
        elif opc == 8:
            v = ~ra & valid
        tregs.append(v)
    return tregs[-1] & valid


def structural_mask_plain(kv_key, kv_val, entry_dur, entry_valid,
                          page_block, spans, max_run: int, lanes: tuple,
                          val_hits=None, widths=None, entry_dur_res=None):
    """K6's function in plain PyTorch ops, lane by lane: each slot
    program's rows are read on the host and only the selected opcode is
    evaluated, vectorised over the span axis and then the entries, as the
    reference's ``_bucket_span_regs`` and ``_bucket_trace_mask`` compute
    it (``desc`` by pointer doubling, segment counts by cumsum)."""
    kw, vw, dw = widths if widths is not None else (None, None, None)
    kk = packing.unpack_ids(kv_key, kw)
    vv = packing.unpack_ids(kv_val, vw)
    pb = page_block.to(torch.int64)
    safe_pb = pb.clamp(min=0)
    valid = entry_valid & (pb >= 0)[:, None]
    Q = lanes[0].shape[0]
    rows = [_lane_plain(q, kk, vv, entry_dur, entry_dur_res, dw, valid,
                        safe_pb, spans, lanes,
                        None if val_hits is None else val_hits[q])
            for q in range(Q)]
    return torch.stack(rows).reshape(Q, -1).to(torch.uint8)


# ---------------------------------------------------------------------------
# the CUDA kernel


def _lib():
    lib = load("structural")
    if not getattr(lib, "_tt_typed", False):
        p = ctypes.c_void_p
        i32 = ctypes.c_int
        i64 = ctypes.c_int64
        lib.tt_structural_mask.restype = i32
        lib.tt_structural_mask.argtypes = (
            [i32, i32, p, p, p, p, i32, i32, p, p, i64, i32, i32]
            + [p] * 7 + [i32, p, p, p, p, i32, i32]
            + [i32] * 9 + [p] * 9 + [i32, p, p, p, p])
        lib.tt_structural_cap.restype = i32
        lib.tt_structural_cap.argtypes = [i32]
        lib._tt_typed = True
    return lib


def tile_cap(Cs: int) -> int:
    """Span rows a K6 tile holds for spans of `Cs` kv slots (at most
    TILE_SPANS): the kernel's own rule, so the card's build is asked."""
    return int(_lib().tt_structural_cap(int(Cs)))


def _hit_rows(val_hits, dev):
    """(host int64 [Q, 3] as a ctypes array, words flag) of per-lane hit
    tables ([G, T, V] each, all bool or all words, or None): each row is
    (address or 0, T, row length in elements), read by the launcher into
    the kernel's arguments."""
    rows, formats = [], set()
    for h in val_hits:
        if h is None:
            rows += (0, 0, 0)
            continue
        formats.add(_check_hit_table(h, 3, "each val_hits table"))
        if h.device != dev or not h.is_contiguous():
            raise ValueError("each val_hits table must be contiguous on the "
                             "kernel's device")
        rows += (h.data_ptr() if h.numel() else 0, int(h.shape[1]),
                 int(h.shape[2]))
    if len(formats) > 1:
        raise ValueError("val_hits tables mix bytes and words")
    return (ctypes.c_int64 * len(rows))(*rows), \
        (formats.pop() if formats else 0)


def _structural_mask_cuda(kv_key, kv_val, entry_dur, entry_valid,
                          page_block, spans, max_run, lanes, val_hits,
                          widths=None, entry_dur_res=None):
    dev = kv_key.device
    kl, vl, C, shift, res_bytes = _check_entries(
        kv_key, kv_val, None, None, entry_dur, entry_valid, entry_dur_res,
        widths)
    P, E = kv_key.shape[:2]
    if page_block.dtype != torch.int32 or tuple(page_block.shape) != (P,):
        raise ValueError(f"page_block: want int32 {(P,)}")
    sprog, tprog, tk, vr, dp, kp, ap, bg = lanes
    Q, NS = sprog.shape[:2]
    NT = tprog.shape[1]
    B, T = tk.shape[1:]
    R = vr.shape[3]
    for name, t, shape in (("span_prog", sprog, (Q, NS, 4)),
                           ("trace_prog", tprog, (Q, NT, 4)),
                           ("term_keys", tk, (Q, B, T)),
                           ("val_ranges", vr, (Q, B, T, R, 2)),
                           ("dur_params", dp, (Q, dp.shape[1], 2)),
                           ("kind_params", kp, (Q, kp.shape[1])),
                           ("agg_params", ap, (Q, ap.shape[1], 3))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want int32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if NS >= MAX_REGS or NT >= MAX_REGS:
        raise ValueError(f"programs of {NS}/{NT} slots; at most "
                         f"{MAX_REGS - 1}")
    hit_rows = None
    hit_words = 0
    if (val_hits is None) != (bg is None):
        raise ValueError("val_hits and block_group go together")
    if val_hits is not None:
        if len(val_hits) != Q or tuple(bg.shape) != (Q, B):
            raise ValueError(f"val_hits: want {Q} tables and block_group "
                             f"[{Q}, {B}]")
        hit_rows, hit_words = _hit_rows(val_hits, dev)
    n = P * E
    cols = [None] * len(_SPAN_NAMES)
    Cs = 1
    if spans is not None:
        cols = [spans[name] for name in _SPAN_NAMES]
        Cs = int(spans["span_kv_key"].shape[1])
        if tuple(spans["entry_span_begin"].shape) != (P, E):
            raise ValueError("entry_span_begin/count must be [P, E]")
    _check_same_device(dev, (kv_key, kv_val, entry_dur, entry_dur_res,
                             entry_valid, page_block, *cols, *lanes),
                       "structural_mask")
    span_words = NS // 32 + 1
    verdicts = torch.empty((Q, n), dtype=torch.uint8, device=dev)
    lib = _lib()
    launched = ctypes.c_int(0)
    by_variant = (ctypes.c_int * len(VARIANTS))()

    def launch(scratch):
        # the launcher says how much scratch its grid needs, if any, and
        # launches nothing while `scratch` is shorter
        words = ctypes.c_int64(0 if scratch is None else scratch.numel())
        rc = on_device(
            dev, lib.tt_structural_mask, kl, vl, kv_key.data_ptr(),
            kv_val.data_ptr(), entry_dur.data_ptr(), _ptr(entry_dur_res),
            shift, res_bytes, entry_valid.data_ptr(), page_block.data_ptr(),
            P, E, C, *(_ptr(c) for c in cols[:7]), Cs, _ptr(cols[7]),
            _ptr(cols[8]), _ptr(scratch), ctypes.byref(words), int(max_run),
            span_words, Q, B, T, R, int(dp.shape[1]), int(kp.shape[1]),
            int(ap.shape[1]), NS, NT, sprog.data_ptr(), tprog.data_ptr(),
            tk.data_ptr(), vr.data_ptr(), dp.data_ptr(), kp.data_ptr(),
            ap.data_ptr(), _ptr(bg), hit_rows, hit_words,
            verdicts.data_ptr(), ctypes.byref(launched), by_variant)
        check(lib, rc, "structural_mask")
        return words.value

    need = launch(None)
    if launched.value == 0 and need > 0:
        launch(torch.empty(need, dtype=torch.int32, device=dev))
    for _ in range(launched.value):
        LAUNCHES.bump()
    for v, k in zip(VARIANTS, by_variant):
        for _ in range(k):
            VARIANT_LAUNCHES[v].bump()
    return verdicts
