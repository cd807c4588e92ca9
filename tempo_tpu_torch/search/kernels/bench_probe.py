"""Time the dictionary probe K3 (``dict_probe``) of one checkout of the port
on one CUDA card, at the shapes of its row in PERF.md's kernel table and
the main path's other calls, against its plain version; and the seeded
edge cases (``K3_CASES``) that the CPU tests and ``chip_smoke.k3_edges``
hold K3 to.

  python3 tempo_tpu_torch/search/kernels/bench_probe.py --root DIR \\
      --label NAME [--out FILE] [--case NAME ...] [--repeat R]

imports ``tempo_tpu_torch`` and ``chip_smoke`` from DIR (this checkout,
or an unpacked older commit), stages the high-cardinality cell's block 0
dictionary (``chip_smoke.make_block(..., sessions=True)``: 1,050,711
values, "session-%08d" and the 8 tags' values) through
``dict_probe.stage_val_dict``, calls only the public wrappers, and prints
one JSON object (also appended to FILE): per case, the card ms (CUDA
events around 50 calls back to back) and the host time spent issuing the
same 50 calls (``host_us`` a call), the device ms
(``bench_structural.event_ms``: the median of 20 single synchronised
calls between CUDA events), the bound (bytes over 3.35 TB/s: the
dictionary read once, the output written once), the plain version's ms,
and whether the kernel equals the plain version exactly; then ptxas's
registers and spills of the ``probe.cu`` build. ``--case``
(repeatable) runs only the named cases, in the order below; ``--repeat
R`` runs them R times in turn. To compare two commits, run both in one
command on one card, in turns (old, new, new, old).

Cases (needles built outside the timed calls but for the last):
  - 77: the scattered needle "77", T = 1, bool rows;
  - 77 packed route: the same as the packed engine asks for it, words
    [1, 32,835] (a tree without K3's word form: K3, then K5);
  - point: "session-00123456" (one value);
  - prefix: "session-0012345" (ten values; every value's first two
    bytes are a candidate);
  - 77 AND svc-007: T = 2;
  - sessions T=8: ``chip_smoke.HC_SESSIONS`` in one call;
  - T=40: forty seeded digit strings in one call;
  - long values: a seeded dictionary of 8,192 values of 1-5,000 bytes
    (20.5 MB), an 8-byte needle from one of them;
  - probe call: ``dict_probe.probe_value_hits(dd, [b"77"])``, the whole
    call from the needle's bytes (its needle upload included).

``--breakdown`` (this checkout's kernel only) also builds variants of
``csrc/probe.cu`` (``BREAKDOWN``: the same launch with no grid barrier,
a persistent grid of 132 CTAs that take the tiles in turn, and a launch
with no tile and no barrier) into ``csrc/build/variants/`` and times
each on "77" beside the kernel itself: what the launch, the barrier and
the grid's shape each cost on the device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
E = 1024
SEED = 20261017                # chip_smoke.py's default --seed
HC_TRACES = 1_048_576          # the hc cell's traces a block
CHUNK = 32640                  # kernels.probe.CHUNK
ALPHABET = ["a", "b", "7", "0", "-", "é", "ß", "日", "本", "😀"]

# K3's edge cases: name -> the dictionary ("kind": "session" ids
# "session-%08d", "mixed" seeded strings over ALPHABET of 0..lmax
# characters with a share `empty` of empty values, or "fixed" `vals`),
# V = n values, the needles (bytes, None for a term that matches nothing,
# ("sub", L): L bytes from a seeded value of at least L bytes, else L
# seeded bytes; then seeded ("sub", 2-4) needles up to T terms), `long`:
# two first values of about a chunk each, a match planted across each of
# the first tile's two chunk seams, and `shift`: buf's address modulo 16
_BASE = dict(kind="mixed", n=300, lmax=12, empty=0.05, needles=[], T=1,
             long=False, shift=0, vals=None)
K3_CASES = {
    "V=1": dict(_BASE, kind="session", n=1, needles=[b"ssion-"]),
    "V=31": dict(_BASE, n=31, T=3),
    "V=32": dict(_BASE, n=32, T=3),
    "V=33": dict(_BASE, n=33, T=3),
    "V=4,097": dict(_BASE, n=4097, T=2),
    "session ids, a prefix": dict(_BASE, kind="session", n=3000,
                                  needles=[b"session-0000", b"77",
                                           b"session-00001234"]),
    "empty values": dict(_BASE, empty=0.4, needles=[b"", b"a", ("sub", 3)]),
    "a value longer than a chunk, matches across its seams": dict(
        _BASE, n=40, long=True, needles=[b"seam-needle-x", b"q", b"zz"]),
    "a match across a value boundary": dict(
        _BASE, kind="fixed", vals=["ab", "cd", "", "abc", "bcd"],
        needles=[b"bc", b"abcd", b"b", b"cdab", b"d"]),
    "a match in the last bytes of buf": dict(
        _BASE, kind="fixed", vals=["x", "yy", "tail-end"],
        needles=[b"end", b"d", b"tail-end", b"ail-en"]),
    "needles of 1, 2, 16 and 64 bytes": dict(
        _BASE, n=200, lmax=40, needles=[("sub", 1), ("sub", 2), ("sub", 16),
                                        ("sub", 64)]),
    "a needle equal to a value, one longer than every value": dict(
        _BASE, kind="fixed", vals=["ab", "abc", "abcd", "xabcdx"],
        needles=[b"abcd", b"abcdefgh", b"xabcdx"]),
    "the empty needle and a None term": dict(_BASE, needles=[b"", None,
                                                             ("sub", 2)]),
    "T=1": dict(_BASE, n=1000, T=1),
    "T=2": dict(_BASE, n=1000, T=2),
    "T=33": dict(_BASE, n=1000, T=33, needles=[None, b""]),
    "T=40": dict(_BASE, n=1000, T=40, needles=[b"7", b"", None]),
    "T=60, two launches": dict(_BASE, n=300, T=60, needles=[b"a", None]),
    "non-ASCII UTF-8": dict(_BASE, n=500, needles=["日本".encode(),
                                                   "😀".encode(),
                                                   "é".encode()[:1],
                                                   "ßa".encode()]),
    "buf from byte 1 of 16": dict(_BASE, n=700, T=3, shift=1),
    "buf from byte 7 of 16, a long value": dict(_BASE, n=60, long=True,
                                                shift=7,
                                                needles=[b"seam-needle-x"]),
}


def k3_case(seed: int, name: str, dev) -> dict:
    """``k3_inputs`` of the case `name`, seeded with `seed` plus the
    case's place among the sorted names."""
    return k3_inputs(seed + sorted(K3_CASES).index(name), K3_CASES[name],
                     dev)


def k3_inputs(seed: int, spec: dict, dev) -> dict:
    """One of ``K3_CASES`` made from the seed with numpy: {"vals": the
    values (str), "needles": bytes or None, "buf": uint8 [N] on `dev`
    (a view whose address is `shift` modulo 16), "off": int32 [V+1] on
    `dev`, "arr", "lens": K3's needle rows and lengths in host memory}."""
    import numpy as np
    import torch

    from tempo_tpu_torch.search.dict_probe import (needle_tensors,
                                                   pack_device_dict)

    rng = np.random.default_rng(seed)
    n = spec["n"]
    if spec["kind"] == "fixed":
        vals = list(spec["vals"])
    elif spec["kind"] == "session":
        ids = np.sort(rng.choice(10**8, size=n, replace=False))
        vals = [f"session-{int(k):08d}" for k in ids]
    else:
        vals = ["" if rng.random() < spec["empty"] else "".join(
            ALPHABET[i] for i in rng.integers(
                len(ALPHABET), size=int(rng.integers(1, spec["lmax"] + 1))))
            for _ in range(n)]
    if spec["long"]:
        # value 0 holds bytes [0, CHUNK + 300), value 1 the next CHUNK
        # bytes; each holds the needle once, across a chunk seam of the
        # first tile (its bytes start at 0 whatever the tile size)
        first = bytearray(rng.integers(97, 123, size=CHUNK + 300,
                                       dtype=np.uint8).tobytes())
        second = bytearray(rng.integers(97, 123, size=CHUNK,
                                        dtype=np.uint8).tobytes())
        first[CHUNK - 5:CHUNK + 8] = b"seam-needle-x"
        at = 2 * CHUNK - 12 - len(first)
        second[at:at + 13] = b"seam-needle-x"
        vals[0], vals[1] = first.decode("ascii"), second.decode("ascii")
    blobs = [v.encode("utf-8") for v in vals]
    needles = []
    for nd in spec["needles"]:
        needles.append(_needle(rng, blobs, nd[1]) if isinstance(nd, tuple)
                       else nd)
    while len(needles) < spec["T"]:
        needles.append(_needle(rng, blobs, int(rng.integers(2, 5))))
    packed = pack_device_dict(vals)
    N = packed.buf.size
    full = torch.zeros(N + 32, dtype=torch.uint8, device=dev)
    at = (spec["shift"] - full.data_ptr()) % 16
    buf = full[at:at + N]
    buf.copy_(torch.from_numpy(np.array(packed.buf, copy=True)))
    off = torch.from_numpy(packed.off).to(dev)
    arr, lens = needle_tensors(needles)
    return {"vals": vals, "needles": needles, "buf": buf, "off": off,
            "arr": arr, "lens": lens}


def _needle(rng, blobs: list, L: int) -> bytes:
    """L bytes from a seeded value of at least L bytes, else L seeded
    bytes (a needle longer than every value)."""
    fit = [b for b in blobs if len(b) >= L]
    if not fit:
        return bytes(rng.integers(97, 123, size=L, dtype="uint8").tolist())
    b = fit[int(rng.integers(len(fit)))]
    at = int(rng.integers(len(b) - L + 1))
    return b[at:at + L]


def k3_bytes(buf, off, T: int, words: bool) -> int:
    """K3's bound in bytes: the dictionary read once (its bytes and
    offsets) and the rows and any_hits written once."""
    V = off.numel() - 1
    rows = T * -(-V // 32) * 4 if words else T * V
    return buf.numel() + off.numel() * 4 + rows + T


def card_host(fn, reps: int) -> tuple:
    """(card ms, host us) a call: CUDA events around `reps` calls back to
    back, and the host's clock around issuing the same calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    h1 = time.perf_counter()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, (h1 - h0) / reps * 1e6


# csrc/probe.cu variants for --breakdown: (text, replacement) pairs
BREAKDOWN = {
    "no grid barrier": [("  cg::this_grid().sync();", "  return;")],
    "132 CTAs, tiles in turn": [
        ("  int64_t grid = tiles < cap ? tiles : cap;",
         "  int64_t grid = tiles < 132 ? tiles : 132;")],
    "empty launch": [
        ("  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {",
         "  for (int tile = blockIdx.x; tile < 0; tile += gridDim.x) {"),
        ("  cg::this_grid().sync();", "  return;")],
}


def breakdown(dd, needles: list) -> dict:
    """Device ms (``event_ms``) of K3 and of its ``BREAKDOWN`` variants on
    the staged dictionary `dd`, each launched straight through its
    library's ``tt_dict_probe``."""
    import ctypes

    import torch

    from tempo_tpu_torch.search import dict_probe
    from tempo_tpu_torch.search.kernels import build, probe
    from tempo_tpu_torch.search.kernels.bench_structural import event_ms

    src = (build.CSRC / "probe.cu").read_text()
    where = build.BUILD_DIR / "variants"
    where.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(BREAKDOWN.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise AssertionError(f"breakdown {name}: csrc/probe.cu has "
                                     f"no {old.strip()!r}")
            text = text.replace(old, new)
        cu, so = where / f"probe_v{i}.cu", where / f"libprobe_v{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {"K3": probe._lib()}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"breakdown {name}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.tt_dict_probe.restype = ctypes.c_int
        lib.tt_dict_probe.argtypes = probe._LIB.tt_dict_probe.argtypes
        libs[name] = lib
    arr, lens = dict_probe.needle_tensors(needles)
    T, L = arr.shape
    V = dd.off.numel() - 1
    nbytes, _any_at = probe.out_layout(T, V, False)
    out = torch.empty(nbytes, dtype=torch.bool, device=dd.buf.device)
    res = {}
    for name, lib in libs.items():
        def fn(lib=lib):
            rc = lib.tt_dict_probe(
                dd.buf.data_ptr(), dd.off.data_ptr(), V, arr.data_ptr(),
                lens.data_ptr(), T, L, 0, out.data_ptr(), nbytes,
                build._raw_stream(dd.buf.device.index))
            if rc:
                raise RuntimeError(f"breakdown {name}: CUDA error {rc}")
        res[name] = event_ms(fn)
    return res


CASES = ("77", "77 packed route", "point", "prefix", "77 AND svc-007",
         "sessions T=8", "T=40", "long values", "probe call")


def measure(label: str, cases=CASES, repeat: int = 1,
            split: bool = False) -> dict:
    import chip_smoke as cs
    import numpy as np
    import torch

    from tempo_tpu_torch.search import dict_probe
    from tempo_tpu_torch.search.kernels import pack, probe

    dev = torch.device("cuda", 0)
    words_route = hasattr(probe, "WORD_LAUNCHES")   # K3 writes words
    out = {"label": label, "card": torch.cuda.get_device_name(0),
           "k3_words": words_route, "cases": {}, "runs": []}
    t0 = time.perf_counter()
    pages = cs.make_block(SEED, 0, HC_TRACES, E, sessions=True)
    dd = dict_probe.stage_val_dict(pages.val_dict, dev)
    rng = np.random.default_rng(SEED)
    lens = rng.integers(1, 5001, size=8192)
    off = np.zeros(lens.size + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    body = rng.integers(97, 123, size=int(off[-1]), dtype=np.uint8)
    at = int(off[4096])
    long_dd = (torch.from_numpy(body).to(dev),
               torch.from_numpy(off.astype(np.int32)).to(dev),
               bytes(body[at + 100:at + 108].tolist()))
    out["corpus_s"] = time.perf_counter() - t0
    # the corpus's million strings would make a collection pass land in
    # a timed loop: collect once, then keep them out of later passes
    gc.collect()
    gc.freeze()
    out["values"] = dd.n_vals
    out["dict_bytes"] = int(dd.buf.numel())

    def needles_of(needles):
        try:
            return dict_probe.needle_tensors(needles)
        except TypeError:       # a tree whose needles go to the card
            return dict_probe.needle_tensors(needles, dev)

    def kernel_case(needles, buf=None, off=None, words=False):
        buf = dd.buf if buf is None else buf
        off = dd.off if off is None else off
        arr, ln = needles_of(needles)
        T = len(needles)
        if words and words_route:
            def fn():
                return probe.dict_probe(buf, off, arr, ln, True)
        elif words:
            def fn():
                h, a = probe.dict_probe(buf, off, arr, ln)
                return pack.pack_mask_words(h), a
        else:
            def fn():
                return probe.dict_probe(buf, off, arr, ln)

        def plain():
            h, a = probe.dict_probe_plain(buf, off, arr, ln)
            return (pack.pack_mask_words_plain(h) if words else h), a

        return timed(fn, plain, k3_bytes(buf, off, T, words), T)

    def call_case(needles):
        def fn():
            return dict_probe.probe_value_hits(dd, needles)

        arr, ln = needles_of(needles)

        def plain():
            return probe.dict_probe_plain(dd.buf, dd.off, arr, ln)

        return timed(fn, plain, k3_bytes(dd.buf, dd.off, len(needles),
                                         False), len(needles))

    t40 = [str(int(k)).encode() for k in
           np.random.default_rng(SEED + 40).integers(10, 10_000, size=40)]
    run = {
        "77": lambda: kernel_case([b"77"]),
        "77 packed route": lambda: kernel_case([b"77"], words=True),
        "point": lambda: kernel_case(
            [f"session-{cs.POINT_SESSION:08d}".encode()]),
        "prefix": lambda: kernel_case(
            [f"session-{cs.POINT_SESSION // 10:07d}".encode()]),
        "77 AND svc-007": lambda: kernel_case([b"77", b"svc-007"]),
        "sessions T=8": lambda: kernel_case(
            [s.encode() for s in cs.HC_SESSIONS]),
        "T=40": lambda: kernel_case(t40),
        "long values": lambda: kernel_case([long_dd[2]], long_dd[0],
                                           long_dd[1]),
        "probe call": lambda: call_case([b"77"]),
    }
    if split:
        out["breakdown_77"] = breakdown(dd, [b"77"])
        print(f"{label} breakdown (77, device ms): "
              f"{json.dumps(out['breakdown_77'])}", flush=True)
    for i in range(repeat):
        results = {}
        for name in cases:
            r = run[name]()
            results[name] = r
            print(f"{label} {name}: {json.dumps(r)}", flush=True)
            if not r["exact"]:
                raise AssertionError(f"{label} {name}: the kernel differs "
                                     "from its plain version")
        out["runs"].append(results)
        if i == 0:
            out["cases"] = results
    return out


def timed(fn, plain, need: int, T: int) -> dict:
    """A probe call `fn` against its plain version: card ms and host us
    (``card_host``), device, bound and plain ms, exact equality of both
    outputs, and the hits counted."""
    import torch

    from tempo_tpu_torch.search.kernels.bench_structural import (card_ms,
                                                                 event_ms)

    got, want = fn(), plain()
    torch.cuda.synchronize()
    exact = all(g.shape == w.shape and torch.equal(g, w)
                for g, w in zip(got, want))
    card, host = card_host(fn, 50)
    counted = got[0] if got[0].dtype == torch.bool else got[0] != 0
    return {"card_ms": card, "host_us": host, "device_ms": event_ms(fn),
            "bound_ms": need / HBM_BYTES_PER_S * 1e3, "bytes": need,
            "plain_ms": card_ms(plain, 3), "exact": exact, "T": T,
            "counted": int(counted.sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose tempo_tpu_torch and chip_smoke to "
                         "import")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--case", action="append", choices=CASES,
                    help="run only this case (repeatable)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="passes over the cases, in turn")
    ap.add_argument("--breakdown", action="store_true",
                    help="also time csrc/probe.cu variants (BREAKDOWN)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_probe: no CUDA card", file=sys.stderr)
        return 2
    # this file's own directory must not shadow the checkout's modules
    sys.path = [p for p in sys.path
                if os.path.abspath(p or ".") != os.path.dirname(
                    os.path.abspath(__file__))]
    sys.path.insert(0, os.path.abspath(args.root))
    from tempo_tpu_torch.search.kernels import build
    from tempo_tpu_torch.search.kernels.bench_coalesced import ptxas_usage

    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    res = measure(args.label,
                  [c for c in CASES if c in args.case] if args.case
                  else CASES, args.repeat, args.breakdown)
    res["build_s"] = build_s
    res["ptxas"] = ptxas_usage(build.BUILD_LOG.get("probe", ""))
    res["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
