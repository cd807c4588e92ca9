"""The port's WAL (``tempo_tpu_torch/wal``) against the reference's.

Segments come from the port's write path over seeded OTLP pushes
(``tests/torch_otlp.py``), traces split over pushes among them, so a
block holds several segments of one id. Files written by either package
replay in the other with the same records, objects, ranges and counts
(codecs ``none``, ``zlib``, ``gzip``, and ``snappy``, ``lz4`` and
``zstd`` through each package's native library; the reference's codec is
set explicitly). Replay handles a torn tail, a corrupt record and stray
files as the reference does. The port's ``auto`` is snappy where its host
library has it, as the reference's; with the codecs taken away
(``monkeypatch``), ``auto`` is zlib, the others raise when a WAL is
built, and a file written with one raises at replay and stays on disk.
"""

from __future__ import annotations

import dataclasses
import os
import zlib

import pytest

from tempo_tpu.backend.types import BlockMeta as RefBlockMeta
from tempo_tpu.encoding.v2.objects import marshal_object as ref_marshal
from tempo_tpu.wal import WAL as RefWAL
from tempo_tpu.wal import wal as ref_wal

from tempo_tpu_torch.backend.types import BlockMeta
from tempo_tpu_torch.backend.local import LocalBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.encoding import compression
from tempo_tpu_torch.modules.distributor import push_items
from tempo_tpu_torch.ops import native as port_native
from tempo_tpu_torch.wal import (WAL, parse_wal_filename,
                                 resolve_wal_encoding, wal_filename)

from tests.torch_otlp import make_pushes

TENANT = "t/1+x y"        # a tenant id the filename must percent-encode
BID = "00000000-0000-4000-8000-000000000018"


@pytest.fixture
def no_native_codecs(monkeypatch):
    """This process as a host without libzstd, liblz4, the library's
    snappy, and the zstandard package."""
    monkeypatch.setattr(port_native, "codecs", lambda: ())
    monkeypatch.setattr(compression, "_zstd", None)


@pytest.fixture(scope="module")
def items():
    pushes, _ = make_pushes(20261018, 60, n_pushes=3)
    out = []
    for batches in pushes:
        out += push_items(batches)[0]
    return out


def _wal(pkg: str, d: str, enc: str):
    return (RefWAL if pkg == "ref" else WAL)(d, encoding=enc)


def _write(pkg: str, d: str, enc: str, items) -> str:
    blk = _wal(pkg, d, enc).new_block(TENANT, block_id=BID)
    for tid, s, e, seg, _sd in items:
        blk.append(tid, seg, s, e)
    path = blk.path
    blk.close()
    return path


def _state(blk) -> tuple:
    return (list(blk.iterator()), len(blk), blk.data_length,
            blk.meta.start_time, blk.meta.end_time, blk.meta.total_objects,
            blk.corrupt_records)


def _replay(pkg: str, d: str):
    w = RefWAL(d, encoding="none") if pkg == "ref" else WAL(d, "none")
    blocks, removed = w.replay_all()
    return w, blocks, removed


@pytest.mark.parametrize("enc", ["none", "zlib", "gzip", "snappy", "lz4",
                                 "zstd"])
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_wal_files_replay_across_packages(tmp_path, items, enc, writer,
                                          reader):
    """A file one package writes replays in the other with the same
    objects (each id's segments combined), record count, length, range
    and object count; the filenames are the same in both, and so are the
    files, but for gzip (its header carries its time of writing) and
    snappy (the port's encoder is its own; the framing is the same)."""
    paths = {}
    for pkg in ("ref", "port"):
        paths[pkg] = _write(pkg, str(tmp_path / pkg), enc, items)
    assert os.path.basename(paths["ref"]) == os.path.basename(paths["port"])
    if enc not in ("gzip", "snappy"):
        with open(paths["ref"], "rb") as a, open(paths["port"], "rb") as b:
            assert a.read() == b.read()
    _, got, _ = _replay(reader, str(tmp_path / writer))
    _, want, _ = _replay(writer, str(tmp_path / writer))
    assert len(got) == len(want) == 1
    assert _state(got[0]) == _state(want[0])
    assert dataclasses.asdict(got[0].meta) == \
        dataclasses.asdict(want[0].meta)
    objs = dict(got[0].iterator())
    # split traces: two segments of one id, combined
    assert len(objs) < len(items) and len(got[0]) == len(items)
    for b in got + want:
        b.close()


def test_filenames_round_trip_as_the_reference():
    meta = BlockMeta(block_id=BID, tenant_id=TENANT, encoding="zlib",
                     data_encoding="v2")
    ref_meta = RefBlockMeta(block_id=BID, tenant_id=TENANT, encoding="zlib",
                            data_encoding="v2")
    name = wal_filename(meta)
    assert name == ref_wal.wal_filename(ref_meta)
    assert dataclasses.asdict(parse_wal_filename(name)) == \
        dataclasses.asdict(ref_wal.parse_wal_filename(name))
    for bad in ("a+b+c", "+t+vT1+none+v2", "x+" * 5):
        for parse in (parse_wal_filename, ref_wal.parse_wal_filename):
            with pytest.raises(ValueError):
                parse(bad)


@pytest.mark.parametrize("cut", [1, 7, 40])
@pytest.mark.parametrize("enc", ["none", "zlib"])
def test_truncated_tail_replays_as_the_reference(tmp_path, items, enc, cut):
    """A crashed writer's partial last record: both replays keep the
    records before it and cut the file to the same length, and an append
    after the replay starts clean."""
    sizes = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path / pkg)
        path = _write("port", d, enc, items)
        with open(path, "rb+") as f:
            f.truncate(os.path.getsize(path) - cut)
        _, blocks, _ = _replay(pkg, d)
        sizes[pkg] = (os.path.getsize(path), _state(blocks[0]))
        tid, s, e, seg, _ = items[0]
        blocks[0].append(tid, seg, s, e)
        blocks[0].close()
        _, again, _ = _replay("port", d)
        assert len(again[0]) == len(items)   # the cut record, appended anew
        again[0].close()
    assert sizes["ref"] == sizes["port"]
    assert sizes["port"][1][1] == len(items) - 1


@pytest.mark.parametrize("enc", ["zlib", "gzip"])
def test_corrupt_record_is_dropped_as_the_reference(tmp_path, items, enc):
    """A record whose payload does not decompress is dropped at replay
    (counted), and the records after it still replay."""
    states = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path / pkg)
        path = _write("port", d, enc, items)
        with open(path, "rb") as f:
            buf = bytearray(f.read())
        # the payload of the third record: past two records and a header
        off = 0
        for _ in range(2):
            id_len = int.from_bytes(buf[off:off + 4], "little")
            data_len = int.from_bytes(buf[off + 4:off + 8], "little")
            off += 8 + id_len + data_len
        id_len = int.from_bytes(buf[off:off + 4], "little")
        buf[off + 8 + id_len:off + 8 + id_len + 6] = b"\xff" * 6
        with open(path, "wb") as f:
            f.write(bytes(buf))
        w, blocks, _ = _replay(pkg, d)
        states[pkg] = _state(blocks[0])
        assert blocks[0].corrupt_records == 1
        assert w.last_replay["corrupt_records"] == 1
        blocks[0].close()
    assert states["ref"] == states["port"]
    assert states["port"][1] == len(items) - 1


def test_replay_removes_what_the_reference_removes(tmp_path, items):
    """Empty files, unparseable names and search sidecars without their
    block are removed; a sidecar with its block stays."""
    removed = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path / pkg)
        path = _write("port", d, "zlib", items)
        open(path + ".search", "wb").close()
        for name in ("not-a-wal-file",
                     f"{BID[:-1]}9+t+vT1+zlib+v2",           # empty
                     f"{BID[:-1]}7+t+vT1+zlib+v2.search"):   # orphan
            open(os.path.join(d, name), "wb").close()
        os.mkdir(os.path.join(d, "a-directory"))
        w, blocks, gone = _replay(pkg, d)
        removed[pkg] = sorted(gone)
        assert len(blocks) == 1 and os.path.exists(path + ".search")
        assert w.last_replay["removed_files"] == 3
        assert sorted(os.listdir(d)) == sorted(
            [os.path.basename(path), os.path.basename(path) + ".search",
             "a-directory"])
        blocks[0].close()
    assert removed["ref"] == removed["port"]


def test_auto_is_zlib_and_the_rest_resolve_as_named(no_native_codecs):
    """Without the host library's codecs ``auto`` is zlib, as the
    reference's without its native runtime."""
    assert resolve_wal_encoding() == resolve_wal_encoding("auto") == "zlib"
    for enc in ("none", "gzip", "zlib"):
        assert resolve_wal_encoding(enc) == enc


def test_auto_is_snappy_where_the_library_has_it():
    assert "snappy" in port_native.codecs()
    assert resolve_wal_encoding() == resolve_wal_encoding("auto") == "snappy"
    for enc in ("none", "gzip", "zlib", "zstd", "lz4", "snappy", "s2"):
        assert resolve_wal_encoding(enc) == enc


@pytest.mark.parametrize("enc", ["snappy", "lz4", "s2", "brotli", ""])
def test_codecs_the_port_cannot_use_raise_when_the_wal_is_built(
        tmp_path, enc, no_native_codecs):
    """brotli and "" are no codec; snappy, lz4 and s2 raise on a host
    without them."""
    with pytest.raises(ValueError, match="wal_encoding"):
        WAL(str(tmp_path / "w"), encoding=enc)
    with pytest.raises(ValueError, match="wal_encoding"):
        TempoDB(LocalBackend(str(tmp_path / "b")),
                TempoDBConfig(wal_encoding=enc), device="cpu",
                wal_dir=str(tmp_path / "w2"))


@pytest.mark.parametrize("enc", ["snappy", "lz4", "s2", "brotli", ""])
def test_native_codecs_resolve_when_the_wal_is_built(tmp_path, enc):
    """With the host library, snappy, lz4 and s2 build a WAL (and a
    database's); brotli and "" still raise."""
    if enc in ("brotli", ""):
        with pytest.raises(ValueError, match="wal_encoding"):
            WAL(str(tmp_path / "w"), encoding=enc)
        return
    assert WAL(str(tmp_path / "w"), encoding=enc).encoding == enc
    db = TempoDB(LocalBackend(str(tmp_path / "b")),
                 TempoDBConfig(wal_encoding=enc), device="cpu",
                 wal_dir=str(tmp_path / "w2"))
    try:
        assert db.wal.encoding == enc
    finally:
        db.close()


def test_zstd_without_zstandard_raises(tmp_path, no_native_codecs):
    """Neither libzstd nor the zstandard package: zstd raises."""
    with pytest.raises(ValueError, match="zstandard"):
        WAL(str(tmp_path), encoding="zstd")


def test_zstd_through_the_library_without_zstandard(tmp_path, monkeypatch,
                                                    items):
    """Without the zstandard package the library's zstd serves, and the
    reference reads what it wrote."""
    monkeypatch.setattr(compression, "_zstd", None)
    path = _write("port", str(tmp_path), "zstd", items[:8])
    assert os.path.basename(path).endswith("+zstd+v2")
    _, got, _ = _replay("ref", str(tmp_path))
    assert len(got[0]) == 8
    got[0].close()


def _snappy_literal(data: bytes) -> bytes:
    """``data`` in the reference's snappy record form: its length as a
    u64, then a valid raw snappy stream of literal chunks (the length as
    a varint, then literals of at most 60 bytes)."""
    out, n = bytearray(len(data).to_bytes(8, "little")), len(data)
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            break
    for i in range(0, len(data), 60):
        chunk = data[i:i + 60]
        out.append((len(chunk) - 1) << 2)
        out += chunk
    return bytes(out)


def _reference_snappy_file(d, items):
    """A WAL file of the reference's snappy codec (its records framed by
    the reference, its name by the reference's wal_filename) with a
    sidecar; returns (path, body)."""
    d.mkdir()
    meta = RefBlockMeta(block_id=BID, tenant_id=TENANT, encoding="snappy",
                        data_encoding="v2")
    body = b"".join(ref_marshal(tid, _snappy_literal(seg))
                    for tid, _s, _e, seg, _ in items[:8])
    from tempo_tpu.ops import native

    if native.available():   # the stream is real snappy
        assert native.snappy_decompress(_snappy_literal(items[0][3])) == \
            items[0][3]
    path = d / ref_wal.wal_filename(meta)
    path.write_bytes(body)
    (d / (path.name + ".search")).write_bytes(b"sidecar")
    return path, body


def test_a_reference_snappy_file_raises_and_stays_on_disk(
        tmp_path, items, no_native_codecs):
    """On a host without the codec the port's replay raises naming it and
    removes nothing: the file and its sidecar stay byte for byte."""
    d = tmp_path / "wal"
    path, body = _reference_snappy_file(d, items)
    before = sorted(os.listdir(d))
    with pytest.raises(ValueError, match="snappy"):
        WAL(str(d)).replay_all()
    assert sorted(os.listdir(d)) == before
    assert path.read_bytes() == body


def test_a_reference_snappy_file_replays(tmp_path, items):
    """With the host library the same file replays: every record, and the
    objects of the same segments written uncompressed."""
    path, _body = _reference_snappy_file(tmp_path / "wal", items)
    blocks, removed = WAL(str(tmp_path / "wal")).replay_all()
    assert len(blocks) == 1 and not removed
    assert blocks[0].path == str(path) and len(blocks[0]) == 8
    assert blocks[0].corrupt_records == 0
    _write("port", str(tmp_path / "plain"), "none", items[:8])
    _, want, _ = _replay("port", str(tmp_path / "plain"))
    assert list(blocks[0].iterator()) == list(want[0].iterator())
    for b in blocks + want:
        b.close()


def test_append_find_and_lifecycle(tmp_path, items):
    """find combines an id's segments, answers None for an absent id and,
    once the block is closed under a reader, for every id; clear removes
    the file."""
    w = WAL(str(tmp_path))
    blk = w.new_block(TENANT)
    by_id: dict = {}
    for tid, s, e, seg, _ in items:
        blk.append(tid, seg, s, e)
        by_id.setdefault(tid, []).append(seg)
    from tempo_tpu_torch.model.codec import segment_codec_for

    codec = segment_codec_for("v2")
    for tid, segs in by_id.items():
        assert blk.find(tid) == codec.to_object(segs)
    assert blk.find(b"\x07" * 16) is None
    assert [t for t, _ in blk.iterator()] == sorted(by_id)
    assert blk.meta.encoding == "snappy" and blk.meta.total_objects == len(items)
    blk.close()
    assert blk.find(items[0][0]) is None
    assert os.path.exists(blk.path)
    blk.clear()
    assert not os.path.exists(blk.path)


def test_database_owns_a_wal_only_when_given_a_directory(tmp_path):
    be = LocalBackend(str(tmp_path / "b"))
    assert TempoDB(be, device="cpu").wal is None
    db = TempoDB(be, TempoDBConfig(wal_encoding="gzip"), device="cpu",
                 wal_dir=str(tmp_path / "w"))
    try:
        assert db.wal.encoding == "gzip" and db.wal.dir == str(tmp_path / "w")
        blk = db.wal.new_block("t")
        blk.append(b"\x01" * 16, b"\x00" * 8 + zlib.compress(b""), 1, 2)
        assert os.path.basename(blk.path).endswith("+vT1+gzip+v2")
        blk.close()
    finally:
        db.close()
