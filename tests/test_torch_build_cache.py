"""The kernel build cache (``kernels/build.py``): a library is saved beside
nvcc's log, and a later process that reuses the library reads ptxas's
report from that log, so checks that read ``BUILD_LOG`` (no spilling
build) hold on a warm cache as on a cold one. nvcc is replaced by a
script that writes an empty library and a ptxas-style report."""

from __future__ import annotations

import stat
import sys

import pytest

from tempo_tpu_torch.search.kernels import build
from tempo_tpu_torch.search.kernels.bench_coalesced import ptxas_usage

REPORT = ("ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'\n"
          "ptxas info    : Function properties for _Z1kv\n"
          "    0 bytes stack frame, 0 bytes spill stores, "
          "0 bytes spill loads\n"
          "ptxas info    : Used 40 registers, used 0 barriers\n")


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A csrc/ with two sources and a fake nvcc that counts its calls."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("one", "two"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').close()\n"
        f"open({str(calls)!r}, 'a').write(sys.argv[-1] + '\\n')\n"
        f"sys.stdout.write({REPORT!r})\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", csrc / "build")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_LOG", {})
    monkeypatch.setattr(build, "BUILT", set())

    def compiled():
        return calls.read_text().split() if calls.exists() else []
    return csrc, compiled


def _fresh_process():
    """What a new process starts with."""
    build.BUILD_LOG.clear()
    build.BUILT.clear()


@pytest.mark.parametrize("warm_runs", [1, 2])
def test_warm_cache_keeps_ptxas_report(tree, warm_runs):
    csrc, compiled = tree
    paths = build.build_all()
    assert build.BUILT == {"one", "two"} and len(compiled()) == 2
    cold = dict(build.BUILD_LOG)
    assert ptxas_usage(cold["one"]) == {
        "k": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
              "registers": 40}}
    for _ in range(warm_runs):
        _fresh_process()
        assert build.build_all() == paths
        assert build.BUILT == set() and len(compiled()) == 2
        assert build.BUILD_LOG == cold
    for p in paths.values():
        assert p.exists() and p.with_suffix(".log").read_text() == REPORT


def test_library_without_its_log_is_rebuilt(tree):
    csrc, compiled = tree
    paths = build.build_all()
    paths["two"].with_suffix(".log").unlink()
    _fresh_process()
    build.build_all()
    assert build.BUILT == {"two"}
    assert compiled()[-1].endswith("two.cu") and len(compiled()) == 3
    assert set(build.BUILD_LOG) == {"one", "two"}
    assert not list((csrc / "build").glob(".*tmp*"))
