"""The port's kernel build (paddle_tpu_torch/ops/cuda/_build.py) on the CPU,
with a stand-in for nvcc: each library's compiler log lies beside it, so a
build with other flags never passes its log off as another build's."""
from __future__ import annotations

import stat
import sys

import pytest

from paddle_tpu_torch.ops.cuda import _build

# prints a log line that names its flags, and writes the -o file
FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
print("ptxas info    : flags " + " ".join(a for a in args if a.startswith("-D")))
open(args[args.index("-o") + 1], "w").write("library")
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_loaded", {})
    return tmp_path / "_build"


def test_log_lies_beside_its_library(fake_build):
    _build.build_all()
    for name in _build.sources():
        so = _build._target(name)
        assert so.read_text() == "library"
        assert so.with_suffix(".log").exists()
        assert "ptxas info" in _build.build_log(name)


def test_a_variant_build_leaves_the_default_log(fake_build, monkeypatch):
    _build.build_all()
    default = _build.build_log("axpy")
    assert "-DPT_AXPY_UNROLL" not in default
    flags = _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "NVCC_FLAGS", flags + ("-DPT_AXPY_UNROLL=4",))
    _build.build_all()
    assert "-DPT_AXPY_UNROLL=4" in _build.build_log("axpy")
    monkeypatch.setattr(_build, "NVCC_FLAGS", flags)
    _build.build_all()  # the default library is built already: nothing runs
    assert _build.build_log("axpy") == default


def test_build_log_reads_the_loaded_library(fake_build, monkeypatch):
    _build.build_all()
    monkeypatch.setitem(_build._loaded, "axpy", _build._target("axpy"))
    default = _build.build_log("axpy")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-DPT_AXPY_UNROLL=8",))
    _build.build_all()
    # the flags now name another library, but the loaded one's log is read
    assert _build.build_log("axpy") == default
