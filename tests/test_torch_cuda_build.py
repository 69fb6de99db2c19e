"""The kernel libraries' cache key (``ops/cuda_build.py::library_path``):
an edit to a ``csrc/`` header that a source includes builds that source
anew, an edit to another source does not, and a build's log is read only
beside the library it built.  Works on copies of ``csrc/`` and
``build/``; needs no ``nvcc``."""
import shutil

import pytest

from gscream_tpu_torch.ops import cuda_build as cb


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    root = tmp_path / "csrc"
    shutil.copytree(cb.CSRC, root)
    monkeypatch.setattr(cb, "CSRC", root)
    monkeypatch.setattr(cb, "BUILD", tmp_path / "build")
    return root


def _paths():
    return {name: cb.library_path(name) for name in cb.SOURCES}


def test_tile_kernels_include_the_blend_header(csrc):
    for name in ("rasterize_fwd", "rasterize_bwd"):
        assert cb.included(csrc / cb.SOURCES[name][0]) == [csrc /
                                                           "blend.cuh"]
    assert cb.included(csrc / "shuffle.cu") == []


def test_header_edit_rebuilds_its_includers(csrc):
    before = _paths()
    with open(csrc / "blend.cuh", "a") as f:
        f.write("\n// an edit\n")
    after = _paths()
    for name in cb.SOURCES:
        changed = before[name] != after[name]
        assert changed == (name in ("rasterize_fwd", "rasterize_bwd")), name


def test_nested_header_and_other_source(csrc):
    (csrc / "inner.cuh").write_text("#pragma once\n")
    with open(csrc / "blend.cuh", "a") as f:
        f.write('\n#include "inner.cuh"\n')
    before = _paths()
    (csrc / "inner.cuh").write_text("#pragma once\n// an edit\n")
    with open(csrc / "shuffle.cu", "a") as f:
        f.write("\n// an edit\n")
    after = _paths()
    assert before["rasterize_bwd"] != after["rasterize_bwd"]
    assert before["shuffle"] != after["shuffle"]
    assert before["segreduce"] == after["segreduce"]
    assert before["emission"] == after["emission"]


def test_build_log_follows_the_library(csrc):
    """The ptxas log read for a kernel is the one its current library's
    build wrote: after a header edit the old build's log is not read."""
    cb.BUILD.mkdir()
    cb.library_path("rasterize_bwd").with_suffix(".log").write_text(
        "ptxas info    : Used 99 registers\n")
    assert "99 registers" in cb.build_log("rasterize_bwd")
    assert cb.build_log("rasterize_fwd") == ""
    with open(csrc / "blend.cuh", "a") as f:
        f.write("\n// an edit\n")
    assert cb.build_log("rasterize_bwd") == ""
