"""The port's kernel build (``repro_torch.kernels.build``): where a library
is built depends on its source, the headers it includes and the flags, so
an edited header rebuilds every kernel that includes it.  The tests
compute paths only and need no ``nvcc``."""
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the build reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def test_every_source_is_there_and_hashes():
    for name in build.SOURCES:
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"


@pytest.mark.parametrize("name", ["segment_sum", "segment_aggregate",
                                  "cloud_aggregate", "weighted_mean"])
def test_sources_list_the_header_they_include(name):
    files = build._with_headers(build.CSRC / f"{name}.cu")
    assert [f.name for f in files] == [f"{name}.cu", "segment_core.cuh"]


def test_editing_a_header_changes_the_path_of_its_includers(csrc):
    before = {name: build.library_path(name) for name in build.SOURCES}
    header = csrc / "segment_core.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    for name in build.SOURCES:
        includes = "segment_core.cuh" in (csrc / f"{name}.cu").read_text()
        assert (after[name] != before[name]) == includes, name
    for name in ("segment_sum", "segment_aggregate", "cloud_aggregate",
                 "weighted_mean"):
        assert after[name] != before[name], name


def test_editing_a_source_changes_only_its_path(csrc):
    before = {name: build.library_path(name) for name in build.SOURCES}
    src = csrc / "segment_sum.cu"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert [n for n in build.SOURCES if after[n] != before[n]] == \
        ["segment_sum"]


def test_a_nested_header_counts_too(csrc):
    (csrc / "inner.cuh").write_text("#pragma once\n")
    core = csrc / "segment_core.cuh"
    core.write_text('#include "inner.cuh"\n' + core.read_text())
    before = build.library_path("segment_sum")
    assert [f.name for f in build._with_headers(csrc / "segment_sum.cu")] \
        == ["segment_sum.cu", "segment_core.cuh", "inner.cuh"]
    (csrc / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert build.library_path("segment_sum") != before
