"""The port's CUDA build cache (`accelerate_tpu_torch/csrc`): a library's
path is keyed on everything its source compiles from, so an edit to a
shared header, or to the flags, builds anew instead of loading a stale
library. Runs on the CPU: computing the key builds nothing."""

import shutil

import pytest

from accelerate_tpu_torch import csrc


@pytest.fixture
def src_copy(tmp_path, monkeypatch):
    """A copy of the CUDA sources, with the cache pointed at it."""
    for f in list(csrc.SRC_DIR.glob("*.cu")) + \
            list(csrc.SRC_DIR.glob("*.cuh")):
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(csrc, "SRC_DIR", tmp_path)
    monkeypatch.setattr(csrc, "BUILD_DIR", tmp_path / "_build")
    return tmp_path


def test_every_source_includes_only_headers_of_this_directory():
    """The key covers the directory's `*.cuh`; a source that included a
    header from elsewhere in the repo would escape it."""
    headers = {p.name for p in csrc.SRC_DIR.glob("*.cuh")}
    assert "hopper.cuh" in headers
    for src in csrc.SRC_DIR.glob("*.cu"):
        for line in src.read_text().splitlines():
            if line.startswith('#include "'):
                assert line.split('"')[1] in headers, (src.name, line)


@pytest.mark.parametrize("name", csrc.sources())
def test_a_header_edit_changes_the_library_path(src_copy, name):
    before = csrc._lib_path(name)
    assert before == csrc._lib_path(name)          # stable
    assert before.parent == src_copy / "_build"
    hdr = src_copy / "hopper.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert csrc._lib_path(name) != before


@pytest.mark.parametrize("name", csrc.sources())
def test_source_and_flag_edits_change_the_library_path(src_copy,
                                                       monkeypatch, name):
    before = csrc._lib_path(name)
    src = src_copy / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    edited = csrc._lib_path(name)
    assert edited != before
    monkeypatch.setattr(csrc, "NVCC_FLAGS", csrc.NVCC_FLAGS + ("-lineinfo",))
    assert csrc._lib_path(name) != edited


def test_another_sources_edit_keeps_the_library_path(src_copy):
    before = csrc._lib_path("paged_decode")
    other = src_copy / "flash_attention.cu"
    other.write_text(other.read_text() + "\n// edited\n")
    assert csrc._lib_path("paged_decode") == before
