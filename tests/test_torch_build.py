"""The kernel build's cache key: a library is rebuilt when its source, a
shared header or the flags change, and only then. Needs no nvcc."""
import pytest

from batchelor_torch import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "shared.cuh"\nint a;\n')
    (src / "b.cu").write_text("int b;\n")
    (src / "shared.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    return src


@pytest.mark.parametrize("name", ["a", "b"])
def test_header_change_renames_every_library(name, csrc):
    before = _build._library_path(name)
    (csrc / "shared.cuh").write_text("#pragma once\nconstexpr int kTile = 128;\n")
    after = _build._library_path(name)
    assert after != before and after.parent == before.parent


def test_new_header_renames_the_library(csrc):
    before = _build._library_path("a")
    (csrc / "other.cuh").write_text("#pragma once\n")
    assert _build._library_path("a") != before


def test_source_change_renames_only_its_library(csrc):
    a, b = _build._library_path("a"), _build._library_path("b")
    (csrc / "a.cu").write_text('#include "shared.cuh"\nint a2;\n')
    assert _build._library_path("a") != a
    assert _build._library_path("b") == b


def test_unchanged_tree_keeps_its_library(csrc):
    (csrc / "notes.txt").write_text("not a source")
    assert _build._library_path("a") == _build._library_path("a")
    assert _build._library_path("a").name.startswith("liba-")


def test_flags_change_renames_the_library(csrc, monkeypatch):
    before = _build._library_path("a")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._library_path("a") != before


def test_built_library_is_found_without_nvcc(csrc, monkeypatch):
    out = _build._library_path("a")
    out.parent.mkdir(parents=True)
    out.write_bytes(b"")
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("nvcc was called"))
    assert _build.build(["a"]) == 0.0
