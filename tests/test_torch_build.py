"""The kernel build helper of the PyTorch port, on a machine without a
CUDA toolkit: nothing is built at import, a missing ``nvcc`` and a
failed launch raise with a message, and a library's file name follows
its source so an edited kernel is never served from a stale build."""

import pytest

from realhf_tpu_torch.ops import _build


def test_every_source_exists_and_names_its_library():
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
        assert _build.library_path(name).parent == _build.BUILD_DIR
        assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_library_name_follows_source(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path("k")
    src.write_text("// two\n")
    assert _build.library_path("k") != first
    src.write_text("// one\n")
    assert _build.library_path("k") == first


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.Path, "exists", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_nothing_to_build_is_a_no_op(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.build([]) == {}


def test_launch_error_codes_raise():
    _build.check(0, "k")
    with pytest.raises(RuntimeError, match="cudaError 98"):
        _build.check(98, "k")


def test_library_name_follows_shared_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text('#include "tile.cuh"\n')
    header = tmp_path / "tile.cuh"
    header.write_text("// one\n")
    first = _build.library_path("k")
    header.write_text("// two\n")
    assert _build.library_path("k") != first
    header.write_text("// one\n")
    assert _build.library_path("k") == first
    (tmp_path / "other.cuh").write_text("// new\n")
    assert _build.library_path("k") != first


def test_shared_header_is_on_the_include_path(tmp_path, monkeypatch):
    # the compiler command names csrc/ with -I (nvcc itself is faked)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    (tmp_path / "k.cu").write_text("// k\n")
    seen = []

    class Done:
        returncode = 1

        def __init__(self, cmd, **kw):
            seen.append(cmd)

        def communicate(self):
            return "", None

    monkeypatch.setattr(_build.subprocess, "Popen", Done)
    with pytest.raises(RuntimeError, match="nvcc failed for k.cu"):
        _build.build(["k"])
    cmd = seen[0]
    assert cmd[cmd.index("-I") + 1] == str(tmp_path)
