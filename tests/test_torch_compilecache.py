"""The port's kernel-library cache (``launch/compilecache``) and its key
(``launch/mesh.backend_cache_tag``).

The port compiles nothing but its CUDA kernels, each built by nvcc into a
shared library at its first launch (``kernels/nvcc.py``).  ``enable``
points that build directory at a keyed one, and ``counters`` reports the
libraries found built (hits) and the nvcc runs (misses).  On the CPU there
is no nvcc, so a stand-in library (the C math library this process has
loaded, copied to the hashed path of a kernel source) shows the hit, and
nvcc patched to fail shows the miss.  Every test restores the build
directory and the counters."""
import json
import os
import re
import shutil

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import nvcc  # noqa: E402
from repro_torch.launch import compilecache, mesh  # noqa: E402


@pytest.fixture(autouse=True)
def _restore(monkeypatch):
    monkeypatch.setattr(nvcc, "BUILD_DIR", nvcc.BUILD_DIR)
    monkeypatch.setattr(nvcc, "COUNTS", dict(nvcc.COUNTS))
    monkeypatch.setattr(compilecache, "_DIR", compilecache._DIR)


def _a_shared_library():
    """A loadable shared library to stand in for a built kernel."""
    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split()[-1]
            if re.search(r"/libm[.-].*\.so|/libm\.so", path):
                return path
    raise AssertionError("no libm mapped in this process")


def _library(tmp_path, name="standin"):
    src = tmp_path / f"{name}.cu"
    src.write_text("extern \"C\" int standin() { return 0; }\n")
    bound = []
    return nvcc.CudaLibrary(name, src, bound.append), bound


def test_backend_cache_tag_keys_version_and_backend():
    tag = mesh.backend_cache_tag()
    version = re.sub(r"[^A-Za-z0-9_.-]+", "-", torch.__version__)
    assert tag.startswith(f"torch{version}-")
    backend = ("cuda" + torch.version.cuda if torch.cuda.is_available()
               else "cpu-cpu")
    assert backend in tag
    # a directory name: path-safe characters only
    assert re.fullmatch(r"[A-Za-z0-9_.-]+", tag), tag
    assert ("-nvcc" in tag) == (nvcc.nvcc_path() is not None)


def test_backend_cache_tag_names_the_nvcc_release(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'Cuda compilation tools, release "
                    "12.8, V12.8.93'\n")
    fake.chmod(0o755)
    monkeypatch.setattr(nvcc, "nvcc_path", lambda: str(fake))
    assert mesh.nvcc_release() == "12.8"
    assert mesh.backend_cache_tag().endswith("-nvcc12.8")
    monkeypatch.setattr(nvcc, "nvcc_path", lambda: None)
    assert mesh.nvcc_release() is None
    assert "nvcc" not in mesh.backend_cache_tag()


def test_default_cache_dir_is_keyed_and_base_overridable(monkeypatch,
                                                         tmp_path):
    monkeypatch.setenv("REPRO_COMPILE_CACHE_BASE", str(tmp_path / "base"))
    assert compilecache.default_cache_dir() == os.path.join(
        str(tmp_path / "base"), mesh.backend_cache_tag())
    monkeypatch.delenv("REPRO_COMPILE_CACHE_BASE")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert compilecache.default_cache_dir() == os.path.join(
        str(tmp_path / "home"), ".cache", "repro-torch",
        mesh.backend_cache_tag())


def test_enable_resolves_and_repoints_the_build_directory(monkeypatch,
                                                          tmp_path):
    assert nvcc.BUILD_DIR == nvcc.REPO / "build" / "kernels"
    monkeypatch.setenv("REPRO_COMPILE_CACHE_BASE", str(tmp_path / "base"))
    for arg in ("", "auto"):
        path = compilecache.enable(arg)
        assert path == compilecache.default_cache_dir()
        assert os.path.isdir(path)
    target = tmp_path / "cc"
    path = compilecache.enable(str(target))
    assert path == str(target) and os.path.isdir(path)
    assert compilecache.cache_dir() == path
    assert str(nvcc.BUILD_DIR) == path
    lib, _ = _library(tmp_path)
    assert lib.path().parent == target


def test_a_built_library_is_a_hit(monkeypatch, tmp_path):
    """A library at its hashed path in the enabled directory loads
    without nvcc: one hit, no miss, its signatures bound once."""
    compilecache.enable(str(tmp_path / "cc"))
    lib, bound = _library(tmp_path)
    shutil.copy(_a_shared_library(), lib.path())

    def no_nvcc():
        raise AssertionError("nvcc must not run for a built library")

    monkeypatch.setattr(nvcc, "_nvcc", no_nvcc)
    before = compilecache.counters()
    loaded = lib.load()
    assert loaded is lib.load() and len(bound) == 1
    after = compilecache.counters()
    assert after["hits"] - before["hits"] == 1
    assert after["misses"] == before["misses"]


def test_a_missing_library_is_a_miss_and_raises(monkeypatch, tmp_path):
    """Without the library, the build counts a miss and nvcc's error
    propagates (nothing falls back)."""
    compilecache.enable(str(tmp_path / "cc"))
    lib, bound = _library(tmp_path)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(nvcc, "_nvcc", no_nvcc)
    before = compilecache.counters()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lib.load()
    after = compilecache.counters()
    assert after["misses"] - before["misses"] == 1
    assert after["hits"] == before["hits"] and not bound
    assert not lib.path().exists()


def test_the_flag_on_train_prints_the_path(capsys, tmp_path):
    from repro_torch.launch import train

    out = tmp_path / "run.json"
    train.main(["--compile-cache", str(tmp_path / "cc"), "--device", "cpu",
                "--flat-state", "--use-kernel", "--rounds", "2", "--m", "4",
                "--s", "1", "--batch", "4", "--n-samples", "400",
                "--out", str(out)])
    printed = capsys.readouterr().out
    assert f"compilation cache: {tmp_path / 'cc'}\n" in printed
    assert os.path.isdir(tmp_path / "cc")
    assert json.load(open(out))["args"]["compile_cache"] == \
        str(tmp_path / "cc")


def test_the_flag_on_experiments_prints_the_path(capsys, tmp_path):
    from repro_torch.launch import experiments

    experiments.main(["--scenario", "fedawe/sine", "--compile-cache",
                      str(tmp_path / "cc"), "--device", "cpu", "--seeds",
                      "2", "--rounds", "2", "--chunk-rounds", "2", "--m",
                      "4", "--s", "1", "--batch", "4", "--n-samples", "400",
                      "--no-save"])
    assert f"compilation cache: {tmp_path / 'cc'}\n" in \
        capsys.readouterr().out
