"""Builds a CUDA C++ kernel source into a shared library and loads it.

Each CUDA kernel of the port (``*/csrc/*.cu``) has a plain C interface and
is compiled at its first launch, never at import (the CPU tests import
every module, and the CPU has no nvcc), by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v

into ``<repo>/build/kernels/lib<name>-<hash>.so`` and bound through
ctypes.  The hash covers the source and the flags, so an edited source
is rebuilt; ptxas's report (registers, shared memory, spills per
instantiation) is kept beside the library in a ``.log`` file.  ``nvcc``
is taken from ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``) or the
``PATH``.  ``launch/compilecache.enable`` points the build directory
elsewhere (``set_build_dir``); ``COUNTS`` counts the libraries found
built (``hits``) and the nvcc runs (``misses``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

REPO = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: libraries found already built (``hits``) and nvcc runs (``misses``)
#: in this process
COUNTS = {"hits": 0, "misses": 0}


def set_build_dir(path) -> pathlib.Path:
    """Build and look up every library under ``path`` from now on (a
    library already loaded in this process stays loaded)."""
    global BUILD_DIR
    BUILD_DIR = pathlib.Path(path)
    return BUILD_DIR


def nvcc_path():
    """nvcc's path, or None when there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else shutil.which("nvcc")


def _nvcc():
    found = nvcc_path()
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and the PATH); the CUDA "
                           "kernels are built at their first launch")
    return found


class CudaLibrary:
    """One ``.cu`` source, built once and loaded once per process.

    ``bind(lib)`` sets the ctypes signatures of the library's C entry
    points; it runs once, when the library is first loaded."""

    def __init__(self, name: str, source: pathlib.Path, bind):
        self.name, self.source, self._bind = name, source, bind
        self._lock = threading.Lock()
        self._lib = None

    def path(self) -> pathlib.Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.name}-{digest[:12]}.so"

    def build(self) -> pathlib.Path:
        """Compile unless this source's library exists; returns its path.
        Safe to call from several threads (one build runs)."""
        lib = self.path()
        with self._lock:
            if lib.exists():
                COUNTS["hits"] += 1
                return lib
            COUNTS["misses"] += 1
            lib.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            out, err = proc.communicate()
            lib.with_suffix(".log").write_text(" ".join(cmd) + "\n" + out
                                               + err)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} "
                                   f"({proc.returncode}):\n{err}")
            os.replace(tmp, lib)
        return lib

    def load(self) -> ctypes.CDLL:
        """The built library with its signatures set.  Once loaded, it is
        returned without hashing the source again (every launch calls
        this; hashing took ~0.5 ms a call)."""
        if self._lib is not None:
            return self._lib
        path = self.build()
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(path))
                self._bind(lib)
                self._lib = lib
        return self._lib
