"""Builds and launches the CUDA C++ flash-attention kernel for Hopper.

The kernel (``csrc/flash_attention.cu``) replaces the JAX package's Pallas
TPU kernel ``repro/kernels/flash_attention/kernel.py:90``
``flash_attention``; its source note says what bounds it and how it is
laid out.  It is compiled at the first launch, never at import (the CPU
tests import this module without nvcc), by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v

into ``<repo>/build/kernels/``, as a shared library with a plain C
interface bound through ctypes.  The library's name carries a hash of the
source, so an edited source is rebuilt; ptxas's report (registers, shared
memory, spills per instantiation) is kept beside it in a ``.log`` file.
``nvcc`` is taken from ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``)
or the ``PATH``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_REPO = pathlib.Path(__file__).resolve().parents[4]
SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BUILD_DIR = _REPO / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_build_lock = threading.Lock()


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and the PATH); the flash "
                           "attention kernel is built at its first launch")
    return found


def _library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libflash_attention-{digest}.so"


def build() -> pathlib.Path:
    """Compile the kernel unless this source's library exists; returns its
    path.  Safe to call from several threads (one build runs)."""
    lib = _library_path()
    with _build_lock:
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        out, err = proc.communicate()
        lib.with_suffix(".log").write_text(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{err}")
        os.replace(tmp, lib)
    return lib


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build()))
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error.argtypes = [ctypes.c_int]
    lib.flash_attention_error.restype = ctypes.c_char_p
    return lib


def launch(q, k, v, out, *, causal, window, softcap):
    """Run the kernel on the current stream: q and out [B, H, L, D], k and
    v [B, K, S, D], CUDA tensors of one dtype (float32 or bfloat16) with a
    unit last stride, possibly non-contiguous views (the model layout
    ``[B, L, H, D]`` transposed).  The caller (``ops.py``) has checked
    every operand.  Raises if the launch is refused."""
    B, H, L, D = q.shape
    K, S = k.shape[1], k.shape[2]
    lib = _library()
    # the C side launches on the current device: the tensors' own, for
    # this call only
    with torch.cuda.device_of(q):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPE_CODES[q.dtype], B, H, K, L, S, D,
            *(q.stride(i) for i in range(3)),
            *(k.stride(i) for i in range(3)),
            *(v.stride(i) for i in range(3)),
            *(out.stride(i) for i in range(3)),
            int(causal), 0 if window is None else window, softcap,
            D ** -0.5, stream)
    if rc != 0:
        raise RuntimeError("flash attention kernel launch failed: "
                           f"{lib.flash_attention_error(rc).decode()} "
                           f"(cudaError {rc})")
