"""Launches the CUDA C++ SSD intra-chunk kernel for Hopper.

The kernel (``csrc/ssd_chunk.cu``) replaces the JAX package's Pallas TPU
kernel ``repro/kernels/ssd_chunk/kernel.py:51`` ``ssd_chunk_pallas``; its
source note says what bounds it and how it is laid out.
``repro_torch.kernels.nvcc`` builds it at the first launch into
``<repo>/build/kernels/`` and loads it through ctypes.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.nvcc import CudaLibrary

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ssd_chunk.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib):
    fn = lib.ssd_chunk_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 20 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ssd_chunk_error.argtypes = [ctypes.c_int]
    lib.ssd_chunk_error.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("ssd_chunk", SOURCE, _bind)
build = LIBRARY.build


def launch(x, dA, B_, C_, y, states, decay):
    """Run the kernel on the current stream.  x and y [b, h, c, K, P], dA
    [b, h, c, K] float32, B_ and C_ [b, h, c, K, N]: CUDA views of any
    strides with a unit last stride (except dA's); states [b, h, c, N, P]
    and decay [b, h, c] contiguous float32.  The caller (``ops.py``) has
    checked every operand.  Raises if the launch is refused."""
    b, h, c, K, P = x.shape
    N = B_.shape[-1]
    lib = LIBRARY.load()
    with torch.cuda.device_of(x):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_chunk_fwd(
            x.data_ptr(), dA.data_ptr(), B_.data_ptr(), C_.data_ptr(),
            y.data_ptr(), states.data_ptr(), decay.data_ptr(),
            DTYPE_CODES[x.dtype], b, h, c, K, P, N,
            *x.stride()[:4], *dA.stride(), *B_.stride()[:4],
            *C_.stride()[:4], *y.stride()[:4], stream)
    if rc != 0:
        raise RuntimeError("SSD chunk kernel launch failed: "
                           f"{lib.ssd_chunk_error(rc).decode()} "
                           f"(cudaError {rc})")
