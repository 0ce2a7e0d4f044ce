"""Launches the CUDA C++ SSD intra-chunk kernels for Hopper.

Both replace the JAX package's Pallas TPU kernel
``repro/kernels/ssd_chunk/kernel.py:51`` ``ssd_chunk_pallas``; each source
note says what bounds it and how it is laid out:

* ``csrc/ssd_chunk_wgmma.cu``: bfloat16 operands on the tensor cores
  (TMA, ``wgmma``, one C.B^T per chunk for a run of heads);
* ``csrc/ssd_chunk.cu``: float32 operands, and bfloat16 ones that the
  tensor maps cannot describe, on the FP32 pipes.

``ops.wgmma_route`` chooses between them.  ``repro_torch.kernels.nvcc``
builds each at its first launch into ``<repo>/build/kernels/`` and loads
it through ctypes.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.nvcc import CudaLibrary

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "ssd_chunk.cu"
WGMMA_SOURCE = CSRC / "ssd_chunk_wgmma.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib):
    fn = lib.ssd_chunk_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 20 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ssd_chunk_error.argtypes = [ctypes.c_int]
    lib.ssd_chunk_error.restype = ctypes.c_char_p


def _bind_wgmma(lib):
    fn = lib.ssd_chunk_wgmma_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 20 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ssd_chunk_wgmma_error.argtypes = [ctypes.c_int]
    lib.ssd_chunk_wgmma_error.restype = ctypes.c_char_p
    lib.ssd_chunk_wgmma_smem.argtypes = [ctypes.c_int]
    lib.ssd_chunk_wgmma_smem.restype = ctypes.c_int


LIBRARY = CudaLibrary("ssd_chunk", SOURCE, _bind)
WGMMA_LIBRARY = CudaLibrary("ssd_chunk_wgmma", WGMMA_SOURCE, _bind_wgmma)
LIBRARIES = (LIBRARY, WGMMA_LIBRARY)


def wgmma_smem_bytes(N):
    """Dynamic shared memory of the tensor-core kernel's build for state
    width N."""
    return WGMMA_LIBRARY.load().ssd_chunk_wgmma_smem(N)


def _strides(x, dA, B_, C_, y):
    return (*x.stride()[:4], *dA.stride(), *B_.stride()[:4],
            *C_.stride()[:4], *y.stride()[:4])


def launch(x, dA, B_, C_, y, states, decay):
    """Run the FP32-pipe kernel on the current stream.  x and y
    [b, h, c, K, P], dA [b, h, c, K] float32, B_ and C_ [b, h, c, K, N]:
    CUDA views of any strides with a unit last stride (except dA's);
    states [b, h, c, N, P] and decay [b, h, c] contiguous float32.  The
    caller (``ops.py``) has checked every operand.  Raises if the launch is
    refused."""
    b, h, c, K, P = x.shape
    N = B_.shape[-1]
    lib = LIBRARY.load()
    with torch.cuda.device_of(x):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_chunk_fwd(
            x.data_ptr(), dA.data_ptr(), B_.data_ptr(), C_.data_ptr(),
            y.data_ptr(), states.data_ptr(), decay.data_ptr(),
            DTYPE_CODES[x.dtype], b, h, c, K, P, N,
            *_strides(x, dA, B_, C_, y), stream)
    if rc != 0:
        raise RuntimeError("SSD chunk kernel launch failed: "
                           f"{lib.ssd_chunk_error(rc).decode()} "
                           f"(cudaError {rc})")


def launch_wgmma(x, dA, B_, C_, y, states, decay, run):
    """Run the tensor-core kernel on the current stream: the operands of
    ``launch`` in bfloat16 (dA, states and decay float32) that
    ``ops.wgmma_route`` admits, ``run`` heads a block.  Raises if the
    launch is refused."""
    b, h, c, K, P = x.shape
    N = B_.shape[-1]
    lib = WGMMA_LIBRARY.load()
    with torch.cuda.device_of(x):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_chunk_wgmma_fwd(
            x.data_ptr(), dA.data_ptr(), B_.data_ptr(), C_.data_ptr(),
            y.data_ptr(), states.data_ptr(), decay.data_ptr(),
            b, h, c, K, P, N, *_strides(x, dA, B_, C_, y), run, stream)
    if rc != 0:
        raise RuntimeError("SSD chunk tensor-core kernel launch failed: "
                           f"{lib.ssd_chunk_wgmma_error(rc).decode()} "
                           f"(code {rc})")
