"""Launches the CUDA C++ echo-aggregate kernel for Hopper.

``csrc/echo_aggregate.cu`` replaces the JAX package's Pallas TPU kernels
in ``repro/kernels/echo_aggregate/kernel.py``: ``echo_aggregate_fused_pallas``
(kernel.py:100, with and without ``upload=``) and ``echo_aggregate_pallas``
(kernel.py:48), one template with the guard and the upload weights as
flags.  Its source note says what bounds it and how it is laid out.
``repro_torch.kernels.nvcc`` builds it at its first launch into
``<repo>/build/kernels/`` and loads it through ctypes.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.nvcc import CudaLibrary

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "echo_aggregate.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib):
    fn = lib.echo_aggregate_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                   + [ctypes.c_longlong] * 2 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.echo_aggregate_error.argtypes = [ctypes.c_int]
    lib.echo_aggregate_error.restype = ctypes.c_char_p
    lib.echo_aggregate_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.echo_aggregate_smem.restype = ctypes.c_int
    lib.echo_aggregate_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_void_p]
    lib.echo_aggregate_occupancy.restype = ctypes.c_int


LIBRARY = CudaLibrary("echo_aggregate", SOURCE, _bind)


def smem_bytes(dtype, slices):
    """Dynamic shared memory one block of the kernel takes for stacks of
    ``dtype`` at ``slices`` row slices."""
    return LIBRARY.load().echo_aggregate_smem(DTYPE_CODES[dtype], slices)


def occupancy(slices):
    """(blocks resident on one SM, clusters of ``slices`` blocks resident
    on the current card) for the kernel's float32 build."""
    lib = LIBRARY.load()
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.echo_aggregate_occupancy(slices, ctypes.byref(blocks),
                                      ctypes.byref(clusters))
    if rc != 0:
        raise RuntimeError("echo-aggregate occupancy query failed: "
                           f"{lib.echo_aggregate_error(rc).decode()}")
    return blocks.value, clusters.value


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch(x, y, g, mask, upload, echo, out, eta_g, *, guard, block_cols,
           slices, seeds=1):
    """Run the kernel on the current stream.  x, y: contiguous [m, N] CUDA
    tensors (float32 or bfloat16); g ([N], read only with ``guard``),
    mask, echo, upload ([m]; ``upload`` may be None, and needs ``guard``)
    and out ([N]) contiguous float32; ``block_cols`` and ``slices`` from
    ``ops.launch_geometry``.  With ``seeds`` S > 1 every operand has a
    leading seed axis ([S, m, N], [S, N], [S, m]) and the one launch
    covers them all.  The caller (``ops.py``) has checked every operand.
    Raises if the launch is refused."""
    m, n = x.shape[-2:]
    lib = LIBRARY.load()
    with torch.cuda.device_of(x):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.echo_aggregate_fwd(
            x.data_ptr(), y.data_ptr(), _ptr(g), mask.data_ptr(),
            _ptr(upload), echo.data_ptr(), out.data_ptr(),
            DTYPE_CODES[x.dtype], int(guard), m, n, eta_g, block_cols,
            slices, seeds, stream)
    if rc != 0:
        raise RuntimeError("echo-aggregate kernel launch failed: "
                           f"{lib.echo_aggregate_error(rc).decode()} "
                           f"(cudaError {rc})")
