"""Launches the CUDA C++ flash-attention kernel for Hopper.

The kernel (``csrc/flash_attention.cu``) replaces the JAX package's Pallas
TPU kernel ``repro/kernels/flash_attention/kernel.py:90``
``flash_attention``; its source note says what bounds it and how it is
laid out.  ``repro_torch.kernels.nvcc`` builds it at the first launch into
``<repo>/build/kernels/`` and loads it through ctypes.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.nvcc import CudaLibrary

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib):
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error.argtypes = [ctypes.c_int]
    lib.flash_attention_error.restype = ctypes.c_char_p
    lib.flash_attention_bf16_smem.argtypes = [ctypes.c_int]
    lib.flash_attention_bf16_smem.restype = ctypes.c_int


LIBRARY = CudaLibrary("flash_attention", SOURCE, _bind)
build = LIBRARY.build


def bf16_smem_bytes(D):
    """Dynamic shared memory of the bf16 kernel's build for head dim D."""
    return LIBRARY.load().flash_attention_bf16_smem(D)


def launch(q, k, v, out, *, causal, window, softcap):
    """Run the kernel on the current stream: q and out [B, H, L, D], k and
    v [B, K, S, D], CUDA tensors of one dtype (float32 or bfloat16) with a
    unit last stride, possibly non-contiguous views (the model layout
    ``[B, L, H, D]`` transposed).  The caller (``ops.py``) has checked
    every operand.  Raises if the launch is refused."""
    B, H, L, D = q.shape
    K, S = k.shape[1], k.shape[2]
    lib = LIBRARY.load()
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
