"""The earlier Triton echo-aggregate kernel, kept as a yardstick only.

The port's kernel for K1-K3 is the CUDA C++ one (``kernel.py``,
``csrc/echo_aggregate.cu``).  This one is reached only through
``ops._echo_aggregate_triton``, which ``chip_smoke.py`` times in turns with
it; no path of the port calls it and nothing falls back to it.

It computes the same function as the CUDA kernel, per column n:
``sum_i w_i (x_in - eta_g e_i (x_in - y_in)) / max(sum_i w_i, 1)``, and,
with ``HAS_GUARD``, ``g_n`` where ``sum_i w_i = 0``; the weights ``w`` come
in ready-made (the caller multiplies ``mask * upload``).  The grid runs
over column tiles of ``BLOCK_N``, and each program walks the client axis
in ``BLOCK_M``-row tiles, upcasting to float32 and keeping the column sums
and the weight total in registers.

Triton is imported, and the kernel compiled, at the first launch (never
at import: the CPU tests import this module without Triton).  The
compiled kernels are cached under ``<repo>/build/triton`` unless
``TRITON_CACHE_DIR`` is already set.
"""
from __future__ import annotations

import functools
import os
import pathlib

import torch

BLOCK_M = 16
BLOCK_N = 128
NUM_WARPS = 4

_REPO = pathlib.Path(__file__).resolve().parents[4]

#: ``triton.language``; bound at the first launch by ``_compiled``
tl = None


def _echo_aggregate_kernel(x_ptr, y_ptr, g_ptr, w_ptr, e_ptr, out_ptr, m, n,
                           stride_x, stride_y, eta_g,
                           HAS_GUARD: tl.constexpr, BLOCK_M: tl.constexpr,
                           BLOCK_N: tl.constexpr):
    pid = tl.program_id(0)
    cols = pid * BLOCK_N + tl.arange(0, BLOCK_N)
    col_ok = cols < n
    acc = tl.zeros((BLOCK_N,), dtype=tl.float32)
    wsum = tl.zeros((BLOCK_M,), dtype=tl.float32)
    for m0 in range(0, m, BLOCK_M):
        rows = m0 + tl.arange(0, BLOCK_M)
        row_ok = rows < m
        w = tl.load(w_ptr + rows, mask=row_ok, other=0.0)
        e = tl.load(e_ptr + rows, mask=row_ok, other=0.0)
        ok = row_ok[:, None] & col_ok[None, :]
        r = rows.to(tl.int64)[:, None]
        x = tl.load(x_ptr + r * stride_x + cols[None, :], mask=ok,
                    other=0.0).to(tl.float32)
        y = tl.load(y_ptr + r * stride_y + cols[None, :], mask=ok,
                    other=0.0).to(tl.float32)
        xd = x - eta_g * e[:, None] * (x - y)
        acc += tl.sum(w[:, None] * xd, axis=0)
        wsum += w
    total = tl.sum(wsum, axis=0)
    res = acc / tl.maximum(total, 1.0)
    if HAS_GUARD:
        g = tl.load(g_ptr + cols, mask=col_ok, other=0.0)
        res = tl.where(total > 0.0, res, g)
    tl.store(out_ptr + cols, res, mask=col_ok)


@functools.cache
def _compiled():
    os.environ.setdefault("TRITON_CACHE_DIR", str(_REPO / "build" / "triton"))
    import triton
    import triton.language

    globals()["tl"] = triton.language
    return triton.jit(_echo_aggregate_kernel)


def echo_aggregate_triton(x, y, g, w, echo, eta_g, *, has_guard):
    """Launch on the current stream.  x, y: contiguous [m, N] CUDA tensors
    (float32 or bfloat16); g: [N] float32 (read only with ``has_guard``);
    w, echo: [m] float32; ``eta_g`` a Python number.  Returns [N] float32.
    The caller (``ops._echo_aggregate_triton``) has checked every
    operand."""
    m, n = x.shape
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    grid = ((n + BLOCK_N - 1) // BLOCK_N,)
    _compiled()[grid](x, y, g, w, echo, out, m, n, x.stride(0),
                      y.stride(0), eta_g, HAS_GUARD=has_guard,
                      BLOCK_M=BLOCK_M, BLOCK_N=BLOCK_N, num_warps=NUM_WARPS)
    return out
