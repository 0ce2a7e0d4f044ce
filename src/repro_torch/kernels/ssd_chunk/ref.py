"""Plain torch version of the SSD intra-chunk block, a port of
``repro/kernels/ssd_chunk/ref.py``: per (batch, head, chunk) the
diagonal-block output, the chunk's end-state contribution and the chunk
decay.  It runs on any device: the CPU path of ``ops.ssd_chunk``, and the
oracle that ``chip_smoke.py`` holds the CUDA kernel against on the card.

Cumulative sums over a chunk are taken in float64 and rounded to float32
(``cumsum_f32``).  On the CPU this is what ``torch.cumsum`` of float32
does anyway (it accumulates in float64); on the card it fixes the order
of the sum, which the reference's 1e-6 bound on the decay needs."""
from __future__ import annotations

import torch


def cumsum_f32(x, dim=-1):
    """cumsum along ``dim``, accumulated in float64, as float32."""
    return torch.cumsum(x.double(), dim).float()


def segsum(x):
    """x: [..., T] -> [..., T, T] with out[i, j] = sum_{k=j+1..i} x_k (i>=j),
    -inf above the diagonal; a port of ``repro/models/ssm.py`` ``segsum``."""
    T = x.shape[-1]
    xx = x[..., :, None].expand(x.shape + (T,))  # out[..., i, j] = x_i
    lower = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device),
                       -1)
    xx = torch.where(lower, xx, torch.zeros((), dtype=x.dtype,
                                            device=x.device))
    seg = cumsum_f32(xx, -2).to(x.dtype)
    keep = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~keep, float("-inf"))


def ssd_chunk_ref(xdt, dA, B_, C_):
    """xdt: [b,h,c,K,P]; dA: [b,h,c,K]; B_, C_: [b,h,c,K,N].

    Returns (y_diag [b,h,c,K,P] in xdt's dtype, states float32
    [b,h,c,N,P], decay float32 [b,h,c])."""
    f32 = torch.float32
    A = dA.to(f32)
    A_cs = cumsum_f32(A)
    L = torch.exp(segsum(A))                                    # [b,h,c,K,K]
    S = torch.einsum("bhcin,bhcjn->bhcij", C_.to(f32), B_.to(f32)) * L
    y = torch.einsum("bhcij,bhcjp->bhcip", S, xdt.to(f32))
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)             # [b,h,c,K]
    states = torch.einsum("bhck,bhckn,bhckp->bhcnp", decay_states,
                          B_.to(f32), xdt.to(f32))
    return y.to(xdt.dtype), states.to(f32), torch.exp(A_cs[..., -1])
