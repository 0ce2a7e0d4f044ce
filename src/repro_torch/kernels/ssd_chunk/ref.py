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


# ---------------------------------------------------------------------------
# The bfloat16 tensor-core kernel's arithmetic (csrc/ssd_chunk_wgmma.cu), a
# test oracle only: ops.ssd_chunk never calls it
# ---------------------------------------------------------------------------

#: wgmma's k-step; the bf16 terms of S in y = S.x and of w o x in the
#: states; the largest exponent of L's factor E (the kernel's kMaxE)
KSTEP, S_TERMS, W_TERMS, MAX_E = 16, 2, 3, 80.0


def bf16_terms(v, n):
    """float32 ``v`` as ``n`` bf16-valued float32 tensors that sum to it:
    the first is v rounded to bf16, each next one the rest rounded."""
    out = []
    for _ in range(n):
        t = v.to(torch.bfloat16).float()
        out.append(t)
        v = v - t
    return out


def kstep_matmul(terms, b, acc=None):
    """sum_e terms[e] @ b in float32 as the kernel's wgmmas accumulate it:
    for each k-step of KSTEP, for each term, the step's products summed
    exactly (bf16 products are exact; float64 here) and rounded to
    float32, then added to the float32 accumulator."""
    for k0 in range(0, b.shape[-2], KSTEP):
        bk = b[..., k0:k0 + KSTEP, :].double()
        for t in terms:
            part = (t[..., k0:k0 + KSTEP].double() @ bk).float()
            acc = part if acc is None else acc + part
    return acc


def l_fast(dA, K):
    """Whether the kernel takes L from its factors R and E for each
    (b, h, c): no dA > 0 in the chunk's K rows and every exponent of E at
    most MAX_E.  dA [..., K] float32."""
    a = torch.cumsum(dA.double(), -1)
    ref = a[..., (torch.arange(K, device=dA.device) // KSTEP) * KSTEP]
    e = (ref - a).float()
    return (dA <= 0).all(-1) & (e <= MAX_E).all(-1)


def ssd_chunk_tiled_ref(xdt, dA, B_, C_, w_terms=W_TERMS):
    """The bf16 kernel's algorithm in plain torch; the operands and results
    of ``ssd_chunk_ref``.

    a_cs in float64; G = C.B^T in k-steps of 16 (once for all heads when B
    and C are stride-0 over them, as the kernel computes it once for a run
    of heads); L = R[i, kk] E[j] with kk = j // 16, m = i // 16,
    E = exp(a_cs[16 kk] - a_cs[j]) and R = exp(a_cs[16 m] - a_cs[16 kk])
    exp(a_cs[i] - a_cs[16 m]) where ``l_fast`` holds, else exp(a_cs[i] -
    a_cs[j]), every exponent a float64 difference rounded to float32; S =
    G L, exactly 0 above the diagonal; y = S.x
    with S in S_TERMS bf16 terms, rounded to x's dtype; w = exp(a_cs[K-1]
    - a_cs), states^T = (w o x)^T.B with w o x in ``w_terms`` bf16 terms
    (the kernel's W_TERMS; fewer to show what they would cost); decay =
    exp(a_cs[K-1])."""
    f32 = torch.float32
    K = xdt.shape[-2]
    dev = xdt.device
    x, Bf, Cf = (t.to(f32) for t in (xdt, B_, C_))
    a = torch.cumsum(dA.double(), -1)                            # [b,h,c,K]
    if B_.stride(1) == 0 and C_.stride(1) == 0:
        G = kstep_matmul([Cf[:, :1]], Bf[:, :1].transpose(-1, -2))
        G = G.expand(Bf.shape[:-2] + (K, K))
    else:
        G = kstep_matmul([Cf], Bf.transpose(-1, -2))             # [...,K,K]
    idx = torch.arange(K, device=dev)
    blk = (idx // KSTEP) * KSTEP
    ref = a[..., blk]                                 # a[16 kk(j)], a[16 m(i)]
    e = (ref - a).float()
    E = torch.exp(e)                                  # [..., K]
    D = torch.exp((ref[..., :, None] - ref[..., None, :]).float())  # [.., i, j]
    R = D * torch.exp(-e)[..., :, None]
    L_fast = R * E[..., None, :]
    L_direct = torch.exp((a[..., :, None] - a[..., None, :]).float())
    fast = l_fast(dA, K)[..., None, None]
    L = torch.where(fast, L_fast, L_direct)
    lower = idx[:, None] >= idx[None, :]
    S = torch.where(lower, G * L, torch.zeros((), dtype=f32, device=dev))
    y = kstep_matmul(bf16_terms(S, S_TERMS), x)
    w = torch.exp((a[..., -1:] - a).float())
    v = w[..., None] * x                                         # [..., K, P]
    st = kstep_matmul([t.transpose(-1, -2) for t in bf16_terms(v, w_terms)],
                      Bf)                                        # [..., P, N]
    return (y.to(xdt.dtype), st.transpose(-1, -2).contiguous(),
            torch.exp(a[..., -1].float()))
