"""Plain torch version of flash attention: causal (optionally
sliding-window, soft-capped) multi-head attention with the full score
matrix, a port of ``repro/kernels/flash_attention/ref.py``.  It runs on
any device: the CPU path of ``ops.flash_mha``, and the oracle that
``chip_smoke.py`` holds the CUDA kernel against on the card."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def mha_ref(q, k, v, *, causal=True, window=None, softcap=0.0):
    """q: [B, H, L, D]; k, v: [B, H, S, D] -> [B, H, L, D].

    Scores in float32 (bf16 products are exact there, as under the
    reference's ``preferred_element_type=float32``); p is cast to v's
    dtype before p.v."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhld,bhsd->bhls", q.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    L, S = s.shape[-2], s.shape[-1]
    qp = torch.arange(L, device=q.device)[:, None] + (S - L)
    kp = torch.arange(S, device=q.device)[None, :]
    m = torch.ones((L, S), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (qp >= kp)
    if window is not None:
        m = m & (qp - kp < window)
    s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhls,bhsd->bhld", p.to(v.dtype), v)


def flash_mha_ref(q, k, v, *, causal=True, window=None, softcap=0.0):
    """Model layout, q: [B, L, H, D]; k, v: [B, S, K, D] -> [B, L, H, D]:
    each kv head repeated for its H / K query heads (the reference's
    ``flash_mha(use_pallas=False)``)."""
    G = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = mha_ref(qt, kt.repeat_interleave(G, 1), vt.repeat_interleave(G, 1),
                  causal=causal, window=window, softcap=softcap)
    return out.transpose(1, 2)
