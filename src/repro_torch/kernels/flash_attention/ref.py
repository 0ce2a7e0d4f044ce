"""Plain torch version of flash attention: causal (optionally
sliding-window, soft-capped) multi-head attention with the full score
matrix, a port of ``repro/kernels/flash_attention/ref.py``.  It runs on
any device: the CPU path of ``ops.flash_mha``, and the oracle that
``chip_smoke.py`` holds the CUDA kernel against on the card."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38
#: the CUDA kernel's masked score (the TPU kernel's -1e38)
NEG_INF_K = -1.0e38


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


# ---------------------------------------------------------------------------
# The bfloat16 CUDA kernel's algorithm, tile by tile (a test oracle only:
# ops.flash_mha never calls it)
# ---------------------------------------------------------------------------

#: the kernel's tiles: 128 query rows a block, 64 a consumer warpgroup, 64
#: keys a key tile
BLOCK_M, WG_ROWS, BLOCK_N = 128, 64, 64
LOG2E = 1.4426950408889634


def block_key_tiles(L, S, causal, window, qt):
    """(t0, nt): the key tiles [t0, t0 + nt) the kernel loads for query
    tile ``qt`` (rows qt * BLOCK_M ..), the union of its rows' live keys."""
    r0 = qt * BLOCK_M
    off = S - L
    kb, ke = 0, S
    if causal:
        ke = min(ke, min(r0 + BLOCK_M, L) + off)
    if window is not None:
        kb = max(kb, r0 + off - window + 1)
    t0 = kb // BLOCK_N
    nt = (ke + BLOCK_N - 1) // BLOCK_N - t0 if ke > kb else 0
    return t0, nt


def edge_tile(L, S, causal, window, row_lo, key0):
    """Whether the kernel evaluates the masks on the key tile at ``key0``
    for the warpgroup whose rows start at ``row_lo``: some key past S, or
    some pair of its rows (those below L) that the causal or window mask
    drops."""
    off = S - L
    q_lo = row_lo + off
    q_hi = min(row_lo + WG_ROWS, L) - 1 + off
    return (key0 + BLOCK_N > S
            or (causal and key0 + BLOCK_N - 1 > q_lo)
            or (window is not None and key0 <= q_hi - window))


def flash_mha_tiled_ref(q, k, v, *, causal=True, window=None, softcap=0.0):
    """The bf16 kernel's algorithm in plain torch, model layout (q
    [B, L, H, D]; k, v [B, S, K, D]) -> [B, L, H, D]: per 128-query block
    the live key tiles of ``block_key_tiles``, per 64-row warpgroup an
    online softmax in base 2 over every such tile (scale * log2 e folded
    into one multiply, the soft-cap's tanh as 1 - 2 / (1 + 2^(2 y log2 e))),
    the masks only on the tiles ``edge_tile`` marks, keys past S as zeros,
    p rounded to v's dtype per tile before p.v and the row sum over the
    float32 p, then acc / max(l, 1e-30)."""
    B, L, H, D = q.shape
    S, G = k.shape[1], H // k.shape[2]
    scale = D ** -0.5
    cap = bool(softcap)
    c = 1.0 if cap else scale * LOG2E
    cap_in = 2.0 * scale * LOG2E / softcap if cap else 0.0
    cap_out = softcap * LOG2E
    qt_ = q.transpose(1, 2).float()                       # [B, H, L, D]
    pad = (-S) % BLOCK_N
    kt_, vt_ = (torch.nn.functional.pad(
        x.transpose(1, 2).repeat_interleave(G, 1), (0, 0, 0, pad))
        for x in (k, v))                                  # [B, H, S', D]
    out = torch.empty(B, H, L, D, dtype=torch.float32, device=q.device)
    off = S - L
    kpos = torch.arange(BLOCK_N, device=q.device)
    for qt in range((L + BLOCK_M - 1) // BLOCK_M):
        t0, nt = block_key_tiles(L, S, causal, window, qt)
        # warpgroups past L compute only rows the kernel never writes
        for row_lo in range(qt * BLOCK_M, min(qt * BLOCK_M + BLOCK_M, L),
                            WG_ROWS):
            rows = torch.arange(row_lo, min(row_lo + WG_ROWS, L),
                                device=q.device)
            qr = qt_[:, :, rows]
            qpos = (rows + off)[:, None]
            m = torch.full(qr.shape[:3] + (1,), NEG_INF_K, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros(qr.shape, device=q.device)
            for j in range(nt):
                key0 = (t0 + j) * BLOCK_N
                kk = kt_[:, :, key0:key0 + BLOCK_N]
                s = torch.einsum("bhld,bhsd->bhls", qr, kk.float())
                if cap:
                    s = cap_out - 2.0 * cap_out / (1.0 + torch.exp2(s * cap_in))
                if edge_tile(L, S, causal, window, row_lo, key0):
                    key = key0 + kpos[None, :]
                    ok = key < S
                    if causal:
                        ok = ok & (key <= qpos)
                    if window is not None:
                        ok = ok & (qpos - key < window)
                    s = s.masked_fill(~ok, NEG_INF_K)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                mc = torch.where(m_new == NEG_INF_K, 0.0, m_new) * c
                alpha = torch.exp2(m * c - mc)
                p = torch.exp2(s * c - mc)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + torch.einsum(
                    "bhls,bhsd->bhld", p.to(v.dtype).float(),
                    vt_[:, :, key0:key0 + BLOCK_N].float())
                m = m_new
            out[:, :, rows] = acc / l.clamp_min(1e-30)
    return out.to(q.dtype).transpose(1, 2)
