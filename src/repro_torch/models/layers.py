"""Core neural layers: RMSNorm, RoPE, GQA attention (full / sliding-window /
query-chunked), gated MLP, as functions on tensors; a port of
``repro/models/layers.py`` with the same names and layouts.

Conventions
-----------
  B batch, L query length, S key length, H query heads, K kv heads,
  G = H // K query heads per kv head, D head dim.
Activations flow in ``cfg.dtype``; softmax statistics, scores and norms
are computed in float32 (bf16 operands are upcast before a score product,
which is exact there, as under the reference's
``preferred_element_type=float32``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.models.placed import (decode_attention, grad_like_forward,
                                       heads_back, is_placed,
                                       local_attention, local_swiglu,
                                       placed_like, project, split_heads,
                                       write_cache)

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# norms / elementwise
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps))
            * (1.0 + gamma.float())).to(x.dtype)


def softcap(x, cap):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def swiglu(x, wi, wd, *, train=False):
    """Fused gate+up projection: wi [d, 2*ff], wd [ff, d].  ``train``
    over DTensors: ``placed.local_swiglu``'s placements."""
    if train and is_placed(x):
        return local_swiglu(x, wi, wd)
    g, u = (x @ wi).chunk(2, dim=-1)
    return (F.silu(g) * u) @ wd


# ---------------------------------------------------------------------------
# rotary embeddings (split halves, not interleaved pairs; angles in f32)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim, theta, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta):
    """x: [..., L, n_heads, D]; positions: [..., L] (int)."""
    inv = placed_like(rope_freqs(x.shape[-1], theta, x.device), positions,
                      replicate=True)  # [D/2]
    ang = positions[..., None].float() * inv  # [..., L, D/2]
    sin = torch.sin(ang)[..., None, :]  # broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention masks
# ---------------------------------------------------------------------------

def causal_window_mask(q_pos, k_pos, window=None, causal=True):
    """Boolean [.., L, S] mask: True = attend.

    q_pos: [..., L], k_pos: [..., S] absolute positions.
    """
    d = q_pos[..., :, None] - k_pos[..., None, :]
    m = torch.ones_like(d, dtype=torch.bool)
    if causal:
        m = m & (d >= 0)
    if window is not None:
        m = m & (d < window)
    return m


# ---------------------------------------------------------------------------
# grouped-query attention
# ---------------------------------------------------------------------------

def _gqa_scores(q, k, scale, cap):
    """q: [B,L,K,G,D], k: [B,S,K,D] -> [B,K,G,L,S] (f32)."""
    s = torch.einsum("blkgd,bskd->bkgls", q.float(), k.float()) * scale
    if cap:
        s = softcap(s, cap)
    return s


def _gqa_out(p, v):
    """p: [B,K,G,L,S] , v: [B,S,K,D] -> [B,L,K*G,D]."""
    o = torch.einsum("bkgls,bskd->blkgd", p.to(v.dtype), v)
    B, L, K, G, D = o.shape
    return o.reshape(B, L, K * G, D)


class _Recompute(torch.autograd.Function):
    """``body(*args)`` whose backward recomputes it from ``args`` (a
    checkpoint that saves only its inputs).  It is an autograd Function
    with a generated vmap rule, so it also holds inside ``torch.func.vmap``
    (the LM loss's client map) with the gradient taken outside, where
    ``torch.utils.checkpoint`` cannot replay."""
    generate_vmap_rule = True

    @staticmethod
    def forward(body, *args):
        return body(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.body = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, grad):
        _, pullback = torch.func.vjp(ctx.body, *ctx.saved_tensors)
        return (None,) + tuple(pullback(grad))


def attention(q, k, v, q_pos, k_pos, *, window=None, causal=True,
              attn_softcap=0.0, q_chunk=0):
    """Grouped-query scaled dot-product attention.

    q: [B, L, H, D]; k, v: [B, S, K, D]. Returns [B, L, H, D].
    q_chunk > 0 evaluates the queries in chunks of q_chunk: peak memory
    drops from O(L*S) to O(q_chunk*S) per (kv-)head without changing the
    math.  Each chunk is checkpointed (``_Recompute``), as in the
    reference: a backward recomputes the chunk's score block instead of
    keeping every chunk's.
    """
    B, L, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, L, K, G, D)
    scale = D ** -0.5

    def block(q_blk, qp_blk, k, v):
        s = _gqa_scores(q_blk, k, scale, attn_softcap)  # [B,K,G,l,S]
        m = causal_window_mask(qp_blk, k_pos, window=window, causal=causal)
        m = m[:, None, None]  # [B,1,1,l,S]
        p = torch.softmax(s.masked_fill(~m, NEG_INF), dim=-1)
        return _gqa_out(p, v)

    if q_chunk and L > q_chunk and L % q_chunk == 0:
        def chunk(i):
            qp = q_pos[:, i:i + q_chunk]
            return _Recompute.apply(lambda qb, kk, vv: block(qb, qp, kk, vv),
                                    qg[:, i:i + q_chunk], k, v)

        return torch.cat([chunk(i) for i in range(0, L, q_chunk)], dim=1)
    return block(qg, q_pos, k, v)


def attention_decode(q, k_cache, v_cache, q_pos, cache_pos, *, window=None,
                     attn_softcap=0.0):
    """Single-token decode attention against a (possibly rolling) cache.

    q: [B, 1, H, D]; caches: [B, Sc, K, D] where Sc = allocated cache length
    (== window for rolling caches). cache_pos: [B, Sc] absolute position held
    in each cache slot (-1 = empty). q_pos: [B, 1].
    """
    def scores(q, k_cache, q_pos, cache_pos):
        B, _, H, D = q.shape
        K = k_cache.shape[2]
        qg = q.reshape(B, 1, K, H // K, D)
        s = _gqa_scores(qg, k_cache, D ** -0.5, attn_softcap)  # [B,K,G,1,Sc]
        valid = (cache_pos >= 0) & (cache_pos <= q_pos)  # [B,Sc]
        if window is not None:
            valid = valid & (q_pos - cache_pos < window)
        return s.masked_fill(~valid[:, None, None, None, :], NEG_INF)

    if is_placed(k_cache):
        return decode_attention(scores, q, k_cache, v_cache, q_pos,
                                cache_pos)
    s = scores(q, k_cache, q_pos, cache_pos)
    return _gqa_out(torch.softmax(s, dim=-1), v_cache)  # [B,1,H,D]


# ---------------------------------------------------------------------------
# attention block application
# ---------------------------------------------------------------------------

def _merged_heads(out, B, L, cfg):
    """The attention output ``[B, L, H, D]`` viewed ``[B, L, H·D]``, its
    gradient brought back to the view's placements over DTensors
    (``grad_like_forward``): the output projection's backward may return
    it sharded over more ranks than the heads divide into, which the
    view's backward cannot split."""
    return grad_like_forward(out.reshape(B, L, cfg.q_dim))


def attn_qkvo(x, bp, cfg, positions, *, lora=None, kv_override=None,
              decode_cache=None, prefill_cache=None, window=None,
              causal=True, train=False):
    """Compute one attention sub-block given params dict ``bp``.

    lora: the block's adapters (``a_n`` [in, r], ``b_n`` [r, out] for n in
    q, k, v, o) or None: each projection adds ``rank**-0.5 * (in @ a_n) @
    b_n``, cast to the projection's dtype (q, k and v on x, o on the
    attention output), as ``repro/models/layers.py:183-188, 243-244``.
    kv_override: (k, v, k_pos) for cross-attention: q is projected and
    roped, k and v are taken as given (unroped), and the plain
    bidirectional attention runs whatever the backend, as in the
    reference.
    decode_cache: dict(k, v, pos, slot) for single-token decode.
    prefill_cache: dict(k, v, pos) — full-sequence forward that also writes
    the (last `alloc`) K/V entries into the cache.
    causal: the self-attention's mask (the encoder's is bidirectional).
    train: the training forward; over DTensors every projection goes
    through ``placed.project`` and the attention region splits what it
    would replicate (``placed.local_attention``).
    Returns the block's output.  Unlike the reference, which returns new
    cache arrays beside it, the caches are updated IN PLACE.
    """
    B, L, _ = x.shape

    def merged(out):
        o = _merged_heads(out, B, L, cfg)
        return heads_back(o, x) if train else o

    def proj(inp, name):
        ab = None if lora is None else (lora[f"a_{name}"],
                                        lora[f"b_{name}"])
        if train:
            return project(inp, bp[f"w{name}"], ab, cfg.lora_rank ** -0.5)
        y = inp @ bp[f"w{name}"]
        if ab is not None:
            r = (inp @ ab[0]) @ ab[1]
            y = y + (cfg.lora_rank ** -0.5) * r.to(y.dtype)
        return y

    q = split_heads(proj(x, "q"), cfg.n_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    if kv_override is not None:
        k, v, k_pos = kv_override

        def cross(q, k, v, q_pos, k_pos):
            return attention(q, k, v, q_pos, k_pos, window=None,
                             causal=False, attn_softcap=cfg.attn_softcap,
                             q_chunk=cfg.attn_chunk)
        out = local_attention(cross, q, k, v, positions, k_pos,
                              keep_seq=True, train=train)
        return proj(merged(out), "o")
    k = split_heads(proj(x, "k"), cfg.n_kv_heads, cfg.head_dim)
    v = split_heads(proj(x, "v"), cfg.n_kv_heads, cfg.head_dim)
    k = apply_rope(k, positions, cfg.rope_theta)
    if decode_cache is not None:
        if L != 1:
            raise ValueError(f"decode takes one token per row; got L={L}")
        slot = decode_cache["slot"][:, None]  # [B, 1] — write index
        k_cache, v_cache = decode_cache["k"], decode_cache["v"]
        cache_pos = decode_cache["pos"]
        for dst, val in ((k_cache, k), (v_cache, v), (cache_pos, positions)):
            write_cache(dst, slot, val)
        out = attention_decode(q, k_cache, v_cache, positions, cache_pos,
                               window=window, attn_softcap=cfg.attn_softcap)
    else:
        use_flash = (cfg.attn_backend == "flash"
                     and prefill_cache is not None
                     and L % 128 == 0 and cfg.head_dim % 8 == 0)
        if use_flash:
            def core(q, k, v, q_pos, k_pos):
                return flash_mha(q, k, v, causal=causal, window=window,
                                 softcap=cfg.attn_softcap)
        else:
            def core(q, k, v, q_pos, k_pos):
                return attention(q, k, v, q_pos, k_pos, window=window,
                                 causal=causal,
                                 attn_softcap=cfg.attn_softcap,
                                 q_chunk=cfg.attn_chunk)
        out = local_attention(core, q, k, v, positions, positions,
                              keep_seq=not use_flash, train=train)
        if prefill_cache is not None:
            alloc = prefill_cache["k"].shape[1]
            take = min(L, alloc)
            slots = positions[:, L - take:] % alloc  # [B, take]
            for name, val in (("k", k), ("v", v), ("pos", positions)):
                write_cache(prefill_cache[name], slots, val[:, L - take:])
    return proj(merged(out), "o")
