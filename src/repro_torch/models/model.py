"""Unified model, dense attention, MoE and Mamba2 / shared-attention
blocks: parameter init, the unit loop, logits, caches, prefill and
decode; a port of ``repro/models/model.py``.

The layer stack is grouped into repeating *units* (cfg.pattern).  Weights
and caches of the full units are stacked on a leading ``[n_units]`` axis,
as in the reference, and a Python loop over the units indexes that axis
(the reference's ``lax.scan``); the remainder ("tail") follows.  The
parameter tree has the reference's keys and shapes, so a JAX tree carries
across through ``repro_torch.checkpointing.params_from_numpy``.
``shared_attn`` blocks hold no weights of their own: every invocation
reads the one attention block ``params["shared"]``, each with its own
cache.

An MoE block is an attention block whose gated MLP is ``moe.moe_ffn``;
the stack sums its router losses as the reference does.  Encoder-decoder
models, modality frontends and LoRA raise NotImplementedError naming the
ROADMAP item that ports them.  Caches are updated in place (the
reference returns new ones): ``prefill`` and ``serve_step`` write into
the cache they are given and return it.
"""
from __future__ import annotations

import itertools
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models import ssm
from repro_torch.models.config import BlockCfg, ModelConfig
from repro_torch.models.layers import attn_qkvo, rms_norm, softcap, swiglu
from repro_torch.models.moe import moe_ffn

_TODO = {
    "enc_dec": "encoder-decoder models are ROADMAP queue 1 item 16",
    "frontend": "modality frontends (stub embeddings) are ROADMAP queue 1 "
                "item 16",
    "lora": "fl_mode='lora' belongs to LM training, ROADMAP queue 1 item 3",
}

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dt(cfg):
    return DTYPES[cfg.dtype]


def check_supported(cfg: ModelConfig):
    """Raise NotImplementedError for what this slice does not run."""
    if cfg.enc_dec:
        raise NotImplementedError(f"{cfg.name}: {_TODO['enc_dec']}")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: {_TODO['frontend']}")
    if cfg.fl_mode == "lora":
        raise NotImplementedError(f"{cfg.name}: {_TODO['lora']}")


# ===========================================================================
# initialization
# ===========================================================================

def _attn_block_shapes(cfg: ModelConfig):
    """name -> shape of one attention block's leaves (``ln*`` are float32
    zeros, the rest dense weights in cfg.dtype)."""
    d, qd, kd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    shapes = {"ln1": (d,), "wq": (d, qd), "wk": (d, kd), "wv": (d, kd),
              "wo": (qd, d), "ln2": (d,)}
    if ff:
        shapes["wi"] = (d, 2 * ff)
        shapes["wd"] = (ff, d)
    return shapes


def _moe_block_shapes(cfg: ModelConfig):
    """name -> (shape, dtype) of one MoE block's leaves
    (``repro/models/model.py:67-81``): the attention block's without its
    dense MLP, the float32 router [d, E], the experts' stacked SwiGLU
    ``wi_e`` [E, d, 2 eff] and ``wd_e`` [E, eff, d], and with shared
    experts their one SwiGLU of width n_shared * eff."""
    dt, f32 = _dt(cfg), torch.float32
    out = {name: (shape, f32 if name.startswith("ln") else dt)
           for name, shape in _attn_block_shapes(cfg).items()
           if name not in ("wi", "wd")}
    d, eff, E = cfg.d_model, cfg.expert_ff, cfg.n_experts
    out["router"] = ((d, E), f32)
    out["wi_e"] = ((E, d, 2 * eff), dt)
    out["wd_e"] = ((E, eff, d), dt)
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * eff
        out["wi_s"] = ((d, 2 * sff), dt)
        out["wd_s"] = ((sff, d), dt)
    return out


def _dense_init(gen, shape, dtype, scale=None, lead=()):
    """N(0, 1) * scale (default fan_in^-0.5, fan_in = shape[0]) drawn in
    float32 and cast; ``lead`` prepends stacking axes."""
    s = scale if scale is not None else shape[0] ** -0.5
    x = torch.randn(tuple(lead) + tuple(shape), generator=gen,
                    dtype=torch.float32, device=gen.device)
    return (x * s).to(dtype)


def init_attn_block(gen, cfg: ModelConfig, lead=()):
    out = {}
    for name, shape in _attn_block_shapes(cfg).items():
        if name.startswith("ln"):
            out[name] = torch.zeros(tuple(lead) + shape, dtype=torch.float32,
                                    device=gen.device)
        else:
            out[name] = _dense_init(gen, shape, _dt(cfg), lead=lead)
    return out


def init_moe_block(gen, cfg: ModelConfig, lead=()):
    """Norms zero; the router and the shared experts dense (fan_in^-0.5);
    the experts' ``wi_e`` at d^-0.5 and ``wd_e`` at eff^-0.5, as the
    reference scales them.  The expert leaves are drawn one stacked unit
    at a time: drawing a whole stack in float32 before the cast would take
    70.9 GB for moonshot-v1-16b-a3b's ``wi_e``."""
    scales = {"wi_e": cfg.d_model ** -0.5, "wd_e": cfg.expert_ff ** -0.5}
    out = {}
    for name, (shape, dtype) in _moe_block_shapes(cfg).items():
        if name.startswith("ln"):
            out[name] = torch.zeros(tuple(lead) + shape, dtype=dtype,
                                    device=gen.device)
        elif name in scales:
            out[name] = torch.empty(tuple(lead) + shape, dtype=dtype,
                                    device=gen.device)
            for u in itertools.product(*map(range, lead)):
                out[name][u] = _dense_init(gen, shape, dtype, scales[name])
        else:
            out[name] = _dense_init(gen, shape, dtype, lead=lead)
    return out


def _mamba_block_shapes(cfg: ModelConfig):
    """name -> (shape, dtype) of one Mamba2 block's leaves
    (``repro/models/model.py:84-101``)."""
    d, di, f32 = cfg.d_model, cfg.ssm_inner, torch.float32
    proj_out = 2 * di + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads
    H = (cfg.ssm_heads,)
    return {"ln1": ((d,), f32), "in_proj": ((d, proj_out), _dt(cfg)),
            "conv_w": ((cfg.ssm_conv_dim, cfg.ssm_conv), f32),
            "conv_b": ((cfg.ssm_conv_dim,), f32), "A_log": (H, f32),
            "D": (H, f32), "dt_bias": (H, f32), "ln_out": ((di,), f32),
            "out_proj": ((di, d), _dt(cfg))}


def init_mamba_block(gen, cfg: ModelConfig, lead=()):
    """A_log = log(linspace(1, 16, H)), D = 1, dt_bias = -4.6 (softplus
    about 0.01), conv weights N(0, 1) * 0.3 and zero biases in float32,
    the projections dense in cfg.dtype, norms zero."""
    dev = gen.device
    H = cfg.ssm_heads

    def full(v, n):
        return torch.full(tuple(lead) + (n,), v, dtype=torch.float32,
                          device=dev)

    shapes = _mamba_block_shapes(cfg)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                     device=dev))
    return {
        "ln1": full(0.0, cfg.d_model),
        "in_proj": _dense_init(gen, shapes["in_proj"][0], _dt(cfg),
                               lead=lead),
        "conv_w": _dense_init(gen, shapes["conv_w"][0], torch.float32,
                              scale=0.3, lead=lead),
        "conv_b": full(0.0, cfg.ssm_conv_dim),
        "A_log": a_log.expand(tuple(lead) + (H,)).clone(),
        "D": full(1.0, H),
        "dt_bias": full(-4.6, H),
        "ln_out": full(0.0, cfg.ssm_inner),
        "out_proj": _dense_init(gen, shapes["out_proj"][0], _dt(cfg),
                                lead=lead),
    }


def _init_block(gen, blk: BlockCfg, cfg: ModelConfig, lead=()):
    if blk.kind == "attn":
        return init_attn_block(gen, cfg, lead)
    if blk.kind == "moe":
        return init_moe_block(gen, cfg, lead)
    if blk.kind == "mamba":
        return init_mamba_block(gen, cfg, lead)
    return {}  # shared_attn: weights live in params["shared"]


def _has_shared(cfg):
    return any(b.kind == "shared_attn" for b in cfg.pattern)


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Random parameters drawn from ``gen`` on its device, in the
    reference's tree layout (``stack/pos{j}`` leaves stacked on a leading
    ``[n_units]`` axis, ``tail/blk{i}``).  The bits differ from the
    reference's ``jax.random`` draws; tests carry JAX weights across."""
    check_supported(cfg)
    dt = _dt(cfg)
    params = {
        "embed": _dense_init(gen, (cfg.vocab, cfg.d_model), dt, scale=0.02),
        "ln_f": torch.zeros((cfg.d_model,), dtype=torch.float32,
                            device=gen.device),
        "stack": {f"pos{j}": (_init_block(gen, blk, cfg, (cfg.n_units,))
                              if cfg.n_units else {})
                  for j, blk in enumerate(cfg.pattern)},
        "tail": {f"blk{i}": _init_block(gen, cfg.pattern[i], cfg)
                 for i in range(cfg.n_tail)},
    }
    if _has_shared(cfg):
        params["shared"] = init_attn_block(gen, cfg)
    if not cfg.tie_embeddings:
        params["unembed"] = _dense_init(gen, (cfg.d_model, cfg.vocab), dt,
                                        scale=0.02)
    return params


def count_params(cfg: ModelConfig, trainable_only: bool = False) -> int:
    """Analytic parameter count (matches init_params).  Every parameter is
    trainable in this slice (LoRA raises), so ``trainable_only`` changes
    nothing."""
    check_supported(cfg)
    attn = sum(math.prod(s) for s in _attn_block_shapes(cfg).values())
    per_kind = {"attn": attn, "shared_attn": 0}
    for kind, shapes in (("moe", _moe_block_shapes),
                         ("mamba", _mamba_block_shapes)):
        per_kind[kind] = sum(math.prod(s) for s, _ in shapes(cfg).values())
    n = cfg.vocab * cfg.d_model + cfg.d_model
    n += sum(per_kind[b.kind] for b in cfg.layer_blocks())
    if _has_shared(cfg):
        n += attn
    if not cfg.tie_embeddings:
        n += cfg.d_model * cfg.vocab
    return n


# ===========================================================================
# forward
# ===========================================================================

def _unit_slice(tree, u):
    return {k: v[u] for k, v in tree.items()}


def apply_block(blk: BlockCfg, bp, h, cfg, positions, *, shared=None,
                cache=None, mode="train"):
    """One block, residual: ``mamba`` runs the Mamba2 mixer; ``attn`` and
    ``shared_attn`` (weights ``shared``) run attention then the gated MLP,
    ``moe`` attention then ``moe_ffn``.  Returns (h, aux): aux the MoE
    block's router loss, None for the other kinds.  The cache
    (prefill/decode modes) is written in place."""
    if blk.kind == "mamba":
        return h + ssm.mamba_block(
            rms_norm(h, bp["ln1"], cfg.norm_eps), bp, cfg,
            decode_cache=cache if mode == "decode" else None,
            prefill_cache=cache if mode == "prefill" else None), None
    if blk.kind == "shared_attn":
        bp = shared
    x = rms_norm(h, bp["ln1"], cfg.norm_eps)
    dec = pre = None
    if cache is not None and mode == "decode":
        alloc = cache["k"].shape[1]
        dec = dict(k=cache["k"], v=cache["v"], pos=cache["pos"],
                   slot=positions[:, 0] % alloc)
    elif cache is not None and mode == "prefill":
        pre = cache
    h = h + attn_qkvo(x, bp, cfg, positions, decode_cache=dec,
                      prefill_cache=pre, window=blk.window)
    x = rms_norm(h, bp["ln2"], cfg.norm_eps)
    if blk.kind == "moe":
        y, aux = moe_ffn(x, bp, cfg)
        return h + y, aux
    return h + swiglu(x, bp["wi"], bp["wd"]), None


def _run_stack(h, params, cfg: ModelConfig, positions, *, caches=None,
               mode="train"):
    """The unit loop, then the tail.  Returns (h, aux): aux the summed
    router loss of the MoE blocks (a float32 scalar, 0 without them); the
    caches are written in place."""
    shared = params.get("shared")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    blocks = [(blk, _unit_slice(params["stack"][f"pos{j}"], u),
               _unit_slice(caches["stack"][f"pos{j}"], u) if caches else None)
              for u in range(cfg.n_units)
              for j, blk in enumerate(cfg.pattern)]
    blocks += [(cfg.pattern[i], params["tail"][f"blk{i}"],
                caches["tail"][f"blk{i}"] if caches else None)
               for i in range(cfg.n_tail)]
    for blk, bp, c in blocks:
        h, aux = apply_block(blk, bp, h, cfg, positions, shared=shared,
                             cache=c, mode=mode)
        if aux is not None:
            total = total + aux
    return h, total


def _embed(params, cfg, tokens):
    check_supported(cfg)
    return params["embed"][tokens].to(_dt(cfg))


def forward_hidden(params, cfg: ModelConfig, tokens, *, positions=None):
    """Training/prefill forward. tokens: [B, L]. Returns (h, aux); aux is the
    summed router loss of the MoE blocks, 0 without them."""
    B, L = tokens.shape
    h = _embed(params, cfg, tokens)
    if positions is None:
        positions = torch.arange(L, device=h.device).expand(B, L)
    h, aux = _run_stack(h, params, cfg, positions)
    return rms_norm(h, params["ln_f"], cfg.norm_eps), aux


def _head_weight(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T  # [d, V]
    return params["unembed"]


def lm_logits(h, params, cfg: ModelConfig):
    logits = h @ _head_weight(params, cfg)
    return softcap(logits.float(), cfg.logit_softcap)


# ===========================================================================
# decode / serving
# ===========================================================================

def init_block_cache(blk: BlockCfg, cfg: ModelConfig, batch, seq_len, dtype,
                     device):
    if blk.kind == "mamba":
        return ssm.init_mamba_cache(cfg, batch, dtype, device)
    alloc = seq_len if blk.window is None else min(blk.window, seq_len)
    shape = (batch, alloc, cfg.n_kv_heads, cfg.head_dim)
    return dict(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, alloc), -1, dtype=torch.int32, device=device),
    )


def init_cache(cfg: ModelConfig, batch, seq_len, dtype=None, *,
               device="cuda"):
    """Empty caches on ``device`` (the card unless the caller asks for the
    CPU): per attention block k, v [batch, alloc, K, D] and pos
    [batch, alloc] = -1, where alloc is seq_len for global blocks and
    min(window, seq_len) for windowed ones (rolling); per Mamba2 block the
    conv window [batch, W-1, conv_dim] and the SSM state [batch, H, P, N],
    both in ``dtype``; full units stacked on [n_units]."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or _dt(cfg)

    def stacked(blk):
        one = init_block_cache(blk, cfg, batch, seq_len, dtype, dev)
        return {k: v.expand((cfg.n_units,) + v.shape).clone()
                for k, v in one.items()}

    return {"stack": {f"pos{j}": stacked(blk)
                      for j, blk in enumerate(cfg.pattern)},
            "tail": {f"blk{i}": init_block_cache(cfg.pattern[i], cfg, batch,
                                                 seq_len, dtype, dev)
                     for i in range(cfg.n_tail)}}


def serve_step(params, cfg: ModelConfig, cache, tokens, pos):
    """One decode step. tokens: [B,1] int; pos: [B] int (absolute index of
    the new token). Returns (logits [B,V], cache), the cache written in
    place."""
    h = _embed(params, cfg, tokens)
    h, _ = _run_stack(h, params, cfg, pos[:, None], caches=cache,
                      mode="decode")
    h = rms_norm(h, params["ln_f"], cfg.norm_eps)
    return lm_logits(h[:, 0], params, cfg), cache


def prefill(params, cfg: ModelConfig, cache, tokens, *, start_pos=0):
    """Full-sequence forward that also populates the decode cache (in
    place). tokens: [B, Lp]. Returns (last-position logits [B, V], cache).
    With ``cfg.attn_backend == "flash"`` and Lp % 128 == 0 the attention
    runs through the flash kernel; Mamba2 blocks run their SSD scan
    through the SSD chunk kernel."""
    B, L = tokens.shape
    h = _embed(params, cfg, tokens)
    positions = torch.arange(start_pos, start_pos + L,
                             device=h.device).expand(B, L)
    h, _ = _run_stack(h, params, cfg, positions, caches=cache,
                      mode="prefill")
    h = rms_norm(h, params["ln_f"], cfg.norm_eps)
    return lm_logits(h[:, -1], params, cfg), cache
