"""Unified model, dense attention, MoE and Mamba2 / shared-attention
blocks, the encoder-decoder and the modality frontends: parameter init,
the unit loop, logits, caches, prefill and decode; a port of
``repro/models/model.py``.

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
the stack sums its router losses as the reference does.

An encoder-decoder model (``cfg.enc_dec``) runs ``encode`` over the
frame embeddings ``enc_embeds`` (a stubbed frontend's output): a stack of
``n_enc_layers`` bidirectional attention blocks under ``params["enc"]``.
Each decoder block then adds a cross-attention sub-block (``ln_x``,
``wq_x``..``wo_x``) whose keys and values it projects from the encoder's
output, unroped, through the plain attention.  The cache holds that
output (``cache["enc_out"]``, written by ``prefill``), and ``serve_step``
projects its keys and values again in every layer at every step, as the
reference does.  A modality frontend's stub embeddings (``embeds``
[B, F, d]) replace the first F token embeddings; positions are
unchanged.  Caches are updated in place (the reference returns new ones):
``prefill`` and ``serve_step`` write into the cache they are given and
return it.

Training: ``lm_loss`` is the reference's masked token cross-entropy, and
``split_trainable`` / ``merge_trainable`` its FL integration point.  In
``fl_mode="full"`` every parameter trains and nothing is frozen; in
``fl_mode="lora"`` the trainable tree is ``params["lora"]``, rank-r
adapters ``a_{q,k,v,o}`` / ``b_{q,k,v,o}`` for every attention block
(``{}`` at Mamba2 positions; ``b_*`` start at zero), and the rest of the
tree is the frozen base.  The adapters apply in every forward (training,
prefill, decode): ``attn_qkvo`` adds ``rank**-0.5 * (x @ a) @ b`` to q,
k, v and the output projection.  ``lm_loss(..., lead=k)`` takes batches
and the trainable leaves with k leading client axes (under LoRA the
frozen base carries none and enters every client map unmapped, so one
copy serves all clients) and maps itself over them
(``torch.func.vmap``), piece by piece:
the embedding, each pattern unit of the stack, each tail block, the
final norm and each loss chunk.  That is where remat goes: with
``cfg.remat`` and a gradient being recorded, each unit (and each encoder
layer) runs under a non-reentrant ``torch.utils.checkpoint`` placed
around its vmapped call, as the reference checkpoints each step of its
unit scan (``remat_policy`` "full" saves nothing inside a unit, "dots"
saves the matrix products' outputs through a selective-checkpoint
policy).  A checkpoint inside ``torch.func.vmap`` cannot be replayed by a
backward taken outside it, so the engine's local SGD hands a loss that
maps its own clients (``maps_clients``) the client-stacked tree as it is.
Remat changes memory, not values: the recomputation runs the same
operations on the same inputs.
"""
from __future__ import annotations

import functools
import itertools
import math

import torch
import torch.utils._pytree as pytree
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models import ssm
from repro_torch.models.config import BlockCfg, ModelConfig
from repro_torch.models.layers import (apply_rope, attention, attn_qkvo,
                                       rms_norm, softcap, swiglu)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.placed import embed as placed_embed
from repro_torch.models.placed import (grad_like_forward, is_placed,
                                       keep_placements,
                                       local_attention, local_mixer,
                                       reduce_partial,
                                       placed_like, split_heads,
                                       token_nll_sum)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dt(cfg):
    return DTYPES[cfg.dtype]


# ===========================================================================
# initialization
# ===========================================================================

def _attn_block_shapes(cfg: ModelConfig, cross=False):
    """name -> shape of one attention block's leaves (``ln*`` are float32
    zeros, the rest dense weights in cfg.dtype); with ``cross`` (an
    encoder-decoder's decoder block) also the cross-attention's ``ln_x``,
    ``wq_x``, ``wk_x``, ``wv_x`` and ``wo_x``
    (``repro/models/model.py:56-63``)."""
    d, qd, kd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    shapes = {"ln1": (d,), "wq": (d, qd), "wk": (d, kd), "wv": (d, kd),
              "wo": (qd, d), "ln2": (d,)}
    if ff:
        shapes["wi"] = (d, 2 * ff)
        shapes["wd"] = (ff, d)
    if cross:
        shapes.update(ln_x=(d,), wq_x=(d, qd), wk_x=(d, kd), wv_x=(d, kd),
                      wo_x=(qd, d))
    return shapes


def _moe_block_shapes(cfg: ModelConfig, cross=False):
    """name -> (shape, dtype) of one MoE block's leaves
    (``repro/models/model.py:67-81``): the attention block's without its
    dense MLP, the float32 router [d, E], the experts' stacked SwiGLU
    ``wi_e`` [E, d, 2 eff] and ``wd_e`` [E, eff, d], and with shared
    experts their one SwiGLU of width n_shared * eff."""
    dt, f32 = _dt(cfg), torch.float32
    out = {name: (shape, f32 if name.startswith("ln") else dt)
           for name, shape in _attn_block_shapes(cfg, cross).items()
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


def init_attn_block(gen, cfg: ModelConfig, lead=(), cross=False):
    out = {}
    for name, shape in _attn_block_shapes(cfg, cross).items():
        if name.startswith("ln"):
            out[name] = torch.zeros(tuple(lead) + shape, dtype=torch.float32,
                                    device=gen.device)
        else:
            out[name] = _dense_init(gen, shape, _dt(cfg), lead=lead)
    return out


def init_moe_block(gen, cfg: ModelConfig, lead=(), cross=False):
    """Norms zero; the router and the shared experts dense (fan_in^-0.5);
    the experts' ``wi_e`` at d^-0.5 and ``wd_e`` at eff^-0.5, as the
    reference scales them.  The expert leaves are drawn one stacked unit
    at a time: drawing a whole stack in float32 before the cast would take
    70.9 GB for moonshot-v1-16b-a3b's ``wi_e``."""
    scales = {"wi_e": cfg.d_model ** -0.5, "wd_e": cfg.expert_ff ** -0.5}
    out = {}
    for name, (shape, dtype) in _moe_block_shapes(cfg, cross).items():
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


def _mamba_fixed(cfg: ModelConfig, lead, device):
    """A Mamba2 block's leaves that no draw touches: A_log = log(linspace(1,
    16, H)), D = 1, dt_bias = -4.6 (softplus about 0.01), zero norms and
    conv bias, all float32."""
    H = cfg.ssm_heads

    def full(v, n):
        return torch.full(tuple(lead) + (n,), v, dtype=torch.float32,
                          device=device)

    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                     device=device))
    return {"ln1": full(0.0, cfg.d_model),
            "conv_b": full(0.0, cfg.ssm_conv_dim),
            "A_log": a_log.expand(tuple(lead) + (H,)).clone(),
            "D": full(1.0, H), "dt_bias": full(-4.6, H),
            "ln_out": full(0.0, cfg.ssm_inner)}


def init_mamba_block(gen, cfg: ModelConfig, lead=()):
    """The fixed leaves (``_mamba_fixed``), conv weights N(0, 1) * 0.3 in
    float32 and the projections dense in cfg.dtype."""
    shapes = _mamba_block_shapes(cfg)
    p = _mamba_fixed(cfg, lead, gen.device)
    p["in_proj"] = _dense_init(gen, shapes["in_proj"][0], _dt(cfg),
                               lead=lead)
    p["conv_w"] = _dense_init(gen, shapes["conv_w"][0], torch.float32,
                              scale=0.3, lead=lead)
    p["out_proj"] = _dense_init(gen, shapes["out_proj"][0], _dt(cfg),
                                lead=lead)
    return p


def _init_block(gen, blk: BlockCfg, cfg: ModelConfig, lead=(), cross=False):
    if blk.kind == "attn":
        return init_attn_block(gen, cfg, lead, cross)
    if blk.kind == "moe":
        return init_moe_block(gen, cfg, lead, cross)
    if blk.kind == "mamba":
        return init_mamba_block(gen, cfg, lead)
    return {}  # shared_attn: weights live in params["shared"]


def _has_shared(cfg):
    return any(b.kind == "shared_attn" for b in cfg.pattern)


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Random parameters drawn from ``gen`` on its device, in the
    reference's tree layout (``stack/pos{j}`` leaves stacked on a leading
    ``[n_units]`` axis, ``tail/blk{i}``; with ``cfg.enc_dec`` the decoder
    blocks carry the cross-attention leaves and ``enc`` holds the
    encoder: ``n_enc_layers`` attention blocks stacked under
    ``stack/pos0``, an empty ``tail`` and its ``ln_f``; with
    ``fl_mode="lora"`` the adapters under ``lora``, ``init_lora``).  The
    bits differ from the reference's ``jax.random`` draws; tests carry
    JAX weights across."""
    dt = _dt(cfg)
    cross = cfg.enc_dec

    def zeros_d():
        return torch.zeros((cfg.d_model,), dtype=torch.float32,
                           device=gen.device)

    params = {
        "embed": _dense_init(gen, (cfg.vocab, cfg.d_model), dt, scale=0.02),
        "ln_f": zeros_d(),
        "stack": {f"pos{j}": (_init_block(gen, blk, cfg, (cfg.n_units,),
                                          cross)
                              if cfg.n_units else {})
                  for j, blk in enumerate(cfg.pattern)},
        "tail": {f"blk{i}": _init_block(gen, cfg.pattern[i], cfg, (), cross)
                 for i in range(cfg.n_tail)},
    }
    if _has_shared(cfg):
        params["shared"] = init_attn_block(gen, cfg)
    if not cfg.tie_embeddings:
        params["unembed"] = _dense_init(gen, (cfg.d_model, cfg.vocab), dt,
                                        scale=0.02)
    if cfg.enc_dec:
        params["enc"] = {
            "stack": {"pos0": (init_attn_block(gen, cfg, (cfg.n_enc_layers,))
                               if cfg.n_enc_layers else {})},
            "tail": {}, "ln_f": zeros_d()}
    if cfg.fl_mode == "lora":
        params["lora"] = init_lora(gen, cfg)
    return params


def _lora_shapes(cfg: ModelConfig):
    """name -> shape of one attention block's adapters, in the reference's
    order (``repro/models/model.py:160-168``): ``a_n`` [in, r] and
    ``b_n`` [r, out] for n in q, k, v, o (o's input is the attention
    output, q_dim wide)."""
    r, d, qd, kd = cfg.lora_rank, cfg.d_model, cfg.q_dim, cfg.kv_dim
    out = {}
    for name, odim in (("q", qd), ("k", kd), ("v", kd), ("o", d)):
        out[f"a_{name}"] = (qd if name == "o" else d, r)
        out[f"b_{name}"] = (r, odim)
    return out


def _init_lora_block(gen, cfg: ModelConfig, lead=()):
    """One attention block's adapters: ``a_*`` dense (fan_in^-0.5),
    ``b_*`` zero, all in cfg.dtype."""
    return {name: (_dense_init(gen, shape, _dt(cfg), lead=lead)
                   if name.startswith("a_")
                   else torch.zeros(tuple(lead) + shape, dtype=_dt(cfg),
                                    device=gen.device))
            for name, shape in _lora_shapes(cfg).items()}


def init_lora(gen, cfg: ModelConfig):
    """The adapters' tree, ``{"stack": {pos{j}}, "tail": {blk{i}}}``: every
    attention-like position (``attn``, ``moe``, ``shared_attn``) stacked on
    ``[n_units]``, ``{}`` at Mamba2 positions (the reference's
    ``init_lora``)."""
    def block(blk, lead):
        if blk.kind == "mamba" or (lead and not cfg.n_units):
            return {}
        return _init_lora_block(gen, cfg, lead)

    return {"stack": {f"pos{j}": block(blk, (cfg.n_units,))
                      for j, blk in enumerate(cfg.pattern)},
            "tail": {f"blk{i}": block(cfg.pattern[i], ())
                     for i in range(cfg.n_tail)}}


# ---------------------------------------------------------------------------
# the reference's own draws, from a PRNG key
# ---------------------------------------------------------------------------

def _key_dense(key, shape, dtype, scale=None):
    s = scale if scale is not None else shape[0] ** -0.5
    return (prng.normal(key, shape) * s).to(dtype)


def _key_zeros(key, shape):
    return torch.zeros(shape, dtype=torch.float32, device=key.device)


def _key_attn_block(key, cfg, cross=False):
    ks = prng.split(key, 16)
    dt = _dt(cfg)
    at = {"wq": 1, "wk": 2, "wv": 3, "wo": 4, "wi": 6, "wd": 7, "wq_x": 9,
          "wk_x": 10, "wv_x": 11, "wo_x": 12}
    return {name: (_key_zeros(key, shape) if name.startswith("ln")
                   else _key_dense(ks[at[name]], shape, dt))
            for name, shape in _attn_block_shapes(cfg, cross).items()}


def _key_moe_block(key, cfg, cross=False):
    ks = prng.split(key, 6)
    p = _key_attn_block(ks[0], cfg, cross)
    p.pop("wi", None), p.pop("wd", None)
    shapes = _moe_block_shapes(cfg, cross)
    scales = {"wi_e": cfg.d_model ** -0.5, "wd_e": cfg.expert_ff ** -0.5}
    for i, name in enumerate(("router", "wi_e", "wd_e", "wi_s", "wd_s"), 1):
        if name in shapes:
            shape, dtype = shapes[name]
            p[name] = _key_dense(ks[i], shape, dtype, scales.get(name))
    return p


def _key_mamba_block(key, cfg):
    ks = prng.split(key, 8)
    shapes = _mamba_block_shapes(cfg)
    p = _mamba_fixed(cfg, (), key.device)
    p["in_proj"] = _key_dense(ks[1], *shapes["in_proj"])
    p["conv_w"] = _key_dense(ks[2], *shapes["conv_w"], scale=0.3)
    p["out_proj"] = _key_dense(ks[4], *shapes["out_proj"])
    return p


def _key_block(key, blk, cfg, cross):
    if blk.kind == "attn":
        return _key_attn_block(key, cfg, cross)
    if blk.kind == "moe":
        return _key_moe_block(key, cfg, cross)
    if blk.kind == "mamba":
        return _key_mamba_block(key, cfg)
    return {}


def _key_stack(key, cfg, pattern, n_units, n_tail, cross):
    """The reference's ``_init_stack``: one key per (position, unit) in
    that order, then one per tail block; units stacked on a leading
    axis."""
    keys = prng.split(key, (n_units + 1) * len(pattern) + 1)
    it = iter(range(keys.shape[0]))
    stack = {}
    for j, blk in enumerate(pattern):
        units = [_key_block(keys[next(it)], blk, cfg, cross)
                 for _ in range(n_units)]
        stack[f"pos{j}"] = ({k: torch.stack([u[k] for u in units])
                             for k in units[0]} if n_units else {})
    tail = {f"blk{i}": _key_block(keys[next(it)], pattern[i], cfg, cross)
            for i in range(n_tail)}
    return stack, tail


def _key_lora(key, cfg):
    """The reference's ``init_lora``: one key per (attention-like
    position, unit), then one per attention-like tail block (Mamba2
    positions take none), each split 4 ways for q, k, v, o."""
    keys = prng.split(key, cfg.n_units * len(cfg.pattern) + cfg.n_tail + 1)
    it = iter(range(keys.shape[0]))
    shapes = _lora_shapes(cfg)

    def block(k):
        ks = prng.split(k, 4)
        return {name: (_key_dense(ks[i // 2], shape, _dt(cfg))
                       if name.startswith("a_")
                       else torch.zeros(shape, dtype=_dt(cfg),
                                        device=key.device))
                for i, (name, shape) in enumerate(shapes.items())}

    stack = {}
    for j, blk in enumerate(cfg.pattern):
        units = ([] if blk.kind == "mamba"
                 else [block(keys[next(it)]) for _ in range(cfg.n_units)])
        stack[f"pos{j}"] = ({k: torch.stack([u[k] for u in units])
                             for k in units[0]} if units else {})
    tail = {f"blk{i}": ({} if cfg.pattern[i].kind == "mamba"
                        else block(keys[next(it)]))
            for i in range(cfg.n_tail)}
    return {"stack": stack, "tail": tail}


def init_params_from_key(key, cfg: ModelConfig):
    """The reference's ``init_params(key, cfg)`` draw for draw: the same
    key splits and the same normals through the port's threefry
    (``prng.normal`` agrees with ``jax.random.normal`` within float32
    rounding), on the key's device.  What ``--preset lm`` initializes
    from, so its runs follow the reference's; ``init_params`` (a
    ``torch.Generator``) is the fast draw for full-width models."""
    dt = _dt(cfg)
    k_emb, k_stack, k_enc, k_shared, k_head, k_lora = prng.split(key, 6)
    params = {"embed": _key_dense(k_emb, (cfg.vocab, cfg.d_model), dt, 0.02),
              "ln_f": _key_zeros(key, (cfg.d_model,))}
    params["stack"], params["tail"] = _key_stack(
        k_stack, cfg, cfg.pattern, cfg.n_units, cfg.n_tail, cfg.enc_dec)
    if _has_shared(cfg):
        params["shared"] = _key_attn_block(k_shared, cfg)
    if not cfg.tie_embeddings:
        params["unembed"] = _key_dense(k_head, (cfg.d_model, cfg.vocab), dt,
                                       0.02)
    if cfg.enc_dec:
        e_stack, e_tail = _key_stack(k_enc, cfg, (BlockCfg("attn"),),
                                     cfg.n_enc_layers, 0, False)
        params["enc"] = {"stack": e_stack, "tail": e_tail,
                         "ln_f": _key_zeros(key, (cfg.d_model,))}
    if cfg.fl_mode == "lora":
        params["lora"] = _key_lora(k_lora, cfg)
    return params


# ---------------------------------------------------------------------------
# trainable / frozen split (the FL integration point)
# ---------------------------------------------------------------------------

def _prune_empty(tree):
    """The tree without its empty subtrees."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _prune_empty(v) for k, v in tree.items()}
    return {k: v for k, v in out.items() if not (isinstance(v, dict)
                                                 and not v)}


def split_trainable(params, cfg: ModelConfig):
    """``(trainable, frozen)``: in full mode every parameter trains and
    nothing is frozen; in LoRA mode the adapters ``params["lora"]`` train
    and the rest is the frozen base.  The trainable tree drops its empty
    subtrees (a ``shared_attn`` position's weights, an empty ``tail``, a
    Mamba2 position's adapters): the engine rebuilds trees from leaf
    paths, which carry no empty node, and the model reads a missing
    subtree as empty."""
    if cfg.fl_mode == "lora":
        return (_prune_empty(params["lora"]),
                {k: v for k, v in params.items() if k != "lora"})
    return _prune_empty(params), {}


def merge_trainable(trainable, frozen, cfg: ModelConfig):
    """The inverse of ``split_trainable``."""
    if cfg.fl_mode == "lora":
        return {**frozen, "lora": trainable}
    return trainable


def count_params(cfg: ModelConfig, trainable_only: bool = False) -> int:
    """Analytic parameter count (matches init_params, the adapters
    included); ``trainable_only`` counts what ``split_trainable`` trains:
    everything in full mode, the adapters in LoRA mode."""
    n_lora = 0
    if cfg.fl_mode == "lora":
        n_lora = (sum(b.kind != "mamba" for b in cfg.layer_blocks())
                  * sum(math.prod(s) for s in _lora_shapes(cfg).values()))
        if trainable_only:
            return n_lora
    cross = cfg.enc_dec

    def attn_count(with_cross):
        return sum(math.prod(s) for s in
                   _attn_block_shapes(cfg, with_cross).values())

    per_kind = {"attn": attn_count(cross), "shared_attn": 0,
                "moe": sum(math.prod(s) for s, _ in
                           _moe_block_shapes(cfg, cross).values()),
                "mamba": sum(math.prod(s) for s, _ in
                             _mamba_block_shapes(cfg).values())}
    n = cfg.vocab * cfg.d_model + cfg.d_model
    n += sum(per_kind[b.kind] for b in cfg.layer_blocks())
    if _has_shared(cfg):
        n += attn_count(False)
    if not cfg.tie_embeddings:
        n += cfg.d_model * cfg.vocab
    if cfg.enc_dec:
        n += cfg.n_enc_layers * attn_count(False) + cfg.d_model
    return n + n_lora


# ===========================================================================
# forward
# ===========================================================================

def _unit_slice(tree, u, lead=0):
    """Unit ``u`` of a stacked block tree whose unit axis follows ``lead``
    client axes."""
    return {k: v.select(lead, u) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# client axes and remat (training)
# ---------------------------------------------------------------------------

def _cmap(body, lead, *args, fixed=()):
    """``body(*args)`` over ``lead`` leading client axes of every tensor in
    ``args`` (nested ``torch.func.vmap``); None arguments, and those at the
    indices in ``fixed`` (the frozen base under LoRA), pass through
    unmapped, and lead = 0 calls ``body`` as it is."""
    if not lead:
        return body(*args)
    at = [i for i, a in enumerate(args) if a is not None and i not in fixed]

    def inner(*xs):
        full = list(args)
        for i, x in zip(at, xs):
            full[i] = x
        return body(*full)

    mapped = inner
    for _ in range(lead):
        mapped = torch.func.vmap(mapped)
    return mapped(*(args[i] for i in at))


#: the matrix products whose outputs the "dots" policy keeps (under the
#: client vmap a per-client product arrives as ``bmm``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _records_grad(*args):
    """Whether autograd records through a tensor of ``args`` (trees)."""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad
        for t in pytree.tree_leaves(args))


def _frozen_base(cfg, *idx):
    """``idx`` (argument indices holding the base's weights) when the base
    is frozen (LoRA) and enters the client maps unmapped, else ()."""
    return idx if cfg.fl_mode == "lora" else ()


def _unit_call(cfg, policy, body, lead, *args, fixed=()):
    """One unit of a training stack, ``_cmap(body, lead, *args,
    fixed=fixed)``.  When
    ``cfg.remat`` is on and a gradient is being recorded through ``args``
    (the reference's ``jax.checkpoint`` on each scan step), it runs under
    a non-reentrant checkpoint placed around the vmap, and the backward
    recomputes it from ``args``: ``policy`` "full" saves nothing inside
    it, "dots" the outputs of the matrix products (the reference's
    ``dots_with_no_batch_dims_saveable``)."""
    if not (cfg.remat and _records_grad(*args)):
        return _cmap(body, lead, *args, fixed=fixed)
    if policy not in ("full", "dots"):
        raise ValueError(f"remat_policy {policy!r}: 'full' or 'dots'")
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(functools.partial(_cmap, body, lead, fixed=fixed),
                      *args, use_reentrant=False, **kw)


def encode(params, cfg: ModelConfig, enc_embeds, *, lead=0):
    """Encoder pass (enc-dec models). enc_embeds: [B, Le, d] -> [B, Le, d]
    (with ``lead`` leading client axes on the parameters and the input).

    Each of the ``n_enc_layers`` blocks: rms_norm, q/k/v projections both
    roped at positions 0..Le-1, bidirectional plain attention
    (``causal=False``, q-chunked by cfg.attn_chunk), ``wo``, then the
    SwiGLU MLP; then the encoder's ``ln_f``.  The encoder takes no
    adapters, and under LoRA its weights carry no client axes.  As in the
    reference, the
    frame embeddings enter uncast and the plain attention runs whatever
    the backend; under ``cfg.remat`` each block is checkpointed while a
    gradient is recorded (policy "full" whatever ``remat_policy`` says,
    as the reference's encoder scan)."""
    B, Le = enc_embeds.shape[lead:lead + 2]
    pos = placed_like(torch.arange(Le, device=enc_embeds.device)
                      .expand(B, Le), enc_embeds, replicate=True)
    enc = params["enc"]

    def block(h, bp):
        x = rms_norm(h, bp["ln1"], cfg.norm_eps)
        q = split_heads(x @ bp["wq"], cfg.n_heads, cfg.head_dim)
        k = split_heads(x @ bp["wk"], cfg.n_kv_heads, cfg.head_dim)
        v = split_heads(x @ bp["wv"], cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        o = local_attention(_bidirectional(cfg), q, k, v, pos, pos,
                            keep_seq=True)
        h = h + o.reshape(B, Le, cfg.q_dim) @ bp["wo"]
        return h + swiglu(rms_norm(h, bp["ln2"], cfg.norm_eps), bp["wi"],
                          bp["wd"])

    h, fixed = enc_embeds, _frozen_base(cfg, 1)
    for u in range(cfg.n_enc_layers):
        h = _unit_call(cfg, "full", block, lead, h,
                       _unit_slice(enc["stack"]["pos0"], u,
                                   0 if fixed else lead), fixed=fixed)
        h = keep_placements(h, enc_embeds)
    return _cmap(lambda x, g: rms_norm(x, g, cfg.norm_eps), lead, h,
                 enc["ln_f"], fixed=fixed)


def _bidirectional(cfg):
    """The plain bidirectional attention of the encoder and the
    cross-attention, as a ``placed.local_attention`` body."""
    def body(q, k, v, q_pos, k_pos):
        return attention(q, k, v, q_pos, k_pos, causal=False,
                         attn_softcap=cfg.attn_softcap,
                         q_chunk=cfg.attn_chunk)
    return body


def _enc_kv(enc_out):
    """The cross-attention's source: the encoder output and its key
    positions [B, Le]."""
    B, Le, _ = enc_out.shape
    return enc_out, placed_like(torch.arange(Le, device=enc_out.device)
                                .expand(B, Le), enc_out, replicate=True)


def _cross_attn(x, wp, cfg, positions, enc_kv):
    """Cross-attention of x on the encoder output: K and V projected from
    it in this block (unroped), q roped at the decoder positions
    (``attn_qkvo(kv_override=)``)."""
    enc_out, k_pos = enc_kv
    B, Le, _ = enc_out.shape
    k = split_heads(enc_out @ wp["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = split_heads(enc_out @ wp["wv"], cfg.n_kv_heads, cfg.head_dim)
    return attn_qkvo(x, wp, cfg, positions, kv_override=(k, v, k_pos))


def _normed(h, g, cfg, mode="train"):
    """``rms_norm(h, g)``.  In training over DTensors the residual's
    partial sums are reduced first (``placed.reduce_partial``) and the
    result's gradient comes back with its forward placements
    (``placed.grad_like_forward``): the tensor-parallel "g" and "f"
    operators.  The serving steps leave placements to propagation."""
    if mode != "train":
        return rms_norm(h, g, cfg.norm_eps)
    return grad_like_forward(rms_norm(reduce_partial(h), g, cfg.norm_eps))


def apply_block(blk: BlockCfg, bp, h, cfg, positions, *, shared=None,
                lora=None, enc_kv=None, cache=None, mode="train"):
    """One block, residual: ``mamba`` runs the Mamba2 mixer; ``attn`` and
    ``shared_attn`` (weights ``shared``) run attention then the gated MLP,
    ``moe`` attention then ``moe_ffn``; ``lora`` (the block's adapters, or
    None) goes to the self-attention.  With ``enc_kv`` (enc-dec models)
    a block that carries cross weights adds, between the two, the
    cross-attention sub-block on the encoder output (``ln_x``, then
    ``_cross_attn``).  Returns (h, aux): aux the MoE block's router loss,
    None for the other kinds.  The cache (prefill/decode modes) is
    written in place."""
    if blk.kind == "mamba":
        def mixer(x, bp, cache):
            return ssm.mamba_block(
                x, bp, cfg, mode=mode,
                decode_cache=cache if mode == "decode" else None,
                prefill_cache=cache if mode == "prefill" else None)

        return h + local_mixer(mixer, _normed(h, bp["ln1"], cfg, mode), bp,
                               cache), None
    if blk.kind == "shared_attn":
        bp = shared
    x = _normed(h, bp["ln1"], cfg, mode)
    dec = pre = None
    if cache is not None and mode == "decode":
        alloc = cache["k"].shape[1]
        dec = dict(k=cache["k"], v=cache["v"], pos=cache["pos"],
                   slot=positions[:, 0] % alloc)
    elif cache is not None and mode == "prefill":
        pre = cache
    h = h + attn_qkvo(x, bp, cfg, positions, lora=lora, decode_cache=dec,
                      prefill_cache=pre, window=blk.window)
    if enc_kv is not None and "wq_x" in bp:
        xp = {"wq": bp["wq_x"], "wk": bp["wk_x"], "wv": bp["wv_x"],
              "wo": bp["wo_x"]}
        h = h + _cross_attn(_normed(h, bp["ln_x"], cfg, mode), xp, cfg,
                            positions, enc_kv)
    x = _normed(h, bp["ln2"], cfg, mode)
    if blk.kind == "moe":
        y, aux = moe_ffn(x, bp, cfg)
        return h + y, aux
    return h + swiglu(x, bp["wi"], bp["wd"]), None


def _block_lora(tree, key, u=None, lead=0):
    """The adapters of block ``key`` (``pos{j}``, sliced at unit ``u``
    behind ``lead`` client axes, or ``blk{i}``) in an adapter subtree, or
    None where it has none (no adapters, a Mamba2 position)."""
    sub = (tree or {}).get(key)
    if not sub:
        return None
    return sub if u is None else _unit_slice(sub, u, lead)


def _run_stack(h, params, cfg: ModelConfig, positions, *, enc_kv=None,
               caches, mode):
    """The serving unit loop (``mode`` "prefill" or "decode"), then the
    tail, writing the caches in place; each block reads its adapters
    from ``params["lora"]`` when it has them.  Returns h."""
    shared = params.get("shared")
    stack, tail = params.get("stack", {}), params.get("tail", {})
    lora = params.get("lora") or {}
    h0 = h
    blocks = [(blk, _unit_slice(stack.get(f"pos{j}", {}), u),
               _block_lora(lora.get("stack"), f"pos{j}", u),
               _unit_slice(caches["stack"][f"pos{j}"], u))
              for u in range(cfg.n_units)
              for j, blk in enumerate(cfg.pattern)]
    blocks += [(cfg.pattern[i], tail.get(f"blk{i}", {}),
                _block_lora(lora.get("tail"), f"blk{i}"),
                caches["tail"][f"blk{i}"]) for i in range(cfg.n_tail)]
    for blk, bp, lp, c in blocks:
        h, _ = apply_block(blk, bp, h, cfg, positions, shared=shared,
                           lora=lp, enc_kv=enc_kv, cache=c, mode=mode)
        h = keep_placements(h, h0)
    return h


def _present(blocks):
    """The entries of ``blocks`` that are not None (a client map takes no
    None inside an argument)."""
    return {k: v for k, v in blocks.items() if v is not None}


def _train_stack(h, params, cfg: ModelConfig, positions, enc_out, lead):
    """The training forward's stack (``mode="train"``): each unit of the
    pattern is one client-mapped call (``_unit_call``: checkpointed under
    ``cfg.remat`` with ``cfg.remat_policy``), the tail blocks follow
    unchecked, as in the reference.  Returns (h, aux): aux the summed
    router loss of the MoE blocks, float32 with the ``lead`` client axes
    (0 without MoE blocks).  Each block's adapters (``params["lora"]``)
    are sliced per unit beside its weights and mapped over the clients;
    under LoRA the base's weights enter every map unmapped."""

    def blocks(kinds):
        def run(h, bps, lps, shared, enc_out):
            enc_kv = None if enc_out is None else _enc_kv(enc_out)
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
            h0 = h
            for i, (blk, bp) in enumerate(zip(kinds, bps)):
                h, a = apply_block(blk, bp, h, cfg, positions, shared=shared,
                                   lora=lps.get(i), enc_kv=enc_kv,
                                   mode="train")
                h = keep_placements(h, h0)
                if a is not None:
                    aux = aux + a
            return h, aux
        return run

    shared = params.get("shared")
    stack, tail = params.get("stack", {}), params.get("tail", {})
    lora = params.get("lora") or {}
    fixed = _frozen_base(cfg, 1, 3)
    base_lead = 0 if fixed else lead
    total = torch.zeros(h.shape[:lead], dtype=torch.float32,
                        device=h.device)
    unit = blocks(cfg.pattern)
    for u in range(cfg.n_units):
        bps = [_unit_slice(stack.get(f"pos{j}", {}), u, base_lead)
               for j in range(len(cfg.pattern))]
        lps = _present({j: _block_lora(lora.get("stack"), f"pos{j}", u, lead)
                        for j in range(len(cfg.pattern))})
        h, aux = _unit_call(cfg, cfg.remat_policy, unit, lead, h, bps, lps,
                            shared, enc_out, fixed=fixed)
        total = total + aux
    for i in range(cfg.n_tail):
        h, aux = _cmap(blocks(cfg.pattern[i:i + 1]), lead, h,
                       [tail.get(f"blk{i}", {})],
                       _present({0: _block_lora(lora.get("tail"),
                                                f"blk{i}")}),
                       shared, enc_out, fixed=fixed)
        total = total + aux
    return h, total


def _embed(params, cfg, tokens, embeds=None):
    """Token embeddings in cfg.dtype; a frontend's stub ``embeds`` [B, F,
    d] take the place of the first F."""
    if is_placed(tokens):
        # vocab-parallel: each rank looks up its rows, then one sum
        # (``placed.embed``), where ``[tokens]`` would gather the table
        h = placed_embed(params["embed"], tokens).to(_dt(cfg))
    else:
        h = params["embed"][tokens].to(_dt(cfg))
    if embeds is not None:
        F = embeds.shape[1]
        h = torch.cat([embeds.to(h.dtype), h[:, F:]], dim=1)
    return h


def forward_hidden(params, cfg: ModelConfig, tokens, *, embeds=None,
                   enc_embeds=None, positions=None, lead=0):
    """Training forward. tokens: [B, L]; ``embeds`` a frontend's stub
    embeddings [B, F, d], ``enc_embeds`` an enc-dec model's encoder input
    [B, Le, d]; with ``lead`` > 0 the trainable parameters and the inputs
    carry that many leading client axes (``positions`` [B, L] do not, nor
    does the frozen base under LoRA).  Returns (h,
    aux); aux is the summed router loss of the MoE blocks, 0 without
    them.  Mamba2 blocks run the plain SSD scan (``mode="train"``)."""
    B, L = tokens.shape[lead:]
    fixed = _frozen_base(cfg, 0)
    h = _cmap(lambda e, t, x: _embed({"embed": e}, cfg, t, x), lead,
              params["embed"], tokens, embeds, fixed=fixed)
    if positions is None:
        positions = placed_like(torch.arange(L, device=h.device)
                                .expand(B, L), tokens)
    enc_out = (encode(params, cfg, enc_embeds, lead=lead) if cfg.enc_dec
               else None)
    h, aux = _train_stack(h, params, cfg, positions, enc_out, lead)
    return _cmap(lambda g, x: _normed(x, g, cfg), lead,
                 params["ln_f"], h, fixed=fixed), aux


def _head_weight(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T  # [d, V]
    return params["unembed"]


def lm_logits(h, params, cfg: ModelConfig):
    logits = h @ _head_weight(params, cfg)
    return softcap(logits.float(), cfg.logit_softcap)


# ===========================================================================
# loss
# ===========================================================================

def lm_loss(params, cfg: ModelConfig, batch, *, lead=0):
    """Mean masked token cross-entropy (+ ``router_aux_coef`` times the
    router loss for MoE models): the reference's ``lm_loss``.

    batch: tokens [B, L], labels [B, L], mask [B, L] (+ ``embeds`` /
    ``enc_embeds``, passed to ``forward_hidden``).  Logits are soft-capped
    in float32; with ``cfg.loss_chunk`` dividing L (and below it) the
    cross-entropy sums over chunks of that many positions, in order; the
    sum is divided by max(sum(mask), 1).  With ``lead`` > 0 every tensor
    of ``batch`` and of the trainable part of ``params`` (all of it in full
    mode, ``params["lora"]`` in LoRA mode) carries that many leading client
    axes, and the result is one loss per client."""
    h, aux = forward_hidden(params, cfg, batch["tokens"],
                            embeds=batch.get("embeds"),
                            enc_embeds=batch.get("enc_embeds"), lead=lead)
    labels, mask = batch["labels"], batch["mask"].float()
    head = params["embed"] if cfg.tie_embeddings else params["unembed"]

    def ce(h_c, w, labels_c, mask_c):
        W = w.T if cfg.tie_embeddings else w
        logits = softcap((h_c @ W).float(), cfg.logit_softcap)
        return token_nll_sum(logits, labels_c, mask_c)

    L, ck = h.shape[-2], cfg.loss_chunk
    fixed = _frozen_base(cfg, 1)
    if ck and L > ck and L % ck == 0:
        total = torch.zeros(h.shape[:lead], dtype=torch.float32,
                            device=h.device)
        for i in range(0, L, ck):
            total = total + _cmap(ce, lead, h[..., i:i + ck, :], head,
                                  labels[..., i:i + ck], mask[..., i:i + ck],
                                  fixed=fixed)
    else:
        total = _cmap(ce, lead, h, head, labels, mask, fixed=fixed)
    loss = total / torch.clamp(mask.sum(dim=(-2, -1)), min=1.0)
    if cfg.is_moe:
        loss = loss + cfg.router_aux_coef * aux
    return loss


def lm_loss_fn(cfg: ModelConfig):
    """The engine's ``loss_fn(trainable, frozen, batch, key)`` over
    ``lm_loss`` of ``merge_trainable(trainable, frozen)``; the key is
    unused, and a batch without ``mask`` counts every label (the
    reference launcher's LM task).  It maps its own client axes
    (``maps_clients``): local SGD hands it the client-stacked tree and
    ``lead``, so its remat checkpoints sit outside the client vmap."""
    def loss_fn(tr, fz, batch, key, *, lead=0):
        if "mask" not in batch:
            batch = dict(batch, mask=torch.ones_like(batch["labels"],
                                                     dtype=torch.float32))
        return lm_loss(merge_trainable(tr, fz, cfg), cfg, batch, lead=lead)

    loss_fn.maps_clients = True
    return loss_fn


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
    both in ``dtype``; full units stacked on [n_units].  An enc-dec
    model's cache also holds the encoder output ``enc_out`` [batch,
    enc_len, d] in ``dtype``, zeros until ``prefill`` writes it."""
    dev = resolve_device(device)
    dtype = dtype or _dt(cfg)

    def stacked(blk):
        one = init_block_cache(blk, cfg, batch, seq_len, dtype, dev)
        return {k: v.expand((cfg.n_units,) + v.shape).clone()
                for k, v in one.items()}

    cache = {"stack": {f"pos{j}": stacked(blk)
                       for j, blk in enumerate(cfg.pattern)},
             "tail": {f"blk{i}": init_block_cache(cfg.pattern[i], cfg,
                                                  batch, seq_len, dtype, dev)
                      for i in range(cfg.n_tail)}}
    if cfg.enc_dec:
        cache["enc_out"] = torch.zeros((batch, cfg.enc_len, cfg.d_model),
                                       dtype=dtype, device=dev)
    return cache


def serve_step(params, cfg: ModelConfig, cache, tokens, pos):
    """One decode step. tokens: [B,1] int; pos: [B] int (absolute index of
    the new token). Returns (logits [B,V], cache), the cache written in
    place.  An enc-dec model's cross-attention reads ``cache["enc_out"]``
    and projects its keys and values again in every layer (the
    reference's arithmetic)."""
    h = _embed(params, cfg, tokens)
    enc_kv = _enc_kv(cache["enc_out"]) if cfg.enc_dec else None
    h = _run_stack(h, params, cfg, pos[:, None], enc_kv=enc_kv,
                   caches=cache, mode="decode")
    h = rms_norm(h, params["ln_f"], cfg.norm_eps)
    return lm_logits(h[:, 0], params, cfg), cache


def prefill(params, cfg: ModelConfig, cache, tokens, *, embeds=None,
            enc_embeds=None, start_pos=0):
    """Full-sequence forward that also populates the decode cache (in
    place). tokens: [B, Lp]; ``embeds`` and ``enc_embeds`` as in
    ``forward_hidden``. Returns (last-position logits [B, V], cache).
    With ``cfg.attn_backend == "flash"`` and Lp % 128 == 0 the decoder's
    self-attention runs through the flash kernel (the encoder and the
    cross-attention run the plain attention, as in the reference); Mamba2
    blocks run their SSD scan through the SSD chunk kernel.  An enc-dec
    model encodes once: the output, cast to the cache's dtype, is written
    into ``cache["enc_out"]``, and the cross-attention reads it uncast."""
    B, L = tokens.shape
    h = _embed(params, cfg, tokens, embeds)
    positions = placed_like(torch.arange(start_pos, start_pos + L,
                                         device=h.device).expand(B, L),
                            tokens)
    enc_kv = None
    if cfg.enc_dec:
        enc_out = encode(params, cfg, enc_embeds)
        if enc_out.shape != cache["enc_out"].shape:
            raise ValueError(f"enc_embeds give an encoder output of shape "
                             f"{tuple(enc_out.shape)}; the cache holds "
                             f"{tuple(cache['enc_out'].shape)}")
        cache["enc_out"].copy_(enc_out)
        enc_kv = _enc_kv(enc_out)
    h = _run_stack(h, params, cfg, positions, enc_kv=enc_kv, caches=cache,
                   mode="prefill")
    h = rms_norm(h, params["ln_f"], cfg.norm_eps)
    return lm_logits(h[:, -1], params, cfg), cache
