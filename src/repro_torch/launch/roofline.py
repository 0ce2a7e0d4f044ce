"""Analytic roofline model (napkin math, codified); the port of the
reference's ``repro/launch/roofline.py``, its formulas unchanged.

Conventions
-----------
* per-DEVICE quantities throughout; ``ax`` names the mesh's axis sizes
  (``'data'``, ``'model'``, ``'pod'``).
* FLOPs: training = 6·N·D matmul convention (+ attention/SSD/MoE-capacity
  terms); inference = 2·N·D.
* HBM bytes: weight-shard traffic x pass count + activation traffic
  (d-width tensors replicated over 'model'; ff-width tensors sharded).
* Collective seconds include the ring factor 2(n-1)/n ~= 2 on all-reduce;
  all-gather/all-to-all counted at payload size.

The seconds divide by the H100 SXM's constants (``launch/mesh.py``): the
bf16 tensor-core peak, HBM3's rate and NVLink 4's rate each way.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16


def _blocks(cfg):
    return cfg.layer_blocks()


def _param_counts(cfg) -> Dict[str, float]:
    """Split parameter counts by role (per full model copy)."""
    d = cfg.d_model
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    attn = moe = dense_ff = ssm = 0
    shared_attn_done = False
    for b in _blocks(cfg):
        if b.kind == "mamba":
            di = cfg.ssm_inner
            gn = cfg.ssm_groups * cfg.ssm_state
            ssm += d * (2 * di + 2 * gn + cfg.ssm_heads) + di * d
        elif b.kind == "moe":
            attn += d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
            moe += 3 * cfg.n_experts * d * cfg.expert_ff
            moe += 3 * cfg.n_shared_experts * d * cfg.expert_ff
        else:
            if b.kind == "shared_attn" and shared_attn_done:
                continue  # weight-shared
            if b.kind == "shared_attn":
                shared_attn_done = True
            attn += d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
            dense_ff += 3 * d * cfg.d_ff
    if cfg.enc_dec:
        # encoder stack + per-decoder-block cross-attention projections
        attn += cfg.n_enc_layers * (
            d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d)
        dense_ff += cfg.n_enc_layers * 3 * d * cfg.d_ff
        attn += cfg.n_layers * (
            d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d)
    return dict(embed=emb, attn=attn, moe=moe, dense_ff=dense_ff, ssm=ssm,
                total=emb + attn + moe + dense_ff + ssm)


def _active_matmul_params(cfg) -> float:
    """Params touched per token, with weight-shared blocks counted per
    APPLICATION (compute-wise they run every occurrence)."""
    pc = _param_counts(cfg)
    n_shared = sum(1 for b in _blocks(cfg) if b.kind == "shared_attn")
    d = cfg.d_model
    shared_extra = max(0, n_shared - 1) * (
        d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d + 3 * d * cfg.d_ff)
    active_moe = pc["moe"]
    if cfg.n_experts:
        n_moe = sum(1 for b in _blocks(cfg) if b.kind == "moe")
        active_moe = n_moe * 3 * cfg.d_model * cfg.expert_ff * (
            cfg.top_k * cfg.capacity_factor + cfg.n_shared_experts)
    return (pc["embed"] / (1 if cfg.tie_embeddings else 2)  # head matmul once
            + pc["attn"] + pc["dense_ff"] + pc["ssm"] + active_moe
            + shared_extra)


def _attn_flops_per_token(cfg, ctx_len, full_ctx) -> float:
    """QK^T + PV flops per token (forward), summed over layers."""
    total = 0.0
    for b in _blocks(cfg):
        if b.kind == "mamba":
            # SSD: intra-chunk quadratic + state update/output
            H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            total += 2 * (cfg.ssm_chunk / 2) * H * P * 2  # intra-chunk
            total += 6 * H * P * N                        # state in/out
            continue
        w = b.window
        eff = min(w, ctx_len) if w else (ctx_len / 2 if full_ctx else ctx_len)
        total += 2 * eff * cfg.q_dim * 2  # qk + pv
        if cfg.enc_dec:
            total += 2 * cfg.enc_len * cfg.q_dim * 2  # cross attention
    return total


def analytic_costs(cfg, shape, ax: Dict[str, int], *, fl_clients=None):
    """Returns per-device dict: flops, hbm_bytes, coll_bytes + breakdown."""
    d_ax, m_ax = ax.get("data", 1), ax.get("model", 1)
    p_ax = ax.get("pod", 1)
    chips = d_ax * m_ax * p_ax
    d = cfg.d_model
    pc = _param_counts(cfg)
    n_act = _active_matmul_params(cfg)
    L = shape.seq_len
    bf = 2  # bf16 bytes

    if shape.kind == "train":
        m = fl_clients or (p_ax * d_ax)
        b = max(1, shape.global_batch // m)
        s = cfg.local_steps
        tok_client = s * b * L  # tokens per client per round
        # ---- FLOPs (per device = one client / model-shard) ----
        mm = 6.0 * n_act * tok_client
        at = 4.0 * _attn_flops_per_token(cfg, L, True) * tok_client
        flops = (mm + at) / m_ax
        # ---- HBM bytes ----
        w_shard = pc["total"] * bf / m_ax
        # fwd + remat + bwd reads + f32 grad write/read
        weight_traffic = w_shard * (3 + 2 * 2)
        # client-stack echo/gossip: read x_i, write x_i, read/write global
        fl_traffic = 4 * (pc["total"] if cfg.fl_mode == "full" else
                          _lora_params(cfg)) * bf / m_ax
        act_traffic = (len(_blocks(cfg)) * tok_client * d * bf *
                       (6 + 4 / m_ax))
        hbm = weight_traffic + fl_traffic + act_traffic
        # ---- collective bytes ----
        # tensor-parallel all-reduces: ~2/layer/pass x (fwd+remat+bwd)
        ar_layer = 6 * len(_blocks(cfg)) * tok_client * d * bf
        # implicit-gossip all-reduce over the client axis (f32 shard)
        trainable = pc["total"] if cfg.fl_mode == "full" else _lora_params(cfg)
        gossip = 2 * trainable * 4 / m_ax
        # FSDP all-gather of the frozen base per pass (lora mode)
        fsdp = 0.0
        if cfg.fl_mode == "lora":
            fsdp = 3 * s * pc["total"] * bf / m_ax * (1 - 1 / d_ax)
        # MoE all-to-all (expert-sharded dispatch there and back, fwd+bwd)
        a2a = 0.0
        if cfg.is_moe and cfg.n_experts % m_ax == 0:
            a2a = 4 * tok_client * d * bf * cfg.top_k * cfg.capacity_factor
        coll = 2 * (ar_layer + gossip) + fsdp + a2a
        extra = dict(tokens_per_round=m * tok_client, clients=m)
    elif shape.kind == "prefill":
        B = shape.global_batch
        toks = B * L
        mm = 2.0 * n_act * toks
        at = 1.0 * _attn_flops_per_token(cfg, L, True) * toks
        flops = (mm + at) / chips
        w_shard = pc["total"] * bf / (m_ax * (d_ax if cfg.fl_mode == "lora"
                                              else 1))
        cache = _cache_bytes(cfg, B, L)
        act_traffic = len(_blocks(cfg)) * toks * d * bf * (6 + 4 / m_ax) / d_ax
        hbm = w_shard * (2 if cfg.fl_mode != "lora" else 2 * d_ax) \
            + cache / chips + act_traffic
        ar_layer = 4 * len(_blocks(cfg)) * toks * d * bf / d_ax
        fsdp = pc["total"] * bf / m_ax * (1 - 1 / d_ax) \
            if cfg.fl_mode == "lora" else 0.0
        a2a = (2 * toks * d * bf * cfg.top_k * cfg.capacity_factor / d_ax
               if cfg.is_moe and cfg.n_experts % m_ax == 0 else 0.0)
        coll = 2 * ar_layer + fsdp + a2a
        extra = dict(tokens=toks)
    else:  # decode: ONE token per sequence against a seq_len cache
        B = shape.global_batch
        mm = 2.0 * n_act * B
        at = _attn_flops_per_token(cfg, L, False) * B
        flops = (mm + at) / chips
        w_read = pc["total"] * bf / (m_ax * (d_ax if cfg.fl_mode == "lora"
                                             else 1))
        if cfg.fl_mode == "lora":
            w_read = pc["total"] * bf / m_ax  # gathered then read
        cache = _cache_bytes(cfg, B, L)
        hbm = (w_read + cache / chips
               + B * d * len(_blocks(cfg)) * bf * 8 / chips)
        ar_layer = 4 * len(_blocks(cfg)) * B * d * bf / d_ax
        fsdp = pc["total"] * bf / m_ax * (1 - 1 / d_ax) \
            if cfg.fl_mode == "lora" else 0.0
        coll = 2 * ar_layer + fsdp
        extra = dict(cache_bytes_total=cache)

    return dict(
        flops_per_dev=flops,
        hbm_bytes_per_dev=hbm,
        coll_bytes_per_dev=coll,
        compute_s=flops / PEAK_FLOPS_BF16,
        memory_s=hbm / HBM_BW,
        collective_s=coll / ICI_BW,
        params_total=pc["total"],
        params_active=n_act,
        **extra,
    )


def _lora_params(cfg) -> float:
    per_block = 2 * cfg.lora_rank * (2 * cfg.d_model + cfg.q_dim + cfg.kv_dim
                                     + (cfg.q_dim + cfg.kv_dim) / 2)
    n_attn = sum(1 for b in _blocks(cfg) if b.kind != "mamba")
    return per_block * n_attn


def _cache_bytes(cfg, B, L) -> float:
    total = 0.0
    for b in _blocks(cfg):
        if b.kind == "mamba":
            total += B * (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
                          + 3 * cfg.ssm_conv_dim) * 2
        else:
            alloc = min(b.window, L) if b.window else L
            total += 2 * B * alloc * cfg.kv_dim * 2
    if cfg.enc_dec:
        total += B * cfg.enc_len * cfg.d_model * 2
    return total


def dominant(terms: Dict[str, float]) -> str:
    keys = ("compute_s", "memory_s", "collective_s")
    return max(keys, key=lambda k: terms[k])
