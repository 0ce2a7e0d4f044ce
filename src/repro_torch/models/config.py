"""Model configuration schema for the unified architecture substrate: a
copy of ``repro/models/config.py`` (no JAX in it), so the port keeps the
reference's config fields and ``reduced``.

Every assigned architecture is expressed as a repeating *pattern* of block
descriptors (attention / MoE / Mamba2 / shared-attention), plus dimension
fields. The stack runs as a loop over full repetitions of the pattern
("units", weights stacked on a leading unit axis) followed by the
non-divisible tail.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """One block position inside the repeating pattern.

    kind:   'attn' | 'moe' | 'mamba' | 'shared_attn'
    window: sliding-window size for attention kinds; None => global/full.
    """

    kind: str = "attn"
    window: Optional[int] = None

    def __post_init__(self):
        assert self.kind in ("attn", "moe", "mamba", "shared_attn"), self.kind


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: Tuple[BlockCfg, ...] = (BlockCfg("attn"),)

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_groups: int = 1
    ssm_chunk: int = 128
    ssm_conv: int = 4

    # --- misc architecture knobs ---
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    # --- encoder-decoder / modality frontends ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_len: int = 0          # encoder sequence length (audio frames)
    frontend: str = "none"    # 'none' | 'audio' | 'vision'
    frontend_len: int = 0     # stub embedding positions prepended to text

    # --- numerics / training ---
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"  # 'full' | 'dots' (save matmul outputs)
    attn_backend: str = "xla"   # 'xla' | 'flash' (Pallas kernel; prefill
    #                             path only — the kernel is forward-only)
    attn_chunk: int = 0       # >0: query-chunked attention (memory-lean)
    loss_chunk: int = 0       # >0: chunked cross-entropy over the sequence

    # --- federated-learning integration ---
    fl_mode: str = "full"     # 'full' | 'lora'
    lora_rank: int = 16
    local_steps: int = 2      # s in the paper

    # provenance
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return any(b.kind == "moe" for b in self.pattern)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    @property
    def ssm_conv_dim(self) -> int:
        # channels that pass through the causal depthwise conv: x, B, C
        return self.ssm_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def n_tail(self) -> int:
        return self.n_layers - self.n_units * len(self.pattern)

    def layer_blocks(self):
        """Full per-layer block descriptor list (length n_layers)."""
        p = list(self.pattern)
        out = p * self.n_units + p[: self.n_tail]
        assert len(out) == self.n_layers
        return out

    def param_count(self, trainable_only: bool = False) -> int:
        """Analytic parameter count (matches init_params)."""
        from repro_torch.models import model as _model

        return _model.count_params(self, trainable_only=trainable_only)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized variant of the same family (<=2 units of the same
    pattern, d_model<=256, <=4 experts), per the assignment rules."""
    unit = len(cfg.pattern)
    n_layers = min(cfg.n_layers, 2 * unit)
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    # keep the GQA ratio flavour if possible
    if cfg.n_kv_heads < cfg.n_heads:
        n_kv = max(1, n_heads // 2)
    head_dim = min(cfg.head_dim, 64)
    kw = dict(
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else cfg.d_ff,
        vocab=min(cfg.vocab, 512),
        dtype="float32",
        remat=False,
        attn_chunk=0,
        loss_chunk=0,
        local_steps=2,
    )
    if cfg.is_moe:
        kw.update(
            n_experts=min(cfg.n_experts, 4),
            top_k=min(cfg.top_k, 2),
            expert_ff=min(cfg.expert_ff, 128),
        )
    if cfg.ssm_heads:
        kw.update(ssm_heads=4, ssm_head_dim=16, ssm_state=16, ssm_chunk=8)
    if cfg.enc_dec:
        kw.update(n_enc_layers=2, enc_len=min(cfg.enc_len, 16))
    if cfg.frontend != "none":
        kw.update(frontend_len=min(cfg.frontend_len, 8))
    # shrink windows so they are exercised at tiny seq lens
    pat = tuple(
        BlockCfg(b.kind, window=None if b.window is None else 8) for b in cfg.pattern
    )
    kw["pattern"] = pat
    kw.update(overrides)
    return cfg.replace(**kw)
