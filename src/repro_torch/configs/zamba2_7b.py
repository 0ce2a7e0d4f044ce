"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64. Mamba2 backbone + weight-shared attention blocks applied every
6th position (the released model adds per-invocation LoRA deltas to the
shared block; we keep the shared-weights essence — DESIGN.md §4).
[arXiv:2411.15242]"""
from repro_torch.models.config import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    pattern=(BlockCfg("mamba"),) * 5 + (BlockCfg("shared_attn"),),
    ssm_state=64,
    ssm_heads=112,       # d_inner = 2*d_model = 7168 = 112 heads x 64
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=128,
    tie_embeddings=True,
    attn_chunk=512,
    loss_chunk=512,
    local_steps=2,
    fl_mode="full",
    source="arXiv:2411.15242",
)
LONG_CONTEXT = True  # SSM decode + 13 shared-attn 500k caches fit
