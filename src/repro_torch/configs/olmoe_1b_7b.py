"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (kv=16) per-expert d_ff=1024
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060]"""
from repro_torch.models.config import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab=50304,
    pattern=(BlockCfg("moe"),),
    n_experts=64,
    top_k=8,
    expert_ff=1024,
    capacity_factor=1.25,
    tie_embeddings=False,
    attn_chunk=512,
    loss_chunk=512,
    local_steps=2,
    fl_mode="full",
    source="arXiv:2409.02060",
)
LONG_CONTEXT = False  # full attention; long_500k skipped (DESIGN.md)
