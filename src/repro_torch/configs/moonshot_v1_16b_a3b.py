"""moonshot-v1-16b-a3b — 48L d_model=2048 16H (kv=16) vocab=163840,
MoE 64 experts top-6 with per-expert d_ff=1408 (+2 shared experts,
Moonlight/DeepSeek-style). The pool labels it [dense] but specifies MoE
fields; we implement the MoE reading per the Moonlight-16B-A3B card.
[hf:moonshotai/Moonlight-16B-A3B]"""
from repro_torch.models.config import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab=163840,
    pattern=(BlockCfg("moe"),),
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    expert_ff=1408,
    capacity_factor=1.25,
    tie_embeddings=False,
    attn_chunk=512,
    loss_chunk=512,
    local_steps=2,
    fl_mode="full",
    source="hf:moonshotai/Moonlight-16B-A3B",
)
LONG_CONTEXT = False  # full attention; long_500k skipped (DESIGN.md)
