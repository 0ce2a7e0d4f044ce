"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) per-expert
d_ff=16384 vocab=32768, 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]

FL mode: lora — 140B-param per-client copies are infeasible; expert FFNs are
frozen + FSDP-sharded over ('data','model'); clients train attention
adapters (DESIGN.md §3)."""
from repro_torch.models.config import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab=32768,
    pattern=(BlockCfg("moe", window=4096),),
    n_experts=8,
    top_k=2,
    expert_ff=16384,
    capacity_factor=1.25,
    rope_theta=1000000.0,
    tie_embeddings=False,
    attn_chunk=512,
    loss_chunk=512,
    local_steps=2,
    fl_mode="lora",
    lora_rank=16,
    source="arXiv:2401.04088",
)
LONG_CONTEXT = True  # SWA(4096) on every layer -> rolling caches
