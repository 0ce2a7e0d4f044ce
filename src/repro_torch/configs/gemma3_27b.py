"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144. 5:1 local(1024):global attention, 128k context.
[hf:google/gemma-3-1b-pt family card]

FL mode: lora — 27B per-client full copies exceed v5e HBM for client-stacked
FedAWE; clients train rank-16 attention adapters over a frozen FSDP base
(DESIGN.md §3)."""
from repro_torch.models.config import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    pattern=(BlockCfg("attn", window=1024),) * 5 + (BlockCfg("attn"),),
    logit_softcap=30.0,
    rope_theta=10000.0,
    tie_embeddings=True,
    attn_chunk=512,
    loss_chunk=512,
    local_steps=2,
    fl_mode="lora",
    lora_rank=16,
    source="hf:google/gemma-3-1b-pt",
)
LONG_CONTEXT = True  # 52/62 layers sliding; ~10 global 500k caches fit
