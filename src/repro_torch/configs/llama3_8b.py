"""llama3-8b [dense] — BONUS architecture (not part of the assigned pool;
demonstrates config extensibility): 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256, rope theta 5e5. [arXiv:2407.21783]"""
from repro_torch.models.config import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    pattern=(BlockCfg("attn"),),
    rope_theta=500000.0,
    tie_embeddings=False,
    attn_chunk=512,
    loss_chunk=512,
    local_steps=2,
    fl_mode="full",
    source="arXiv:2407.21783",
)
LONG_CONTEXT = False  # pure full attention
