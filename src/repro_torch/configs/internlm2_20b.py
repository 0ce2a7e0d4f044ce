"""internlm2-20b [dense] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544. [arXiv:2403.17297]"""
from repro_torch.models.config import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92544,
    pattern=(BlockCfg("attn"),),
    rope_theta=1000000.0,
    tie_embeddings=False,
    attn_chunk=512,
    loss_chunk=512,
    local_steps=2,
    fl_mode="full",
    source="arXiv:2403.17297",
)
LONG_CONTEXT = False  # pure full attention; long_500k skipped (DESIGN.md)
