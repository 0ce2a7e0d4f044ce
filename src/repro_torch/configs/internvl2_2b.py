"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553. InternViT vision encoder is an embedding stub per the
assignment carve-out (input_specs provides 1024 patch embeddings); the
InternLM2-chat-1.8B language backbone is implemented in full.
[arXiv:2404.16821]"""
from repro_torch.models.config import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92553,
    pattern=(BlockCfg("attn"),),
    rope_theta=1000000.0,
    tie_embeddings=False,
    frontend="vision",
    frontend_len=1024,   # image patch tokens prepended to the text span
    attn_chunk=512,
    loss_chunk=512,
    local_steps=2,
    fl_mode="full",
    source="arXiv:2404.16821",
)
LONG_CONTEXT = False  # full attention; long_500k skipped (DESIGN.md)
