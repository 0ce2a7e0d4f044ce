"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Local(4096)+global alternating attention, attn/logit soft-capping.
[arXiv:2408.00118]"""
from repro_torch.models.config import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    pattern=(BlockCfg("attn", window=4096), BlockCfg("attn")),
    logit_softcap=30.0,
    attn_softcap=50.0,
    rope_theta=10000.0,
    tie_embeddings=True,
    attn_chunk=512,
    loss_chunk=512,
    local_steps=2,
    fl_mode="full",
    source="arXiv:2408.00118",
)
LONG_CONTEXT = True  # sliding-window layers; 13 global layers' 500k cache fits
