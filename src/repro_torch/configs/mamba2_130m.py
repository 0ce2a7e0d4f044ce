"""mamba2-130m [ssm] — 24L d_model=768 attn-free, ssm_state=128,
vocab=50280. SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.models.config import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    pattern=(BlockCfg("mamba"),),
    ssm_state=128,
    ssm_heads=24,        # d_inner = 2*d_model = 1536 = 24 heads x 64
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=128,
    tie_embeddings=True,
    loss_chunk=512,
    local_steps=2,
    fl_mode="full",
    source="arXiv:2405.21060",
)
LONG_CONTEXT = True  # O(1)-state decode
