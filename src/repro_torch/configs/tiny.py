"""Tiny dense config for tests and the 4-device mini dry-run."""
from repro_torch.models.config import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="tiny",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=128,
    pattern=(BlockCfg("attn", window=16), BlockCfg("attn")),
    dtype="float32",
    remat=False,
    local_steps=2,
    fl_mode="full",
    source="(test fixture)",
)
LONG_CONTEXT = True
