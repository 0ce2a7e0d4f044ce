"""Models of the port: the Table-6 CNN of the simulation tier (``cnn``)
and the LM substrate's dense attention, MoE, Mamba2 and
shared-attention blocks (``config``, ``layers``, ``moe``, ``ssm``,
``model``), with the reference's exports minus the training-only
``lm_loss``, ``split_trainable`` and ``merge_trainable``."""
from repro_torch.models.config import BlockCfg, ModelConfig, reduced  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    count_params,
    forward_hidden,
    init_cache,
    init_params,
    serve_step,
)
