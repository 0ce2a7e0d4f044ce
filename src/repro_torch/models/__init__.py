"""Models of the port: the Table-6 CNN of the simulation tier (``cnn``)
and the LM substrate's dense attention, MoE, Mamba2 and
shared-attention blocks (``config``, ``layers``, ``moe``, ``ssm``,
``model``), with the reference's exports, ``lm_loss`` and the
trainable split of full-parameter training among them."""
from repro_torch.models.config import BlockCfg, ModelConfig, reduced  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    count_params,
    forward_hidden,
    init_cache,
    init_params,
    init_params_from_key,
    lm_loss,
    lm_loss_fn,
    merge_trainable,
    serve_step,
    split_trainable,
)
