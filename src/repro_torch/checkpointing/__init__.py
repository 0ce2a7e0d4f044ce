"""Checkpoint I/O in the JAX package's format, and conversion of its
parameters into the port's tensors."""
from repro_torch.checkpointing.convert import params_from_numpy  # noqa: F401
from repro_torch.checkpointing.io import (  # noqa: F401
    load_pytree,
    restore_fl_state,
    restore_run_state,
    save_fl_state,
    save_pytree,
    save_run_state,
)
