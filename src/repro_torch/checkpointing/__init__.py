"""Conversion of the JAX package's parameters into the port's tensors."""
from repro_torch.checkpointing.convert import params_from_numpy  # noqa: F401
