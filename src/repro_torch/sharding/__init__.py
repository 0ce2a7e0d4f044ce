"""Sharding rules (partition specs, their DTensor placements) and the
client placement of a rank under a process group."""
from repro_torch.sharding.rules import (  # noqa: F401
    P,
    batch_pspecs,
    cache_pspecs,
    client_stack_pspecs,
    cohort_pspecs,
    flat_pspecs,
    local_shape,
    param_pspecs,
    placements,
    sampler_pspecs,
    seed_axes_for,
    seed_pspecs,
    serve_batch_pspecs,
)
