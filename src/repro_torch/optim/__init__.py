"""Hand-written optimizers and learning-rate schedules; a port of
``repro/optim``."""
from repro_torch.optim.optimizers import adam, momentum, sgd  # noqa: F401
from repro_torch.optim.schedules import (  # noqa: F401
    constant_schedule,
    cosine_schedule,
    paper_schedule,
)
