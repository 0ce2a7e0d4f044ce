"""FedAWE's federated-round system in torch: PRNG, flat substrate,
availability processes, the FedAWE strategy and the round engine."""
from repro_torch.core.availability import AvailabilityCfg  # noqa: F401
from repro_torch.core.engine import (  # noqa: F401
    FLConfig,
    FLState,
    global_trainables,
    init_fl_state,
    local_sgd,
    make_chunk_fn,
    make_round_fn,
    run_rounds,
)
from repro_torch.core.flatten import FlatSpec, resident_dtype  # noqa: F401
from repro_torch.core.strategies import REGISTRY, get_strategy  # noqa: F401
