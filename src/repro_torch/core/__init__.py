"""FedAWE's federated-round system in torch: PRNG, flat substrate,
availability processes, fault injection, semi-async rounds, the sparse
cohort, the FedAWE strategies and the round engine."""
from repro_torch.core.availability import (  # noqa: F401
    AvailabilityCfg,
    base_probs,
)
from repro_torch.core.cohort import (  # noqa: F401
    cohort_gather,
    cohort_scatter,
    cohort_select,
)
from repro_torch.core.engine import (  # noqa: F401
    FLConfig,
    FLState,
    client_trainables,
    global_trainables,
    index_seed,
    init_fl_state,
    local_sgd,
    make_chunk_fn,
    make_grid_chunk_fn,
    make_round_fn,
    make_round_fn_with_frozen,
    make_seeds_chunk_fn,
    run_rounds,
    seed_vmap,
    stack_seeds,
)
from repro_torch.core.faults import (  # noqa: F401
    FaultCfg,
    adversarial_probs_from_nu,
    clusters_from_nu,
    diurnal_trace,
    init_fault_state,
)
from repro_torch.core.flatten import FlatSpec, resident_dtype  # noqa: F401
from repro_torch.core.staleness import (  # noqa: F401
    StalenessCfg,
    init_staleness_state,
    staircase_delay_trace,
)
from repro_torch.core.strategies import REGISTRY, get_strategy  # noqa: F401
