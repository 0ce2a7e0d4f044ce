from repro_torch.data.partition import dirichlet_partition  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticImageTask,
    SyntheticLMTask,
    make_image_classification,
    make_lm_tokens,
)
from repro_torch.data.federated import (  # noqa: F401
    SAMPLING_MODES,
    FederatedDataset,
    contiguous_client_index,
    device_store,
    gather_batches_at,
    init_seed_sampler_states,
    make_device_sampler,
    pad_store,
    padded_client_index,
    seed_data_keys,
)
