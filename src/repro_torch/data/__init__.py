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
    device_store,
    init_seed_sampler_states,
    make_device_sampler,
    pad_store,
    padded_client_index,
    seed_data_keys,
)
