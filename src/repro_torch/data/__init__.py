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
    make_device_sampler,
    padded_client_index,
)
