"""Parameters from the JAX package's layout into the port's tensors.

Both packages keep the same layout (HWIO conv kernels, ``[din, dout]``
dense weights, nested dicts), so converting is a dtype and device move
only: no transpose, no renaming."""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device):
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device``, each leaf keeping its dtype."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)
