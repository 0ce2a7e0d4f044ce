"""Parameters from the JAX package's layout into the port's tensors.

Both packages keep the same layout (HWIO conv kernels, ``[din, dout]``
dense weights, nested dicts whose LM stack leaves carry a leading
``[n_units]`` axis), so converting is a dtype and device move only: no
transpose, no renaming.  bfloat16 leaves (numpy's ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` rejects) travel as their 16-bit patterns, so
they arrive bit for bit."""
from __future__ import annotations

import numpy as np
import torch


def _leaf(x):
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device):
    """Nested dict of numpy (or JAX) arrays -> the same dict of tensors on
    ``device``, each leaf keeping its dtype and bits."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _leaf(tree).to(device)
