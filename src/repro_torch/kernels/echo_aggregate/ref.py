"""Plain torch versions of the fused echo-aggregate operator (FedAWE lines
10-11 + line 4 of Algorithm 1, fused over the client axis): ports of the
JAX package's ``kernels/echo_aggregate/ref.py``."""
from __future__ import annotations

import torch


def echo_aggregate_ref(x, y, mask, echo, eta_g, *, upload=None):
    """x, y: [m, N] (client start / post-local-SGD params); mask, echo: [m].

    Returns [N] float32: the mean over active clients of
        x_i - eta_g * echo_i * (x_i - y_i).
    Empty mask returns zeros (callers apply the W=I empty-round rule).
    ``upload`` ([m], optional) makes the weight ``mask_i * upload_i``.
    """
    x32 = x.float()
    y32 = y.float()
    w = mask.float()
    if upload is not None:
        w = w * upload.float()
    e = echo.float()
    xd = x32 - eta_g * e[:, None] * (x32 - y32)
    denom = torch.clamp(w.sum(), min=1.0)
    return (w[:, None] * xd).sum(dim=0) / denom


def echo_aggregate_fused_ref(x, y, g, mask, echo, eta_g, *, upload=None):
    """``echo_aggregate_ref`` plus the empty-round guard: with no
    delivering client the result is the previous global ``g``."""
    acc = echo_aggregate_ref(x, y, mask, echo, eta_g, upload=upload)
    w = mask.float()
    if upload is not None:
        w = w * upload.float()
    return torch.where(w.sum() > 0, acc, g.float())
