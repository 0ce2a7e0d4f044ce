"""Plain torch versions of the fused echo-aggregate operator (FedAWE lines
10-11 + line 4 of Algorithm 1, fused over the client axis): ports of the
JAX package's ``kernels/echo_aggregate/ref.py``; and
``echo_aggregate_split_ref``, the CUDA kernel's own arithmetic (row
slices, rank-ordered combine) in plain torch, an oracle for the kernel.

Each takes an optional leading seed axis: ``[S, m, N]`` stacks with
``[S, m]`` vectors and ``[S, N]`` globals give ``[S, N]``, seed ``j``'s
row bit-equal to the function on seed ``j`` alone (the reductions run
over the client axis, as ``torch.func.vmap`` of the single-seed function
runs them)."""
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
    xd = x32 - eta_g * e[..., None] * (x32 - y32)
    denom = torch.clamp(w.sum(dim=-1), min=1.0)
    return (w[..., None] * xd).sum(dim=-2) / denom[..., None]


def echo_aggregate_fused_ref(x, y, g, mask, echo, eta_g, *, upload=None):
    """``echo_aggregate_ref`` plus the empty-round guard: with no
    delivering client the result is the previous global ``g``."""
    acc = echo_aggregate_ref(x, y, mask, echo, eta_g, upload=upload)
    w = mask.float()
    if upload is not None:
        w = w * upload.float()
    return torch.where(w.sum(dim=-1)[..., None] > 0, acc, g.float())


def slice_bounds(m, slices):
    """Row ranges of the CUDA kernel's slices: slice k takes rows
    ``[k m // slices, (k + 1) m // slices)``."""
    return [(k * m // slices, (k + 1) * m // slices) for k in range(slices)]


def echo_aggregate_split_ref(x, y, g, mask, echo, eta_g, *, slices,
                             upload=None):
    """The CUDA kernel's arithmetic (``csrc/echo_aggregate.cu``), operation
    for operation in float32: per slice of ``slice_bounds(m, slices)``, the
    rows added in order into column sums and a weight sum from 0, each
    product and sum rounded where it is written; the slices' partials
    added in rank order 0, 1, ...; then ``acc / max(sum w, 1)``, and with
    a global ``g`` (None: no guard) ``g`` where ``sum w <= 0``.  Columns
    are independent, so the column tiles do not enter.  x, y: [m, N];
    mask, echo, upload: [m].  Returns [N] float32.  With a seed axis each
    seed is its own launch's arithmetic (the kernel's ``blockIdx.z``)."""
    if x.dim() == 3:
        return torch.stack([echo_aggregate_split_ref(
            x[j], y[j], None if g is None else g[j], mask[j], echo[j],
            eta_g, slices=slices, upload=None if upload is None
            else upload[j]) for j in range(x.shape[0])])
    m, n = x.shape
    w = mask.float()
    if upload is not None:
        w = w * upload.float()
    c = eta_g * echo.float()
    accs, sums = [], []
    for lo, hi in slice_bounds(m, slices):
        acc = torch.zeros(n, dtype=torch.float32, device=x.device)
        ws = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(lo, hi):
            xi, yi = x[i].float(), y[i].float()
            acc = acc + w[i] * (xi - c[i] * (xi - yi))
            ws = ws + w[i]
        accs.append(acc)
        sums.append(ws)
    acc, ws = accs[0], sums[0]
    for a, s in zip(accs[1:], sums[1:]):
        acc = acc + a
        ws = ws + s
    res = acc / torch.clamp(ws, min=1.0)
    if g is None:
        return res
    return torch.where(ws > 0, res, g.float())
