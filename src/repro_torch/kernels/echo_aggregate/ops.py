"""Checked wrappers: flat client stacks -> the echo-aggregate kernel.

``echo_aggregate_flat`` is the single-launch FedAWE server update over the
flat ``[m, N]`` substrate (core/flatten.py), guard included;
``echo_aggregate`` is the masked echo mean without the guard.

Device dispatch is by the tensors' device and nothing else: CPU tensors
take the plain version (``ref.py``); CUDA tensors launch the Triton kernel
(``kernel.py``) or raise.  There is no fallback from the kernel to the
plain version.  Each wrapper counts its kernel launches in plain integer
attributes (``echo_aggregate_flat.launches`` for the fault-free update,
``echo_aggregate_flat.upload_launches`` for the ``upload=`` variant,
``echo_aggregate.launches``), so a run can show that it went through the
kernel; a caller resets them by assigning 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.echo_aggregate import kernel
from repro_torch.kernels.echo_aggregate.ref import (echo_aggregate_fused_ref,
                                                    echo_aggregate_ref)

STACK_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, y, vecs, g=None):
    """Validate the operands the kernel takes; raise on anything else."""
    if x.dim() != 2 or x.shape != y.shape:
        raise ValueError(f"x, y must be [m, N] of one shape; got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    m, n = x.shape
    if m < 1 or n < 1:
        raise ValueError(f"empty client stack {tuple(x.shape)}")
    if x.dtype not in STACK_DTYPES or y.dtype != x.dtype:
        raise TypeError(f"x, y must share a dtype in {STACK_DTYPES}; got "
                        f"{x.dtype} and {y.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("x, y must be contiguous")
    for name, v in vecs.items():
        if v is not None and tuple(v.shape) != (m,):
            raise ValueError(f"{name} must be [m] = [{m}]; got "
                             f"{tuple(v.shape)}")
    if g is not None and tuple(g.shape) != (n,):
        raise ValueError(f"global must be [N] = [{n}]; got {tuple(g.shape)}")
    operands = [x, y, g] + list(vecs.values())
    if any(t is not None and t.device != x.device for t in operands):
        raise ValueError("all operands must lie on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _check_eta(eta_g):
    """η_g is static config, a Python number; the kernel takes it as a
    scalar argument (a tensor would be taken for a pointer)."""
    if isinstance(eta_g, bool) or not isinstance(eta_g, (int, float)):
        raise TypeError(f"eta_g must be a Python number; got "
                        f"{type(eta_g).__name__}")


def _weights(mask, upload):
    w = mask.float()
    return w if upload is None else w * upload.float()


def echo_aggregate_flat(clients_flat, x_end_flat, global_flat, mask, echo,
                        eta_g, *, upload=None):
    """Fused FedAWE update on the flat substrate: one launch, guard included.

    clients_flat, x_end_flat: [m, N] start / post-local-SGD stacks;
    global_flat: [N] previous global (returned verbatim on empty rounds).
    ``upload`` ([m], optional) is the mid-round delivery weight fused into
    the kernel weights.  Returns the new [N] float32 global."""
    _check(clients_flat, x_end_flat, dict(mask=mask, echo=echo,
                                          upload=upload), g=global_flat)
    _check_eta(eta_g)
    if clients_flat.device.type == "cpu":
        return echo_aggregate_fused_ref(clients_flat, x_end_flat,
                                        global_flat, mask, echo, eta_g,
                                        upload=upload)
    out = kernel.echo_aggregate_triton(
        clients_flat, x_end_flat, global_flat.float().contiguous(),
        _weights(mask, upload).contiguous(), echo.float().contiguous(),
        eta_g, has_guard=True)
    if upload is None:
        echo_aggregate_flat.launches += 1
    else:
        echo_aggregate_flat.upload_launches += 1
    return out


echo_aggregate_flat.launches = 0
echo_aggregate_flat.upload_launches = 0


def echo_aggregate(x, y, mask, echo, eta_g):
    """x, y: [m, ...]; returns the aggregated [...] (float32).  No
    empty-round guard — callers apply the W = I rule themselves."""
    m = x.shape[0]
    flat_x = x.reshape(m, -1)
    flat_y = y.reshape(m, -1)
    _check(flat_x, flat_y, dict(mask=mask, echo=echo))
    _check_eta(eta_g)
    if flat_x.device.type == "cpu":
        out = echo_aggregate_ref(flat_x, flat_y, mask, echo, eta_g)
    else:
        out = kernel.echo_aggregate_triton(
            flat_x, flat_y, flat_x, _weights(mask, None).contiguous(),
            echo.float().contiguous(), eta_g, has_guard=False)
        echo_aggregate.launches += 1
    return out.reshape(x.shape[1:])


echo_aggregate.launches = 0
