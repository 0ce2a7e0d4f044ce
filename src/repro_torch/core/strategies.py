"""Aggregation strategies: FedAWE (the paper) on the flat substrate.

The uniform interface of the reference: a strategy consumes the per-round
quantities (client-stacked innovations ``G`` = x_start − x_end, the
availability mask, the true probabilities) and produces the new global,
the new client stack, the new τ vector and its own auxiliary state.

Ported so far: FedAWE's ``aggregate_flat`` — the global is one [N]
float32 vector, the client stack one [m, N] buffer, and the server update
is either the fused echo-aggregate kernel (``use_kernel``) or two matvecs
through ``flat_weighted_sum``.  The tree path (``aggregate``) and the
other nine strategies of the reference's registry belong to later slices
of the port.

``mask_upload`` and ``ages`` keep the reference's signature: under fault
injection ``mask_upload`` is the delivered-update weight, and under the
semi-async substrate ``ages`` carries each delivery's age (FedAWE ignores
it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Strategy:
    name: str
    stateful_clients: bool
    init_extra: Callable[[Any, int], Any]
    aggregate: Callable[..., Any]
    aggregate_flat: Optional[Callable[..., Any]] = None


def flat_weighted_sum(w, G):
    """The one shared flat reduction: sum_i w_i * G_i over an [m, N] stack,
    as a single float32 matvec."""
    return w.float() @ G.float()


# ---------------------------------------------------------------------------
# FedAWE — Algorithm 1
# ---------------------------------------------------------------------------

def _fedawe_init(template, m):
    return ()


def _fedawe_aggregate(*, global_tr, clients_tr, G, mask, t, tau, probs,
                      extra, eta_g, use_kernel=False, x_end=None,
                      mask_upload=None, ages=None):
    """The tree-state path of the reference (leaves keep their shapes)."""
    raise NotImplementedError(
        "the tree-state FedAWE path is not ported yet (a later slice of "
        "the port); run with FLConfig.flat_state=True")


def _fedawe_aggregate_flat(*, global_flat, clients_flat, x_end, G, mask, t,
                           tau, probs, extra, eta_g, use_kernel=False,
                           mask_upload=None, ages=None):
    """Adaptive innovation echoing + implicit gossiping on the flat stack.

    x_i^† = x_i − η_g (t − τ_i) G_i            (echo, active clients)
    x^{t+1} = mean_{i∈A} x_i^†                  (gossip mean)
    x_i^{t+1} = x^{t+1} for i∈A, else x_i^t     (postponed multicast)
    τ_i ← t for i∈A.
    Empty rounds keep the previous global (W = I).

    With ``use_kernel`` the server update is one launch of the fused
    kernel; otherwise two matvecs, with no [m, N] temporary."""
    mu = mask if mask_upload is None else mask_upload
    echo = (t - tau).float()
    if use_kernel:
        from repro_torch.kernels.echo_aggregate import ops as ea_ops
        new_global = ea_ops.echo_aggregate_flat(
            clients_flat, x_end, global_flat, mask, echo, eta_g,
            upload=mask_upload)
    else:
        denom = torch.clamp(torch.sum(mu), min=1.0)
        acc = (flat_weighted_sum(mu, clients_flat)
               - eta_g * flat_weighted_sum(mu * echo, G)) / denom
        new_global = torch.where(torch.sum(mu) > 0, acc, global_flat)
    new_clients = torch.where(mu[:, None] > 0, new_global[None],
                              clients_flat)
    new_tau = torch.where(mu > 0, t, tau)
    return new_global, new_clients, new_tau, extra


FEDAWE = Strategy("fedawe", True, _fedawe_init, _fedawe_aggregate,
                  aggregate_flat=_fedawe_aggregate_flat)


REGISTRY = {s.name: s for s in (FEDAWE,)}


def get_strategy(name: str) -> Strategy:
    if name not in REGISTRY:
        raise KeyError(f"unknown strategy {name!r}; known: {sorted(REGISTRY)}"
                       " (the other strategies of the reference are not "
                       "ported yet)")
    return REGISTRY[name]
