"""Aggregation strategies: FedAWE (the paper) and the baselines it is
compared with, on the flat substrate.

The uniform interface of the reference: a strategy consumes the per-round
quantities (client-stacked innovations ``G`` = x_start − x_end, the
availability mask, the true probabilities for the known-p baseline) and
produces the new global, the new client stack, the new τ vector and its
own auxiliary state.

  stateful (per-client model persists):   FedAWE, FedAWE-M
  stateless (clients restart from the broadcast global): the baselines
  memory-aided (an [m, N] server memory): MIFA, FedVARP, FedAR

Every strategy of the reference's registry has its ``aggregate_flat``
here: the global is one [N] float32 vector, every weighted sum and memory
update is one reduction through ``flat_weighted_sum``, and a stateless
strategy returns ``None`` clients (the engine starts local SGD from a
broadcast view of the global, so no [m, N] client copy exists).  FedAWE's
server update is the fused echo-aggregate kernel under ``use_kernel``;
the baselines ignore ``use_kernel``, as in the reference.  The tree path
(``aggregate``) raises for every strategy, and the cohort path
(``aggregate_cohort``) belongs to a later slice of the port.

Scalar strategy state (FedAU's cutoff ``K``, F3AST's ``beta``, FedAWE-M's
``beta``) is a 0-d float32 tensor on the state's device, so a round never
reads it on the host and a checkpoint carries it as a leaf.

``mask_upload`` and ``ages`` keep the reference's signature: under fault
injection ``mask_upload`` is the delivered-update weight; under the
semi-async substrate it is the staleness-discounted delivery weight and
``ages`` carries each delivery's age in rounds (only FedAR reads it).
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
    # echoes the paper's grouping (Table 2)
    memory_aided: bool = False
    uses_true_probs: bool = False


def flat_weighted_sum(w, G):
    """The one shared flat reduction: sum_i w_i * G_i over an [m, N] stack,
    as a single float32 matvec."""
    return w.float() @ G.float()


def _scalar(value, like):
    """A 0-d float32 tensor on ``like``'s device."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _stateless_tau(mask, t, tau):
    return torch.where(mask > 0, t, tau)


def _tree_path(*, global_tr, clients_tr, G, mask, t, tau, probs, extra,
               eta_g, use_kernel=False, x_end=None, mask_upload=None,
               ages=None):
    """The tree-state path of the reference (leaves keep their shapes)."""
    raise NotImplementedError(
        "the tree-state strategy path is not ported yet (a later slice of "
        "the port); run with FLConfig.flat_state=True")


# ---------------------------------------------------------------------------
# FedAWE — Algorithm 1
# ---------------------------------------------------------------------------

def _no_extra(template, m):
    return ()


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


FEDAWE = Strategy("fedawe", True, _no_extra, _tree_path,
                  aggregate_flat=_fedawe_aggregate_flat)


# ---------------------------------------------------------------------------
# FedAvg variants: weighted innovation means
# ---------------------------------------------------------------------------

def _mk_weighted_fedavg(weight_fn, name, uses_true_probs=False):
    def _denom(mu):
        # fedavg_active divides by the round's delivered weight, the other
        # two by the population
        if name == "fedavg_active":
            return torch.clamp(torch.sum(mu), min=1.0)
        return mu.shape[0]

    def agg_flat(*, global_flat, clients_flat, x_end, G, mask, t, tau, probs,
                 extra, eta_g, use_kernel=False, mask_upload=None, ages=None):
        mu = mask if mask_upload is None else mask_upload
        w = weight_fn(mu, probs) * mu
        new_global = global_flat - eta_g * flat_weighted_sum(w, G) / _denom(mu)
        return new_global, None, _stateless_tau(mu, t, tau), extra

    return Strategy(name, False, _no_extra, _tree_path,
                    aggregate_flat=agg_flat, uses_true_probs=uses_true_probs)


FEDAVG_ACTIVE = _mk_weighted_fedavg(lambda mu, p: torch.ones_like(mu),
                                    "fedavg_active")
FEDAVG_ALL = _mk_weighted_fedavg(lambda mu, p: torch.ones_like(mu),
                                 "fedavg_all")
FEDAVG_KNOWN_P = _mk_weighted_fedavg(
    lambda mu, p: 1.0 / torch.clamp(p, 1e-2, 1.0), "fedavg_known_p",
    uses_true_probs=True)


# ---------------------------------------------------------------------------
# FedAU — online participation-interval estimates (cutoff K)
# ---------------------------------------------------------------------------

def _fedau_init(template, m, K=50):
    f32 = dict(dtype=torch.float32, device=template.device)
    return dict(interval=torch.zeros((m,), **f32),   # rounds since active
                omega=torch.ones((m,), **f32),       # est. mean interval
                n_intervals=torch.zeros((m,), **f32),
                K=_scalar(K, template))


def _fedau_weights(mu, extra):
    """Per-client weights (the estimated interval ≈ 1/p̂_i, on delivered
    clients) and the new interval estimates."""
    interval = extra["interval"] + 1.0
    capped = torch.minimum(interval, extra["K"])
    n = extra["n_intervals"]
    # online mean of completed intervals for active clients
    new_n = torch.where(mu > 0, n + 1.0, n)
    new_omega = torch.where(
        mu > 0, (extra["omega"] * n + capped) / torch.clamp(new_n, min=1.0),
        extra["omega"])
    new_extra = dict(interval=torch.where(mu > 0, 0.0, interval),
                     omega=new_omega, n_intervals=new_n, K=extra["K"])
    return new_omega * mu, new_extra


def _fedau_aggregate_flat(*, global_flat, clients_flat, x_end, G, mask, t,
                          tau, probs, extra, eta_g, use_kernel=False,
                          mask_upload=None, ages=None):
    mu = mask if mask_upload is None else mask_upload
    w, new_extra = _fedau_weights(mu, extra)
    new_global = global_flat - eta_g * flat_weighted_sum(w, G) / mu.shape[0]
    return new_global, None, _stateless_tau(mu, t, tau), new_extra


FEDAU = Strategy("fedau", False, _fedau_init, _tree_path,
                 aggregate_flat=_fedau_aggregate_flat)


# ---------------------------------------------------------------------------
# F3AST — EMA availability-rate estimates
# ---------------------------------------------------------------------------

def _f3ast_init(template, m, beta=0.001):
    return dict(rate=torch.full((m,), 0.5, dtype=torch.float32,
                                device=template.device),
                beta=_scalar(beta, template))


def _f3ast_aggregate_flat(*, global_flat, clients_flat, x_end, G, mask, t,
                          tau, probs, extra, eta_g, use_kernel=False,
                          mask_upload=None, ages=None):
    mu = mask if mask_upload is None else mask_upload
    beta = extra["beta"]
    rate = (1 - beta) * extra["rate"] + beta * mu
    w = mu / torch.clamp(rate, 1e-2, 1.0)
    new_global = global_flat - eta_g * flat_weighted_sum(w, G) / mu.shape[0]
    return (new_global, None, _stateless_tau(mu, t, tau),
            dict(rate=rate, beta=beta))


F3AST = Strategy("f3ast", False, _f3ast_init, _tree_path,
                 aggregate_flat=_f3ast_aggregate_flat)


# ---------------------------------------------------------------------------
# Memory-aided baselines: an [m, N] float32 server memory each
# ---------------------------------------------------------------------------

def _memory_init(key):
    def init(template, m):
        return {key: torch.zeros((m,) + tuple(template.shape),
                                 dtype=template.dtype,
                                 device=template.device)}
    return init


def _mifa_aggregate_flat(*, global_flat, clients_flat, x_end, G, mask, t,
                         tau, probs, extra, eta_g, use_kernel=False,
                         mask_upload=None, ages=None):
    """MIFA: memorize every client's latest innovation; step by the mean
    of the whole memory."""
    mu = mask if mask_upload is None else mask_upload
    mem = torch.where(mu[:, None] > 0, G, extra["mem"])
    new_global = global_flat - eta_g * flat_weighted_sum(
        torch.ones_like(mu), mem) / mu.shape[0]
    return new_global, None, _stateless_tau(mu, t, tau), dict(mem=mem)


MIFA = Strategy("mifa", False, _memory_init("mem"), _tree_path,
                aggregate_flat=_mifa_aggregate_flat, memory_aided=True)


def _fedvarp_aggregate_flat(*, global_flat, clients_flat, x_end, G, mask, t,
                            tau, probs, extra, eta_g, use_kernel=False,
                            mask_upload=None, ages=None):
    """FedVARP: server-side variance reduction — the delivered clients'
    mean correction ``G − y`` (zero on an empty round) plus the mean of
    the memory ``y``."""
    mu = mask if mask_upload is None else mask_upload
    y = extra["y"]
    denom = torch.clamp(torch.sum(mu), min=1.0)
    diff_mean = flat_weighted_sum(mu, G - y) / denom
    y_mean = flat_weighted_sum(torch.ones_like(mu), y) / mu.shape[0]
    any_active = (torch.sum(mu) > 0).float()
    new_global = global_flat - eta_g * (any_active * diff_mean + y_mean)
    new_y = torch.where(mu[:, None] > 0, G, y)
    return new_global, None, _stateless_tau(mu, t, tau), dict(y=new_y)


FEDVARP = Strategy("fedvarp", False, _memory_init("y"), _tree_path,
                   aggregate_flat=_fedvarp_aggregate_flat, memory_aided=True)


# ---------------------------------------------------------------------------
# FedAWE-M — the reference's beyond-paper extension: server-side momentum
# on the gossip delta.  beta = 0 recovers FedAWE exactly.
# ---------------------------------------------------------------------------

def _fedawe_m_init(template, m, beta=0.9):
    return dict(v=torch.zeros_like(template), beta=_scalar(beta, template))


def _fedawe_m_aggregate_flat(*, global_flat, clients_flat, x_end, G, mask, t,
                             tau, probs, extra, eta_g, use_kernel=False,
                             mask_upload=None, ages=None):
    """v ← β v + (gossip − x), x ← x + v on non-empty rounds; an empty
    round keeps the global (its gossip is the guarded previous global, so
    v decays by β)."""
    mu = mask if mask_upload is None else mask_upload
    gossip, _, new_tau, _ = _fedawe_aggregate_flat(
        global_flat=global_flat, clients_flat=clients_flat, x_end=x_end, G=G,
        mask=mask, t=t, tau=tau, probs=probs, extra=(), eta_g=eta_g,
        use_kernel=use_kernel, mask_upload=mask_upload)
    beta = extra["beta"]
    v = beta * extra["v"] + (gossip - global_flat)
    new_global = torch.where(torch.sum(mu) > 0, global_flat + v, global_flat)
    new_clients = torch.where(mu[:, None] > 0, new_global[None],
                              clients_flat)
    return new_global, new_clients, new_tau, dict(v=v, beta=beta)


FEDAWE_M = Strategy("fedawe_m", True, _fedawe_m_init, _tree_path,
                    aggregate_flat=_fedawe_m_aggregate_flat)


# ---------------------------------------------------------------------------
# FedAR — local-update approximation with rectification (Jiang et al. 2024,
# arXiv:2407.19103): MIFA's cache, where a delivery d rounds late blends
# into the cache by 1 / (1 + d) instead of replacing it.  ``ages=None``
# (the synchronous engine) replaces in full: FedAR is then MIFA.
# ---------------------------------------------------------------------------

def _fedar_aggregate_flat(*, global_flat, clients_flat, x_end, G, mask, t,
                          tau, probs, extra, eta_g, use_kernel=False,
                          mask_upload=None, ages=None):
    mu = mask if mask_upload is None else mask_upload
    r = torch.ones_like(mask) if ages is None else 1.0 / (1.0 + ages.float())
    mem = extra["mem"]
    mem = torch.where(mu[:, None] > 0, mem + r[:, None] * (G - mem), mem)
    new_global = global_flat - eta_g * flat_weighted_sum(
        torch.ones_like(mask), mem) / mask.shape[0]
    return new_global, None, _stateless_tau(mu, t, tau), dict(mem=mem)


FEDAR = Strategy("fedar", False, _memory_init("mem"), _tree_path,
                 aggregate_flat=_fedar_aggregate_flat, memory_aided=True)


REGISTRY = {s.name: s for s in
            (FEDAWE, FEDAWE_M, FEDAVG_ACTIVE, FEDAVG_ALL, FEDAVG_KNOWN_P,
             FEDAU, F3AST, MIFA, FEDVARP, FEDAR)}


def get_strategy(name: str) -> Strategy:
    if name not in REGISTRY:
        raise KeyError(f"unknown strategy {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
