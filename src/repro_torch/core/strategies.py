"""Aggregation strategies: FedAWE (the paper) and the baselines it is
compared with, on tree state, on the flat substrate and on the cohort.

The uniform interface of the reference: a strategy consumes the per-round
quantities (client-stacked innovations ``G`` = x_start − x_end, the
availability mask, the true probabilities for the known-p baseline) and
produces the new global, the new client stack, the new τ vector and its
own auxiliary state.

  stateful (per-client model persists):   FedAWE, FedAWE-M
  stateless (clients restart from the broadcast global): the baselines
  memory-aided (an [m, N] server memory): MIFA, FedVARP, FedAR

Every strategy of the reference's registry has its three paths here.
``aggregate`` is the tree path (leaves keep their shapes, one reduction
per leaf, float32 arithmetic cast back to the leaf dtype); a stateless
strategy's client stack mirrors the global as a broadcast view.
``init_extra`` takes a tree template (a flat vector is a one-leaf tree).
In ``aggregate_flat`` the global is one [N] float32 vector, every
weighted sum and memory update is one reduction through
``flat_weighted_sum``, and a stateless strategy returns ``None`` clients
(the engine starts local SGD from a broadcast view of the global, so no
[m, N] client copy exists).  FedAWE's server update is the fused
echo-aggregate kernel under ``use_kernel`` on both paths (on tree state
through ``ops.echo_aggregate_tree``: one launch over the raveled
leaves); the baselines ignore ``use_kernel``, as in the reference.

``aggregate_cohort`` is the sparse cohort path (core/cohort.py,
``FLConfig.sparse_cohort``): the round's math runs on the gathered
float32 ``[c, N]`` working set, and it returns ``(new_global, rows,
write, new_extra)``, where ``rows`` / ``write`` are what the engine
writes into the resident client stack at the cohort's rows (None for a
stateless strategy); the engine advances τ.  The ``/m`` baselines divide
by the population ``m_total``, not by c.  A memory strategy (MIFA,
FedVARP, FedAR) names its resident ``[m, N]`` memory in
``cohort_memory``: it is born in the resident dtype beside a float32
``[N]`` running column sum (``init_extra_cohort``), the engine hands the
aggregate the memory's resident rows at the cohort (``mem_c``), and the
aggregate returns, under the memory's key, the rows the engine writes
back in place (``cohort.cohort_payload``).  The column sum moves by the
rows as stored, after the demote, so the population mean costs O(c·N) a
round and tracks the bfloat16 content exactly.

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

from repro_torch.core.cohort import cohort_payload
from repro_torch.core.tree_util import (_bshape, tree_broadcast,
                                        tree_leaves, tree_map,
                                        tree_masked_mean, tree_mean,
                                        tree_select, tree_select_broadcast,
                                        tree_sub, tree_zeros_like)


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
    # the sparse cohort path (module docstring): aggregate_cohort runs the
    # round on the [c, N] working set; init_extra_cohort(g, m, dtype)
    # builds the resident memory and its running sum (None: init_extra);
    # cohort_memory names the extra's resident [m, N] stacks
    aggregate_cohort: Optional[Callable[..., Any]] = None
    init_extra_cohort: Optional[Callable[..., Any]] = None
    cohort_memory: tuple = ()


def flat_weighted_sum(w, G):
    """The one shared flat reduction: sum_i w_i * G_i over an [m, N] stack,
    as a single float32 matvec."""
    return w.float() @ G.float()


def _scalar(value, template):
    """A 0-d float32 tensor on the device of ``template``'s leaves."""
    return torch.full((), value, dtype=torch.float32,
                      device=tree_leaves(template)[0].device)


def _stateless_tau(mask, t, tau):
    return torch.where(mask > 0, t, tau)


def _stateless_wrap(new_global, clients_tr, mask, t, tau):
    """A stateless strategy's tree clients restart from the global: the
    client stack mirrors it (a broadcast view)."""
    new_clients = (tree_broadcast(new_global, tau.shape[0])
                   if clients_tr is not None else None)
    return new_clients, _stateless_tau(mask, t, tau)


def _tree_step(global_tr, upd, eta_g):
    """``x − η_g·u`` per leaf in float32, cast back to the leaf dtype."""
    return tree_map(lambda x, u: (x.float() - eta_g * u.float())
                    .to(x.dtype), global_tr, upd)


def _weighted_sum(w, G):
    """The tree counterpart of ``flat_weighted_sum``: Σ_i w_i G_i per
    leaf, in float32."""
    return tree_map(lambda g: torch.sum(g.float() * _bshape(w, g), dim=0),
                    G)


# ---------------------------------------------------------------------------
# FedAWE — Algorithm 1
# ---------------------------------------------------------------------------

def _no_extra(template, m):
    return ()


def _fedawe_aggregate(*, global_tr, clients_tr, G, mask, t, tau, probs,
                      extra, eta_g, use_kernel=False, x_end=None,
                      mask_upload=None, ages=None):
    """Adaptive innovation echoing + implicit gossiping on tree state.

    x_i^† = x_i − η_g (t − τ_i) G_i            (echo, active clients)
    x^{t+1} = mean_{i∈A} x_i^†                  (gossip mean)
    x_i^{t+1} = x^{t+1} for i∈A, else x_i^t     (postponed multicast)
    τ_i ← t for i∈A.
    Empty rounds keep the previous global (W = I); under faults only the
    delivering clients (``mask_upload``) count.

    With ``use_kernel`` the server update is one launch of the fused
    kernel over the raveled leaves (``ops.echo_aggregate_tree``), from
    ``x_end`` (or ``x − G``); otherwise a masked mean per leaf."""
    mu = mask if mask_upload is None else mask_upload
    echo = (t - tau).float()
    if use_kernel:
        from repro_torch.kernels.echo_aggregate import ops as ea_ops
        y = x_end if x_end is not None else tree_sub(clients_tr, G)
        new_global = ea_ops.echo_aggregate_tree(
            clients_tr, y, mask, echo, eta_g, global_tr, upload=mask_upload)
    else:
        x_dagger = tree_map(
            lambda x, g: (x.float() - eta_g * _bshape(echo * mu, g)
                          * g.float()).to(x.dtype), clients_tr, G)
        any_active = torch.sum(mu) > 0
        new_global = tree_map(
            lambda n, o: torch.where(any_active, n, o.to(n.dtype)),
            tree_masked_mean(x_dagger, mu), global_tr)
    new_clients = tree_select_broadcast(mu, new_global, clients_tr)
    new_tau = torch.where(mu > 0, t, tau)
    return new_global, new_clients, new_tau, extra


def _fedawe_aggregate_flat(*, global_flat, clients_flat, x_end, G, mask, t,
                           tau, probs, extra, eta_g, use_kernel=False,
                           mask_upload=None, ages=None):
    """FedAWE (``_fedawe_aggregate``) on the flat stack: with
    ``use_kernel`` one launch of the fused kernel; otherwise two
    matvecs, with no [m, N] temporary."""
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


def _fedawe_aggregate_cohort(*, global_flat, cohort_flat, x_end, G, mask, t,
                             tau_c, probs_c, extra, eta_g, m_total, idx,
                             mu_full, mem_c=None, use_kernel=False,
                             mask_upload=None, ages=None):
    """FedAWE on the [c, N] working set: the flat path's update, every
    client outside the cohort carrying zero weight there.  With
    ``use_kernel`` one launch of the fused kernel on the [c, N] operands
    (``upload=`` under faults)."""
    mu = mask if mask_upload is None else mask_upload
    echo = (t - tau_c).float()
    if use_kernel:
        from repro_torch.kernels.echo_aggregate import ops as ea_ops
        new_global = ea_ops.echo_aggregate_flat(
            cohort_flat, x_end, global_flat, mask, echo, eta_g,
            upload=mask_upload)
    else:
        denom = torch.clamp(torch.sum(mu), min=1.0)
        acc = (flat_weighted_sum(mu, cohort_flat)
               - eta_g * flat_weighted_sum(mu * echo, G)) / denom
        new_global = torch.where(torch.sum(mu) > 0, acc, global_flat)
    rows = torch.where(mu[:, None] > 0, new_global[None], cohort_flat)
    return new_global, rows, mu, extra


FEDAWE = Strategy("fedawe", True, _no_extra, _fedawe_aggregate,
                  aggregate_flat=_fedawe_aggregate_flat,
                  aggregate_cohort=_fedawe_aggregate_cohort)


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

    def agg(*, global_tr, clients_tr, G, mask, t, tau, probs, extra, eta_g,
            use_kernel=False, x_end=None, mask_upload=None, ages=None):
        mu = mask if mask_upload is None else mask_upload
        w = weight_fn(mu, probs) * mu
        denom = _denom(mu)
        new_global = tree_map(
            lambda x, u: (x.float() - eta_g * u / denom).to(x.dtype),
            global_tr, _weighted_sum(w, G))
        new_clients, new_tau = _stateless_wrap(new_global, clients_tr, mu,
                                               t, tau)
        return new_global, new_clients, new_tau, extra

    def agg_flat(*, global_flat, clients_flat, x_end, G, mask, t, tau, probs,
                 extra, eta_g, use_kernel=False, mask_upload=None, ages=None):
        mu = mask if mask_upload is None else mask_upload
        w = weight_fn(mu, probs) * mu
        new_global = global_flat - eta_g * flat_weighted_sum(w, G) / _denom(mu)
        return new_global, None, _stateless_tau(mu, t, tau), extra

    def agg_cohort(*, global_flat, cohort_flat, x_end, G, mask, t, tau_c,
                   probs_c, extra, eta_g, m_total, idx, mu_full, mem_c=None,
                   use_kernel=False, mask_upload=None, ages=None):
        mu = mask if mask_upload is None else mask_upload
        w = weight_fn(mu, probs_c) * mu
        # the /m variants divide by the population, not the cohort
        denom = _denom(mu) if name == "fedavg_active" else m_total
        new_global = global_flat - eta_g * flat_weighted_sum(w, G) / denom
        return new_global, None, None, extra

    return Strategy(name, False, _no_extra, agg,
                    aggregate_flat=agg_flat, uses_true_probs=uses_true_probs,
                    aggregate_cohort=agg_cohort)


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
    f32 = dict(dtype=torch.float32, device=tree_leaves(template)[0].device)
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


def _fedau_aggregate(*, global_tr, clients_tr, G, mask, t, tau, probs, extra,
                     eta_g, use_kernel=False, x_end=None, mask_upload=None,
                     ages=None):
    mu = mask if mask_upload is None else mask_upload
    w, new_extra = _fedau_weights(mu, extra)
    m = mu.shape[0]
    upd = tree_map(lambda u: u / m, _weighted_sum(w, G))
    new_global = _tree_step(global_tr, upd, eta_g)
    new_clients, new_tau = _stateless_wrap(new_global, clients_tr, mu, t, tau)
    return new_global, new_clients, new_tau, new_extra


def _fedau_aggregate_flat(*, global_flat, clients_flat, x_end, G, mask, t,
                          tau, probs, extra, eta_g, use_kernel=False,
                          mask_upload=None, ages=None):
    mu = mask if mask_upload is None else mask_upload
    w, new_extra = _fedau_weights(mu, extra)
    new_global = global_flat - eta_g * flat_weighted_sum(w, G) / mu.shape[0]
    return new_global, None, _stateless_tau(mu, t, tau), new_extra


def _fedau_aggregate_cohort(*, global_flat, cohort_flat, x_end, G, mask, t,
                            tau_c, probs_c, extra, eta_g, m_total, idx,
                            mu_full, mem_c=None, use_kernel=False,
                            mask_upload=None, ages=None):
    # the interval estimates advance for every client every round, so the
    # [m] scalar state stays dense (O(m), not O(m·N)); only the weighted
    # innovation sum runs on the cohort
    w_full, new_extra = _fedau_weights(mu_full, extra)
    new_global = global_flat - eta_g * flat_weighted_sum(
        torch.gather(w_full, -1, idx), G) / m_total
    return new_global, None, None, new_extra


FEDAU = Strategy("fedau", False, _fedau_init, _fedau_aggregate,
                 aggregate_flat=_fedau_aggregate_flat,
                 aggregate_cohort=_fedau_aggregate_cohort)


# ---------------------------------------------------------------------------
# F3AST — EMA availability-rate estimates
# ---------------------------------------------------------------------------

def _f3ast_init(template, m, beta=0.001):
    return dict(rate=torch.full((m,), 0.5, dtype=torch.float32,
                                device=tree_leaves(template)[0].device),
                beta=_scalar(beta, template))


def _f3ast_aggregate(*, global_tr, clients_tr, G, mask, t, tau, probs, extra,
                     eta_g, use_kernel=False, x_end=None, mask_upload=None,
                     ages=None):
    mu = mask if mask_upload is None else mask_upload
    w, new_extra = _f3ast_weights(mu, extra)
    m = mu.shape[0]
    upd = tree_map(lambda u: u / m, _weighted_sum(w, G))
    new_global = _tree_step(global_tr, upd, eta_g)
    new_clients, new_tau = _stateless_wrap(new_global, clients_tr, mu, t, tau)
    return new_global, new_clients, new_tau, new_extra


def _f3ast_aggregate_flat(*, global_flat, clients_flat, x_end, G, mask, t,
                          tau, probs, extra, eta_g, use_kernel=False,
                          mask_upload=None, ages=None):
    mu = mask if mask_upload is None else mask_upload
    w, new_extra = _f3ast_weights(mu, extra)
    new_global = global_flat - eta_g * flat_weighted_sum(w, G) / mu.shape[0]
    return new_global, None, _stateless_tau(mu, t, tau), new_extra


def _f3ast_weights(mu, extra):
    """Per-client weights ``mu / clip(rate)`` and the new EMA rates."""
    beta = extra["beta"]
    rate = (1 - beta) * extra["rate"] + beta * mu
    return mu / torch.clamp(rate, 1e-2, 1.0), dict(rate=rate, beta=beta)


def _f3ast_aggregate_cohort(*, global_flat, cohort_flat, x_end, G, mask, t,
                            tau_c, probs_c, extra, eta_g, m_total, idx,
                            mu_full, mem_c=None, use_kernel=False,
                            mask_upload=None, ages=None):
    # the EMA rates decay for every client every round: dense [m] state,
    # as FedAU's, and the innovation sum on the cohort
    w_full, new_extra = _f3ast_weights(mu_full, extra)
    new_global = global_flat - eta_g * flat_weighted_sum(
        torch.gather(w_full, -1, idx), G) / m_total
    return new_global, None, None, new_extra


F3AST = Strategy("f3ast", False, _f3ast_init, _f3ast_aggregate,
                 aggregate_flat=_f3ast_aggregate_flat,
                 aggregate_cohort=_f3ast_aggregate_cohort)


# ---------------------------------------------------------------------------
# Memory-aided baselines: an [m, N] float32 server memory each
# ---------------------------------------------------------------------------

def _memory_init(key):
    """An all-zero client-stacked copy of the template under ``key``
    (``[m, N]`` for a flat vector, ``[m, ...]`` leaves for a tree)."""
    def init(template, m):
        return {key: tree_map(lambda x: x.new_zeros((m,) + tuple(x.shape)),
                              template)}
    return init


def _memory_init_cohort(key):
    def init(g, m, dtype):
        n = g.shape[0]
        return {key: torch.zeros((m, n), dtype=dtype, device=g.device),
                key + "_sum": torch.zeros((n,), dtype=torch.float32,
                                          device=g.device)}
    return init


def _memory_step(extra, mem_c, key, new_rows, mu):
    """The cohort rows ``new_rows`` (float32, written where ``mu`` > 0)
    demoted into the memory's resident rows ``mem_c[key]``: the rows the
    engine stores, and the running column sum moved by what they change
    as stored."""
    old = mem_c[key]
    payload = cohort_payload(old, new_rows, mu)
    col_sum = extra[key + "_sum"] + torch.sum(payload.float() - old.float(),
                                              dim=0)
    return {key: payload, key + "_sum": col_sum}


def _mifa_aggregate(*, global_tr, clients_tr, G, mask, t, tau, probs, extra,
                    eta_g, use_kernel=False, x_end=None, mask_upload=None,
                    ages=None):
    """MIFA: memorize every client's latest innovation; step by the mean
    of the whole memory."""
    mu = mask if mask_upload is None else mask_upload
    mem = tree_select(mu, G, extra["mem"])
    new_global = _tree_step(global_tr, tree_mean(mem), eta_g)
    new_clients, new_tau = _stateless_wrap(new_global, clients_tr, mu, t, tau)
    return new_global, new_clients, new_tau, dict(mem=mem)


def _mifa_aggregate_flat(*, global_flat, clients_flat, x_end, G, mask, t,
                         tau, probs, extra, eta_g, use_kernel=False,
                         mask_upload=None, ages=None):
    mu = mask if mask_upload is None else mask_upload
    mem = torch.where(mu[:, None] > 0, G, extra["mem"])
    new_global = global_flat - eta_g * flat_weighted_sum(
        torch.ones_like(mu), mem) / mu.shape[0]
    return new_global, None, _stateless_tau(mu, t, tau), dict(mem=mem)


def _mifa_aggregate_cohort(*, global_flat, cohort_flat, x_end, G, mask, t,
                           tau_c, probs_c, extra, eta_g, m_total, idx,
                           mu_full, mem_c=None, use_kernel=False,
                           mask_upload=None, ages=None):
    """MIFA on the cohort: the memory's population mean is its carried
    float32 column sum over m."""
    mu = mask if mask_upload is None else mask_upload
    new_rows = torch.where(mu[:, None] > 0, G, mem_c["mem"].float())
    new_extra = _memory_step(extra, mem_c, "mem", new_rows, mu)
    new_global = global_flat - eta_g * new_extra["mem_sum"] / m_total
    return new_global, None, None, new_extra


MIFA = Strategy("mifa", False, _memory_init("mem"), _mifa_aggregate,
                aggregate_flat=_mifa_aggregate_flat, memory_aided=True,
                aggregate_cohort=_mifa_aggregate_cohort,
                init_extra_cohort=_memory_init_cohort("mem"),
                cohort_memory=("mem",))


def _fedvarp_aggregate(*, global_tr, clients_tr, G, mask, t, tau, probs,
                       extra, eta_g, use_kernel=False, x_end=None,
                       mask_upload=None, ages=None):
    """FedVARP: server-side variance reduction — the delivered clients'
    mean correction ``G − y`` (zero on an empty round) plus the mean of
    the memory ``y``."""
    mu = mask if mask_upload is None else mask_upload
    y = extra["y"]
    any_active = (torch.sum(mu) > 0).float()
    new_global = tree_map(
        lambda x, d, ym: (x.float() - eta_g * (any_active * d.float()
                                               + ym.float())).to(x.dtype),
        global_tr, tree_masked_mean(tree_sub(G, y), mu), tree_mean(y))
    new_clients, new_tau = _stateless_wrap(new_global, clients_tr, mu, t, tau)
    return new_global, new_clients, new_tau, dict(y=tree_select(mu, G, y))


def _fedvarp_aggregate_flat(*, global_flat, clients_flat, x_end, G, mask, t,
                            tau, probs, extra, eta_g, use_kernel=False,
                            mask_upload=None, ages=None):
    mu = mask if mask_upload is None else mask_upload
    y = extra["y"]
    denom = torch.clamp(torch.sum(mu), min=1.0)
    diff_mean = flat_weighted_sum(mu, G - y) / denom
    y_mean = flat_weighted_sum(torch.ones_like(mu), y) / mu.shape[0]
    any_active = (torch.sum(mu) > 0).float()
    new_global = global_flat - eta_g * (any_active * diff_mean + y_mean)
    new_y = torch.where(mu[:, None] > 0, G, y)
    return new_global, None, _stateless_tau(mu, t, tau), dict(y=new_y)


def _fedvarp_aggregate_cohort(*, global_flat, cohort_flat, x_end, G, mask,
                              t, tau_c, probs_c, extra, eta_g, m_total, idx,
                              mu_full, mem_c=None, use_kernel=False,
                              mask_upload=None, ages=None):
    mu = mask if mask_upload is None else mask_upload
    y_c = mem_c["y"].float()
    denom = torch.clamp(torch.sum(mu), min=1.0)
    diff_mean = flat_weighted_sum(mu, G - y_c) / denom
    # the population mean of the OLD memory, from its column sum
    y_mean = extra["y_sum"] / m_total
    any_active = (torch.sum(mu) > 0).float()
    new_global = global_flat - eta_g * (any_active * diff_mean + y_mean)
    new_rows = torch.where(mu[:, None] > 0, G, y_c)
    return new_global, None, None, _memory_step(extra, mem_c, "y",
                                                new_rows, mu)


FEDVARP = Strategy("fedvarp", False, _memory_init("y"),
                   _fedvarp_aggregate,
                   aggregate_flat=_fedvarp_aggregate_flat, memory_aided=True,
                   aggregate_cohort=_fedvarp_aggregate_cohort,
                   init_extra_cohort=_memory_init_cohort("y"),
                   cohort_memory=("y",))


# ---------------------------------------------------------------------------
# FedAWE-M — the reference's beyond-paper extension: server-side momentum
# on the gossip delta.  beta = 0 recovers FedAWE exactly.
# ---------------------------------------------------------------------------

def _fedawe_m_init(template, m, beta=0.9):
    return dict(v=tree_zeros_like(template), beta=_scalar(beta, template))


def _fedawe_m_aggregate(*, global_tr, clients_tr, G, mask, t, tau, probs,
                        extra, eta_g, use_kernel=False, x_end=None,
                        mask_upload=None, ages=None):
    """v ← β v + (gossip − x), x ← x + v on non-empty rounds, per leaf;
    an empty round keeps the global (its gossip is the guarded previous
    global, so v decays by β)."""
    mu = mask if mask_upload is None else mask_upload
    gossip, _, new_tau, _ = _fedawe_aggregate(
        global_tr=global_tr, clients_tr=clients_tr, G=G, mask=mask, t=t,
        tau=tau, probs=probs, extra=(), eta_g=eta_g, use_kernel=use_kernel,
        x_end=x_end, mask_upload=mask_upload)
    beta = extra["beta"]
    v = tree_map(lambda vv, d: beta * vv + d.float(), extra["v"],
                 tree_sub(gossip, global_tr))
    any_active = torch.sum(mu) > 0
    new_global = tree_map(
        lambda x, vv: torch.where(any_active, (x.float() + vv).to(x.dtype),
                                  x), global_tr, v)
    new_clients = tree_select_broadcast(mu, new_global, clients_tr)
    return new_global, new_clients, new_tau, dict(v=v, beta=beta)


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


def _fedawe_m_aggregate_cohort(*, global_flat, cohort_flat, x_end, G, mask,
                               t, tau_c, probs_c, extra, eta_g, m_total,
                               idx, mu_full, mem_c=None, use_kernel=False,
                               mask_upload=None, ages=None):
    mu = mask if mask_upload is None else mask_upload
    gossip, _, _, _ = _fedawe_aggregate_cohort(
        global_flat=global_flat, cohort_flat=cohort_flat, x_end=x_end, G=G,
        mask=mask, t=t, tau_c=tau_c, probs_c=probs_c, extra=(), eta_g=eta_g,
        m_total=m_total, idx=idx, mu_full=mu_full, use_kernel=use_kernel,
        mask_upload=mask_upload)
    beta = extra["beta"]
    v = beta * extra["v"] + (gossip - global_flat)  # gossip is guarded
    new_global = torch.where(torch.sum(mu) > 0, global_flat + v, global_flat)
    rows = torch.where(mu[:, None] > 0, new_global[None], cohort_flat)
    return new_global, rows, mu, dict(v=v, beta=beta)


FEDAWE_M = Strategy("fedawe_m", True, _fedawe_m_init, _fedawe_m_aggregate,
                    aggregate_flat=_fedawe_m_aggregate_flat,
                    aggregate_cohort=_fedawe_m_aggregate_cohort)


# ---------------------------------------------------------------------------
# FedAR — local-update approximation with rectification (Jiang et al. 2024,
# arXiv:2407.19103): MIFA's cache, where a delivery d rounds late blends
# into the cache by 1 / (1 + d) instead of replacing it.  ``ages=None``
# (the synchronous engine) replaces in full: FedAR is then MIFA.
# ---------------------------------------------------------------------------

def _fedar_rect(mask, ages):
    """The rectification factor 1 / (1 + d) of a delivery d rounds late
    (1 when the engine passes no ages)."""
    return torch.ones_like(mask) if ages is None else 1.0 / (1.0
                                                             + ages.float())


def _fedar_aggregate(*, global_tr, clients_tr, G, mask, t, tau, probs, extra,
                     eta_g, use_kernel=False, x_end=None, mask_upload=None,
                     ages=None):
    mu = mask if mask_upload is None else mask_upload
    sel = mu > 0
    r = _fedar_rect(mask, ages)
    mem = tree_map(
        lambda mm, g: torch.where(
            _bshape(sel, mm),
            (mm.float() + _bshape(r, mm) * (g.float() - mm.float()))
            .to(mm.dtype), mm), extra["mem"], G)
    new_global = _tree_step(global_tr, tree_mean(mem), eta_g)
    new_clients, new_tau = _stateless_wrap(new_global, clients_tr, mu, t, tau)
    return new_global, new_clients, new_tau, dict(mem=mem)


def _fedar_aggregate_flat(*, global_flat, clients_flat, x_end, G, mask, t,
                          tau, probs, extra, eta_g, use_kernel=False,
                          mask_upload=None, ages=None):
    mu = mask if mask_upload is None else mask_upload
    r = _fedar_rect(mask, ages)
    mem = extra["mem"]
    mem = torch.where(mu[:, None] > 0, mem + r[:, None] * (G - mem), mem)
    new_global = global_flat - eta_g * flat_weighted_sum(
        torch.ones_like(mask), mem) / mask.shape[0]
    return new_global, None, _stateless_tau(mu, t, tau), dict(mem=mem)


def _fedar_aggregate_cohort(*, global_flat, cohort_flat, x_end, G, mask, t,
                            tau_c, probs_c, extra, eta_g, m_total, idx,
                            mu_full, mem_c=None, use_kernel=False,
                            mask_upload=None, ages=None):
    mu = mask if mask_upload is None else mask_upload
    r = _fedar_rect(mask, ages)
    mem = mem_c["mem"].float()
    new_rows = torch.where(mu[:, None] > 0, mem + r[:, None] * (G - mem),
                           mem)
    new_extra = _memory_step(extra, mem_c, "mem", new_rows, mu)
    new_global = global_flat - eta_g * new_extra["mem_sum"] / m_total
    return new_global, None, None, new_extra


FEDAR = Strategy("fedar", False, _memory_init("mem"), _fedar_aggregate,
                 aggregate_flat=_fedar_aggregate_flat, memory_aided=True,
                 aggregate_cohort=_fedar_aggregate_cohort,
                 init_extra_cohort=_memory_init_cohort("mem"),
                 cohort_memory=("mem",))


REGISTRY = {s.name: s for s in
            (FEDAWE, FEDAWE_M, FEDAVG_ACTIVE, FEDAVG_ALL, FEDAVG_KNOWN_P,
             FEDAU, F3AST, MIFA, FEDVARP, FEDAR)}


def get_strategy(name: str) -> Strategy:
    if name not in REGISTRY:
        raise KeyError(f"unknown strategy {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
