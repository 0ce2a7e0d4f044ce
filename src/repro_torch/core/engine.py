"""Federated round engine, flat substrate.

One ``round_fn`` executes a full FL round for every client in lockstep:

  1. local s-step SGD from each client's start model, as one batched
     computation over the m clients (``local_sgd``),
  2. innovation G_i = x_start − x_end on the flat [m, N] stack,
  3. strategy aggregation (echo + implicit gossip for FedAWE; one launch
     of the echo-aggregate kernel with ``use_kernel``).

The engine is model-agnostic: it sees only a trainable tree and a loss
function ``loss_fn(trainable, frozen, batch, rng) -> scalar``.  The
persistent state lives on the flat substrate (core/flatten.py): the global
is one [N] float32 vector and the client stack one [m, N] buffer; trees
appear only at the local-SGD entry (as views) and at eval.

Two executors drive the round function, as in the reference:

  * host loop (``run_rounds`` default): one round per iteration and one
    blocking metrics fetch per round;
  * chunked (``make_chunk_fn`` / ``run_rounds(chunk_rounds=K)``): K rounds
    per call, batches drawn on the device by the stateful sampler keyed by
    ``fold_in(data_key, t)``, metrics stacked ``[K]`` on the device and
    fetched once per chunk.  The chunk is a Python loop of K rounds that
    never reads a device value on the host.

Ported so far: the flat, fault-free, synchronous, dense case.  The tree
path, faults, staleness, the cohort path and the seed/grid executors
belong to later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.core.availability import (AvailabilityCfg, probs_at,
                                           sample_active)
from repro_torch.core.flatten import FlatSpec
from repro_torch.core.strategies import get_strategy
from repro_torch.core.tree_util import (tree_client_norm, tree_client_scale,
                                        tree_from_paths, tree_leaves,
                                        tree_map, tree_paths)

_TREE_PATH = ("the tree-state path is not ported yet (a later slice of the "
              "port); use flat_state=True (--flat-state)")


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Static config of the federated optimization (the reference's
    ``FLConfig`` without the cohort fields, which are not ported)."""
    m: int                      # number of clients
    s: int = 10                 # local steps per round
    eta_l: float = 0.05         # local lr (eta_0; 1/sqrt(t/10+1) schedule)
    eta_g: float = 1.0          # global lr
    strategy: str = "fedawe"
    lr_schedule: bool = True    # paper's eta_l / sqrt(t/10 + 1)
    use_kernel: bool = False    # fused echo-aggregate kernel
    flat_state: bool = False    # flat [m, N] substrate (core/flatten.py)
    grad_clip: float = 0.5      # paper uses max-norm 0.5


class FLState(NamedTuple):
    """Whole persistent state of a run, on one device."""
    global_tr: Any              # [N] float32 flat global
    clients_tr: Any             # [m, N] float32 client stack
    tau: torch.Tensor           # [m] int32, init -1
    t: torch.Tensor             # scalar int32 round counter
    extra: Any                  # strategy state
    markov: torch.Tensor        # availability markov state [m]
    rng: torch.Tensor           # PRNG key [2] (core/prng.py)
    spec: Any = None            # FlatSpec


def init_fl_state(rng, cfg: FLConfig, trainable_template) -> FLState:
    """Fresh state on the device of ``rng``; every field owns its buffer
    (nothing aliases the caller's template)."""
    if not cfg.flat_state:
        raise NotImplementedError(_TREE_PATH)
    strat = get_strategy(cfg.strategy)
    dev = rng.device
    spec = FlatSpec.from_tree(trainable_template)
    g = spec.flatten(trainable_template).to(dev).clone()
    return FLState(
        global_tr=g,
        clients_tr=g[None].expand(cfg.m, spec.size).clone(),
        tau=torch.full((cfg.m,), -1, dtype=torch.int32, device=dev),
        t=torch.zeros((), dtype=torch.int32, device=dev),
        extra=strat.init_extra(g, cfg.m),
        markov=torch.ones((cfg.m,), dtype=torch.float32, device=dev),
        rng=rng.clone(),
        spec=spec)


def global_trainables(state: FLState):
    """Trainable tree of the global model (views of the flat global)."""
    return state.spec.unflatten(state.global_tr)


def _clip(g, max_norm):
    """Per-client global-norm clip of a client-stacked gradient tree:
    ``g_i * min(1, max_norm / max(||g_i||, 1e-12))``."""
    if not max_norm:
        return g
    n = tree_client_norm(g)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    return tree_client_scale(scale, g)


def local_sgd(trainable, frozen, batches, rng, *, s, eta_l, loss_fn,
              grad_clip=0.0):
    """s local SGD steps for every client at once.

    trainable: client-stacked tree (leaves [m, ...]); batches: {k: [m, s,
    ...]}; rng: [m, 2] per-client keys.  Returns (x_end, mean_loss [m]).

    The loss is ``torch.func.vmap``-ed over clients and differentiated by
    one backward over the sum of per-client losses: each loss depends
    only on its own client's row, so the gradient of the sum is every
    client's own gradient.  Each step splits every client's key as the
    reference's scan does (the image loss ignores the subkey; keeping
    the split count keeps key-consuming losses aligned)."""
    per_client = torch.func.vmap(loss_fn, in_dims=(0, None, 0, 0))
    paths = [p for p, _ in tree_paths(trainable)]
    x, key, losses = trainable, rng, []
    for i in range(s):
        ks = prng.split(key)
        key, sub = ks[:, 0], ks[:, 1]
        mb = {k: v[:, i] for k, v in batches.items()}
        with torch.enable_grad():
            xg = tree_map(lambda a: a.detach().requires_grad_(True), x)
            loss = per_client(xg, frozen, mb, sub)
            grads = torch.autograd.grad(loss.sum(), tree_leaves(xg))
        g = _clip(tree_from_paths(paths, grads), grad_clip)
        x = tree_map(lambda xx, gg: (xx.float() - eta_l * gg.float())
                     .to(xx.dtype), x, g)
        losses.append(loss.detach())
    return x, torch.stack(losses, dim=1).mean(dim=1)


def make_round_fn(cfg: FLConfig, loss_fn: Callable, frozen: Any,
                  avail_cfg: AvailabilityCfg, base_p):
    """Build the round function ``(state, batches[m, s, ...]) -> (state,
    metrics)``; metrics are 0-d device tensors (``loss``, ``n_active``,
    ``mean_echo``), read by nobody inside the round."""
    if not cfg.flat_state:
        raise NotImplementedError(_TREE_PATH)
    strat = get_strategy(cfg.strategy)

    def round_fn(state: FLState, batches):
        keys = prng.split(state.rng, 3)
        rng, k_av, k_loc = keys[0], keys[1], keys[2]
        mask, markov = sample_active(k_av, avail_cfg, base_p, state.t,
                                     state.markov)
        probs_t = probs_at(avail_cfg, base_p, state.t)

        eta_l = cfg.eta_l
        if cfg.lr_schedule:
            eta_l = cfg.eta_l / torch.sqrt(state.t.float() / 10.0 + 1.0)

        loc_rngs = prng.split(k_loc, cfg.m)
        spec = state.spec
        start = state.clients_tr
        x_end_tr, losses = local_sgd(
            spec.unflatten_stacked(start), frozen, batches, loc_rngs,
            s=cfg.s, eta_l=eta_l, loss_fn=loss_fn, grad_clip=cfg.grad_clip)
        x_end = spec.flatten_stacked(x_end_tr)
        G = start - x_end
        new_global, new_clients, new_tau, new_extra = strat.aggregate_flat(
            global_flat=state.global_tr, clients_flat=start, x_end=x_end,
            G=G, mask=mask, t=state.t, tau=state.tau, probs=probs_t,
            extra=state.extra, eta_g=cfg.eta_g, use_kernel=cfg.use_kernel)

        denom = torch.clamp(torch.sum(mask), min=1.0)
        metrics = dict(
            loss=torch.sum(losses * mask) / denom,
            n_active=torch.sum(mask),
            mean_echo=torch.sum((state.t - state.tau).float() * mask)
            / denom,
        )
        new_state = state._replace(
            global_tr=new_global, clients_tr=new_clients, tau=new_tau,
            t=state.t + 1, extra=new_extra, markov=markov, rng=rng)
        return new_state, metrics

    return round_fn


def make_chunk_fn(cfg, round_fn, sample_fn, chunk_rounds):
    """Chunked round executor: K = ``chunk_rounds`` rounds per call.

    Returned callable: ``chunk(state, sampler_state, store, data_key) ->
    (state, sampler_state, metrics)``.  Per round, batches come from the
    stateful sampler ``sample_fn(store, sampler_state, fold_in(data_key,
    state.t))`` — keyed by the global round counter on the device, so a
    host loop driven through the same sampler and keys sees identical
    data.  Metrics come back stacked ``[K]`` per key, still on the device.
    ``cfg`` is kept for signature symmetry with the reference."""
    del cfg
    K = int(chunk_rounds)
    if K < 1:
        raise ValueError(f"chunk_rounds must be >= 1; got {chunk_rounds}")

    def chunk(state, sampler_state, store, data_key):
        per_round = []
        for _ in range(K):
            batches, sampler_state = sample_fn(
                store, sampler_state, prng.fold_in(data_key, state.t))
            state, metrics = round_fn(state, batches)
            per_round.append(metrics)
        stacked = {k: torch.stack([r[k] for r in per_round])
                   for k in per_round[0]}
        return state, sampler_state, stacked

    return chunk


def _metrics_to_host(metrics):
    """One device->host copy for a whole metrics dict (0-d or [K]
    values): ``{key: float or [float]}``, keys sorted as the reference's
    ``jax.device_get`` returns them."""
    keys = sorted(metrics)
    vals = torch.stack([metrics[k].float() for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def _log(done, rec):
    print(f"[round {done:5d}] " +
          " ".join(f"{k}={v:.4f}" for k, v in rec.items() if k != "t"))


def run_rounds(state: FLState, round_fn, batch_fn, T, *, log_every=0,
               eval_fn=None, eval_every=0, chunk_rounds=0, sample_fn=None,
               store=None, data_key=None, sampler_state=None):
    """Run T rounds; returns (state, history list of metric dicts).

    Host loop (default): ``batch_fn(t)`` batches — or, when ``batch_fn``
    is None, the stateful device sampler keyed by ``fold_in(data_key,
    t)``, the chunked executor's stream — and one metrics fetch per round.

    Chunked (``chunk_rounds=K > 0``): ``ceil(T / K)`` chunk calls (a
    shorter final chunk covers ``T % K``) and one metrics fetch per chunk;
    ``eval_fn`` fires at the first chunk boundary at or past each
    ``eval_every`` multiple."""
    if chunk_rounds:
        return _run_rounds_chunked(
            state, round_fn, T, chunk_rounds, sample_fn=sample_fn,
            store=store, data_key=data_key, sampler_state=sampler_state,
            log_every=log_every, eval_fn=eval_fn, eval_every=eval_every)

    if batch_fn is None:
        if sample_fn is None or store is None or data_key is None \
                or sampler_state is None:
            raise ValueError(
                "host loop needs batch_fn, or a stateful device sampler "
                "(sample_fn + store + data_key + sampler_state)")
        carried = [sampler_state]
        # key by the GLOBAL round counter, like the chunk executor
        t0 = int(state.t)

        def batch_fn(t):
            batches, carried[0] = sample_fn(
                store, carried[0], prng.fold_in(data_key, t0 + t))
            return batches

    history = []
    for t in range(T):
        state, metrics = round_fn(state, batch_fn(t))
        rec = _metrics_to_host(metrics)
        rec["t"] = t
        if eval_fn is not None and eval_every and (t + 1) % eval_every == 0:
            rec.update(eval_fn(state))
        history.append(rec)
        if log_every and (t + 1) % log_every == 0:
            _log(t + 1, rec)
    return state, history


def _crossed(done, k, every):
    """Did [done-k, done] cross a multiple of ``every``?"""
    return every and (done // every) > ((done - k) // every)


def _run_rounds_chunked(state, round_fn, T, K, *, sample_fn, store, data_key,
                        sampler_state, log_every, eval_fn, eval_every):
    if sample_fn is None or store is None or data_key is None \
            or sampler_state is None:
        raise ValueError(
            "chunked executor needs sample_fn, store, data_key and the "
            "carried sampler_state (make_device_sampler)")
    chunk_fn = make_chunk_fn(None, round_fn, sample_fn, K)
    history, done = [], 0
    while done < T:
        k = min(K, T - done)
        f = chunk_fn if k == K else make_chunk_fn(None, round_fn, sample_fn,
                                                  k)
        state, sampler_state, metrics = f(state, sampler_state, store,
                                          data_key)
        vals = _metrics_to_host(metrics)      # ONE host sync per chunk
        for j in range(k):
            rec = {key: v[j] for key, v in vals.items()}
            rec["t"] = done + j
            history.append(rec)
        done += k
        if eval_fn is not None and _crossed(done, k, eval_every):
            history[-1].update(eval_fn(state))
        if _crossed(done, k, log_every):
            _log(done, history[-1])
    return state, history
