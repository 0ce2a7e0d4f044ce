"""Federated round engine, on tree state or the flat substrate.

One ``round_fn`` executes a full FL round for every client in lockstep:

  1. local s-step SGD from each client's start model, as one batched
     computation over the m clients (``local_sgd``),
  2. innovation G_i = x_start − x_end on the flat [m, N] stack,
  3. strategy aggregation (echo + implicit gossip for FedAWE; one launch
     of the echo-aggregate kernel with ``use_kernel``).

The engine is model-agnostic: it sees only a trainable tree and a loss
function ``loss_fn(trainable, frozen, batch, rng) -> scalar``.  The
persistent state is a tree by default, as in the reference: the global
is the trainable tree, the client stack the same tree with ``[m, ...]``
leaves for every strategy (a stateless one's mirrors the global as a
broadcast view), and strategies aggregate leaf by leaf (``aggregate``;
FedAWE's kernel route ravels the leaves into one launch).  With
``FLConfig.flat_state`` it lives on the flat substrate (core/flatten.py):
the global is one [N] float32 vector and the client stack one [m, N]
buffer; trees appear only at the local-SGD entry (as views) and at eval.

Four executors drive the round function, as in the reference:

  * host loop (``run_rounds`` default): one round per iteration and one
    blocking metrics fetch per round;
  * chunked (``make_chunk_fn`` / ``run_rounds(chunk_rounds=K)``): K rounds
    per call, batches drawn on the device by the stateful sampler keyed by
    ``fold_in(data_key, t)``, metrics stacked ``[K]`` on the device and
    fetched once per chunk.  The chunk is a Python loop of K rounds that
    never reads a device value on the host;
  * seed-batched (``make_seeds_chunk_fn``): S independent seeds advance
    K rounds per call, their state stacked ``[S, ...]`` (``stack_seeds``).
    The reference vmaps the whole round; here the parts before and after
    local SGD run under ``torch.func.vmap`` (``seed_vmap``) and local SGD
    once over all S·m clients, so a round dispatches the operations of
    one seed's round, each over S seeds' data (the echo-aggregate kernel
    once for all of them);
  * packed grid (``make_grid_chunk_fn``): several cells' seed chunks, one
    after another, in one call.

The round of all ten strategies on tree state, with fault injection
(``fault_cfg``, core/faults.py); on the flat substrate also semi-async
rounds (``staleness_cfg``, core/staleness.py) alone or composed with
faults, and the sparse cohort round (``FLConfig.sparse_cohort``,
core/cohort.py) with all of them — both need the flat substrate, as in
the reference.  A stateful strategy (FedAWE, FedAWE-M) starts local SGD
from its client stack; a stateless one starts from a broadcast view of
the global (on the flat substrate it keeps no stack at all,
``FLState.clients_tr is None``).  The host-loop and chunked executors
take a checkpoint hook (``ckpt_fn`` / ``ckpt_every``), the seed-batched
one through ``launch/experiments.run_seed_rounds``.  Building a state or
a round applies the port's float32 policy (``device.float32_policy``:
TF32 off), as the entry points do.

A cohort round gathers the round's active clients, at most ``c_max``,
into a float32 ``[c, N]`` working set, runs local SGD and aggregation
there, and writes the touched rows back into the resident ``[m, N]``
stacks IN PLACE (the client stack, and a memory strategy's memory): it
consumes the state it is given, as the reference's donated scan carry
does.  Read the state a round returns, never the one passed in.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import torch
import torch.utils._pytree as pytree

from repro_torch.core import faults as _faults
from repro_torch.core import prng
from repro_torch.core.cohort import (cohort_payload, cohort_rows,
                                     cohort_select, cohort_write)
from repro_torch.core import staleness as _stale
from repro_torch.core.availability import (AvailabilityCfg, probs_at,
                                           sample_active)
from repro_torch.core.flatten import FlatSpec, resident_dtype
from repro_torch.core.strategies import get_strategy
from repro_torch.core.tree_util import (_bshape, tree_broadcast,
                                        tree_client_norm, tree_client_scale,
                                        tree_from_paths, tree_leaves,
                                        tree_map, tree_paths)
from repro_torch.data.federated import gather_batches_at
from repro_torch.device import float32_policy


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Static config of the federated optimization (the reference's
    ``FLConfig``).

    ``sparse_cohort`` > 0 switches the flat round to the cohort round
    (module docstring): at most ``c_max = sparse_cohort`` active clients
    compute, the actives beyond the cap are deferred (``n_deferred``
    metric).  It needs ``flat_state`` and a sampler built with
    ``emit="cols"``.  ``resident_dtype`` stores the resident stacks (the
    client stack, a memory strategy's memory) below float32
    (``flatten.RESIDENT_DTYPES``; gather promotes, scatter demotes): only
    the cohort round has that boundary."""
    m: int                      # number of clients
    s: int = 10                 # local steps per round
    eta_l: float = 0.05         # local lr (eta_0; 1/sqrt(t/10+1) schedule)
    eta_g: float = 1.0          # global lr
    strategy: str = "fedawe"
    lr_schedule: bool = True    # paper's eta_l / sqrt(t/10 + 1)
    use_kernel: bool = False    # fused echo-aggregate kernel
    flat_state: bool = False    # flat [m, N] substrate (core/flatten.py)
    grad_clip: float = 0.5      # paper uses max-norm 0.5
    sparse_cohort: int = 0      # cohort cap c_max (0 = dense rounds)
    resident_dtype: str = "float32"   # [m, N] stack storage dtype

    def __post_init__(self):
        resident_dtype(self.resident_dtype)  # validate the name eagerly
        if self.sparse_cohort:
            if self.sparse_cohort < 0:
                raise ValueError(f"sparse_cohort must be >= 0; got "
                                 f"{self.sparse_cohort}")
            if not self.flat_state:
                raise ValueError("sparse_cohort needs the flat [m, N] "
                                 "substrate (flat_state)")
        elif self.resident_dtype != "float32":
            raise ValueError(
                "resident_dtype below float32 needs sparse_cohort > 0: only "
                "the cohort round has the gather-promote / accumulate-"
                "demote boundary (core/cohort.py); the dense round reads "
                "the stack in place")


class FLState(NamedTuple):
    """Whole persistent state of a run, on one device."""
    global_tr: Any              # global trainable tree ([N] float32 when
                                # flat_state)
    clients_tr: Any             # [m, ...] client-stacked tree; when
                                # flat_state the [m, N] stack (float32, or
                                # the resident dtype), or None (stateless
                                # strategies keep none)
    tau: torch.Tensor           # [m] int32, init -1
    t: torch.Tensor             # scalar int32 round counter
    extra: Any                  # strategy state
    markov: torch.Tensor        # availability markov state [m]
    rng: torch.Tensor           # PRNG key [2] (core/prng.py)
    spec: Any = None            # FlatSpec (flat_state), or None
    fault: Any = None           # fault-injection carry (core/faults.py):
                                # [T, m] trace / [m] cluster labels, or None
    stale: Any = None           # semi-async carry (core/staleness.py):
                                # [tau_max, m, N] pending-update ring + ages
                                # [tau_max, m] (+ delay trace), or None


def init_fl_state(rng, cfg: FLConfig, trainable_template, *, fault=None,
                  stale=None) -> FLState:
    """Fresh state on the device of ``rng``; every field owns its buffer
    (nothing aliases the caller's template).  ``fault`` is the read-only
    carry from ``faults.init_fault_state``, ``stale`` the ring the round
    advances, from ``staleness.init_staleness_state`` (or None).

    On tree state (``cfg.flat_state`` False, the reference's default) the
    global is a copy of the template on that device and the client stack
    its ``[m, ...]`` copies, for every strategy; ``spec`` is None.

    Under the cohort the client stack is born in the resident dtype, and
    so is a memory strategy's memory (``init_extra_cohort``, with its
    float32 column sum) unless ``stale`` is given: with a ring the round
    runs in dense lanes, and the memory keeps its dense float32 form."""
    float32_policy()
    strat = get_strategy(cfg.strategy)
    dev = rng.device
    tau = torch.full((cfg.m,), -1, dtype=torch.int32, device=dev)
    t = torch.zeros((), dtype=torch.int32, device=dev)
    markov = torch.ones((cfg.m,), dtype=torch.float32, device=dev)
    if not cfg.flat_state:
        g = tree_map(lambda x: x.to(dev).clone(), trainable_template)
        return FLState(
            global_tr=g,
            clients_tr=tree_map(lambda x: x.contiguous(),
                                tree_broadcast(g, cfg.m)),
            tau=tau, t=t, extra=strat.init_extra(g, cfg.m), markov=markov,
            rng=rng.clone(), fault=fault, stale=stale)
    spec = FlatSpec.from_tree(trainable_template)
    g = spec.flatten(trainable_template).to(dev).clone()
    rdt = resident_dtype(cfg.resident_dtype)
    # stateless strategies never materialize the [m, N] client stack
    clients = (g.to(rdt)[None].expand(cfg.m, spec.size).contiguous()
               if strat.stateful_clients else None)
    if cfg.sparse_cohort and stale is None \
            and strat.init_extra_cohort is not None:
        extra = strat.init_extra_cohort(g, cfg.m, rdt)
    else:
        extra = strat.init_extra(g, cfg.m)
    return FLState(global_tr=g, clients_tr=clients, tau=tau, t=t,
                   extra=extra, markov=markov, rng=rng.clone(), spec=spec,
                   fault=fault, stale=stale)


def global_trainables(state: FLState):
    """Trainable tree of the global model (on the flat substrate, views of
    the flat global)."""
    if state.spec is None:
        return state.global_tr
    return state.spec.unflatten(state.global_tr)


def client_trainables(state: FLState):
    """Client-stacked trainable tree (leaves ``[m, ...]``; views on the
    flat substrate), or None when the strategy keeps no per-client
    state."""
    if state.spec is None or state.clients_tr is None:
        return state.clients_tr
    return state.spec.unflatten_stacked(state.clients_tr)


def _clip(g, max_norm, lead=1):
    """Per-client global-norm clip of a client-stacked gradient tree
    (``lead`` client axes): ``g_i * min(1, max_norm / max(||g_i||,
    1e-12))``."""
    if not max_norm:
        return g
    n = tree_client_norm(g, lead)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    return tree_client_scale(scale, g)


def _per_client(v, leaf):
    """``v`` (a number, a 0-d tensor, or a ``[S]`` per-seed tensor) shaped
    to broadcast against a ``[S, m, ...]`` leaf."""
    if torch.is_tensor(v) and v.dim() == 1:
        return v.reshape((v.shape[0],) + (1,) * (leaf.dim() - 1))
    return v


def local_sgd(trainable, frozen, batches, rng, *, s, eta_l, loss_fn,
              grad_clip=0.0):
    """s local SGD steps for every client at once.

    trainable: client-stacked tree (leaves [m, ...]); batches: {k: [m, s,
    ...]}; rng: [m, 2] per-client keys.  Returns (x_end, mean_loss [m]).
    With two client axes — leaves [S, m, ...], batches [S, m, s, ...],
    rng [S, m, 2] and ``eta_l`` a number or an [S] per-seed tensor — the
    S seeds' clients take their steps together (the seed-batched round).

    The loss is ``torch.func.vmap``-ed over the client axes and
    differentiated by one backward over the sum of per-client losses:
    each loss depends only on its own client's row, so the gradient of the
    sum is every client's own gradient.  Each step splits every client's
    key as the reference's scan does (the image loss ignores the subkey;
    keeping the split count keeps key-consuming losses aligned).

    A loss marked ``maps_clients`` (``models.model.lm_loss_fn``) maps its
    own client axes: it is called once on the client-stacked tree with
    ``lead=`` the number of client axes, so that it can place its remat
    checkpoints around the vmapped pieces (a checkpoint inside the vmap
    cannot be replayed by the backward taken here, outside it)."""
    lead = rng.dim() - 1
    if getattr(loss_fn, "maps_clients", False):
        per_client = functools.partial(loss_fn, lead=lead)
    else:
        per_client = loss_fn
        for _ in range(lead):
            per_client = torch.func.vmap(per_client,
                                         in_dims=(0, None, 0, 0))
    paths = [p for p, _ in tree_paths(trainable)]
    x, key, losses = trainable, rng, []
    for i in range(s):
        ks = prng.split(key)
        key, sub = ks[..., 0, :], ks[..., 1, :]
        mb = {k: v.select(lead, i) for k, v in batches.items()}
        with torch.enable_grad():
            xg = tree_map(lambda a: a.detach().requires_grad_(True), x)
            loss = per_client(xg, frozen, mb, sub)
            grads = torch.autograd.grad(loss.sum(), tree_leaves(xg))
        g = _clip(tree_from_paths(paths, grads), grad_clip, lead)
        x = tree_map(lambda xx, gg: (xx.float() - _per_client(eta_l, xx)
                                     * gg.float()).to(xx.dtype), x, g)
        losses.append(loss.detach())
    return x, torch.stack(losses, dim=lead).mean(dim=lead)


def make_round_fn(cfg: FLConfig, loss_fn: Callable, frozen: Any,
                  avail_cfg: AvailabilityCfg, base_p, fault_cfg=None,
                  staleness_cfg=None):
    """Build the round function ``(state, batches[m, s, ...]) -> (state,
    metrics)`` with the frozen parameters ``frozen`` closed over: the
    round of ``make_round_fn_with_frozen`` (which documents the round),
    as the reference builds it.  ``round_fn.seeds(states, batches)`` is
    its seed-batched form."""
    inner = make_round_fn_with_frozen(cfg, loss_fn, avail_cfg, base_p,
                                      fault_cfg=fault_cfg,
                                      staleness_cfg=staleness_cfg)

    def round_fn(state: FLState, batches):
        return inner(state, frozen, batches)

    def seeds_round_fn(states: FLState, batches):
        return inner.seeds(states, frozen, batches)

    round_fn.seeds = seeds_round_fn
    return round_fn


def make_round_fn_with_frozen(cfg: FLConfig, loss_fn: Callable,
                              avail_cfg: AvailabilityCfg, base_p,
                              fault_cfg=None, staleness_cfg=None):
    """Build the round function ``(state, frozen, batches[m, s, ...]) ->
    (state, metrics)``, the frozen parameters a runtime argument (a LoRA
    run's base); metrics are 0-d device tensors, read by nobody inside
    the round.  ``frozen`` reaches only local SGD, where every client's
    loss reads the one tree unmapped: it never gains a client or seed
    axis, never requires a gradient and is never written.

    ``fault_cfg`` (a ``faults.FaultCfg``) splits the availability mask in
    two: ``mask`` (who runs local SGD; trace replay and blackouts apply
    here) and ``mask_upload`` (who delivers: the mid-round survival draw
    and sanitization).  Only delivering clients aggregate, update their
    row and τ; the metrics grow ``n_dropped`` / ``n_rejected``.

    ``staleness_cfg`` (a ``staleness.StalenessCfg``) makes rounds
    semi-asynchronous: an update computed at ``t`` arrives at ``t + d``
    through the ``FLState.stale`` ring, a client with an update in flight
    does not compute, arrivals aggregate with weight ``gamma ** d``, and
    the fault layer acts at delivery; the metrics grow ``n_stale`` /
    ``mean_staleness``.  Either left None (or ``tau_max = 0``) keeps the
    key split, the metrics keys and every value of the synchronous,
    fault-free round.

    ``cfg.sparse_cohort`` makes it a cohort round: ``batches`` is the
    ``emit="cols"`` sampler's ``{"cols", "store"}``, the cohort is chosen
    after every availability layer (trace, blackout, busy gating), and
    the metrics grow ``n_deferred``.  Without a ring the round runs at
    O(c·N) and writes the resident stacks in place (it consumes its
    state); with one, the cohort's results fill dense lanes of the
    synchronous path, whose ring is O(m·N) anyway.

    On tree state (``cfg.flat_state`` False) the round runs local SGD on
    the client-stacked tree, forms ``G = start − x_end`` and sanitizes
    per leaf, and aggregates through the strategy's ``aggregate``;
    staleness needs the flat substrate, as in the reference."""
    float32_policy()
    strat = get_strategy(cfg.strategy)
    if staleness_cfg is not None and staleness_cfg.tau_max == 0:
        # tau_max = 0 IS the synchronous engine
        staleness_cfg = None
    if staleness_cfg is not None and not cfg.flat_state:
        raise ValueError("staleness_cfg needs the flat [m, N] substrate "
                         "(flat_state)")
    c_max = min(cfg.sparse_cohort, cfg.m)
    rdt = resident_dtype(cfg.resident_dtype)

    # The round is three parts: what comes before local SGD (keys,
    # availability, faults, the ring's drain and delays, the cohort), local
    # SGD, and what comes after (innovations, delivery, aggregation,
    # metrics, the ring's step).  ``round_fn`` composes them;
    # ``round_fn.seeds`` runs the first and last under ``seed_vmap`` and
    # local SGD once over the S seeds' clients, since ``torch.func.vmap``
    # cannot differentiate with ``torch.autograd.grad``.  The cohort's
    # gathers and in-place writes run between the parts, on every seed's
    # rows at once (core/cohort.py).

    def before(state):
        n_keys = 3 + (fault_cfg is not None) + (staleness_cfg is not None)
        keys = prng.split(state.rng, n_keys)
        rng, k_av, k_loc = keys[0], keys[1], keys[2]
        mask, markov = sample_active(k_av, avail_cfg, base_p, state.t,
                                     state.markov)
        pre = dict(rng=rng, markov=markov,
                   probs=probs_at(avail_cfg, base_p, state.t))
        if fault_cfg is not None:
            pre["k_up"] = keys[3]
            mask = _faults.compute_mask(fault_cfg, state.fault, mask,
                                        state.t)
        if staleness_cfg is not None:
            # arrivals due this round, then busy gating: an in-flight
            # client (including one landing now) does not compute at t
            pre["arrived"], pre["arr_age"], pre["arr_buf"] = _stale.drain(
                state.stale, state.t)
            mask = mask * (1.0 - _stale.busy_mask(state.stale))
            pre["delay"] = _stale.draw_delay(staleness_cfg, state.stale,
                                             keys[-1], state.t, cfg.m)
        loc_rngs = prng.split(k_loc, cfg.m)
        if c_max:
            # after every availability layer, so no slot goes to a client
            # that could not compute; the actives beyond the cap are
            # deferred before local work (the effective mask zeroes them).
            # The keys split over the full [m] and are gathered, so a
            # cohort row draws what the dense round would give its client
            idx, pre["n_deferred"] = cohort_select(mask, c_max)
            pre["mask_c"] = torch.gather(mask, -1, idx)
            mask = torch.zeros_like(mask).scatter(-1, idx, pre["mask_c"])
            loc_rngs = loc_rngs.index_select(0, idx)
            pre["idx"] = idx
        pre.update(mask=mask, loc_rngs=loc_rngs)
        return pre

    def eta_at(t):
        """η_l of round ``t`` (a 0-d tensor, or [S] across seeds)."""
        if cfg.lr_schedule:
            return cfg.eta_l / torch.sqrt(t.float() / 10.0 + 1.0)
        return cfg.eta_l

    def start_of(state, n):
        """Local SGD's start: the client stack, or for a stateless
        strategy a broadcast VIEW of the global (leaves ``[n, ...]``, or
        ``[S, n, ...]`` across seeds: ``[n, N]`` on the flat substrate),
        never a copy; nothing writes into it in place."""
        if strat.stateful_clients:
            return state.clients_tr
        lead = state.t.dim()
        return tree_map(lambda g: g.unsqueeze(lead).expand(
            g.shape[:lead] + (n,) + g.shape[lead:]), state.global_tr)

    def local_update(state, frozen, start, batches, rngs):
        spec = state.spec
        kw = dict(s=cfg.s, eta_l=eta_at(state.t), loss_fn=loss_fn,
                  grad_clip=cfg.grad_clip)
        if spec is None:
            return local_sgd(start, frozen, batches, rngs, **kw)
        x_end_tr, losses = local_sgd(spec.unflatten_stacked(start), frozen,
                                     batches, rngs, **kw)
        return spec.flatten_stacked(x_end_tr), losses

    def sync_metrics(state, mask, mask_upload, losses):
        """The synchronous round's metrics: under faults the delivered
        clients define them, and a rejected client's loss (possibly
        non-finite) is excluded by value, not just by weight."""
        safe = losses if fault_cfg is None else torch.where(
            torch.isfinite(losses), losses, 0.0)
        echo = (state.t - state.tau).float()
        mu = mask if mask_upload is None else mask_upload
        denom = torch.clamp(torch.sum(mu), min=1.0)
        return dict(loss=torch.sum(safe * mu) / denom,
                    n_active=torch.sum(mask),
                    mean_echo=torch.sum(echo * mu) / denom)

    def after(state, pre, start, x_end, losses):
        """The round after local SGD.  ``start`` and ``x_end`` are
        [m, N] stacks on the flat substrate, client-stacked trees on tree
        state (one leaf or many: ``G`` and the scrub go leaf by leaf)."""
        mask = pre["mask"]
        G = tree_map(torch.sub, start, x_end)
        if staleness_cfg is not None:
            # delivery candidates: synchronous computes (drawn d = 0) plus
            # ring arrivals — disjoint, since an arriving client was busy
            arrived, arr_age, arr_buf = (pre["arrived"], pre["arr_age"],
                                         pre["arr_buf"])
            delay = pre["delay"]
            now = mask * (delay == 0).float()
            defer = mask * (delay > 0).float()
            deliver = now + arrived
            G_eff = torch.where(arrived[:, None] > 0, arr_buf,
                                torch.where(now[:, None] > 0, G, 0.0))
            x_end_eff = torch.where(arrived[:, None] > 0, start - arr_buf,
                                    x_end)
            age_eff = torch.where(arrived > 0, arr_age, 0.0)
        else:
            deliver, G_eff, x_end_eff = mask, G, x_end
        mask_upload = None
        if fault_cfg is not None:
            mask_upload, n_dropped, n_rejected = _faults.upload_mask(
                fault_cfg, pre["k_up"], deliver, G_eff)
            if fault_cfg.sanitize:
                # scrub demoted rows by selection: the kernel forms w·x†
                # and 0 * NaN = NaN, so a rejected row must hold finite
                # values, not just zero weight
                keep = mask_upload > 0
                x_end_eff = tree_map(
                    lambda xe, st: torch.where(_bshape(keep, xe), xe, st),
                    x_end_eff, start)
                G_eff = tree_map(
                    lambda g: torch.where(_bshape(keep, g), g, 0.0), G_eff)
        if staleness_cfg is not None:
            mu0 = deliver if mask_upload is None else mask_upload
            w_disc = mu0 if staleness_cfg.gamma >= 1.0 else mu0 * torch.pow(
                torch.full((), staleness_cfg.gamma, dtype=torch.float32,
                           device=mu0.device), age_eff)
            agg_mask, agg_kwargs = mu0, dict(mask_upload=w_disc,
                                             ages=age_eff)
        else:
            agg_mask, agg_kwargs = mask, dict(mask_upload=mask_upload)
        agg = dict(x_end=x_end_eff, G=G_eff, mask=agg_mask, t=state.t,
                   tau=state.tau, probs=pre["probs"], extra=state.extra,
                   eta_g=cfg.eta_g, use_kernel=cfg.use_kernel, **agg_kwargs)
        if cfg.flat_state:
            new_global, new_clients, new_tau, new_extra = \
                strat.aggregate_flat(global_flat=state.global_tr,
                                     clients_flat=start, **agg)
        else:
            new_global, new_clients, new_tau, new_extra = strat.aggregate(
                global_tr=state.global_tr, clients_tr=start, **agg)

        if staleness_cfg is not None:
            # loss / n_active describe who COMPUTED this round; the
            # delivery side gets its own keys
            safe = losses if fault_cfg is None else torch.where(
                torch.isfinite(losses), losses, 0.0)
            echo = (state.t - state.tau).float()
            den_mu = torch.clamp(torch.sum(mu0), min=1.0)
            metrics = dict(
                loss=torch.sum(safe * mask)
                / torch.clamp(torch.sum(mask), min=1.0),
                n_active=torch.sum(mask),
                mean_echo=torch.sum(echo * mu0) / den_mu,
                n_stale=torch.sum(arrived),
                mean_staleness=torch.sum(age_eff * mu0) / den_mu,
            )
        else:
            metrics = sync_metrics(state, mask, mask_upload, losses)
        if fault_cfg is not None:
            metrics.update(n_dropped=n_dropped, n_rejected=n_rejected)
        new_state = state._replace(
            global_tr=new_global, clients_tr=new_clients, tau=new_tau,
            t=state.t + 1, extra=new_extra, markov=pre["markov"],
            rng=pre["rng"])
        if staleness_cfg is not None:
            # raw (unsanitized, undiscounted) innovations enter the ring;
            # faults and the discount apply at delivery
            new_state = new_state._replace(stale=_stale.step_buffer(
                state.stale, state.t, defer, delay, G))
        return new_state, metrics

    def after_cohort(state, pre, old_c, start_c, x_end_c, losses_c, mem_c):
        """The pure cohort round's aggregation on the [c, N] working set:
        returns the new state's fields (without the resident stacks), the
        rows to write into each resident stack at the cohort
        (``"clients"`` and the strategy's memories), and the metrics."""
        idx, mask_c, mask = pre["idx"], pre["mask_c"], pre["mask"]
        G_c = start_c - x_end_c
        mask_upload_c = None
        if fault_cfg is not None:
            mask_upload_c, n_dropped, n_rejected = \
                _faults.upload_mask_cohort(fault_cfg, pre["k_up"], cfg.m,
                                           idx, mask_c, G_c)
            if fault_cfg.sanitize:
                keep = mask_upload_c[:, None] > 0
                x_end_c = torch.where(keep, x_end_c, start_c)
                G_c = torch.where(keep, G_c, 0.0)
        mu_c = mask_c if mask_upload_c is None else mask_upload_c
        mu_full = torch.zeros_like(mask).scatter(-1, idx, mu_c)
        new_global, rows, write, new_extra = strat.aggregate_cohort(
            global_flat=state.global_tr, cohort_flat=start_c, x_end=x_end_c,
            G=G_c, mask=mask_c, t=state.t,
            tau_c=torch.gather(state.tau, -1, idx),
            probs_c=torch.gather(pre["probs"], -1, idx), extra=state.extra,
            mem_c=mem_c, eta_g=cfg.eta_g, m_total=cfg.m, idx=idx,
            mu_full=mu_full, use_kernel=cfg.use_kernel,
            mask_upload=mask_upload_c)
        writes = {k: new_extra[k] for k in strat.cohort_memory}
        if strat.cohort_memory:
            new_extra = {k: v for k, v in new_extra.items()
                         if k not in writes}
        if rows is not None and old_c is not None:
            writes["clients"] = cohort_payload(old_c, rows, write)
        # full-[m] metric inputs (O(m) vectors): the scattered lanes hold
        # exact zeros wherever the mask does
        losses = torch.zeros_like(mask).scatter(-1, idx, losses_c)
        metrics = sync_metrics(state, mask,
                               None if mask_upload_c is None else mu_full,
                               losses)
        if fault_cfg is not None:
            metrics.update(n_dropped=n_dropped, n_rejected=n_rejected)
        fields = dict(global_tr=new_global,
                      tau=torch.where(mu_full > 0, state.t, state.tau),
                      t=state.t + 1, extra=new_extra, markov=pre["markov"],
                      rng=pre["rng"])
        return fields, writes, metrics

    def cohort_part(state, frozen, batches, pre, vm):
        """The cohort's part of a round between ``before`` and the
        aggregation: its batches and rows gathered at O(c), local SGD over
        c clients, then ``after_cohort`` and the in-place writes — or,
        with a ring, ``after`` on dense lanes."""
        idx = pre["idx"]
        cols = batches["cols"]
        q = cols.shape[-1]
        cols_c = torch.gather(cols, -2,
                              idx.unsqueeze(-1).expand(idx.shape + (q,)))
        b_c = gather_batches_at(batches["store"], cols_c, idx, cfg.s,
                                q // cfg.s)
        old_c = None
        if strat.stateful_clients:
            old_c = cohort_rows(state.clients_tr, idx)
            start_c = old_c.float()
        else:
            start_c = start_of(state, c_max)
        x_end_c, losses_c = local_update(state, frozen, start_c, b_c,
                                         pre["loc_rngs"])
        if staleness_cfg is not None:
            # the ring is O(m·N) a round regardless: the cohort's results
            # fill dense lanes (G = 0 exactly off the cohort) and the
            # synchronous path runs unchanged, then the stack is demoted
            start = (state.clients_tr.float() if strat.stateful_clients
                     else start_of(state, cfg.m))
            x_end = cohort_write(
                start.clone(memory_format=torch.contiguous_format), idx,
                x_end_c)
            losses = torch.zeros(idx.shape[:-1] + (cfg.m,),
                                 device=losses_c.device).scatter(
                                     -1, idx, losses_c)
            new_state, metrics = vm(after)(state, pre, start, x_end, losses)
            if new_state.clients_tr is not None:
                new_state = new_state._replace(
                    clients_tr=new_state.clients_tr.to(rdt))
        else:
            mem_c = {k: cohort_rows(state.extra[k], idx)
                     for k in strat.cohort_memory}
            fields, writes, metrics = vm(after_cohort)(
                state, pre, old_c, start_c, x_end_c, losses_c, mem_c)
            # the in-place writes: the round consumes ``state``'s stacks
            if "clients" in writes:
                cohort_write(state.clients_tr, idx, writes.pop("clients"))
            for k, payload in writes.items():
                cohort_write(state.extra[k], idx, payload)
            if writes:
                fields["extra"] = dict(
                    fields["extra"], **{k: state.extra[k] for k in writes})
            new_state = state._replace(**fields)
        metrics["n_deferred"] = pre["n_deferred"]
        return new_state, metrics

    def compose_round(state, frozen, batches, vm):
        pre = vm(before)(state)
        if c_max:
            return cohort_part(state, frozen, batches, pre, vm)
        start = start_of(state, cfg.m)
        x_end, losses = local_update(state, frozen, start, batches,
                                     pre["loc_rngs"])
        return vm(after)(state, pre, start, x_end, losses)

    def round_fn(state: FLState, frozen, batches):
        return compose_round(state, frozen, batches, lambda part: part)

    def seeds_round_fn(states: FLState, frozen, batches):
        """The round of S independent seeds: ``states`` with ``[S, ...]``
        leaves (``stack_seeds``), batches ``[S, m, s, ...]`` (or the
        cohort sampler's ``[S, m, s*b]`` columns beside the shared
        store), ``frozen`` shared by the seeds; returns the new states and
        metrics ``[S]`` per key."""
        return compose_round(states, frozen, batches, seed_vmap)

    round_fn.seeds = seeds_round_fn
    return round_fn


def make_chunk_fn(cfg, round_fn, sample_fn, chunk_rounds, *,
                  with_frozen=False):
    """Chunked round executor: K = ``chunk_rounds`` rounds per call.

    Returned callable: ``chunk(state, sampler_state, store, data_key) ->
    (state, sampler_state, metrics)``, or with ``with_frozen`` (a round of
    ``make_round_fn_with_frozen``) ``chunk(state, frozen, sampler_state,
    store, data_key)``, the reference's signatures.  Per round, batches
    come from the stateful sampler ``sample_fn(store, sampler_state,
    fold_in(data_key, state.t))`` — keyed by the global round counter on the device, so a
    host loop driven through the same sampler and keys sees identical
    data.  Metrics come back stacked ``[K]`` per key, still on the device.
    ``cfg`` is kept for signature symmetry with the reference."""
    del cfg
    K = int(chunk_rounds)
    if K < 1:
        raise ValueError(f"chunk_rounds must be >= 1; got {chunk_rounds}")

    advance = (round_fn if with_frozen
               else (lambda st, _, b: round_fn(st, b)))

    def k_rounds(state, frozen, sampler_state, store, data_key):
        per_round = []
        for _ in range(K):
            batches, sampler_state = sample_fn(
                store, sampler_state, prng.fold_in(data_key, state.t))
            state, metrics = advance(state, frozen, batches)
            per_round.append(metrics)
        stacked = {k: torch.stack([r[k] for r in per_round])
                   for k in per_round[0]}
        return state, sampler_state, stacked

    if with_frozen:
        return k_rounds

    def chunk(state, sampler_state, store, data_key):
        return k_rounds(state, None, sampler_state, store, data_key)

    return chunk


def seed_vmap(part):
    """``part`` over a leading seed axis: ``torch.func.vmap`` over every
    tensor leaf of its arguments (dicts, tuples and ``FLState`` are
    walked), while every other leaf — None, a ``FlatSpec``, a number —
    passes through unbatched, as does every non-tensor leaf of the
    result.  What ``part`` closes over is shared by the seeds."""
    def batched(*args):
        leaves, spec = pytree.tree_flatten(args)
        at = [i for i, v in enumerate(leaves) if torch.is_tensor(v)]
        out_tree = {}

        def inner(*tensors):
            ls = list(leaves)
            for i, v in zip(at, tensors):
                ls[i] = v
            out = part(*pytree.tree_unflatten(ls, spec))
            out_leaves, out_tree["spec"] = pytree.tree_flatten(out)
            out_tree["at"] = [i for i, v in enumerate(out_leaves)
                              if torch.is_tensor(v)]
            out_tree["leaves"] = [None if torch.is_tensor(v) else v
                                  for v in out_leaves]
            return tuple(out_leaves[i] for i in out_tree["at"])

        outs = torch.func.vmap(inner)(*(leaves[i] for i in at))
        ls = out_tree["leaves"]
        for i, v in zip(out_tree["at"], outs):
            ls[i] = v
        return pytree.tree_unflatten(ls, out_tree["spec"])

    return batched


def stack_seeds(trees):
    """Stack identically structured trees along a new leading seed axis:
    ``[tree_0, ..., tree_{S-1}] -> tree with [S, ...] leaves``.  Each seed
    is built exactly as a single-seed run builds it and then stacked, so
    slice ``j`` is bit for bit the input of run ``j``.  Leaves that are
    not tensors (the ``FlatSpec`` in ``FLState.spec``, None) must agree
    across the trees and pass through."""
    if not trees:
        raise ValueError("stack_seeds needs at least one tree")
    flat = [pytree.tree_flatten(t) for t in trees]
    spec = flat[0][1]
    if any(f[1] != spec for f in flat[1:]):
        raise ValueError("stack_seeds: the trees differ in structure")
    out = []
    for col in zip(*(f[0] for f in flat)):
        tensors = sum(torch.is_tensor(v) for v in col)
        if tensors and tensors < len(col):
            raise ValueError("stack_seeds: the trees differ in structure "
                             "(a tensor in one, not in another)")
        if tensors:
            out.append(torch.stack(col))
        elif any(v != col[0] for v in col[1:]):
            raise ValueError("stack_seeds: a non-tensor leaf differs "
                             "across the trees")
        else:
            out.append(col[0])
    return pytree.tree_unflatten(out, spec)


def index_seed(tree, j):
    """Seed ``j`` of a seed-stacked tree (``[S, ...]`` leaves -> ``[...]``
    views); non-tensor leaves pass through."""
    return pytree.tree_map(lambda v: v[j] if torch.is_tensor(v) else v,
                           tree)


def make_seeds_chunk_fn(cfg, round_fn, sample_fn, chunk_rounds, n_seeds, *,
                        with_frozen=False):
    """S-batched chunk executor: one call advances ``n_seeds`` independent
    seed replicates by ``chunk_rounds`` rounds each.

    Returned callable::

        chunk(states, sampler_states, store, data_keys)
            -> (states, sampler_states, metrics)     # metrics [S, K] per key

    or with ``with_frozen`` (a round of ``make_round_fn_with_frozen``)::

        chunk(states, frozen, sampler_states, store, data_keys)

    where ``frozen`` is shared by every seed: it stays outside
    ``seed_vmap`` (closed over, never an argument of a vmapped part) and
    reaches only local SGD, unmapped.

    ``states`` and ``sampler_states`` carry ``[S, ...]`` leaves
    (``stack_seeds``), ``data_keys`` is ``[S, 2]``; the ``store`` is
    shared by every seed (a cohort sampler's ``{"cols", "store"}``
    batches get ``[S, m, s*b]`` columns and the one store).  Per round,
    seed ``j``'s batches come from
    ``sample_fn(store, sampler_states[j], fold_in(data_keys[j], t_j))``
    and its round is ``round_fn``'s, so each seed evolves as its
    single-seed chunked run would.  ``round_fn`` is the single-seed round
    of ``make_round_fn``; its seed-batched form (``round_fn.seeds``) runs
    the sampler and the parts of the round around local SGD under
    ``seed_vmap`` and local SGD once over all S·m clients, so a round
    dispatches one seed's operations, each over S seeds' data.  ``cfg``
    is kept for signature symmetry with the reference."""
    del cfg
    K, S = int(chunk_rounds), int(n_seeds)
    if K < 1:
        raise ValueError(f"chunk_rounds must be >= 1; got {chunk_rounds}")
    if S < 1:
        raise ValueError(f"n_seeds must be >= 1; got {n_seeds}")
    seeds_round = getattr(round_fn, "seeds", None)
    if seeds_round is None:
        raise ValueError("round_fn has no seed-batched form: build it with "
                         "make_round_fn or make_round_fn_with_frozen")
    advance = (seeds_round if with_frozen
               else (lambda st, _, b: seeds_round(st, b)))

    def draw(store, ss, key, t):
        batches, ss = sample_fn(store, ss, prng.fold_in(key, t))
        # the cohort sampler hands back its store beside the columns: the
        # seeds share it, so it stays out of the vmap
        return {k: v for k, v in batches.items() if k != "store"}, ss

    def k_rounds(states, frozen, sampler_states, store, data_keys):
        if states.t.shape != (S,):
            raise ValueError(f"states carry {tuple(states.t.shape)} seeds; "
                             f"the executor was built for {S}")
        sample = seed_vmap(lambda ss, key, t: draw(store, ss, key, t))
        per_round = []
        for _ in range(K):
            batches, sampler_states = sample(sampler_states, data_keys,
                                             states.t)
            if "cols" in batches:
                batches["store"] = store
            states, metrics = advance(states, frozen, batches)
            per_round.append(metrics)
        stacked = {k: torch.stack([r[k] for r in per_round], dim=1)
                   for k in per_round[0]}
        return states, sampler_states, stacked

    if with_frozen:
        return k_rounds

    def chunk(states, sampler_states, store, data_keys):
        return k_rounds(states, None, sampler_states, store, data_keys)

    return chunk


def make_grid_chunk_fn(cells, chunk_rounds, n_seeds):
    """Packed grid executor: one call advances C grid cells x ``n_seeds``
    seeds x ``chunk_rounds`` rounds.  ``cells`` lists ``(round_fn,
    sample_fn)`` pairs; the cells are different computations, so their
    seed chunks (``make_seeds_chunk_fn``) run one after another.

    Returned callable::

        packed(states_t, sampler_states_t, stores_t, data_keys_t)
            -> (states_t, sampler_states_t, metrics_t)

    every argument and result a C-tuple over cells, element ``i`` laid
    out as ``make_seeds_chunk_fn``'s."""
    if not cells:
        raise ValueError("make_grid_chunk_fn needs at least one cell")
    bodies = [make_seeds_chunk_fn(None, rf, sf, chunk_rounds, n_seeds)
              for rf, sf in cells]

    def packed(states_t, sampler_states_t, stores_t, data_keys_t):
        outs = [body(st, ss, store, dk)
                for body, st, ss, store, dk in zip(
                    bodies, states_t, sampler_states_t, stores_t,
                    data_keys_t)]
        return (tuple(o[0] for o in outs), tuple(o[1] for o in outs),
                tuple(o[2] for o in outs))

    return packed


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
               store=None, data_key=None, sampler_state=None, ckpt_fn=None,
               ckpt_every=0):
    """Run T rounds; returns (state, history list of metric dicts).

    Host loop (default): ``batch_fn(t)`` batches — or, when ``batch_fn``
    is None, the stateful device sampler keyed by ``fold_in(data_key,
    t)``, the chunked executor's stream — and one metrics fetch per round.

    Chunked (``chunk_rounds=K > 0``): ``ceil(T / K)`` chunk calls (a
    shorter final chunk covers ``T % K``) and one metrics fetch per chunk;
    ``eval_fn`` and ``ckpt_fn`` fire at the first chunk boundary at or
    past each ``eval_every`` / ``ckpt_every`` multiple.

    ``ckpt_fn(state, t)`` writes an eval/export checkpoint after ``t``
    rounds of this call; a 3-argument (or variadic) ``ckpt_fn(state, t,
    sampler_state)`` also gets the carried sampler state, which a
    resumable checkpoint (``checkpointing.save_run_state``) needs."""
    if chunk_rounds:
        return _run_rounds_chunked(
            state, round_fn, T, chunk_rounds, sample_fn=sample_fn,
            store=store, data_key=data_key, sampler_state=sampler_state,
            log_every=log_every, eval_fn=eval_fn, eval_every=eval_every,
            ckpt_fn=ckpt_fn, ckpt_every=ckpt_every)

    if batch_fn is None:
        if sample_fn is None or store is None or data_key is None \
                or sampler_state is None:
            raise ValueError(
                "host loop needs batch_fn, or a stateful device sampler "
                "(sample_fn + store + data_key + sampler_state)")
        # key by the GLOBAL round counter, like the chunk executor: a
        # resumed state must not replay the stream from round 0
        t0 = int(state.t)

        def batch_fn(t):
            batches, carried[0] = sample_fn(
                store, carried[0], prng.fold_in(data_key, t0 + t))
            return batches

    carried = [sampler_state]
    history = []
    for t in range(T):
        state, metrics = round_fn(state, batch_fn(t))
        rec = _metrics_to_host(metrics)
        rec["t"] = t
        if eval_fn is not None and eval_every and (t + 1) % eval_every == 0:
            rec.update(eval_fn(state))
        history.append(rec)
        if ckpt_fn is not None and ckpt_every and (t + 1) % ckpt_every == 0:
            _call_ckpt(ckpt_fn, state, t + 1, carried[0])
        if log_every and (t + 1) % log_every == 0:
            _log(t + 1, rec)
    return state, history


def _crossed(done, k, every):
    """Did [done-k, done] cross a multiple of ``every``?"""
    return every and (done // every) > ((done - k) // every)


def _call_ckpt(ckpt_fn, state, done, sampler_state):
    """Call a checkpoint hook by its arity: ``(state, t)`` for a 2-argument
    hook; ``(state, t, sampler_state)`` for a 3-argument or variadic one
    (a hook that absorbs arguments gets the whole run state)."""
    import inspect

    try:
        params = inspect.signature(ckpt_fn).parameters.values()
        variadic = any(p.kind == inspect.Parameter.VAR_POSITIONAL
                       for p in params)
        n = 3 if variadic else len(params)
    except (TypeError, ValueError):  # callables without a signature
        n = 2
    if n >= 3:
        ckpt_fn(state, done, sampler_state)
    else:
        ckpt_fn(state, done)


def _run_rounds_chunked(state, round_fn, T, K, *, sample_fn, store, data_key,
                        sampler_state, log_every, eval_fn, eval_every,
                        ckpt_fn, ckpt_every):
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
        if ckpt_fn is not None and _crossed(done, k, ckpt_every):
            _call_ckpt(ckpt_fn, state, done, sampler_state)
        if _crossed(done, k, log_every):
            _log(done, history[-1])
    return state, history
