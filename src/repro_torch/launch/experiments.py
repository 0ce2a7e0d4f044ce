"""Scenario-matrix runner for the paper's experiment grid (the port of
``python -m repro.launch.experiments``).

The paper's claims are about a GRID — strategy x availability dynamics x
sampler x heterogeneity — over several seeds.  This module answers a cell
of it in one command:

  * a **scenario registry**: named cells (``"fedawe/sine"``, ...) binding a
    strategy to an availability process, a sampling mode, the Dirichlet
    heterogeneity and the fault and staleness knobs, cell for cell the
    reference's, with its named sub-grids (``GRIDS``);
  * a **seed-batched executor** (``core.engine.make_seeds_chunk_fn``): the
    ``FLState``, the sampler carry and the data keys carry a leading seed
    axis, and one call advances S independent seeds K rounds.  Seed ``j``
    evolves as a single-seed chunked run driven by ``fold_in(rng, j)`` /
    ``fold_in(data_key, j)``: counts, τ, keys and sampler carries to the
    bit, states within float32 rounding (the batched reductions may add in
    another order).  Replication is shared-template by default or full
    (``--replicate full``: per-seed model init from ``fold_in(model_rng,
    j)``);
  * a **packed grid** (``--packed``): cells group by shape, near-miss
    sampler caps are padded (``pack_cells``), and each group's seed chunks
    run in one call (``core.engine.make_grid_chunk_fn``);
  * a **seed mesh** (``--seed-mesh``, ``launch/mesh.make_seed_mesh``): the
    seed axis splits into the mesh's seed-axis size of contiguous shards,
    each moved once to the first device of its sub-mesh
    (``place_seed_batch``) and advanced there by its own seed chunk; the
    metrics join back in seed order.  A placement changes no number: each
    seed evolves as in the unsplit chunk.  Clients are not split over
    devices (that placement comes with ``sharding/``), and the mesh takes
    the flat substrate only, as the reference's;
  * a **results table** (``launch/analysis.py``): per-seed histories to
    mean±std curves and a paper-style table under ``--out-dir``.

CLI::

    python -m repro_torch.launch.experiments --list
    python -m repro_torch.launch.experiments --scenario fedawe/sine \\
        --seeds 4 --use-kernel
    python -m repro_torch.launch.experiments --grid speedup-sine \\
        --seeds 4 --packed

    python -m repro_torch.launch.experiments --scenario fedawe/sine \\
        --seeds 4 --seed-mesh --compile-cache auto

It runs on the card (``--device cuda``, the default) unless ``--device
cpu`` is passed, and raises when the card is missing.  ``--preset lm``
runs each cell on the launcher's LM task (``train.build_lm_task``).
``--seed-mesh`` sizes the mesh over every visible card (over the CPU with
``--device cpu``); ``--compile-cache`` keeps the kernel libraries nvcc
builds in a keyed directory (``launch/compilecache``).
"""
from __future__ import annotations

import argparse
import dataclasses
import fnmatch
import json
import os
import re

import torch
import torch.utils._pytree as pytree

from repro_torch.core import (FaultCfg, FlatSpec, FLConfig, StalenessCfg,
                              faults, index_seed, init_fl_state,
                              make_grid_chunk_fn, make_round_fn,
                              make_seeds_chunk_fn, prng, stack_seeds,
                              staleness)
from repro_torch.core.availability import KINDS, AvailabilityCfg
from repro_torch.core.engine import _crossed, _metrics_to_host
from repro_torch.core.strategies import REGISTRY
from repro_torch.data import (SAMPLING_MODES, init_seed_sampler_states,
                              make_device_sampler, pad_store, seed_data_keys)
from repro_torch.device import resolve_device
from repro_torch.launch import analysis, train
from repro_torch.launch.mesh import mesh_axis_sizes

# ---------------------------------------------------------------------------
# scenario registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named cell of the experiment grid (the reference's fields and
    defaults).  The cell fixes the comparison point — strategy,
    availability process and knobs, sampling mode, Dirichlet ``alpha``,
    fault and staleness knobs — while run scale (clients, rounds, seeds,
    batch) stays a CLI argument."""
    name: str
    strategy: str = "fedawe"
    kind: str = "stationary"        # availability dynamics (one of KINDS)
    sampling: str = "uniform"       # device-sampler mode
    alpha: float = 0.1              # Dirichlet heterogeneity (data + avail)
    gamma: float = 0.3              # sine family amplitude
    period: int = 20                # staircase / sine period
    staircase_low: float = 0.4
    cutoff: float = 0.1             # interleaved_sine hard cutoff
    delta_floor: float = 0.0        # Assumption-1 clamp
    markov_up: float = 0.2          # Gilbert-Elliott P(off -> on) scale
    markov_down: float = 0.2        # Gilbert-Elliott P(on -> off)
    eta_l: float = 0.05
    eta_g: float = 1.0
    flat_state: bool = True         # flat [m, N] substrate by default
    # fault-injection knobs (core/faults.py) — all off by default
    upload_survival: float = 1.0    # < 1 enables mid-round dropout
    sanitize: bool = False          # demote non-finite updates to dropped
    norm_cap: float = 0.0           # with sanitize: reject ||G_i|| > cap
    fault_trace: str = ""           # "" or "diurnal": [T, m] replay trace
    blackout_start: int = 0
    blackout_len: int = 0           # > 0: blackout B consecutive rounds
    blackout_every: int = 0         # recurrence period (0 = one-shot)
    blackout_cluster: int = 0       # targeted data cluster (dominant label)
    nu_corr: bool = False           # base_p := adversarial_probs_from_nu
    # semi-async knobs (core/staleness.py) — all off by default
    stale_max: int = 0              # tau_max delay bound (0 = synchronous)
    stale_kind: str = "det"         # delay dynamics: det | geom | trace
    stale_delay: int = 1            # det: every straggler takes this long
    stale_p: float = 0.5            # geom: per-round arrival probability
    stale_gamma: float = 1.0        # delivery discount base (gamma ** d)
    note: str = ""

    def __post_init__(self):
        for field, value, allowed in (
                ("strategy", self.strategy, tuple(REGISTRY)),
                ("kind", self.kind, KINDS),
                ("sampling", self.sampling, SAMPLING_MODES),
                ("fault_trace", self.fault_trace, ("", "diurnal")),
                ("stale_kind", self.stale_kind, ("det", "geom", "trace"))):
            if value not in allowed:
                raise ValueError(f"scenario {self.name!r}: {field} "
                                 f"{value!r} is not one of {allowed}")

    def availability(self) -> AvailabilityCfg:
        return AvailabilityCfg(
            kind=self.kind, gamma=self.gamma, period=self.period,
            staircase_low=self.staircase_low, cutoff=self.cutoff,
            delta_floor=self.delta_floor, markov_up=self.markov_up,
            markov_down=self.markov_down)

    def fault(self):
        """The cell's ``FaultCfg``, or None when every fault knob is at
        its default (the fault-free round)."""
        if (self.upload_survival >= 1.0 and not self.sanitize
                and not self.fault_trace and self.blackout_len == 0):
            return None
        return FaultCfg(
            upload_survival=self.upload_survival,
            trace=bool(self.fault_trace),
            blackout_start=self.blackout_start,
            blackout_len=self.blackout_len,
            blackout_every=self.blackout_every,
            blackout_cluster=self.blackout_cluster,
            sanitize=self.sanitize, norm_cap=self.norm_cap)

    def staleness(self):
        """The cell's ``StalenessCfg``, or None when ``stale_max == 0``
        (the synchronous round)."""
        if self.stale_max == 0:
            return None
        return StalenessCfg(
            tau_max=self.stale_max, kind=self.stale_kind,
            delay=self.stale_delay, p_next=self.stale_p,
            gamma=self.stale_gamma)


SCENARIOS: dict = {}

#: Named sub-grids: lists of scenario names matching the paper's figures.
GRIDS: dict = {}


def register_scenario(sc: Scenario) -> Scenario:
    if sc.name in SCENARIOS:
        raise ValueError(f"duplicate scenario {sc.name!r}")
    SCENARIOS[sc.name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; see --list "
                       f"({len(SCENARIOS)} registered)")
    return SCENARIOS[name]


def match_scenarios(patterns) -> list:
    """Expand names / fnmatch patterns into sorted scenario names; raises
    on a pattern matching nothing (silent empty grids hide typos)."""
    names = []
    for pat in patterns:
        hit = sorted(n for n in SCENARIOS if fnmatch.fnmatch(n, pat))
        if not hit:
            raise KeyError(f"pattern {pat!r} matches no scenario; see --list")
        names.extend(h for h in hit if h not in names)
    return names


def _register_paper_grid():
    """The paper's Section 7 grid (every strategy against every
    availability process; the markov column is the F3AST setting of
    Ribero et al.), the epoch-sampler, heterogeneity and floor ablations,
    the fault and semi-async cells, and the named sub-grids: the
    reference's registry, cell for cell."""
    for strat in sorted(REGISTRY):
        for kind in KINDS:
            note = ("F3AST-style Gilbert-Elliott availability "
                    "(Ribero et al.)" if kind == "markov" else
                    "paper Section 7 dynamics")
            register_scenario(Scenario(name=f"{strat}/{kind}",
                                       strategy=strat, kind=kind, note=note))
    for kind in KINDS:
        register_scenario(Scenario(
            name=f"fedawe/{kind}+epoch", strategy="fedawe", kind=kind,
            sampling="epoch", note="epoch-permutation device sampler"))
    for alpha, tag in ((100.0, "iid"), (0.3, "dir03"), (0.05, "dir005")):
        register_scenario(Scenario(
            name=f"fedawe/sine@{tag}", strategy="fedawe", kind="sine",
            alpha=alpha, note=f"Dirichlet alpha={alpha} heterogeneity"))
    register_scenario(Scenario(
        name="fedawe/interleaved_sine@floor", strategy="fedawe",
        kind="interleaved_sine", delta_floor=0.05,
        note="delta_floor=0.05 keeps Assumption 1 in the dynamics"))

    register_scenario(Scenario(
        name="fig2_midround_dropout", strategy="fedawe", nu_corr=True,
        upload_survival=0.7, sanitize=True,
        note="Fig.2 nu-correlated availability + 30% mid-round dropout "
             "+ sanitization"))
    register_scenario(Scenario(
        name="blackout_cluster", strategy="fedawe", kind="sine",
        blackout_start=4, blackout_len=4, blackout_every=12,
        blackout_cluster=0,
        note="recurring 4-round blackout of data cluster 0 "
             "(dominant-label targeting)"))
    register_scenario(Scenario(
        name="trace_diurnal", strategy="fedawe", fault_trace="diurnal",
        note="replay a recorded-style diurnal [T, m] availability trace "
             "bit-exactly"))
    for strat in sorted(REGISTRY):
        register_scenario(Scenario(
            name=f"{strat}/midround", strategy=strat, kind="sine",
            upload_survival=0.8, sanitize=True,
            note="20% mid-round upload dropout + sanitization"))

    for strat in sorted(REGISTRY):
        register_scenario(Scenario(
            name=f"{strat}/stale_d2", strategy=strat, kind="sine",
            stale_max=2, stale_kind="det", stale_delay=2,
            note="deterministic 2-round straggler delay, sine dynamics"))
    register_scenario(Scenario(
        name="fedawe/stale_geom", strategy="fedawe", kind="sine",
        stale_max=4, stale_kind="geom", stale_p=0.5,
        note="geometric upload delays, tau_max=4 bound"))
    register_scenario(Scenario(
        name="fedawe/stale_trace", strategy="fedawe", kind="sine",
        stale_max=4, stale_kind="trace",
        note="replayed staircase per-client delay trace, tau_max=4"))
    register_scenario(Scenario(
        name="fedawe/stale_d2+midround", strategy="fedawe", kind="sine",
        stale_max=2, stale_kind="det", stale_delay=2,
        upload_survival=0.8, sanitize=True,
        note="semi-async delays composed with 20% mid-round dropout "
             "+ sanitization at delivery"))
    register_scenario(Scenario(
        name="fedar/semi_async", strategy="fedar", kind="sine",
        stale_max=4, stale_kind="geom", stale_p=0.5, stale_gamma=0.7,
        note="FedAR rectification baseline (Jiang et al. 2024): "
             "geometric delays, gamma**d delivery discount"))

    GRIDS.update({
        "speedup-sine": ["fedawe/sine", "fedawe_m/sine",
                         "fedavg_active/sine", "fedavg_known_p/sine",
                         "fedau/sine", "mifa/sine", "fedvarp/sine"],
        "nonstationary": [f"{s}/{k}" for s in ("fedawe", "fedavg_active",
                                               "fedau")
                          for k in ("staircase", "sine",
                                    "interleaved_sine")],
        "f3ast-markov": [f"{s}/markov" for s in sorted(REGISTRY)],
        "paper-sec7": [f"{s}/{k}" for s in sorted(REGISTRY)
                       for k in ("stationary", "staircase", "sine",
                                 "interleaved_sine")],
        "faults": (["fig2_midround_dropout", "blackout_cluster",
                    "trace_diurnal"]
                   + [f"{s}/midround" for s in sorted(REGISTRY)]),
        "staleness": ([f"{s}/stale_d2" for s in sorted(REGISTRY)]
                      + ["fedawe/stale_geom", "fedawe/stale_trace",
                         "fedawe/stale_d2+midround", "fedar/semi_async"]),
    })


_register_paper_grid()


# ---------------------------------------------------------------------------
# seed-batched executor runs
# ---------------------------------------------------------------------------

def build_seed_batch(cfg: FLConfig, template, base_rng, data_key,
                     init_sampler_state, store, n_seeds: int, *,
                     template_fn=None, model_rng=None, seed_ids=None,
                     fault=None, stale=None):
    """Stacked per-seed carry for ``make_seeds_chunk_fn``: seed ``j`` is
    initialized exactly as a single-seed run with ``rng_j = fold_in(
    base_rng, j)`` and ``data_key_j = fold_in(data_key, j)``, then the
    seeds are stacked.

    Template modes: shared (``template_fn`` None) starts every seed from
    ``template``; full re-initializes seed ``j``'s model from
    ``template_fn(fold_in(model_rng, j))`` (``model_rng`` defaults to
    ``base_rng``).  ``seed_ids`` (default ``range(n_seeds)``) names the
    fold-in id of each stacked row, so permuting it permutes the per-seed
    results.  ``fault`` / ``stale`` are the same carry for every seed
    (the replay trace, cluster labels, the empty ring).

    Returns ``(states, sampler_states, data_keys)`` with ``[S, ...]``
    leaves (``sampler_states`` is ``{}`` under uniform sampling)."""
    ids = list(range(n_seeds)) if seed_ids is None else \
        [int(j) for j in seed_ids]
    if len(ids) != n_seeds:
        raise ValueError(f"seed_ids {ids} name {len(ids)} seeds, not "
                         f"{n_seeds}")
    if model_rng is None:
        model_rng = base_rng

    def tmpl(j):
        if template_fn is None:
            return template
        return template_fn(prng.fold_in(model_rng, j))

    states = stack_seeds([
        init_fl_state(prng.fold_in(base_rng, j), cfg, tmpl(j),
                      fault=fault, stale=stale)
        for j in ids])
    if seed_ids is None:
        data_keys = seed_data_keys(data_key, n_seeds)
    else:
        data_keys = torch.stack([prng.fold_in(data_key, j) for j in ids])
    sampler_states = init_seed_sampler_states(init_sampler_state, store,
                                              data_keys)
    return states, sampler_states, data_keys


class SeedShards(tuple):
    """A carry of a seed-mesh run: element ``i`` is shard ``i``'s ``[S_i,
    ...]`` tree on its device, the shards in seed order."""


def seed_shards(mesh, n_seeds):
    """``[(device, rows)]``: the seed axis of an ``n_seeds`` carry split
    into ``mesh``'s seed-axis size of contiguous row slices, shard ``i`` on
    the first device of its sub-mesh.  A mesh without a 'seed' axis keeps
    every seed in one shard on its first device."""
    n = mesh_axis_sizes(mesh).get("seed", 1)
    if n_seeds % n:
        raise ValueError(f"{n_seeds} seeds do not split into {n} shards")
    per, sub = n_seeds // n, len(mesh.devices) // n
    return [(mesh.devices[i * sub], slice(i * per, (i + 1) * per))
            for i in range(n)]


def _on(tree, dev, rows=None):
    """``tree``'s tensors (their ``rows`` of the seed axis, copied) on
    ``dev``; without ``rows`` a tensor already there is not copied."""
    def move(v):
        if not torch.is_tensor(v):
            return v
        if rows is None:
            return v.to(dev)
        return v[rows].to(dev, copy=True)

    return pytree.tree_map(move, tree)


def join_seed_shards(tree):
    """A ``SeedShards`` carry joined into one ``[S, ...]`` tree on its
    first shard's device, in seed order; any other tree as it is."""
    if not isinstance(tree, SeedShards):
        return tree
    flat = [pytree.tree_flatten(t) for t in tree]
    out = [torch.cat([v.to(col[0].device) for v in col])
           if torch.is_tensor(col[0]) else col[0]
           for col in zip(*(f[0] for f in flat))]
    return pytree.tree_unflatten(out, flat[0][1])


def _join_metrics(per_shard, dev):
    return {k: torch.cat([m[k].to(dev) for m in per_shard])
            for k in per_shard[0]}


def _round_fns(round_fn, shards):
    """The round function of each distinct shard device.  A round closes
    over tensors of one device (its ``base_p``); a grid cell's round
    carries ``round_fn.on(device)``, which builds it for another device.
    A round without ``on`` runs on every shard as it is."""
    on = getattr(round_fn, "on", None)
    return {dev: round_fn if on is None else on(dev)
            for dev in dict.fromkeys(d for d, _ in shards)}


def _check_flat(fl):
    if not fl.flat_state:
        raise ValueError("the seed mesh needs the flat [m, N] substrate "
                         "(flat_state), as the reference's")


def build_seed_executor(fl: FLConfig, round_fn, sample_fn, n_seeds, *,
                        mesh=None):
    """``make_chunk(k)``: a seed-batched chunk executor of ``k`` rounds, for
    the full-K chunks and the ``T % K`` tail alike (so the tail keeps the
    placement).  Without ``mesh``, ``make_seeds_chunk_fn``.  With one, each
    of ``seed_shards(mesh, n_seeds)`` runs ``make_seeds_chunk_fn`` for its
    seeds on its device: a call takes and returns ``SeedShards`` carries
    (``place_seed_batch`` makes the first), launches the shards one after
    another from the host (the seed chunk makes no host sync, so on
    distinct cards their work may overlap; not measured), and joins their
    ``[S_i, k]`` metrics in seed order on the first shard's device; each
    shard device runs ``_round_fns``' round.
    ``make_chunk.shards`` is the placement (None without a mesh)."""
    if mesh is None:
        def make_chunk(k):
            return make_seeds_chunk_fn(fl, round_fn, sample_fn, k, n_seeds)
        make_chunk.shards = None
        return make_chunk
    _check_flat(fl)
    shards = seed_shards(mesh, n_seeds)
    fns = _round_fns(round_fn, shards)

    def make_chunk(k):
        bodies = [make_seeds_chunk_fn(fl, fns[dev], sample_fn, k,
                                      rows.stop - rows.start)
                  for dev, rows in shards]

        def chunk(states, sampler_states, stores, data_keys):
            outs = [body(*args) for body, args in zip(
                bodies, zip(states, sampler_states, stores, data_keys))]
            return (SeedShards(o[0] for o in outs),
                    SeedShards(o[1] for o in outs),
                    _join_metrics([o[2] for o in outs], shards[0][0]))
        return chunk

    make_chunk.shards = shards
    return make_chunk


def place_seed_batch(shards, states, sampler_states, store, data_keys):
    """Move a freshly built seed batch onto the mesh once, before the first
    call: shard ``i`` gets a copy of its rows of the states, sampler
    carries and data keys, and the shared store, on its device
    (``SeedShards`` each).  A copy changes no value.  No-op when
    ``shards`` is None (an executor without a mesh)."""
    if shards is None:
        return states, sampler_states, store, data_keys
    return (SeedShards(_on(states, d, r) for d, r in shards),
            SeedShards(_on(sampler_states, d, r) for d, r in shards),
            SeedShards(_on(store, d) for d, _ in shards),
            SeedShards(_on(data_keys, d, r) for d, r in shards))


def _resolve_chunk_rounds(chunk_rounds, rounds):
    """Validated chunk length, clamped to the run length.  Zero or
    negative values raise: the multi-seed and packed runners are always
    chunked (a CLI resolves its own auto default first)."""
    K = int(chunk_rounds)
    if K <= 0:
        raise ValueError(
            f"chunk_rounds={chunk_rounds} must be >= 1: the multi-seed "
            "runners are always chunked (0 used to silently become 8; "
            "resolve any auto default at the CLI layer instead)")
    return min(K, int(rounds))


def _append_seed_records(histories, metrics, k, done, n_seeds):
    """Append one fetched ``{key: [S][k] floats}`` blob to the per-seed
    histories as per-round dicts ``{"t": done + i, <metric>: float}``:
    the one record maker of the unpacked and packed runners."""
    for j in range(n_seeds):
        for i in range(k):
            rec = {key: float(v[j][i]) for key, v in metrics.items()}
            rec["t"] = done + i
            histories[j].append(rec)


def run_seed_rounds(states, chunk_fn, T, K, *, sampler_states, store,
                    data_keys, n_seeds, make_tail_fn=None, eval_fn=None,
                    eval_every=0, log_every=0, ckpt_fn=None, ckpt_every=0):
    """Drive the seed-batched executor for T rounds in ceil(T/K) calls,
    with one host fetch of the ``[S, K]`` metrics per call.  ``eval_fn``
    (of a single-seed ``FLState``) runs per seed on ``index_seed(states,
    j)`` at the first chunk boundary at or past each ``eval_every``
    multiple; ``ckpt_fn(states, done, sampler_states)`` likewise per
    ``ckpt_every``.  A ``T % K`` tail needs ``make_tail_fn(k)``, demanded
    before the first call.  Seed-mesh carries (``SeedShards``) are joined
    for ``eval_fn``, ``ckpt_fn`` and the result.  Returns ``(states,
    histories)``, one history per seed."""
    if T % K and make_tail_fn is None:
        # fail before the first call rather than after T - T % K rounds
        raise ValueError(
            f"T={T} is not a multiple of chunk_rounds={K}: pass "
            "make_tail_fn(k) to build the S-batched tail executor, or "
            "make T a multiple of K")
    histories = [[] for _ in range(n_seeds)]
    tail_fn, done = None, 0
    while done < T:
        k = min(K, T - done)
        if k == K:
            f = chunk_fn
        else:
            tail_fn = tail_fn or make_tail_fn(k)
            f = tail_fn
        states, sampler_states, metrics = f(states, sampler_states, store,
                                            data_keys)
        # one host sync per call
        _append_seed_records(histories, _metrics_to_host(metrics), k, done,
                             n_seeds)
        done += k
        if eval_fn is not None and _crossed(done, k, eval_every):
            joined = join_seed_shards(states)
            for j in range(n_seeds):
                histories[j][-1].update(eval_fn(index_seed(joined, j)))
        if ckpt_fn is not None and _crossed(done, k, ckpt_every):
            ckpt_fn(join_seed_shards(states), done,
                    join_seed_shards(sampler_states))
        if _crossed(done, k, log_every):
            mean_loss = sum(h[-1].get("loss", float("nan"))
                            for h in histories) / n_seeds
            print(f"[round {done:5d}] seeds={n_seeds} "
                  f"mean_loss={mean_loss:.4f}")
    return join_seed_shards(states), histories


def run_multi_seed(fl: FLConfig, round_fn, template, ds, *, sampling,
                   batch, seeds, rounds, chunk_rounds, rng, data_key,
                   eval_fn=None, eval_every=0, log_every=0, mesh=None,
                   template_fn=None, fault=None, stale=None):
    """The multi-seed runner of ``run_scenario`` and ``train --seeds``:
    the device store (on ``rng``'s device), the stateful sampler, the
    stacked per-seed carry and the seed-batched executor, end to end.
    ``chunk_rounds`` must be >= 1 and is clamped to ``rounds``; a ``T %
    K`` tail executor is built as needed.  ``mesh`` (``launch/mesh.
    make_seed_mesh``) splits the seeds over its devices
    (``build_seed_executor``) and places the carries before the first
    call.  Returns ``(states, histories, finals)``: the seed-stacked
    final ``FLState``, one history per seed and, with ``eval_fn``, one
    final eval per seed."""
    K = _resolve_chunk_rounds(chunk_rounds, rounds)
    store = ds.device_store(rng.device)
    init_fn, sample_fn = make_device_sampler(
        fl.m, fl.s, batch, mode=sampling,
        min_count=min(len(ix) for ix in ds.client_indices),
        emit="cols" if fl.sparse_cohort else "batches")
    states, sampler_states, data_keys = build_seed_batch(
        fl, template, rng, data_key, init_fn, store, seeds,
        template_fn=template_fn, fault=fault, stale=stale)
    make_chunk = build_seed_executor(fl, round_fn, sample_fn, seeds,
                                     mesh=mesh)
    states, sampler_states, store, data_keys = place_seed_batch(
        make_chunk.shards, states, sampler_states, store, data_keys)
    states, histories = run_seed_rounds(
        states, make_chunk(K), rounds, K, sampler_states=sampler_states,
        store=store, data_keys=data_keys, n_seeds=seeds,
        make_tail_fn=make_chunk, eval_fn=eval_fn, eval_every=eval_every,
        log_every=log_every)
    finals = ([eval_fn(index_seed(states, j)) for j in range(seeds)]
              if eval_fn is not None else [])
    return states, histories, finals


def _pad_m_config(sc: Scenario, fl: FLConfig, base_p, pad_m: int, *,
                  has_fault, has_stale):
    """Widen a cell's client axis from ``fl.m`` to ``pad_m`` with padding
    clients of zero availability mass (``base_p = 0``: they never
    activate, and under markov availability never turn on).  Only where
    that is provably inert: uniform sampling, no Assumption-1 floor, no
    fault or staleness carry (sized to the real m), the flat substrate.
    A padded cell equals the unpadded runner's run of the padded config,
    not the original cell (the key splits are m-shaped)."""
    if pad_m == fl.m:
        return fl, base_p
    if pad_m < fl.m:
        raise ValueError(f"pad_m={pad_m} is below the cell's m={fl.m}")
    if sc.sampling != "uniform":
        raise ValueError(
            f"pad_m: cell {sc.name!r} uses {sc.sampling!r} sampling; "
            "only uniform-mode cells can absorb padded clients")
    if sc.delta_floor > 0:
        raise ValueError(
            f"pad_m: cell {sc.name!r} has delta_floor={sc.delta_floor}; "
            "the Assumption-1 clamp would give padded clients non-zero "
            "availability mass")
    if has_fault or has_stale:
        raise ValueError(
            f"pad_m: cell {sc.name!r} carries fault/staleness state "
            "sized to the real client count; padding is not supported")
    if not fl.flat_state:
        raise ValueError(f"pad_m: cell {sc.name!r} needs flat_state")
    base_p = torch.cat([base_p, base_p.new_zeros((pad_m - fl.m,))])
    return dataclasses.replace(fl, m=pad_m), base_p


def _cell_task(sc: Scenario, *, m, s, batch, n_samples, preset, seed,
               use_kernel, rounds=0, pad_m=0, device):
    """One cell's task and round function on ``device``: ``(fl,
    round_fn, params, ds, eval_fn, init_fn, fault_state, stale_state)``.

    ``nu_corr`` swaps base_p for the ν-correlated one, a fault trace is
    drawn from ``PRNGKey(seed + 2)`` and a delay trace from
    ``PRNGKey(seed + 3)``, blackout clusters come from the task's ν, as
    the reference builds them; ``pad_m > m`` widens the client axis
    (``_pad_m_config``) before the round function closes over base_p.
    ``preset`` names the task (``train.TASKS``: "image" or "lm").
    ``round_fn.on(dev)`` builds the same round over ``base_p`` on another
    device (a seed-mesh shard's)."""
    args = argparse.Namespace(seed=seed, n_samples=n_samples, m=m,
                              alpha=sc.alpha, batch=batch)
    rng = prng.PRNGKey(seed, device)
    params, loss_fn, ds, base_p, eval_fn, init_fn = \
        train.TASKS[preset](args, rng, device)
    nu = torch.from_numpy(ds.nu).to(device)
    if sc.nu_corr:
        base_p = faults.adversarial_probs_from_nu(nu)
    fl = FLConfig(m=m, s=s, eta_l=sc.eta_l, eta_g=sc.eta_g,
                  strategy=sc.strategy, flat_state=sc.flat_state,
                  use_kernel=use_kernel)
    fc = sc.fault()
    fault_state = None
    if fc is not None and fc.needs_state:
        trace = None
        if fc.trace:
            if rounds <= 0:
                raise ValueError(f"trace cell {sc.name!r} needs the run "
                                 "length for its trace")
            trace = faults.diurnal_trace(prng.PRNGKey(seed + 2, device),
                                         base_p, rounds)
        clusters = (faults.clusters_from_nu(nu)
                    if fc.blackout_len > 0 else None)
        fault_state = faults.init_fault_state(fc, trace=trace,
                                              clusters=clusters)
    stcfg = sc.staleness()
    stale_state = None
    if stcfg is not None and stcfg.needs_state:
        dtrace = None
        if stcfg.kind == "trace":
            if rounds <= 0:
                raise ValueError(f"trace cell {sc.name!r} needs the run "
                                 "length for its trace")
            dtrace = staleness.staircase_delay_trace(
                prng.PRNGKey(seed + 3, device), m, rounds)
        stale_state = staleness.init_staleness_state(
            stcfg, FlatSpec.from_tree(params).size, m, dtrace=dtrace,
            device=device)
    if pad_m:
        fl, base_p = _pad_m_config(sc, fl, base_p, pad_m,
                                   has_fault=fault_state is not None,
                                   has_stale=stale_state is not None)

    def round_on(dev):
        return make_round_fn(fl, loss_fn, {}, sc.availability(),
                             base_p.to(dev), fault_cfg=fc,
                             staleness_cfg=stcfg)

    rf = round_on(device)
    rf.on = round_on
    return fl, rf, params, ds, eval_fn, init_fn, fault_state, stale_state


def _cell_record(sc: Scenario, *, seeds, rounds, chunk_rounds, finals,
                 histories):
    return dict(
        scenario=sc.name, strategy=sc.strategy, dynamics=sc.kind,
        sampling=sc.sampling, alpha=sc.alpha, seeds=seeds, rounds=rounds,
        chunk_rounds=chunk_rounds, note=sc.note,
        final=analysis.seed_summary(finals),
        curves=analysis.aggregate_seed_histories(histories),
        histories=histories,
    )


def run_scenario(sc: Scenario, *, seeds=4, rounds=24, chunk_rounds=8,
                 m=16, s=3, batch=8, n_samples=4000, preset="image",
                 seed=0, eval_every=0, use_kernel=False, log_every=0,
                 mesh=None, replicate="shared", device="cuda"):
    """Run one grid cell: S seeds of ``rounds`` rounds, K rounds per call
    of the seed-batched executor, on ``device`` (the card unless "cpu";
    raises when the card is missing).  ``mesh`` splits the seeds over its
    devices (``build_seed_executor``); ``replicate='full'``
    re-initializes the model per seed.  Returns the cell record: per-seed
    final evals, their mean±std (``final``), mean±std curves (``curves``)
    and the per-seed ``histories``."""
    K = _resolve_chunk_rounds(chunk_rounds, rounds)   # before the task
    dev = resolve_device(device)
    fl, rf, params, ds, eval_fn, init_fn, fault_state, stale_state = \
        _cell_task(
            sc, m=m, s=s, batch=batch, n_samples=n_samples, preset=preset,
            seed=seed, use_kernel=use_kernel, rounds=rounds, device=dev)
    _, histories, finals = run_multi_seed(
        fl, rf, params, ds, sampling=sc.sampling, batch=batch, seeds=seeds,
        rounds=rounds, chunk_rounds=K, rng=prng.PRNGKey(seed, dev),
        data_key=prng.PRNGKey(seed + 1, dev), eval_fn=eval_fn,
        eval_every=eval_every, log_every=log_every, mesh=mesh,
        template_fn=init_fn if replicate == "full" else None,
        fault=fault_state, stale=stale_state)
    return _cell_record(sc, seeds=seeds, rounds=rounds, chunk_rounds=K,
                        finals=finals, histories=histories)


# ---------------------------------------------------------------------------
# grid packing: shape-compatible cells -> one call per chunk
# ---------------------------------------------------------------------------

def build_cell(sc: Scenario, *, seeds, rounds, chunk_rounds, m, s, batch,
               n_samples, preset, seed, use_kernel=False,
               replicate="shared", pad_m=0, device="cuda"):
    """Everything one packed grid cell needs — task, round and sample
    functions, device store, stacked per-seed carry — without running it:
    the unit ``pack_cells`` groups and ``run_packed_grid`` drives.
    ``pad_m > m`` widens the client axis (``_pad_m_config``; the padded
    store rows own one dummy sample each, padded markov chains start
    off).  ``cap_paddable`` marks cells whose sampler cap
    ``pack_cells(pad=True)`` may pad without changing their draws."""
    K = _resolve_chunk_rounds(chunk_rounds, rounds)   # before the task
    dev = resolve_device(device)
    fl, rf, params, ds, eval_fn, init_fn, fault_state, stale_state = \
        _cell_task(
            sc, m=m, s=s, batch=batch, n_samples=n_samples, preset=preset,
            seed=seed, use_kernel=use_kernel, rounds=rounds, pad_m=pad_m,
            device=dev)
    store = ds.device_store(dev)
    if fl.m > m:
        store = pad_store(store, m=fl.m)
    init_sampler, sample_fn = make_device_sampler(
        fl.m, fl.s, batch, mode=sc.sampling,
        min_count=min(len(ix) for ix in ds.client_indices),
        emit="cols" if fl.sparse_cohort else "batches")
    states, sampler_states, data_keys = build_seed_batch(
        fl, params, prng.PRNGKey(seed, dev), prng.PRNGKey(seed + 1, dev),
        init_sampler, store, seeds,
        template_fn=init_fn if replicate == "full" else None,
        fault=fault_state, stale=stale_state)
    if fl.m > m and sc.kind == "markov":
        # padded clients must START off: base_p = 0 zeroes their turn-on
        # rate, but init_fl_state starts the whole chain on
        markov = states.markov.clone()
        markov[:, m:] = 0.0
        states = states._replace(markov=markov)
    return dict(sc=sc, fl=fl, round_fn=rf, sample_fn=sample_fn,
                store=store, states=states, sampler_states=sampler_states,
                data_keys=data_keys, eval_fn=eval_fn, seeds=seeds,
                rounds=rounds, K=K,
                cap_paddable=(sc.sampling == "uniform"))


def _shape_sig(tree):
    """Hashable signature of a tree of tensors: its structure and each
    tensor leaf's shape and dtype — the packing layer's grouping key."""
    leaves, spec = pytree.tree_flatten(tree)
    return (str(spec),) + tuple(
        (i, tuple(int(d) for d in v.shape), str(v.dtype))
        for i, v in enumerate(leaves) if torch.is_tensor(v))


def pack_cells(cells, *, pad=False):
    """Group built cells by shape signature (model, m, N, strategy
    memory, sampler state, store, and S, K, T), keeping input order; each
    group runs as one call per chunk (``make_grid_chunk_fn``).

    ``pad=True``: cells whose signatures differ only in the store's
    sampler cap (a heterogeneity ablation changes the largest shard and
    nothing else) are padded to their bucket's largest cap
    (``pad_store``; the uniform sampler's draws do not change), and the
    groups are merged to one per (S, K, T).  Cells without
    ``cap_paddable`` are not padded."""
    if pad:
        buckets: dict = {}
        for c in cells:
            if not c.get("cap_paddable"):
                continue
            # bucket key: the full signature with the cap abstracted away
            key = (_shape_sig(c["states"]), _shape_sig(c["sampler_states"]),
                   _shape_sig(dict(c["store"],
                                   idx=c["store"]["idx"][:, :1])),
                   c["seeds"], c["K"], c["rounds"])
            buckets.setdefault(key, []).append(c)
        for bucket in buckets.values():
            cap = max(c["store"]["idx"].shape[1] for c in bucket)
            for c in bucket:
                short = cap - c["store"]["idx"].shape[1]
                if short:
                    c["store"] = pad_store(c["store"], cap=cap)
                    c["padded_cap"] = short
    groups: dict = {}
    for c in cells:
        sig = ((c["seeds"], c["K"], c["rounds"]) if pad else
               (_shape_sig(c["states"]), _shape_sig(c["sampler_states"]),
                _shape_sig(c["store"]), c["seeds"], c["K"], c["rounds"]))
        groups.setdefault(sig, []).append(c)
    return list(groups.values())


def _mesh_grid_chunk(cells, k, shards):
    """The packed call of ``cells`` under the seed mesh: shard ``i`` runs
    ``make_grid_chunk_fn`` over every cell's rows on its device; the
    carries are C-tuples of ``SeedShards``, and each cell's metrics join
    in seed order on the first shard's device."""
    fns = [_round_fns(c["round_fn"], shards) for c in cells]
    bodies = [make_grid_chunk_fn([(f[dev], c["sample_fn"])
                                  for f, c in zip(fns, cells)],
                                 k, rows.stop - rows.start)
              for dev, rows in shards]

    def packed(states_t, sampler_t, stores_t, keys_t):
        outs = [body(*(tuple(c[i] for c in x)
                       for x in (states_t, sampler_t, stores_t, keys_t)))
                for i, body in enumerate(bodies)]
        cs = range(len(cells))
        return (tuple(SeedShards(o[0][c] for o in outs) for c in cs),
                tuple(SeedShards(o[1][c] for o in outs) for c in cs),
                tuple(_join_metrics([o[2][c] for o in outs], shards[0][0])
                      for c in cs))
    return packed


def run_packed_group(cells, *, mesh=None, eval_every=0, log_every=0):
    """Drive one packed group: ceil(T/K) calls, each advancing every
    cell x seed x round of the group.  Per-cell results equal the
    unpacked ``run_seed_rounds`` drive.  ``mesh`` splits every cell's
    seeds as ``build_seed_executor`` does, the carries placed before the
    first call (``place_seed_batch``) and the tail kept on the mesh.
    Returns ``(states_t, histories_t)``: per-cell seed-stacked states and
    per-cell, per-seed histories."""
    if not cells:
        raise ValueError("run_packed_group needs at least one cell")
    seeds, K, T = cells[0]["seeds"], cells[0]["K"], cells[0]["rounds"]
    if any((c["seeds"], c["K"], c["rounds"]) != (seeds, K, T)
           for c in cells):
        raise ValueError("a packed group's cells share (S, K, T); group "
                         "them with pack_cells")
    pairs = [(c["round_fn"], c["sample_fn"]) for c in cells]
    states_t = tuple(c["states"] for c in cells)
    sampler_t = tuple(c["sampler_states"] for c in cells)
    stores_t = tuple(c["store"] for c in cells)
    keys_t = tuple(c["data_keys"] for c in cells)
    if mesh is None:
        def make_packed(k):
            return make_grid_chunk_fn(pairs, k, seeds)
    else:
        for c in cells:
            _check_flat(c["fl"])
        shards = seed_shards(mesh, seeds)
        placed = [place_seed_batch(shards, *carry) for carry in zip(
            states_t, sampler_t, stores_t, keys_t)]
        states_t, sampler_t, stores_t, keys_t = (
            tuple(p[i] for p in placed) for i in range(4))

        def make_packed(k):
            return _mesh_grid_chunk(cells, k, shards)
    packed, tail_fn = make_packed(K), None
    histories = [[[] for _ in range(seeds)] for _ in cells]
    done = 0
    while done < T:
        k = min(K, T - done)
        if k == K:
            f = packed
        else:
            tail_fn = tail_fn or make_packed(k)
            f = tail_fn
        states_t, sampler_t, metrics_t = f(states_t, sampler_t, stores_t,
                                           keys_t)
        for ci, metrics in enumerate(metrics_t):
            _append_seed_records(histories[ci], _metrics_to_host(metrics),
                                 k, done, seeds)
        done += k
        if _crossed(done, k, eval_every):
            for ci, c in enumerate(cells):
                if c["eval_fn"] is None:
                    continue
                joined = join_seed_shards(states_t[ci])
                for j in range(seeds):
                    histories[ci][j][-1].update(
                        c["eval_fn"](index_seed(joined, j)))
        if _crossed(done, k, log_every):
            print(f"[round {done:5d}] packed group: {len(cells)} cells "
                  f"x {seeds} seeds", flush=True)
    return tuple(join_seed_shards(st) for st in states_t), histories


def run_packed_grid(names, *, seeds=4, rounds=24, chunk_rounds=8, m=16,
                    s=3, batch=8, n_samples=4000, preset="image", seed=0,
                    eval_every=0, use_kernel=False, log_every=0,
                    replicate="shared", mesh=None, pad=True, device="cuda"):
    """The packed grid runner behind ``--packed``: build every named cell,
    group them (``pack_cells``), advance each group (over ``mesh``'s seed
    shards with one), and return the per-cell records in input order (as
    ``run_scenario`` shapes them)."""
    cells = [build_cell(get_scenario(n), seeds=seeds, rounds=rounds,
                        chunk_rounds=chunk_rounds, m=m, s=s, batch=batch,
                        n_samples=n_samples, preset=preset, seed=seed,
                        use_kernel=use_kernel, replicate=replicate,
                        device=device)
             for n in names]
    groups = pack_cells(cells, pad=pad)
    padded = sum(1 for c in cells if c.get("padded_cap"))
    print(f"packed {len(cells)} cells into {len(groups)} group(s)"
          + (f" ({padded} cap-padded)" if padded else ""), flush=True)
    recs = {}
    for group in groups:
        states_t, hists = run_packed_group(group, mesh=mesh,
                                           eval_every=eval_every,
                                           log_every=log_every)
        for c, st, hs in zip(group, states_t, hists):
            finals = ([c["eval_fn"](index_seed(st, j))
                       for j in range(seeds)]
                      if c["eval_fn"] is not None else [])
            recs[c["sc"].name] = _cell_record(
                c["sc"], seeds=seeds, rounds=rounds, chunk_rounds=c["K"],
                finals=finals, histories=hs)
    return [recs[n] for n in names]


def _cell_row(rec: dict) -> dict:
    """One results-table row of a cell record (finals as ``mean±std``)."""
    row = {k: rec[k] for k in ("scenario", "strategy", "dynamics",
                               "sampling", "seeds", "rounds")}
    for k, v in rec["final"].items():
        row[k] = f"{v['mean']:.4f}±{v['std']:.4f}"
    loss = rec["curves"]["metrics"].get("loss")
    if loss is not None:
        row["last_loss"] = f"{loss['mean'][-1]:.4f}±{loss['std'][-1]:.4f}"
    return row


def _slug(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", name)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.experiments",
        description="Run named cells of the paper's experiment grid with "
                    "the seed-batched executor (one call advances all "
                    "seeds one chunk).")
    ap.add_argument("--scenario", action="append", default=None,
                    metavar="NAME",
                    help="scenario name or fnmatch pattern (e.g. "
                         "'fedawe/sine', 'fedau/*'); repeatable")
    ap.add_argument("--grid", default=None, choices=sorted(GRIDS),
                    help="named sub-grid preset (expands to its scenarios)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and grids, then exit")
    ap.add_argument("--seeds", type=int, default=4,
                    help="seed replicates per cell, advanced together by "
                         "the seed-batched executor")
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--chunk-rounds", type=int, default=8,
                    help="K rounds per call (clamped to --rounds)")
    ap.add_argument("--m", type=int, default=16, help="clients")
    ap.add_argument("--s", type=int, default=3, help="local steps")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-samples", type=int, default=4000)
    ap.add_argument("--preset", default="image", choices=["image", "lm"],
                    help="task preset: the CNN on synthetic images, or "
                         "the fl-lm-tiny transformer on synthetic tokens")
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed; replicate j uses fold_in(seed, j)")
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--use-kernel", action="store_true",
                    help="the echo-aggregate kernel for FedAWE and "
                         "FedAWE-M: one launch a round for all seeds")
    ap.add_argument("--packed", action="store_true",
                    help="grid packing: group shape-compatible cells and "
                         "advance each group's cells in one call per "
                         "chunk, instead of one run per cell")
    ap.add_argument("--no-pad-buckets", action="store_true",
                    help="with --packed: no cap padding or group merging; "
                         "pack strictly shape-identical cells only")
    ap.add_argument("--compile-cache", default="", metavar="DIR",
                    help="build and load the CUDA kernel libraries in DIR "
                         "('auto' resolves to ~/.cache/repro-torch/<torch+"
                         "cuda+card+nvcc tag>, see launch/compilecache); "
                         "warm re-runs then skip nvcc")
    ap.add_argument("--replicate", default="shared",
                    choices=["shared", "full"],
                    help="seed-replication mode: 'shared' starts every "
                         "replicate from one model init, 'full' "
                         "re-initializes the model per seed from "
                         "fold_in(model_rng, j)")
    ap.add_argument("--seed-mesh", action="store_true",
                    help="build a ('seed','pod','data') mesh "
                         "(launch/mesh.make_seed_mesh, auto-sized from "
                         "--seeds and the visible cards, or the CPU with "
                         "--device cpu) and split each cell's seeds into "
                         "its seed-axis size of shards, each run on its "
                         "own device; composes with --packed")
    ap.add_argument("--out-dir", default="results",
                    help="per-cell JSON + the results table land here")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run; 'cuda' raises when no card is "
                         "visible")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.list:
        for name in sorted(SCENARIOS):
            sc = SCENARIOS[name]
            print(f"{name:40s} {sc.strategy:15s} {sc.kind:17s} "
                  f"{sc.sampling:8s} alpha={sc.alpha:<6g} {sc.note}")
        print()
        for g, names in sorted(GRIDS.items()):
            print(f"grid {g}: {len(names)} cells")
        return []

    patterns = list(args.scenario or [])
    if args.grid:
        patterns.extend(GRIDS[args.grid])
    if not patterns:
        raise SystemExit("nothing to run: pass --scenario and/or --grid "
                         "(or --list)")
    names = match_scenarios(patterns)

    mesh = None
    if args.seed_mesh:
        from repro_torch.launch.mesh import make_seed_mesh
        dev = resolve_device(args.device)
        mesh = make_seed_mesh(args.seeds, devices=(
            None if dev.type == "cuda" else [dev]))
        print(f"seed mesh: {mesh_axis_sizes(mesh)}", flush=True)
    if args.compile_cache:
        from repro_torch.launch import compilecache
        print(f"compilation cache: {compilecache.enable(args.compile_cache)}",
              flush=True)
    common = dict(seeds=args.seeds, rounds=args.rounds,
                  chunk_rounds=args.chunk_rounds, m=args.m, s=args.s,
                  batch=args.batch, n_samples=args.n_samples,
                  preset=args.preset, seed=args.seed,
                  eval_every=args.eval_every, use_kernel=args.use_kernel,
                  log_every=max(1, args.rounds // 4), mesh=mesh,
                  replicate=args.replicate, device=args.device)
    if args.packed:
        recs = run_packed_grid(names, pad=not args.no_pad_buckets, **common)
    else:
        recs = []
        for name in names:
            print(f"=== scenario {name} (seeds={args.seeds}, "
                  f"rounds={args.rounds}) ===", flush=True)
            recs.append(run_scenario(get_scenario(name), **common))

    rows = []
    for name, rec in zip(names, recs):
        rows.append(_cell_row(rec))
        if not args.no_save:
            path = os.path.join(args.out_dir, "experiments",
                                _slug(name) + ".json")
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1, default=str)
            print(f"wrote {path}")
    if not args.no_save:
        table = analysis.write_results_table(
            rows, os.path.join(args.out_dir, "experiments_table.md"))
        print(f"wrote {table}")
    for row in rows:
        print(json.dumps(row))
    return rows


if __name__ == "__main__":
    main()
