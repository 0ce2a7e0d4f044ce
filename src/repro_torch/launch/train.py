"""FedAWE training launcher (simulation tier):

    python -m repro_torch.launch.train [--preset lm] --strategy fedawe \
        --dynamics sine [--flat-state] --chunk-rounds 16 --use-kernel \
        --rounds 300 \
        [--midround-drop 0.3 --sanitize --stale-max 4 --stale-kind geom] \
        [--sampling epoch] [--ckpt PATH --ckpt-every N] \
        [--resume PATH --ckpt-every N] [--scenario NAME] \
        [--seeds S [--replicate full]] \
        [--sparse-cohort C_MAX [--resident-dtype bfloat16]] \
        [--compile-cache DIR|auto]

The port of ``python -m repro.launch.train`` on its simulation tier, for
all ten strategies of the reference's registry (FedAWE, FedAWE-M and the
eight baselines), on tree state (the reference's default) or, with
``--flat-state``, on the flat ``[m, N]`` substrate.  ``--preset image``
(the default) trains the Table-6 CNN on synthetic images; ``--preset lm``
trains the reference's ``fl-lm-tiny`` transformer (2 layers, d_model 64,
float32) with full parameters on Markov-chain token streams, split over
the clients by a pseudo-label (``build_lm_task``).  It runs on the card
(``--device cuda``, the default) unless ``--device cpu`` is passed, and
raises when the card is missing.  Flags
keep the reference's names and defaults; flags of paths not ported yet
are not defined, so argparse refuses them.  Checkpoints are written in
the reference's format (``checkpointing/io.py``), so either launcher
resumes the other's ``--resume`` artifact.  ``--scenario`` takes a cell
of ``launch/experiments``' registry (an explicit flag wins over the cell,
the cell over the default); ``--seeds S > 1`` runs S seeds together
through the seed-batched executor (``experiments.run_multi_seed``).
``--sparse-cohort C_MAX`` runs O(cohort) rounds over a resident ``[m,
N]`` stack (core/cohort.py), stored in ``--resident-dtype``.
``--compile-cache`` builds and loads the CUDA kernel libraries in a keyed
directory (``launch/compilecache``), so a warm run skips nvcc.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.checkpointing import (restore_run_state, save_fl_state,
                                       save_run_state)
from repro_torch.core import (REGISTRY, AvailabilityCfg, FaultCfg, FLConfig,
                              FlatSpec, StalenessCfg, clusters_from_nu,
                              diurnal_trace, global_trainables, index_seed,
                              init_fault_state, init_fl_state,
                              init_staleness_state, make_round_fn, prng,
                              run_rounds, staircase_delay_trace)
from repro_torch.core.availability import base_probs_from_data
from repro_torch.data import (SAMPLING_MODES, FederatedDataset,
                              dirichlet_partition, make_device_sampler,
                              make_image_classification, make_lm_tokens)
from repro_torch.device import resolve_device
from repro_torch.models import cnn, model
from repro_torch.models.config import BlockCfg, ModelConfig


def build_image_task(args, rng, device):
    """Synthetic image-classification task.  Returns ``(params, loss_fn,
    ds, base_p, eval_fn, init_fn)``, all tensors on ``device``;
    ``init_fn(key)`` initializes the model from any key (``--replicate
    full`` draws seed j's from ``init_fn(fold_in(model_rng, j))``)."""
    task = make_image_classification(seed=args.seed, n=args.n_samples,
                                     shape=(8, 8, 1))
    nprng = np.random.default_rng(args.seed)
    idx, nu = dirichlet_partition(nprng, task.labels, args.m,
                                  alpha=args.alpha, min_per_client=args.batch)
    ds = FederatedDataset(dict(images=task.images, labels=task.labels), idx,
                          seed=args.seed)
    # per-client label distributions ride along for the fault scenarios
    # (nu-correlated availability, cluster blackouts — core/faults.py)
    ds.nu = nu.astype(np.float32)
    base_p = base_probs_from_data(rng, torch.from_numpy(ds.nu).to(device))
    def init_fn(key):
        return cnn.init_cnn(key, in_shape=(8, 8, 1),
                            n_classes=task.n_classes)

    params = init_fn(prng.PRNGKey(args.seed, device))
    loss_fn = cnn.make_image_loss_fn(cnn.cnn_apply)
    eval_batch = {k: torch.from_numpy(v).to(device)
                  for k, v in ds.eval_batch(1024, seed=1).items()}

    def eval_fn(state):
        acc = cnn.accuracy(cnn.cnn_apply, global_trainables(state),
                           eval_batch)
        return {"eval_acc": float(acc)}

    return params, loss_fn, ds, base_p, eval_fn, init_fn


def build_lm_task(args, rng, device):
    """The reference's synthetic LM task (``train.py:69-109``): 4 096
    Markov-chain sequences of 33 tokens over a vocabulary of 97
    (``make_lm_tokens``), tokens the first 32 and labels the next, split
    Dirichlet-wise over the clients by the pseudo-label ``int(mean
    token) % 10``; the model ``fl-lm-tiny`` (2 attention layers,
    d_model 64, 4 heads over 2 kv heads of 16, d_ff 128, float32, no
    remat) with full parameters, initialized from ``PRNGKey(seed)``
    draw for draw as the reference (``model.init_params_from_key``).
    The loss is ``lm_loss`` with every label counted; ``eval_fn`` the
    global model's loss on 256 sequences.  Returns what
    ``build_image_task`` returns."""
    lm = make_lm_tokens(seed=args.seed, n_seq=4096, seq_len=32, vocab=97)
    cfg = ModelConfig("fl-lm-tiny", 2, 64, 4, 2, 16, 128, lm.vocab,
                      pattern=(BlockCfg("attn"),), dtype="float32",
                      remat=False)
    labels = lm.tokens[:, 1:]
    tokens = lm.tokens[:, :-1]
    nprng = np.random.default_rng(args.seed)
    pseudo = tokens.mean(axis=1).astype(np.int64) % 10
    idx, nu = dirichlet_partition(nprng, pseudo, args.m, alpha=args.alpha,
                                  min_per_client=args.batch)
    ds = FederatedDataset(dict(tokens=tokens, labels=labels), idx,
                          seed=args.seed)
    ds.nu = nu.astype(np.float32)
    base_p = base_probs_from_data(rng, torch.from_numpy(ds.nu).to(device))

    def init_fn(key):
        return model.split_trainable(model.init_params_from_key(key, cfg),
                                     cfg)[0]

    params = init_fn(prng.PRNGKey(args.seed, device))
    loss_fn = model.lm_loss_fn(cfg)
    eval_batch = {k: torch.from_numpy(v).to(device)
                  for k, v in ds.eval_batch(256, seed=1).items()}
    eval_batch["mask"] = torch.ones_like(eval_batch["labels"],
                                         dtype=torch.float32)

    def eval_fn(state):
        return {"eval_loss": float(model.lm_loss(global_trainables(state),
                                                 cfg, eval_batch))}

    return params, loss_fn, ds, base_p, eval_fn, init_fn


#: the builder of each --preset's task
TASKS = {"image": build_image_task, "lm": build_lm_task}


#: the flags a --scenario cell supplies: explicit flag (even at its
#: default value) > scenario cell > this default.  Their argparse defaults
#: are None, so "passed the default" and "not passed" differ.
_SCENARIO_FLAG_DEFAULTS = dict(strategy="fedawe", dynamics="stationary",
                               sampling="uniform", gamma=0.3, alpha=0.1,
                               eta_l=0.05, eta_g=1.0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--preset", default="image", choices=sorted(TASKS),
                    help="task: 'image' (the Table-6 CNN on synthetic "
                         "images) or 'lm' (the fl-lm-tiny transformer on "
                         "synthetic token streams)")
    ap.add_argument("--strategy", default=None,
                    help="aggregation strategy (default: fedawe): "
                         + ", ".join(REGISTRY))
    ap.add_argument("--dynamics", default=None,
                    choices=["stationary", "staircase", "sine",
                             "interleaved_sine", "markov"],
                    help="availability process (default: stationary)")
    ap.add_argument("--gamma", type=float, default=None,
                    help="sine-family amplitude (default: 0.3)")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--s", type=int, default=5)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eta-l", type=float, default=None,
                    help="local lr (default: 0.05)")
    ap.add_argument("--eta-g", type=float, default=None,
                    help="global lr (default: 1.0)")
    ap.add_argument("--alpha", type=float, default=None,
                    help="Dirichlet heterogeneity (default: 0.1)")
    ap.add_argument("--n-samples", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--use-kernel", action="store_true",
                    help="fused echo-aggregate kernel for FedAWE and "
                         "FedAWE-M (CUDA C++ on the card; one launch a "
                         "round, over the raveled leaves on tree state)")
    ap.add_argument("--flat-state", action="store_true",
                    help="flat [m, N] client-state substrate (default: "
                         "tree state, one tensor per model leaf; staleness "
                         "and --sparse-cohort imply it)")
    ap.add_argument("--chunk-rounds", type=int, default=0,
                    help="K>0: chunked executor — K rounds per call, "
                         "device-resident batch sampling, one metrics "
                         "fetch per chunk, eval at chunk boundaries "
                         "(0 = host loop single-seed, K=8 with --seeds "
                         "> 1)")
    ap.add_argument("--compile-cache", default="", metavar="DIR",
                    help="build and load the CUDA kernel libraries in DIR "
                         "('auto' resolves to ~/.cache/repro-torch/<torch+"
                         "cuda+card+nvcc tag>, see launch/compilecache); "
                         "warm re-runs skip nvcc")
    ap.add_argument("--sparse-cohort", type=int, default=0,
                    metavar="C_MAX",
                    help="O(cohort) rounds (core/cohort.py): gather the "
                         "round's active clients — capped at C_MAX, "
                         "overflow defers deterministically to later "
                         "rounds — into a [C_MAX, N] f32 working set, run "
                         "local updates and aggregation there, scatter "
                         "the touched rows back; the resident [m, N] "
                         "stack is never touched O(m*N) per round "
                         "(0 = dense rounds, the default; implies "
                         "--flat-state)")
    ap.add_argument("--resident-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="storage dtype of the resident [m, N] client "
                         "stack under --sparse-cohort: bfloat16 halves "
                         "residency; the cohort gather promotes rows to "
                         "f32, the scatter-back demote confines "
                         "non-finite rows (int8 is reserved — see "
                         "core/flatten.py)")
    ap.add_argument("--sampling", default=None,
                    choices=list(SAMPLING_MODES),
                    help="device-sampler mode (default: uniform): uniform "
                         "draws with replacement, or epoch permutations "
                         "(every sample once an epoch)")
    ap.add_argument("--seeds", type=int, default=1,
                    help="S>1: run S seeds together through the "
                         "seed-batched executor (seed j's keys are "
                         "fold_in(seed_key, j)); reports mean±std over "
                         "seeds")
    ap.add_argument("--replicate", default="shared",
                    choices=["shared", "full"],
                    help="with --seeds S>1: 'shared' starts every seed "
                         "from one model init, 'full' re-initializes the "
                         "model per seed from fold_in(model_rng, j)")
    ap.add_argument("--scenario", default=None,
                    help="named experiment-grid cell (launch/experiments "
                         "--list): supplies --strategy/--dynamics/"
                         "--sampling/--gamma/--alpha/--eta-l/--eta-g, the "
                         "availability, fault and staleness knobs; a flag "
                         "passed explicitly still wins, even at its "
                         "default value")
    ap.add_argument("--midround-drop", type=float, default=0.0,
                    help="P(a computed update fails to upload) per client "
                         "per round — mid-round dropout fault injection "
                         "(core/faults.py); only delivered updates "
                         "aggregate")
    ap.add_argument("--sanitize", action="store_true",
                    help="demote clients with non-finite local updates to "
                         "dropped for the round instead of poisoning the "
                         "aggregate (adds n_dropped/n_rejected metrics)")
    ap.add_argument("--norm-cap", type=float, default=0.0,
                    help="with --sanitize: also reject updates with "
                         "||G_i|| above this cap (0 = non-finite only)")
    ap.add_argument("--stale-max", type=int, default=None,
                    help="semi-async rounds (core/staleness.py): bound "
                         "straggler upload delay by tau_max rounds; a "
                         "delayed update parks in the pending ring buffer "
                         "and aggregates on arrival (0 = synchronous, the "
                         "default; implies --flat-state)")
    ap.add_argument("--stale-kind", default=None,
                    choices=["det", "geom", "trace"],
                    help="delay dynamics (default: det): det = every "
                         "straggler takes --stale-delay rounds, geom = "
                         "geometric arrival with --stale-p, trace = "
                         "replayed staircase per-client delay schedule")
    ap.add_argument("--stale-delay", type=int, default=None,
                    help="det delay in rounds (default: 1)")
    ap.add_argument("--stale-p", type=float, default=None,
                    help="geom per-round arrival probability (default: 0.5)")
    ap.add_argument("--stale-gamma", type=float, default=None,
                    help="staleness delivery discount base: an update "
                         "arriving d rounds late aggregates with weight "
                         "gamma**d (default: 1.0 = undiscounted)")
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--out", default=None)
    ap.add_argument("--ckpt", default=None,
                    help="write the final FLState to PATH.npz + PATH.json")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="overwrite --ckpt every N rounds (chunk-aligned; "
                         "multi-seed runs write seed 0 at the end); with "
                         "--resume, overwrite the resumable artifact")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="resumable run artifact prefix (PATH.npz + "
                         "PATH.json holding the FLState and the carried "
                         "sampler state): every --ckpt-every rounds the "
                         "run overwrites it, and when it exists the run "
                         "restores it and continues to --rounds; forces "
                         "the device sampler")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run; 'cuda' raises when no card is "
                         "visible")
    return ap


def resolve_flags(args):
    """Fill the scenario-overridable flags left at None: from the
    ``--scenario`` cell where one is named, else from the defaults; an
    explicit flag wins.  Returns the ``Scenario`` or None; calling it
    again changes nothing."""
    scenario = None
    if args.scenario:
        from repro_torch.launch.experiments import get_scenario
        scenario = get_scenario(args.scenario)
        args.flat_state = args.flat_state or scenario.flat_state
    for attr, fallback in _SCENARIO_FLAG_DEFAULTS.items():
        if getattr(args, attr) is None:
            if scenario is not None:
                sc_attr = "kind" if attr == "dynamics" else attr
                setattr(args, attr, getattr(scenario, sc_attr))
            else:
                setattr(args, attr, fallback)
    return scenario


def fault_configs(args, scenario=None):
    """``(fault_cfg, stale_cfg)``: the scenario cell's (or none) with the
    explicit fault and stale flags composed on top, as the reference
    launcher composes them (train.py:262-330): the fault flags build or
    amend a ``FaultCfg``, any stale flag a ``StalenessCfg``;
    ``tau_max = 0`` means none."""
    fault_cfg = scenario.fault() if scenario is not None else None
    if args.midround_drop or args.sanitize or args.norm_cap:
        fc0 = fault_cfg or FaultCfg()
        fault_cfg = dataclasses.replace(
            fc0,
            upload_survival=(1.0 - args.midround_drop if args.midround_drop
                             else fc0.upload_survival),
            sanitize=fc0.sanitize or args.sanitize or args.norm_cap > 0,
            norm_cap=args.norm_cap or fc0.norm_cap)
    stale_cfg = scenario.staleness() if scenario is not None else None
    flags = dict(tau_max=args.stale_max, kind=args.stale_kind,
                 delay=args.stale_delay, p_next=args.stale_p,
                 gamma=args.stale_gamma)
    if any(v is not None for v in flags.values()):
        stale_cfg = dataclasses.replace(
            stale_cfg or StalenessCfg(),
            **{k: v for k, v in flags.items() if v is not None})
    if stale_cfg is not None and stale_cfg.tau_max == 0:
        stale_cfg = None
    return fault_cfg, stale_cfg


def setup(args, device):
    """Everything a run needs, built on ``device`` as the reference
    launcher builds it (train.py:302-357): the same ``PRNGKey(seed)``
    feeds ``base_probs_from_data`` and ``init_fl_state``,
    ``PRNGKey(seed + 1)`` is the data key, ``PRNGKey(seed + 2)`` draws a
    fault cell's replayed trace and ``PRNGKey(seed + 3)`` the delay trace
    of ``--stale-kind trace``.  Returns a dict with ``state``,
    ``round_fn``, ``ds``, ``eval_fn``, ``data_key`` and, for the
    multi-seed run, ``fl``, ``params``, ``init_fn``, ``rng`` and the
    ``fault`` and ``stale`` carries."""
    scenario = resolve_flags(args)
    rng = prng.PRNGKey(args.seed, device)
    params, loss_fn, ds, base_p, eval_fn, init_fn = TASKS[args.preset](
        args, rng, device)
    fl = FLConfig(m=args.m, s=args.s, eta_l=args.eta_l, eta_g=args.eta_g,
                  strategy=args.strategy, use_kernel=args.use_kernel,
                  flat_state=args.flat_state,
                  sparse_cohort=args.sparse_cohort,
                  resident_dtype=args.resident_dtype)
    if scenario is not None:
        # the cell's availability knobs, with any explicit flag on top
        av = dataclasses.replace(scenario.availability(),
                                 kind=args.dynamics, gamma=args.gamma)
    else:
        av = AvailabilityCfg(kind=args.dynamics, gamma=args.gamma)
    fault_cfg, stale_cfg = fault_configs(args, scenario)
    fault_state = None
    if fault_cfg is not None and fault_cfg.needs_state:
        trace = (diurnal_trace(prng.PRNGKey(args.seed + 2, device), base_p,
                               args.rounds) if fault_cfg.trace else None)
        clusters = (clusters_from_nu(torch.from_numpy(ds.nu).to(device))
                    if fault_cfg.blackout_len > 0 else None)
        fault_state = init_fault_state(fault_cfg, trace=trace,
                                       clusters=clusters)
    stale_state = None
    if stale_cfg is not None:
        dtrace = None
        if stale_cfg.kind == "trace":
            dtrace = staircase_delay_trace(
                prng.PRNGKey(args.seed + 3, device), args.m, args.rounds)
        stale_state = init_staleness_state(
            stale_cfg, FlatSpec.from_tree(params).size, args.m,
            dtrace=dtrace, device=device)
    return dict(state=init_fl_state(rng, fl, params, fault=fault_state,
                                    stale=stale_state),
                round_fn=make_round_fn(fl, loss_fn, {}, av, base_p,
                                       fault_cfg=fault_cfg,
                                       staleness_cfg=stale_cfg),
                ds=ds, eval_fn=eval_fn,
                data_key=prng.PRNGKey(args.seed + 1, device), fl=fl,
                params=params, init_fn=init_fn, rng=rng, fault=fault_state,
                stale=stale_state)


def run(args):
    """Train as the parsed ``args`` say; returns ``(state, history,
    final)``, or with ``--seeds S > 1`` ``(states, histories, final)``:
    the seed-stacked state, one history per seed and the mean±std over
    seeds of the final eval.  The body of ``main``, checkpoints included,
    without its printing and ``--out``."""
    scenario = resolve_flags(args)
    # the pending-update ring and the cohort's gather and scatter both
    # ride the flat [m, N] substrate
    args.flat_state = (args.flat_state
                       or fault_configs(args, scenario)[1] is not None
                       or args.sparse_cohort > 0)
    device = resolve_device(args.device)
    parts = setup(args, device)
    if args.seeds > 1:
        return _run_multi_seed(args, parts)
    state, round_fn, ds = parts["state"], parts["round_fn"], parts["ds"]
    eval_fn = parts["eval_fn"]
    ckpt_fn = None
    if args.ckpt and args.ckpt_every:
        def ckpt_fn(st, t):
            save_fl_state(args.ckpt, st, round_t=t)

    if args.chunk_rounds or args.sampling == "epoch" or args.resume \
            or args.sparse_cohort:
        # the device sampler: always for the chunked executor, and for the
        # host loop under epoch sampling or --resume, whose carry lives on
        # the device (and in the resumable artifact), and under the
        # cohort, whose round gathers its batches from the column draws
        store = ds.device_store(device)
        init_sampler_fn, sample_fn = make_device_sampler(
            args.m, args.s, args.batch, mode=args.sampling,
            min_count=min(len(ix) for ix in ds.client_indices),
            emit="cols" if args.sparse_cohort else "batches")
        data_key = parts["data_key"]
        sampler_state = init_sampler_fn(store, data_key)
        rounds_left = args.rounds
        if args.resume:
            # the artifact is a prefix: probe its manifest
            if os.path.exists(args.resume + ".json"):
                state, sampler_state = restore_run_state(
                    args.resume, state, sampler_state)
                done = int(state.t)
                rounds_left = max(args.rounds - done, 0)
                print(f"resumed {args.resume} at round {done}; "
                      f"{rounds_left} to go")
            if args.ckpt_every:
                # 3 arguments: the executor hands over the carried sampler
                # state, which makes the artifact resumable
                def ckpt_fn(st, t, ss):
                    save_run_state(args.resume, st, ss, round_t=t)
        state, hist = run_rounds(
            state, round_fn, None, rounds_left,
            chunk_rounds=args.chunk_rounds, sample_fn=sample_fn,
            store=store, data_key=data_key, sampler_state=sampler_state,
            log_every=max(1, rounds_left // 10),
            eval_fn=eval_fn, eval_every=args.eval_every,
            ckpt_fn=ckpt_fn, ckpt_every=args.ckpt_every)
    else:
        def batch_fn(t):
            return {k: torch.from_numpy(v).to(device)
                    for k, v in ds.round_batches(t, args.s,
                                                 args.batch).items()}

        state, hist = run_rounds(state, round_fn, batch_fn, args.rounds,
                                 log_every=max(1, args.rounds // 10),
                                 eval_fn=eval_fn, eval_every=args.eval_every,
                                 ckpt_fn=ckpt_fn, ckpt_every=args.ckpt_every)
    final = eval_fn(state)
    if args.ckpt:
        save_fl_state(args.ckpt, state)
    return state, hist, final


def _run_multi_seed(args, parts):
    """``--seeds S > 1``: the seed-batched executor, always chunked
    (``--chunk-rounds``, or K = 8).  Seed j uses ``fold_in(rng, j)`` /
    ``fold_in(data_key, j)``; ``--replicate full`` also re-initializes
    the model per seed.  ``--ckpt`` saves seed 0's final state."""
    from repro_torch.launch import analysis
    from repro_torch.launch.experiments import run_multi_seed

    states, hists, finals = run_multi_seed(
        parts["fl"], parts["round_fn"], parts["params"], parts["ds"],
        sampling=args.sampling, batch=args.batch, seeds=args.seeds,
        rounds=args.rounds,
        # 0 is the CLI's auto value; the driver itself rejects K <= 0
        chunk_rounds=args.chunk_rounds or 8, rng=parts["rng"],
        data_key=parts["data_key"], eval_fn=parts["eval_fn"],
        eval_every=args.eval_every, log_every=max(1, args.rounds // 10),
        template_fn=(parts["init_fn"] if args.replicate == "full"
                     else None),
        fault=parts["fault"], stale=parts["stale"])
    if args.ckpt:
        save_fl_state(args.ckpt, index_seed(states, 0))
    return states, hists, analysis.seed_summary(finals)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.compile_cache:
        from repro_torch.launch import compilecache
        print(f"compilation cache: {compilecache.enable(args.compile_cache)}",
              flush=True)
    _, hist, final = run(args)
    if args.seeds > 1:
        from repro_torch.launch import analysis
        print("final (mean±std over seeds):", final)
        record = dict(args=vars(args), final=final,
                      curves=analysis.aggregate_seed_histories(hist),
                      history_per_seed=hist)
    else:
        print("final:", final)
        record = dict(args=vars(args), final=final, history=hist)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f)
    return final


if __name__ == "__main__":
    main()
