"""FedAWE training launcher (simulation tier, image preset):

    python -m repro_torch.launch.train --strategy fedawe --dynamics sine \
        --flat-state --chunk-rounds 16 --use-kernel --rounds 300

The port of ``python -m repro.launch.train --preset image``.  It runs on
the card (``--device cuda``, the default) unless ``--device cpu`` is
passed, and raises when the card is missing.  Flags keep the reference's
names and defaults; flags of paths not ported yet are not defined, so
argparse refuses them.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from repro_torch.core import (AvailabilityCfg, FLConfig, global_trainables,
                              init_fl_state, make_round_fn, prng,
                              run_rounds)
from repro_torch.core.availability import base_probs_from_data
from repro_torch.data import (SAMPLING_MODES, FederatedDataset,
                              dirichlet_partition, make_device_sampler,
                              make_image_classification)
from repro_torch.device import resolve_device
from repro_torch.models import cnn


def build_image_task(args, rng, device):
    """Synthetic image-classification task.  Returns ``(params, loss_fn,
    ds, base_p, eval_fn)``, all tensors on ``device``."""
    task = make_image_classification(seed=args.seed, n=args.n_samples,
                                     shape=(8, 8, 1))
    nprng = np.random.default_rng(args.seed)
    idx, nu = dirichlet_partition(nprng, task.labels, args.m,
                                  alpha=args.alpha, min_per_client=args.batch)
    ds = FederatedDataset(dict(images=task.images, labels=task.labels), idx,
                          seed=args.seed)
    base_p = base_probs_from_data(
        rng, torch.from_numpy(nu.astype(np.float32)).to(device))
    params = cnn.init_cnn(prng.PRNGKey(args.seed, device),
                          in_shape=(8, 8, 1), n_classes=task.n_classes)
    loss_fn = cnn.make_image_loss_fn(cnn.cnn_apply)
    eval_batch = {k: torch.from_numpy(v).to(device)
                  for k, v in ds.eval_batch(1024, seed=1).items()}

    def eval_fn(state):
        acc = cnn.accuracy(cnn.cnn_apply, global_trainables(state),
                           eval_batch)
        return {"eval_acc": float(acc)}

    return params, loss_fn, ds, base_p, eval_fn


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--strategy", default="fedawe",
                    help="aggregation strategy (ported: fedawe)")
    ap.add_argument("--dynamics", default="stationary",
                    choices=["stationary", "staircase", "sine",
                             "interleaved_sine", "markov"],
                    help="availability process")
    ap.add_argument("--gamma", type=float, default=0.3,
                    help="sine-family amplitude")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--s", type=int, default=5)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eta-l", type=float, default=0.05, help="local lr")
    ap.add_argument("--eta-g", type=float, default=1.0, help="global lr")
    ap.add_argument("--alpha", type=float, default=0.1,
                    help="Dirichlet heterogeneity")
    ap.add_argument("--n-samples", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--use-kernel", action="store_true",
                    help="fused echo-aggregate kernel (Triton on the card)")
    ap.add_argument("--flat-state", action="store_true",
                    help="flat [m, N] client-state substrate (required: "
                         "the tree-state path is not ported)")
    ap.add_argument("--chunk-rounds", type=int, default=0,
                    help="K>0: chunked executor — K rounds per call, "
                         "device-resident batch sampling, one metrics "
                         "fetch per chunk, eval at chunk boundaries "
                         "(0 = host loop)")
    ap.add_argument("--sampling", default="uniform",
                    choices=list(SAMPLING_MODES),
                    help="device-sampler mode (ported: uniform)")
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run; 'cuda' raises when no card is "
                         "visible")
    return ap


def setup(args, device):
    """Everything a run needs, built on ``device`` as the reference
    launcher builds it (train.py:302-357): the same ``PRNGKey(seed)``
    feeds ``base_probs_from_data`` and ``init_fl_state``, and
    ``PRNGKey(seed + 1)`` is the data key.  Returns a dict with ``state``,
    ``round_fn``, ``ds``, ``eval_fn`` and ``data_key``."""
    rng = prng.PRNGKey(args.seed, device)
    params, loss_fn, ds, base_p, eval_fn = build_image_task(args, rng,
                                                            device)
    fl = FLConfig(m=args.m, s=args.s, eta_l=args.eta_l, eta_g=args.eta_g,
                  strategy=args.strategy, use_kernel=args.use_kernel,
                  flat_state=args.flat_state)
    av = AvailabilityCfg(kind=args.dynamics, gamma=args.gamma)
    return dict(state=init_fl_state(rng, fl, params),
                round_fn=make_round_fn(fl, loss_fn, {}, av, base_p),
                ds=ds, eval_fn=eval_fn,
                data_key=prng.PRNGKey(args.seed + 1, device))


def run(args):
    """Train as the parsed ``args`` say; returns ``(state, history,
    final)``.  The body of ``main``, without its printing and output."""
    if not args.flat_state:
        raise NotImplementedError(
            "tree-state path not ported: pass --flat-state")
    device = resolve_device(args.device)
    parts = setup(args, device)
    state, round_fn, ds = parts["state"], parts["round_fn"], parts["ds"]
    eval_fn = parts["eval_fn"]
    if args.chunk_rounds or args.sampling == "epoch":
        store = ds.device_store(device)
        init_sampler_fn, sample_fn = make_device_sampler(
            args.m, args.s, args.batch, mode=args.sampling)
        data_key = parts["data_key"]
        state, hist = run_rounds(
            state, round_fn, None, args.rounds,
            chunk_rounds=args.chunk_rounds, sample_fn=sample_fn,
            store=store, data_key=data_key,
            sampler_state=init_sampler_fn(store, data_key),
            log_every=max(1, args.rounds // 10),
            eval_fn=eval_fn, eval_every=args.eval_every)
    else:
        def batch_fn(t):
            return {k: torch.from_numpy(v).to(device)
                    for k, v in ds.round_batches(t, args.s,
                                                 args.batch).items()}

        state, hist = run_rounds(state, round_fn, batch_fn, args.rounds,
                                 log_every=max(1, args.rounds // 10),
                                 eval_fn=eval_fn, eval_every=args.eval_every)
    return state, hist, eval_fn(state)


def main(argv=None):
    args = build_parser().parse_args(argv)
    _, hist, final = run(args)
    print("final:", final)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(args=vars(args), final=final, history=hist), f)
    return final


if __name__ == "__main__":
    main()
