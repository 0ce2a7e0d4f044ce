"""Federated language-model training with FedAWE on the PyTorch port's
transformer (the same model code that serves the registry's configs).

--scale tiny  (default): 2-layer d=64 transformer, CPU-friendly demo.
--scale 100m           : GPT-style ~100M decoder (12L, d=768, 12H); run it
                         on the card.

Run:  PYTHONPATH=src python examples/torch/federated_lm.py --rounds 100 \
          [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (AvailabilityCfg, FLConfig, init_fl_state,
                              make_round_fn, prng, run_rounds)
from repro_torch.core.availability import base_probs_from_data
from repro_torch.data import (FederatedDataset, dirichlet_partition,
                              make_lm_tokens)
from repro_torch.device import resolve_device
from repro_torch.models import model
from repro_torch.models.config import BlockCfg, ModelConfig

SCALES = {
    "tiny": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                 head_dim=16, d_ff=128),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
                 head_dim=64, d_ff=3072),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="tiny", choices=list(SCALES))
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--s", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--dynamics", default="sine")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    dims = SCALES[args.scale]
    cfg = ModelConfig("fl-lm", vocab=1024, pattern=(BlockCfg("attn"),),
                      dtype="float32", remat=False, **dims)
    print(f"model: {cfg.name} ({model.count_params(cfg)/1e6:.1f}M params)")

    lm = make_lm_tokens(seed=0, n_seq=4096, seq_len=args.seq, vocab=cfg.vocab)
    tokens, labels = lm.tokens[:, :-1], lm.tokens[:, 1:]
    pseudo = tokens.mean(axis=1).astype(np.int64) % 10
    idx, nu = dirichlet_partition(np.random.default_rng(0), pseudo, args.m,
                                  alpha=0.1, min_per_client=args.batch)
    ds = FederatedDataset(dict(tokens=tokens, labels=labels), idx)
    nu = torch.from_numpy(nu.astype(np.float32)).to(dev)
    base_p = base_probs_from_data(prng.PRNGKey(1, dev), nu)

    # the reference's init, draw for draw; the engine trains the tree
    # split_trainable gives (empty subtrees dropped)
    params = model.split_trainable(
        model.init_params_from_key(prng.PRNGKey(0, dev), cfg), cfg)[0]

    fl = FLConfig(m=args.m, s=args.s, eta_l=0.1, strategy="fedawe")
    av = AvailabilityCfg(kind=args.dynamics, gamma=0.3)
    state = init_fl_state(prng.PRNGKey(0, dev), fl, params)
    # lm_loss over every label (a batch without "mask" counts them all)
    rf = make_round_fn(fl, model.lm_loss_fn(cfg), {}, av, base_p)

    def batch_fn(t):
        return {k: torch.from_numpy(v).to(dev) for k, v in
                ds.round_batches(t, args.s, args.batch).items()}

    state, hist = run_rounds(state, rf, batch_fn, args.rounds,
                             log_every=max(1, args.rounds // 10))
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} over {args.rounds} rounds")
    if not last < first:
        raise AssertionError("federated LM training must reduce the loss")
    print("federated LM training OK ✓")
    return hist


if __name__ == "__main__":
    main()
