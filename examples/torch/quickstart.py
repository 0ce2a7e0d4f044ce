"""Quickstart on the PyTorch port: the paper's Example 1 in 60 lines.

Two clients hold quadratic objectives with minimizers u1=0, u2=100; the
global optimum is x* = 50. Client 1 is available 90% of rounds, client 2
only 30%. Plain FedAvg converges to the availability-weighted point
(p1*u1 + p2*u2)/(p1+p2) = 25; FedAWE's adaptive innovation echoing +
implicit gossiping removes the bias.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (AvailabilityCfg, FLConfig, init_fl_state,
                              make_round_fn, prng)
from repro_torch.device import resolve_device

U = (0.0, 100.0)       # per-client minimizers
BASE_P = (0.9, 0.3)    # heterogeneous availability
T = 2000


def loss_fn(trainable, frozen, batch, rng):
    return 0.5 * (trainable["x"] - batch["u"]) ** 2


def run(strategy, T=T, device="cuda"):
    """The long-run output of ``strategy``: the mean global model over
    the rounds after T // 2."""
    dev = resolve_device(device)
    cfg = FLConfig(m=2, s=2, eta_l=0.05, eta_g=1.0, strategy=strategy,
                   lr_schedule=False, grad_clip=0.0)
    state = init_fl_state(prng.PRNGKey(0, dev), cfg,
                          {"x": torch.zeros((), device=dev)})
    round_fn = make_round_fn(cfg, loss_fn, {},
                             AvailabilityCfg(kind="stationary"),
                             torch.tensor(BASE_P, device=dev))
    u = torch.tensor(U, device=dev)
    batches = {"u": u[:, None].expand(2, cfg.s)}
    tail = []
    for t in range(T):
        state, _ = round_fn(state, batches)
        if t > T // 2:
            tail.append(state.global_tr["x"])
    return float(np.mean(torch.stack(tail).cpu().numpy().astype(np.float64)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=T)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    x_avg = run("fedavg_active", args.rounds, args.device)
    x_awe = run("fedawe", args.rounds, args.device)
    print("optimum x*                      = 50.0")
    print("availability-weighted bias point = 25.0")
    print(f"FedAvg  long-run output          = {x_avg:6.2f}  "
          f"(bias {abs(x_avg-50):.1f})")
    print(f"FedAWE  long-run output          = {x_awe:6.2f}  "
          f"(bias {abs(x_awe-50):.1f})")
    if not abs(x_awe - 50) < abs(x_avg - 50):
        raise AssertionError("FedAWE must reduce the bias")
    print("FedAWE corrects the unavailability bias ✓")
    return x_avg, x_awe


if __name__ == "__main__":
    main()
