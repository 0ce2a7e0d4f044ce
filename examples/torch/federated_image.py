"""End-to-end run on the PyTorch port: federated image classification
under non-stationary client unavailability (the paper's Table-2 setting at
a small scale).

100 clients, Dirichlet(0.1) label skew, data-correlated base availability
probabilities, sine non-stationarity; compares FedAWE against FedAvg over
active clients for a few hundred rounds and writes metrics + a checkpoint
under --out-dir.

Run:  PYTHONPATH=src python examples/torch/federated_image.py \
          [--rounds 300] [--device cpu]
"""
import argparse
import os
import sys

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--dynamics", default="sine")
    ap.add_argument("--out-dir", default="results")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    results = {}
    for strategy in ("fedawe", "fedavg_active"):
        print(f"\n=== {strategy} / {args.dynamics} / m={args.m} ===")
        out = os.path.join(args.out_dir, f"example_image_{strategy}")
        final = train.main([
            "--preset", "image", "--strategy", strategy,
            "--dynamics", args.dynamics, "--rounds", str(args.rounds),
            "--m", str(args.m), "--s", "5", "--batch", "32",
            "--out", out + ".json", "--ckpt", out + "_ckpt",
            "--device", args.device,
        ])
        results[strategy] = final["eval_acc"]

    print("\n==== summary ====")
    for k, v in results.items():
        print(f"{k:16s} test acc = {100*v:.2f}%")
    if results["fedawe"] >= results["fedavg_active"]:
        print("FedAWE >= FedAvg under non-stationary unavailability ✓")
    else:
        print("note: FedAvg won this seed — increase --rounds; the gap "
              "emerges as availability bias accumulates", file=sys.stderr)
    return results


if __name__ == "__main__":
    main()
