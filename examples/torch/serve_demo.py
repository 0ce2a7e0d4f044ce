"""Serving demo on the PyTorch port: continuous-batching inference over the
model substrate.

Spins up the fixed-slot scheduler of repro_torch/launch/serve.py on a
reduced gemma2-family model, submits a burst of prompts, and prints
per-request completions plus throughput.

Run:  PYTHONPATH=src python examples/torch/serve_demo.py \
          [--arch mamba2-130m] [--device cpu]
"""
import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    stats = serve.main(["--arch", args.arch,
                        "--requests", str(args.requests),
                        "--slots", str(args.slots),
                        "--device", args.device])
    print(f"served {args.requests} requests with {args.slots} slots: "
          f"{stats['tok_per_s']:.1f} tok/s")
    return stats


if __name__ == "__main__":
    main()
