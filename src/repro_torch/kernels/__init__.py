"""Hand-written Hopper kernels for the port's hot spots.

echo_aggregate — the paper's own operator: fused adaptive-innovation echo
                 + implicit-gossip masked mean over the flat [m, N] client
                 stack (Triton; replaces the JAX package's Pallas kernel).

Each kernel ships kernel.py (the kernel and its launcher), ops.py (the
checked wrapper the port calls, with its launch count) and ref.py (the
plain torch version, used on CPU tensors and as the oracle on the card)."""
