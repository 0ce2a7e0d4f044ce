"""Hand-written Hopper kernels for the port's hot spots.

echo_aggregate — the paper's own operator: fused adaptive-innovation echo
                 + implicit-gossip masked mean over the flat [m, N] client
                 stack (CUDA C++ for sm_90a in csrc/; replaces the JAX
                 package's Pallas kernels; the earlier Triton kernel stays
                 as a yardstick only).
flash_attention — forward blockwise online-softmax attention for the LM
                 prefill (GQA, causal + sliding window, soft-cap; CUDA C++
                 for sm_90a in csrc/, built by nvcc at first use).
ssd_chunk      — the Mamba2 SSD intra-chunk block (y_diag, chunk states,
                 chunk decay) for the Mamba2 prefill, with the plain
                 inter-chunk scan around it (CUDA C++ for sm_90a in csrc/).

``nvcc.py`` builds a CUDA source into a shared library at its first launch
and loads it through ctypes, for every CUDA kernel.

Each kernel ships kernel.py (the kernel and its launcher), ops.py (the
checked wrapper the port calls, with its launch count) and ref.py (the
plain torch version, used on CPU tensors and as the oracle on the card)."""
