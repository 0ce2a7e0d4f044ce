"""Phase 3n of ``chip_smoke.py`` alone, on one card:

    python3 tools/chip_probe_mesh.py

Starts the cold ``train --use-kernel --compile-cache`` run beside the
K1-K3 build, then runs the four ``examples/torch`` scripts, the grid's
seed mesh against the unsplit 4-seed chunk, the warm compile-cache run,
and one ``model_flops_share`` line, each with ``chip_smoke.py``'s checks;
prints the seconds since the start after each.  Imports neither jax nor
the JAX package."""
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels.echo_aggregate import kernel, ops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_chunk import ops as sops
    from repro_torch.launch import experiments, mesh

    if not torch.cuda.is_available():
        print("chip_probe_mesh: no CUDA device is visible", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    shutil.rmtree(cs.CACHE_DIR, ignore_errors=True)
    cold = cs.start_cache_run()
    kernel.LIBRARY.build()
    cold = cs.cache_run(cold)
    print("cold read", time.perf_counter() - t0, flush=True)
    counts = cs.Counts(ops, fops, sops)
    cs.examples_path(torch, counts, smi)
    print("examples", time.perf_counter() - t0, flush=True)
    cs.seed_mesh_path(torch, experiments, mesh, prng, counts, smi)
    print("mesh", time.perf_counter() - t0, flush=True)
    cs.compile_cache_path(cold, smi)
    cs.model_flops_share(get_config("mamba2-130m"), 131072, "train", 1750.0,
                         smi, "probe")
    print("done", time.perf_counter() - t0, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
