"""The LoRA slice of ``chip_smoke.py`` alone, on one card:

    python3 tools/chip_probe_lora.py

Builds K1-K3 and K4, runs phase 2's K4 checks at gemma3-27b's two
attention shapes (the other K4 cases left out), phase 3m's serving and
training on one full-width gemma3-27b, K1 at the [4, N] LoRA stack,
gemma3-27b's K4 timing and the reduced architectures' card rounds.  The
training runs first at 2 048 tokens a client and step and, if that runs
out of the card's memory, at 1 024 (``chip_smoke.py`` runs 1 024 only);
the out-of-memory line gives what was allocated.  Imports neither jax nor
the JAX package."""
import concurrent.futures
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main():
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(cs.REPO, "src"))
    from repro_torch.configs import get_config
    from repro_torch.core import availability, engine, prng
    from repro_torch.data import federated
    from repro_torch.kernels.echo_aggregate import kernel, ops, ref
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ssd_chunk import ops as sops
    from repro_torch.models import layers, model, reduced

    t00 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(kernel.LIBRARY.build),
                  pool.submit(fkernel.build)]
        smi = cs.nvidia_smi()
        print(smi, flush=True)
        for b in builds:
            b.result()
    cs.emit(dict(phase="built", s=time.perf_counter() - t00))
    counts = cs.Counts(ops, fops, sops)
    for name in ("FLASH_CASES", "HEAD256_CASES", "GEMMA_ATTN",
                 "ZAMBA_ATTN_CHECK", "FLASH_RAGGED_CASES", "MOE_ATTN_CHECK",
                 "ENCDEC_ATTN_CHECK"):
        setattr(cs, name, [])
    cs.emit(dict(phase="probe_check_flash",
                 errs=cs.check_flash(torch, fops, fref)))
    cfg = cs.full_config(get_config, cs.LORA_ARCH, "bfloat16")
    params = cs.lm_weights(torch, model, cfg, seed=60)
    cs.draw_adapters(torch, params["lora"], seed=61)
    cs.lora_serving(torch, model, layers, cfg, params, counts, smi)
    torch.cuda.empty_cache()
    for L in (2048, 1024):
        cs.LORA_L = L
        try:
            n, _ = cs.lora_training(torch, np, model, engine, federated,
                                    availability, prng, cfg, params, counts,
                                    smi)
            break
        except torch.cuda.OutOfMemoryError as e:
            cs.emit(dict(phase="probe_oom", L=L, msg=str(e)[:600],
                         alloc_gb=torch.cuda.memory_allocated() / 1e9,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9))
            torch.cuda.empty_cache()
    else:
        raise RuntimeError("the LoRA round ran out of memory at every length")
    del params
    torch.cuda.empty_cache()
    cs.lm_k1_at_stack(torch, ops, ref, n, smi, m=cs.LORA_M)
    cs.time_flash_gemma3(torch, fops, fref, smi)
    cs.lm_small_paths(torch, np, model, engine, availability, prng,
                      get_config, reduced, counts, smi)
    print(smi, flush=True)
    cs.emit(dict(phase="probe_done", s=time.perf_counter() - t00))
    return 0


if __name__ == "__main__":
    sys.exit(main())
