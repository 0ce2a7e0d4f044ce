"""K1 / K2's partial form and phases 3o and 3p of ``chip_smoke.py`` alone,
on one card:

    python3 tools/chip_probe_placed.py

Builds K1-K3 and K4 (two nvcc processes together), prints ptxas's report
of every K1-K3 instantiation (the partial ones and the finalize
included), holds the partial form and its finalize against the fused K1
and their plain versions (``check_partial``), runs the placed FL path
(``placed_fl_path``: four gloo ranks spawned on card 0), times the
partial form and the finalize (``time_partial``), then phase 3p: the dry
run's counters on gemma2-2b's prefill, real and fake
(``lowering_prefill``), and the placed round's counted collectives
(``lowering_placed_round``), each with ``chip_smoke.py``'s checks;
prints the seconds since the start after each.  Imports neither jax nor
the JAX package."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main():
    import torch

    import concurrent.futures

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels.echo_aggregate import kernel, ops, ref
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_chunk import ops as sops
    from repro_torch.launch import analysis, experiments
    from repro_torch.models import model

    if not torch.cuda.is_available():
        print("chip_probe_placed: no CUDA device is visible", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    k4 = pool.submit(fkernel.build)
    lib = kernel.LIBRARY.build()
    cs.emit(dict(phase="kernel_build", kernel="K1-K3",
                 ptxas=cs.ptxas_report(lib.with_suffix(".log").read_text()),
                 s=time.perf_counter() - t0))
    errs = cs.check_partial(torch, ops, ref)
    cs.emit(dict(phase="partial_errs", **errs, s=time.perf_counter() - t0))
    counts = cs.Counts(ops, fops, sops)
    placed = cs.placed_fl_path(torch, experiments, prng, ops, counts, smi)
    cs.emit(dict(phase="placed", **{k: v for k, v in placed.items()
                                    if k != "collectives"},
                 s=time.perf_counter() - t0))
    cs.time_partial(torch, ops, ref, smi)
    cs.emit(dict(phase="partial_timed", s=time.perf_counter() - t0))
    k4.result()
    pool.shutdown()
    cs.lowering_prefill(torch, model, analysis, get_config, counts, smi)
    cs.lowering_placed_round(placed, smi)
    cs.emit(dict(phase="probe_done", s=time.perf_counter() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
