"""The placed FL paths of ``chip_smoke.py``'s phases 3o and 3q over the
cards of one host, one rank a card, the collectives over NCCL:

    torchrun --nproc-per-node 4 tools/chip_probe_nccl.py [--tree]

With ``--tree``, phase 3q (a)'s tree-state placed round alone, on the
(2, 2) ('data', 'model') mesh that one card cannot take (DTensor's
all-gathers over 'model' of CUDA tensors through gloo segfaulted there):
``tiny`` in float32, FedAWE with K1, m = 8, four client rows a rank and
each leaf's model dims over two cards; rank 0 runs the unplaced tree
round on its card and holds the ranks' results to phase 3q's gates
(``chip_smoke.tree_placed_path``: within ``TREE_PLACED_TOL``, the partial
form and the finalize once a round on every rank, the fused K1 never, τ,
keys and counts bit-equal), printing rank 0's counted collectives.
Without it:

fedawe/sine and fedawe/stale_d2+midround (m 100, s 5, batch 32, the
full-width CNN, 2 seeds, 16 rounds in chunks of 8, with the kernel) over
a ``(2, 1, 2)`` ('seed', 'pod', 'data') mesh: each rank holds 50 clients
of one seed on its own card.  Rank 0 also runs each cell unplaced on its
card; the turns go unplaced, placed, placed, unplaced.  Gates, as phase
3o's: the partial form and the finalize once a round on every rank, the
fused kernel never; the histories' counts, τ, keys, t and markov
bit-equal to the unplaced run's, losses, globals and client stacks
within ``chip_smoke.PLACED_TOL``.  Then rank 0 profiles a third placed
run of fedawe/sine and prints the NCCL kernels' count and device time
beside all kernels'.  Prints every card's name and power limit.  Exits
non-zero when a gate fails.  Imports neither jax nor the JAX package."""
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

CELLS = cs.PLACED_CELLS


def _counts(ops):
    return dict(fused=ops.echo_aggregate_flat.launches,
                fused_upload=ops.echo_aggregate_flat.upload_launches,
                **cs.partial_launches(ops))


def _reset(ops):
    for fn in (ops.echo_aggregate_flat, ops.echo_aggregate_partial):
        fn.launches = 0
        fn.upload_launches = 0
    ops.echo_aggregate_finalize.launches = 0


def _compare(torch, a, b):
    """The placed run ``a`` against the unplaced ``b``: the largest
    loss and state differences; raises where a count, τ, key, t or
    markov differs."""
    exact = ("n_active", "mean_echo", "n_dropped", "n_rejected", "n_stale",
             "mean_staleness")
    loss = 0.0
    for ha, hb in zip(a["hists"], b["hists"]):
        cs.require(len(ha) == len(hb) == cs.PLACED_ROUNDS, "history")
        for ra, rb in zip(ha, hb):
            cs.require(all(ra[k] == rb[k] for k in exact if k in rb),
                       f"counts differ: {ra} {rb}")
            cs.require(math.isfinite(ra["loss"]), f"loss {ra['loss']}")
            loss = max(loss, abs(ra["loss"] - rb["loss"]))
    sa, sb = a["states"], b["states"]
    for k in ("tau", "rng", "t", "markov"):
        cs.require(torch.equal(getattr(sa, k).cpu(), getattr(sb, k).cpu()),
                   f"{k} differs")
    state = max((getattr(sa, k).cpu() - getattr(sb, k).cpu()).abs().max()
                .item() for k in ("global_tr", "clients_tr"))
    cs.require(loss <= cs.PLACED_TOL and state <= cs.PLACED_TOL,
               f"losses {loss}, states {state}")
    return dict(max_loss_diff=loss, max_state_diff=state)


def _profile(torch, run):
    """``run()`` under torch.profiler: the NCCL kernels' count and device
    ms, and all kernels'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    nccl = [(n, us) for n, us in kernels if "nccl" in n.lower()]
    return dict(nccl_kernels=len(nccl),
                nccl_device_ms=sum(us for _, us in nccl) / 1e3,
                nccl_names=sorted({n[:60] for n, _ in nccl}),
                kernels=len(kernels),
                device_ms=sum(us for _, us in kernels) / 1e3)


def _tree(torch, dist, rank, smi):
    """Phase 3q (a) on the (2, 2) mesh over the four cards: every rank's
    run, gathered to rank 0, held there against the unplaced tree
    round."""
    from repro_torch.kernels.echo_aggregate import kernel, ops, ref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_chunk import ops as sops

    if rank == 0:
        kernel.LIBRARY.build()      # one nvcc; the other ranks load it
    dist.barrier()
    kernel.LIBRARY.build()
    got = dict(tree=cs.tree_placed_rank(torch, rank, shape=(2, 2)))
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, got)
    if rank == 0:
        cs.tree_placed_path(torch, ops, ref, ranks,
                            cs.Counts(ops, fops, sops), smi, shape=(2, 2),
                            backend="nccl")


def main():
    import torch
    import torch.distributed as dist

    from repro_torch.core import prng
    from repro_torch.kernels.echo_aggregate import ops
    from repro_torch.launch import experiments, mesh

    if not torch.cuda.is_available():
        print("chip_probe_nccl: no CUDA device is visible", file=sys.stderr)
        return 1
    experiments._join_group_from_env("cuda")
    rank = dist.get_rank()
    t0 = time.perf_counter()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        if rank == 0:
            print(smi, flush=True)
        if "--tree" in sys.argv[1:]:
            _tree(torch, dist, rank, smi)
            return 0
        m = mesh.make_seed_mesh(cs.PLACED_SEEDS, device_type="cuda")
        cs.require(mesh.mesh_axis_sizes(m) == {"seed": 2, "pod": 1,
                                               "data": 2},
                   f"mesh {mesh.mesh_axis_sizes(m)}")
        want = {"sine": dict(fused=0, fused_upload=0,
                             partial=cs.PLACED_ROUNDS, partial_upload=0,
                             finalize=cs.PLACED_ROUNDS),
                "fault": dict(fused=0, fused_upload=0, partial=0,
                              partial_upload=cs.PLACED_ROUNDS,
                              finalize=cs.PLACED_ROUNDS)}
        out = {}
        for tag, name in CELLS:
            turns = {"placed": [], "unplaced": []}
            runs = {}
            for kind in ("unplaced", "placed", "placed", "unplaced"):
                dist.barrier()
                if kind == "placed":
                    _reset(ops)
                    r = cs.placed_run(torch, experiments, prng, m, name)
                    cs.require(_counts(ops) == want[tag],
                               f"rank {rank} {tag} launches {_counts(ops)}")
                elif rank == 0:
                    r = cs.placed_run(torch, experiments, prng, None, name)
                else:
                    continue
                turns[kind].append(r["wall_s"])
                runs[kind] = r
            if rank == 0:
                out[tag] = dict(placed_wall_s_turns=turns["placed"],
                                unplaced_wall_s_turns=turns["unplaced"],
                                rank_held=runs["placed"]["held"],
                                rank_peak_bytes=runs["placed"]["peak_bytes"],
                                unplaced_peak_bytes=runs["unplaced"]
                                ["peak_bytes"],
                                **_compare(torch, runs["placed"],
                                           runs["unplaced"]))
        dist.barrier()
        prof = _profile(torch, lambda: cs.placed_run(
            torch, experiments, prng, m, CELLS[0][1]))
        if rank == 0:
            print(json.dumps(dict(
                phase="nccl_placed", ranks=dist.get_world_size(),
                rounds=cs.PLACED_ROUNDS, cells=out, profile_sine=prof,
                s=time.perf_counter() - t0)), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
