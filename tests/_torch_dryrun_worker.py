"""The worker side of ``tests/test_torch_dryrun_lowering.py``'s placed
serving case: each of four ``gloo`` CPU processes (a ``FileStore``, no
ports) places ``tiny`` on the ``(2, 2)`` test mesh by the dry run's own
builders, runs prefill and then a decode step over DTensors, and rank 0
saves the gathered logits and caches, the unplaced step's, and the
collectives it counted.  No JAX here."""
import os

import torch

#: sequences and cache length (= the prompt's, as the dry run's shapes)
B, L = 4, 32


def shapes():
    from repro_torch.configs.shapes import InputShape

    return (InputShape("prompt", "prefill", L, B),
            InputShape("step", "decode", L, B))


def _full(tree):
    import torch.utils._pytree as pytree

    return pytree.tree_map(
        lambda v: v.full_tensor() if hasattr(v, "full_tensor") else v, tree)


def _steps(cfg, mesh):
    """Prefill, then a decode step, unplaced and placed: the outputs and
    the collectives rank 0 counted in each placed step."""
    import copy

    from repro_torch.launch import analysis, dryrun
    from repro_torch.models.model import prefill, serve_step

    pre, dec = shapes()
    gen = torch.Generator().manual_seed(3)
    args, specs = dryrun.serve_args(cfg, pre, mesh)
    args["inputs"]["tokens"] = torch.randint(0, cfg.vocab, (B, L),
                                             generator=gen)
    want_pre = prefill(args["params"], cfg, copy.deepcopy(args["cache"]),
                       args["inputs"]["tokens"])
    step, step_args = dryrun.build_prefill_step(cfg, pre, mesh, args, specs)
    with analysis.CollectiveCounter() as c_pre:
        got_pre = step(*step_args)
    # the decode step reads the prefilled cache, one new token a row
    dargs, dspecs = dryrun.serve_args(cfg, dec, mesh)
    dargs["params"], dargs["cache"] = args["params"], want_pre[1]
    dargs["inputs"] = dict(
        tokens=torch.randint(0, cfg.vocab, (B, 1), generator=gen),
        pos=torch.full((B,), L, dtype=torch.int32))
    want_dec = serve_step(dargs["params"], cfg, copy.deepcopy(dargs["cache"]),
                          dargs["inputs"]["tokens"], dargs["inputs"]["pos"])
    step, step_args = dryrun.build_decode_step(cfg, dec, mesh, dargs, dspecs)
    with analysis.CollectiveCounter() as c_dec:
        got_dec = step(*step_args)
    return dict(prefill=(want_pre, _full(got_pre), c_pre.collective_bytes()),
                decode=(want_dec, _full(got_dec), c_dec.collective_bytes()))


def run_rank(rank, world, store_path, out_dir):
    """One rank of the placed serving case; rank 0 saves the results to
    ``out_dir/results.pt``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_test_mesh

        out = _steps(get_config("tiny"),
                     make_test_mesh(device_type="cpu"))
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "results.pt"))
    finally:
        dist.destroy_process_group()
