"""The worker side of ``tests/test_torch_placement.py``: each of four
``gloo`` CPU processes (a ``FileStore``, no ports) runs every case as one
rank of a client placement and writes what rank 0 gathers.

A single-seed case runs ``_torch_fl_port``'s small problem on the
``(2, 2, 1)`` test mesh (four blocks of two of its eight clients):
``setup_port(place=)``, the chunked executor, then the final state and
sampler carry gathered whole through DTensor by ``flat_pspecs`` /
``sampler_pspecs``.  A grid case runs ``launch/experiments``' cell on the
``(2, 1, 2)`` seed mesh (two seeds, each's clients over two ranks),
unpacked or packed, which gather their own results.  No JAX here."""
import os

import torch

CASE_T, CASE_K = 6, 3
#: strategy, and the ``setup_port`` keywords beside the defaults
STRATEGIES = ("fedawe", "fedawe_m", "fedavg_active", "fedavg_all",
              "fedavg_known_p", "fedau", "f3ast", "mifa", "fedvarp", "fedar")
FAULT = dict(upload_survival=0.6, sanitize=True)
STALE = dict(tau_max=3, kind="geom", p_next=0.6, gamma=0.7)
SINGLE = {
    **{f"{s}/sync": dict(strategy=s) for s in STRATEGIES},
    **{f"{s}/faults+stale": dict(strategy=s, fault=FAULT, stale=STALE)
       for s in STRATEGIES},
    "fedawe/faults": dict(strategy="fedawe", fault=FAULT),
    "fedawe/stale": dict(strategy="fedawe", stale=STALE),
    "fedawe/markov": dict(strategy="fedawe", kind="markov"),
    "fedawe/epoch": dict(strategy="fedawe", sampling="epoch", min_count=6),
    "mifa/epoch": dict(strategy="mifa", sampling="epoch", min_count=6),
    "fedawe/kernel": dict(strategy="fedawe", use_kernel=True),
    "fedawe/kernel+faults": dict(strategy="fedawe", use_kernel=True,
                                 fault=FAULT),
    "fedawe_m/kernel+stale": dict(strategy="fedawe_m", use_kernel=True,
                                  stale=STALE),
}
#: launch/experiments cells on the (2, 1, 2) seed mesh
GRID = dict(seeds=2, rounds=4, chunk_rounds=2, m=8, s=2, batch=4,
            n_samples=400, seed=0, device="cpu")
GRID_CASES = {
    "grid/fedawe-sine": dict(names=["fedawe/sine"], use_kernel=True),
    "grid/packed": dict(names=["fedawe/sine", "fedavg_active/sine"],
                        packed=True),
}
#: cells whose placed build ``_share`` holds to the rank's share: fault
#: and stale carries, a memory strategy's memory, the epoch sampler's
#: carry, a fault trace, blackout clusters and a delay trace
SHARE_CELLS = ("fedawe/stale_d2+midround", "mifa/stale_d2",
               "fedawe/sine+epoch", "trace_diurnal", "blackout_cluster",
               "fedawe/stale_trace")
#: the CLI inside the ranks' group (its ``--seed-mesh`` takes the group's
#: ranks); without ``--seed-mesh`` in one process, the same rows
CLI = ["--scenario", "fedawe/stale_d2+midround", "--seeds", "2", "--rounds",
       "4", "--chunk-rounds", "2", "--m", "8", "--s", "2", "--batch", "4",
       "--n-samples", "400", "--use-kernel", "--no-save", "--device", "cpu"]


def setup_kwargs(kw):
    """``kw`` completed with ``_torch_fl_port.setup_port``'s defaults."""
    out = dict(fault=None, stale=None, use_kernel=False, trace=None,
               clusters=None, dtrace=None, nan_client=None, base_p=0.6,
               kind="sine", sampling="uniform", min_count=1)
    out.update(kw)
    return out


def _gather_tree(ex, tree, spec, mesh):
    return ex._map_placed(ex._join_block, tree, spec, mesh)


def _single(name, kw, mesh):
    import torch.distributed as dist
    from _torch_fl_port import M, setup_port
    from repro_torch import core
    from repro_torch.launch import experiments as ex
    from repro_torch.sharding import flat_pspecs, sampler_pspecs
    from repro_torch.sharding.placement import client_placement

    kw = setup_kwargs(kw)
    strategy = kw.pop("strategy")
    fault, stale = kw.pop("fault"), kw.pop("stale")
    place = client_placement(mesh, M)
    parts = setup_port(strategy, fault, stale, place=place, **kw)
    got = {}

    def grab(state, t, sampler_state):
        got["carry"] = sampler_state

    # every collective of the rounds: each all-reduce counted
    all_reduce, calls = dist.all_reduce, []

    def counted(*args, **kw):
        calls.append(1)
        return all_reduce(*args, **kw)

    dist.all_reduce = counted
    try:
        state, hist = core.run_rounds(
            parts["state"], parts["round_fn"], None, CASE_T,
            chunk_rounds=CASE_K, sample_fn=parts["sample_fn"],
            store=parts["store"], data_key=parts["data_key"],
            sampler_state=parts["sampler_state"], ckpt_fn=grab,
            ckpt_every=CASE_T)
    finally:
        dist.all_reduce = all_reduce
    whole = setup_port(strategy, fault, stale, **kw)   # the shapes only
    state = _gather_tree(ex, state, flat_pspecs(mesh, whole["state"],
                                                multi_pod=True), mesh)
    carry = _gather_tree(ex, got["carry"], sampler_pspecs(
        mesh, whole["sampler_state"], M, multi_pod=True), mesh)
    return dict(state=state._replace(spec=None), history=hist, carry=carry,
                rows=(place.lo, place.hi), all_reduces=len(calls))


def _grid(kw, mesh):
    from repro_torch.launch import experiments as ex

    kw = dict(kw)
    names, packed = kw.pop("names"), kw.pop("packed", False)
    if packed:
        return ex.run_packed_grid(names, mesh=mesh, **GRID, **kw)
    return [ex.run_scenario(ex.get_scenario(n), mesh=mesh, **GRID, **kw)
            for n in names]


def _shapes(tree):
    import torch.utils._pytree as pytree

    return [tuple(v.shape) if torch.is_tensor(v) else None
            for v in pytree.tree_leaves(tree)]


def _share(mesh):
    """Per ``SHARE_CELLS`` cell and carry, the leaf shapes of what a rank
    builds (``build_cell(mesh=)``), of the rank's share of the unplaced
    cell's by the specs that place them (``sharding.local_shape``), and
    of the unplaced cell's; and the same of ``run_multi_seed``'s returned
    states for the first cell."""
    import torch.utils._pytree as pytree

    from repro_torch.core import prng
    from repro_torch.launch import experiments as ex
    from repro_torch.sharding import local_shape
    from repro_torch.sharding.rules import _is_spec

    place = ex.seed_chunk_placement(mesh, GRID["m"], GRID["seeds"])
    kw = {k: GRID[k] for k in ("seeds", "rounds", "chunk_rounds", "m", "s",
                               "batch", "n_samples", "seed", "device")}

    def shares(got, whole, spec):
        specs = pytree.tree_leaves(spec, is_leaf=_is_spec)
        want = _shapes(whole)
        return (_shapes(got), [None if w is None else local_shape(w, p, mesh)
                               for w, p in zip(want, specs)], want)

    out = {}
    for name in SHARE_CELLS:
        sc = ex.get_scenario(name)
        got = ex.build_cell(sc, preset="image", mesh=place, **kw)
        whole = ex.build_cell(sc, preset="image", **kw)
        spec = ex.seed_chunk_shardings(place, got["states"],
                                       got["sampler_states"], got["store"],
                                       got["data_keys"])
        out[name] = {k: shares(got[k], whole[k], spec[k])
                     for k in ("states", "sampler_states", "store",
                               "data_keys")}
    sc = ex.get_scenario(SHARE_CELLS[0])
    runs = {}
    for pl in (place, None):
        fl, rf, params, ds, _, _, fault, stale = ex._cell_task(
            sc, m=GRID["m"], s=GRID["s"], batch=GRID["batch"],
            n_samples=GRID["n_samples"], preset="image", seed=0,
            use_kernel=True, rounds=2, device=torch.device("cpu"),
            place=None if pl is None else pl.clients)
        runs[pl is None] = ex.run_multi_seed(
            fl, rf, params, ds, sampling=sc.sampling, batch=GRID["batch"],
            seeds=GRID["seeds"], rounds=2, chunk_rounds=2,
            rng=prng.PRNGKey(0, "cpu"), data_key=prng.PRNGKey(1, "cpu"),
            mesh=pl, fault=fault, stale=stale)[0]
    placed = runs[False]
    assert isinstance(placed, ex.PlacedCarry), type(placed)
    out["run_multi_seed"] = {"states": shares(placed.local, runs[True],
                                              placed.spec)}
    return out


def run_rank(rank, world, store_path, out_dir, names):
    """One rank: every case in ``names``; rank 0 saves the gathered
    results to ``out_dir/results.pt``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        from repro_torch.launch.mesh import make_seed_mesh, make_test_mesh

        test_mesh = make_test_mesh(multi_pod=True, device_type="cpu")
        seed_mesh = make_seed_mesh(2, device_type="cpu")
        assert tuple(seed_mesh.shape) == (2, 1, 2)
        out = {}
        for name in names:
            if name == "grid/share":
                out[name] = _share(seed_mesh)
            elif name == "grid/cli":
                from repro_torch.launch import experiments as ex
                out[name] = ex.main(CLI + ["--seed-mesh"])
            elif name in GRID_CASES:
                out[name] = _grid(GRID_CASES[name], seed_mesh)
            else:
                out[name] = _single(name, SINGLE[name], test_mesh)
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "results.pt"))
    finally:
        dist.destroy_process_group()
