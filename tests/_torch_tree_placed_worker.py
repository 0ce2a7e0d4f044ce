"""The worker side of ``tests/test_torch_tree_placement.py``: each of four
``gloo`` CPU processes (a ``FileStore``, no ports) runs every case as one
rank of a ``TreePlacement`` on the ``(2, 2)`` ('data', 'model') test mesh
and saves what it holds.

A case is ``ROUNDS`` rounds of the ``tiny`` LM on tree state, float32,
m = 8 (four client rows a rank, each leaf's model dims over the two
'model' ranks), the weights the test hands over as numpy; an ``arch``
case runs that architecture's reduced config (with ``cfg``'s overrides)
in float32 from weights drawn here; a ``mesh`` case runs on that
('data', 'model') shape of the four ranks instead, and ``m`` / ``rounds``
take the place of ``M`` / ``ROUNDS``.  ``run_case`` with ``place=None`` is the unplaced tree round
the test runs itself on the same inputs.  No JAX here."""
import os

import numpy as np
import torch

M, ROUNDS, B, L = 8, 2, 2, 16
FAULT = dict(upload_survival=0.6, sanitize=True)
#: case -> FLConfig keywords beside ``FL``, the fault flags, the modes
CASES = {
    "fedawe": dict(),
    "fedawe/kernel": dict(use_kernel=True),
    "fedawe/faults": dict(fault=FAULT),
    "mifa": dict(strategy="mifa"),
    "fedawe/dp_client": dict(mode="dp", batch_mode="dp"),
    "fedawe/zero_client": dict(mode="tp", batch_mode="dp"),
    # the Mamba2 mixer's region over a batch split on 'model': its
    # replicated weights' gradients are partial sums there
    "mamba2/dp_client": dict(arch="mamba2-130m", mode="dp",
                             batch_mode="dp"),
    # the training splits of what would run replicated over 'model': one
    # kv head (the attention over the batch), the Mamba2 mixer over the
    # batch with an odd tied vocab (the loss over the tokens); on a
    # 4-wide 'model' the rows x head-groups splits (two kv heads, four
    # SSM heads, two rows a client)
    "gemma2/kv1": dict(arch="gemma2-2b", cfg=dict(n_layers=2,
                                                   n_kv_heads=1), rounds=1),
    "mamba2/vocab509": dict(arch="mamba2-130m", cfg=dict(vocab=509),
                            rounds=1),
    "gemma2/kv2@1x4": dict(arch="gemma2-2b", cfg=dict(n_layers=2,
                                                       n_kv_heads=2),
                           mesh=(1, 4), m=4, rounds=1),
    "mamba2/vocab509@1x4": dict(arch="mamba2-130m", cfg=dict(vocab=509),
                                mesh=(1, 4), m=4, rounds=1),
    # LoRA adapters over a frozen base: the output projection's adapter
    # beside its row-sharded weight (``placed._row_lora``); its second
    # round runs the adapters' B, zero in the first
    "gemma3/lora": dict(arch="gemma3-27b", cfg=dict(n_layers=2), m=4),
}
FL = dict(m=M, eta_l=0.05, eta_g=1.0, strategy="fedawe", lr_schedule=True,
          grad_clip=0.5)


def batches(cfg, t, m=M):
    """Round ``t``'s ``[m, s, B, L]`` token batch, drawn with numpy."""
    rng = np.random.default_rng(100 + t)
    toks = rng.integers(0, cfg.vocab, (m, cfg.local_steps, B, L))
    return dict(tokens=torch.from_numpy(toks.astype(np.int32)),
                labels=torch.from_numpy(np.roll(toks, -1, -1)
                                        .astype(np.int32)),
                mask=torch.ones((m, cfg.local_steps, B, L)))


def _whole(x):
    from repro_torch.models.placed import is_placed

    return x.full_tensor() if is_placed(x) else x


def _nbytes(tree):
    import torch.utils._pytree as pytree

    from repro_torch.models.placed import is_placed

    return sum((v.to_local() if is_placed(v) else v).nbytes
               for v in pytree.tree_leaves(tree) if torch.is_tensor(v))


def run_case(name, weights, place=None):
    """Case ``name`` from ``weights`` (the reference layout, numpy):
    the global whole, the client rows held (whole over 'model'), τ,
    markov, the key, t, the metrics of each round, the client leaves'
    placements after each round against ``client_stack_pspecs``', and
    the state's bytes on this rank."""
    import torch.utils._pytree as pytree

    from repro_torch.checkpointing import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.core import (AvailabilityCfg, FLConfig, init_fl_state,
                                  make_round_fn, prng)
    from repro_torch.core.faults import FaultCfg, init_fault_state
    from repro_torch.models import reduced
    from repro_torch.models.model import (init_params, lm_loss_fn,
                                          split_trainable)
    from repro_torch.sharding import placements
    from repro_torch.sharding.placement import rows_of
    from repro_torch.core.tree_util import tree_leaves

    kw = dict(CASES[name])
    fault = kw.pop("fault", None)
    for key in ("mode", "batch_mode", "mesh"):
        kw.pop(key, None)
    arch = kw.pop("arch", None)
    over = kw.pop("cfg", {})
    m, rounds = kw.pop("m", M), kw.pop("rounds", ROUNDS)
    if arch is None:
        cfg = get_config("tiny")
        params = params_from_numpy(weights, "cpu")
    else:
        cfg = reduced(get_config(arch), **over).replace(dtype="float32")
        params = init_params(torch.Generator().manual_seed(0), cfg)
    fl = FLConfig(s=cfg.local_steps, **dict(FL, m=m, **kw))
    trainable, frozen = split_trainable(params, cfg)
    fault_cfg = None if fault is None else FaultCfg(**fault)
    fstate = None if fault_cfg is None else init_fault_state(
        fault_cfg, place=place)
    av = AvailabilityCfg(kind="sine", gamma=0.3, period=4)
    round_fn = make_round_fn(fl, lm_loss_fn(cfg), frozen, av,
                             torch.full((m,), 0.6), fault_cfg=fault_cfg,
                             place=place)
    state = init_fl_state(prng.PRNGKey(3, "cpu"), fl, trainable,
                          fault=fstate, place=place)
    want = None
    if place is not None:
        want = [tuple(placements(s, place.sub))
                for s in tree_leaves(place.client_specs(trainable))]
    history, kept = [], []
    for t in range(rounds):
        state, metrics = round_fn(state, {
            k: rows_of(v, place) for k, v in batches(cfg, t, m).items()})
        history.append({k: float(v) for k, v in metrics.items()})
        if want is not None:
            kept.append([tuple(v.placements) for v in
                         tree_leaves(state.clients_tr)] == want)
    return dict(
        global_tr=pytree.tree_map(_whole, state.global_tr),
        clients=pytree.tree_map(_whole, state.clients_tr),
        tau=state.tau, markov=state.markov, rng=state.rng, t=state.t,
        history=history, kept=kept, state_bytes=_nbytes(state))


def run_rank(rank, world, store_path, out_dir, weights_path, names):
    """One rank: every case in ``names`` on its ``TreePlacement``; each
    rank saves its results (and its rows) to ``out_dir/rank{r}.pt``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.sharding.placement import tree_placement

        weights = torch.load(weights_path, weights_only=False)
        meshes = {(2, 2): make_test_mesh(device_type="cpu")}
        out = {}
        for name in names:
            kw = CASES[name]
            shape = kw.get("mesh", (2, 2))
            if shape not in meshes:
                meshes[shape] = init_device_mesh(
                    "cpu", shape, mesh_dim_names=("data", "model"))
            place = tree_placement(meshes[shape], kw.get("m", M),
                                   mode=kw.get("mode", "tp"),
                                   batch_mode=kw.get("batch_mode", "tp"))
            out[name] = dict(run_case(name, weights, place),
                             rows=(place.lo, place.hi))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
