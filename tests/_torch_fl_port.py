"""The port's half of ``tests/_torch_fl_small.py``'s small FL problem (a
linear model, M = 8 clients, the device sampler, keys 0 and 42), free of
JAX so that worker processes of the placement tests import it quickly.
``setup_port(..., place=)`` builds the run of one rank of a client
placement (``sharding.placement``): its state, store and sampler hold
the rank's rows."""
import numpy as np
import torch

from repro_torch import core
from repro_torch.core import faults, prng, staleness
from repro_torch.data import federated as fed

M, S, B, DIM = 8, 3, 4, 4
N_FLAT = DIM * DIM + 7                   # the linear model's flat width


def arrays(nan_client=None):
    rng = np.random.default_rng(0)
    n = 48
    x = rng.normal(size=(n, DIM)).astype(np.float32)
    y = rng.normal(size=(n, DIM)).astype(np.float32)
    idx = [np.arange(i, n, M) for i in range(M)]
    if nan_client is not None:
        x[idx[nan_client]] = np.nan      # every batch of that client is bad
    return dict(x=x, y=y), idx


def torch_loss(tr, frozen, batch, rng):
    return (0.5 * torch.mean((batch["x"] @ tr["w"] - batch["y"]) ** 2)
            + torch.sum(tr["b"] ** 2))


def setup_port(strategy, fault, stale, *, use_kernel, trace, clusters,
               dtrace, nan_client, base_p, kind, sampling, min_count,
               seed=None, sparse=0, rdt="float32", flat=True, place=None):
    store = fed.device_store(*arrays(nan_client), "cpu", place=place)
    init_fn, sample_fn = fed.make_device_sampler(
        M, S, B, mode=sampling, min_count=min_count,
        emit="cols" if sparse else "batches", place=place)
    cfg = core.FLConfig(m=M, s=S, eta_l=0.03, strategy=strategy,
                        lr_schedule=False, grad_clip=0.0,
                        use_kernel=use_kernel, flat_state=flat,
                        sparse_cohort=sparse, resident_dtype=rdt)
    fc = None if fault is None else faults.FaultCfg(**fault)
    sc = None if stale is None else staleness.StalenessCfg(**stale)
    rf = core.make_round_fn(
        cfg, torch_loss, {}, core.AvailabilityCfg(kind=kind, gamma=0.3),
        torch.full((M,), base_p), fault_cfg=fc, staleness_cfg=sc,
        place=place)
    tr0 = {"w": torch.ones((DIM, DIM)) * 0.1, "b": torch.zeros((7,))}
    fault_state = faults.init_fault_state(fc, trace=trace,
                                          clusters=clusters, place=place)
    stale_state = staleness.init_staleness_state(sc, N_FLAT, M,
                                                 dtrace=dtrace, place=place)
    rng, key = prng.PRNGKey(0, "cpu"), prng.PRNGKey(42, "cpu")
    if seed is not None:
        rng, key = prng.fold_in(rng, seed), prng.fold_in(key, seed)
    state = core.init_fl_state(rng, cfg, tr0, fault=fault_state,
                               stale=stale_state, place=place)
    return dict(state=state, round_fn=rf, store=store, sample_fn=sample_fn,
                data_key=key, sampler_state=init_fn(store, key), cfg=cfg,
                template=tr0, init_fn=init_fn, fault=fault_state,
                stale=stale_state)
