"""The small FL problem of tests/test_faults.py and tests/test_staleness.py
(a linear model, M = 8 clients, the device sampler, keys 0 and 42),
driven through the JAX package or its port from the same numpy inputs,
and the comparison both parity files apply to the two runs.

``run(pkg, strategy, fault=None, stale=None, ...)`` takes the fault and
staleness configs as plain dicts of ``FaultCfg`` / ``StalenessCfg``
fields, so one description builds both packages' configs; ``setup`` and
``drive`` are its two halves, for runs that restart from a checkpoint.
The sampler is uniform unless ``sampling="epoch"``.  ``setup(...,
seed=j)`` is seed j of a multi-seed run (state key ``fold_in(0, j)``,
data key ``fold_in(42, j)``); ``run_seeds`` drives S such seeds through
either package's seed-batched executor.  ``setup(..., sparse=C)`` runs
the sparse cohort round with cap C (the sampler emits columns), its
stacks resident in ``rdt``; ``setup(..., flat=False)`` the tree-state
round (the reference's default: the state is the ``{"w", "b"}`` tree,
and every strategy keeps a client stack).  The comparisons take tree
states and flat ones alike."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro import core as ref_core
from repro.core import faults as ref_faults
from repro.core import staleness as ref_stale
from repro.data import federated as ref_fed
from _torch_fl_port import (B, DIM, M, N_FLAT, S, arrays,  # noqa: F401
                            setup_port as _setup_port)
from repro_torch import core
from repro_torch.core import prng

#: counts and integer-valued means: bit-equal between the packages
EXACT = ("n_active", "n_dropped", "n_rejected", "n_stale", "mean_echo",
         "mean_staleness", "t")


def _jax_loss(tr, frozen, batch, rng):
    return (0.5 * jnp.mean((batch["x"] @ tr["w"] - batch["y"]) ** 2)
            + jnp.sum(tr["b"] ** 2))


def _setup_ref(strategy, fault, stale, *, use_kernel, trace, clusters,
               dtrace, nan_client, base_p, kind, sampling, min_count,
               seed=None, sparse=0, rdt="float32", flat=True):
    store = ref_fed.device_store(*arrays(nan_client))
    init_fn, sample_fn = ref_fed.make_device_sampler(
        M, S, B, mode=sampling, min_count=min_count,
        emit="cols" if sparse else "batches")
    cfg = ref_core.FLConfig(m=M, s=S, eta_l=0.03, strategy=strategy,
                            lr_schedule=False, grad_clip=0.0,
                            use_kernel=use_kernel, flat_state=flat,
                            sparse_cohort=sparse, resident_dtype=rdt)
    fc = None if fault is None else ref_faults.FaultCfg(**fault)
    sc = None if stale is None else ref_stale.StalenessCfg(**stale)
    rf = ref_core.make_round_fn(
        cfg, _jax_loss, {}, ref_core.AvailabilityCfg(kind=kind, gamma=0.3),
        jnp.full((M,), base_p), fault_cfg=fc, staleness_cfg=sc)
    tr0 = {"w": jnp.ones((DIM, DIM)) * 0.1, "b": jnp.zeros((7,))}
    fault_state = ref_faults.init_fault_state(fc, trace=trace,
                                              clusters=clusters)
    stale_state = ref_stale.init_staleness_state(sc, N_FLAT, M,
                                                 dtrace=dtrace)
    rng, key = jax.random.PRNGKey(0), jax.random.PRNGKey(42)
    if seed is not None:
        rng, key = (jax.random.fold_in(rng, seed),
                    jax.random.fold_in(key, seed))
    state = ref_core.init_fl_state(rng, cfg, tr0, fault=fault_state,
                                   stale=stale_state)
    return dict(state=state, round_fn=rf, store=store, sample_fn=sample_fn,
                data_key=key, sampler_state=init_fn(store, key), cfg=cfg,
                template=tr0, init_fn=init_fn, fault=fault_state,
                stale=stale_state)


def setup(pkg, strategy="fedawe", fault=None, stale=None, *,
          use_kernel=False, trace=None, clusters=None, dtrace=None,
          nan_client=None, base_p=0.6, kind="sine", sampling="uniform",
          min_count=1, seed=None, sparse=0, rdt="float32", flat=True):
    """The fresh run of ``pkg`` ("ref" or "port"): a dict with ``state``,
    ``round_fn``, ``store``, ``sample_fn``, ``data_key`` and
    ``sampler_state`` (and the ``cfg``, ``template``, ``init_fn`` and
    ``fault`` / ``stale`` carries a multi-seed run is built from)."""
    fn = _setup_ref if pkg == "ref" else _setup_port
    return fn(strategy, fault, stale, use_kernel=use_kernel, trace=trace,
              clusters=clusters, dtrace=dtrace, nan_client=nan_client,
              base_p=base_p, kind=kind, sampling=sampling,
              min_count=min_count, seed=seed, sparse=sparse, rdt=rdt,
              flat=flat)


def drive(pkg, parts, T, *, chunk=False, K=4, carry=False, **kw):
    """T rounds of ``setup``'s ``parts`` through ``pkg``'s ``run_rounds``:
    ``(state, history)``, and the final sampler carry with ``carry``
    (taken by a 3-argument checkpoint hook at round T)."""
    run_rounds = (ref_core if pkg == "ref" else core).run_rounds
    got = [None]

    def grab(state, t, sampler_state):
        got[0] = sampler_state

    if carry:
        kw.update(ckpt_fn=grab, ckpt_every=T)
    state, hist = run_rounds(
        parts["state"], parts["round_fn"], None, T,
        chunk_rounds=K if chunk else 0, sample_fn=parts["sample_fn"],
        store=parts["store"], data_key=parts["data_key"],
        sampler_state=parts["sampler_state"], **kw)
    return (state, hist, got[0]) if carry else (state, hist)


def run(pkg, strategy="fedawe", fault=None, stale=None, *, chunk=False,
        T=6, K=4, carry=False, **kw):
    """``(state, history)`` of T rounds of ``pkg`` ("ref" or "port"), and
    the final sampler carry with ``carry``; ``kw`` goes to ``setup``."""
    return drive(pkg, setup(pkg, strategy, fault, stale, **kw), T,
                 chunk=chunk, K=K, carry=carry)


def run_seeds(pkg, n_seeds, strategy="fedawe", fault=None, stale=None, *,
              T=5, K=2, **kw):
    """``n_seeds`` seeds of ``setup``'s run through ``pkg``'s seed-batched
    executor (``build_seed_batch``, ``make_seeds_chunk_fn``,
    ``run_seed_rounds`` with a ``T % K`` tail): ``(states, histories,
    sampler_states)``, seed j driven by ``fold_in(0, j)`` /
    ``fold_in(42, j)``."""
    if pkg == "ref":
        from repro.launch import experiments as ex
        make = ref_core.make_seeds_chunk_fn
        base = (jax.random.PRNGKey(0), jax.random.PRNGKey(42))
    else:
        from repro_torch.launch import experiments as ex
        make = core.make_seeds_chunk_fn
        base = (prng.PRNGKey(0, "cpu"), prng.PRNGKey(42, "cpu"))
    p = setup(pkg, strategy, fault, stale, **kw)
    states, sss, dks = ex.build_seed_batch(
        p["cfg"], p["template"], *base, p["init_fn"], p["store"], n_seeds,
        fault=p["fault"], stale=p["stale"])
    got = {}

    def grab(st, done, ss):
        got["ss"] = ss

    def seeds_chunk(k):
        return make(p["cfg"], p["round_fn"], p["sample_fn"], k, n_seeds)

    states, hists = ex.run_seed_rounds(
        states, seeds_chunk(K), T, K, sampler_states=sss, store=p["store"],
        data_keys=dks, n_seeds=n_seeds, make_tail_fn=seeds_chunk, ckpt_fn=grab,
        ckpt_every=T)
    return states, hists, got["ss"]


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                               equal_nan=True)


def _f32(x):
    """A tensor or an array of either package as a float32 numpy array
    (bfloat16 included)."""
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _leaves(tree, prefix=""):
    """``{path: array}`` of a dict tree of arrays or tensors (``{}`` for
    None, ``{"": x}`` for a bare array)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)):
        assert len(tree) == 0, "only the empty tuple is a leafless extra"
        return {}
    return {prefix.rstrip("/"): tree}


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_carry_equal(port, ref):
    """A sampler carry (dict of tensors) bit-equal to the reference's;
    PRNG key words compare as int64."""
    got, want = _leaves(port), _leaves(ref)
    assert set(got) == set(want), (set(got), set(want))
    for k in want:
        w = _np(want[k])
        if w.dtype == np.uint32:
            w = w.astype(np.int64)
        np.testing.assert_array_equal(_np(got[k]), w, err_msg=k)


def assert_parity(ref, port, tol=1e-4):
    """Counts, τ, keys and ring ages bit-equal; states, strategy state and
    losses within ``tol`` (1e-4, tests/test_engine_kernel_path.py's
    bound); every state leaf in the reference's dtype."""
    (rs, rh), (ps, ph) = ref[:2], port[:2]
    assert len(rh) == len(ph)
    for w, g in zip(rh, ph):
        assert set(g) == set(w), (set(g), set(w))
        for k in w:
            if k in EXACT:
                assert g[k] == w[k], (k, g[k], w[k])
            else:
                _close(g[k], w[k], tol)
    np.testing.assert_array_equal(ps.tau.numpy(), np.asarray(rs.tau))
    np.testing.assert_array_equal(ps.rng.numpy(),
                                  np.asarray(rs.rng).astype(np.int64))
    assert (ps.spec is None) == (rs.spec is None)
    assert (ps.clients_tr is None) == (rs.clients_tr is None)
    for name in ("global_tr", "clients_tr", "extra"):
        got = _leaves(getattr(ps, name))
        want = _leaves(getattr(rs, name))
        assert set(got) == set(want), (name, set(got), set(want))
        for k in want:
            assert _dtype_name(got[k]) == _dtype_name(want[k]), (name, k)
            _close(_f32(got[k]), _f32(want[k]), tol)
    assert (ps.stale is None) == (rs.stale is None)
    if rs.stale is not None:
        np.testing.assert_array_equal(ps.stale["ages"].numpy(),
                                      np.asarray(rs.stale["ages"]))
        _close(ps.stale["buf"].numpy(), np.asarray(rs.stale["buf"]), tol)


def assert_same_port(a, b):
    """Two port runs (host loop against chunked) agree exactly."""
    (sa, ha), (sb, hb) = a[:2], b[:2]
    assert ha == hb
    for name in ("tau", "t", "markov", "rng"):
        assert torch.equal(getattr(sa, name), getattr(sb, name)), name
    assert (sa.clients_tr is None) == (sb.clients_tr is None)
    for name in ("global_tr", "clients_tr"):
        ea, eb = _leaves(getattr(sa, name)), _leaves(getattr(sb, name))
        assert set(ea) == set(eb), name
        for k in ea:
            assert torch.equal(ea[k], eb[k]), (name, k)
    ea, eb = _leaves(sa.extra), _leaves(sb.extra)
    assert set(ea) == set(eb)
    for k in ea:
        assert torch.equal(ea[k].nan_to_num(), eb[k].nan_to_num()), k
    if sa.stale is not None:
        for k in sa.stale:
            assert torch.equal(sa.stale[k].nan_to_num(),
                               sb.stale[k].nan_to_num()), k
