"""The port's seed-batched executor (``core.engine.make_seeds_chunk_fn``,
``seed_vmap``, ``stack_seeds``, ``index_seed``) and the echo-aggregate
kernel's seed axis, against the JAX package's ``make_seeds_chunk_fn`` on
the small problem of tests/_torch_fl_small.py (S = 3 seeds, K = 2, T = 5
so a tail chunk runs).

Per seed, against the reference: n_active and the other counts, τ, the
PRNG key, the markov state, the sampler carry and the ring ages
bit-equal; states and losses within 1e-4.  Against S single-seed port
runs driven by ``fold_in(0, j)`` / ``fold_in(42, j)``: the same bits and
states within 1e-6 (the seed-batched reductions may add in another
order).  Then the properties the batched round rests on: no
``torch.func.vmap`` slow path, the stateless start a stride-0 view, the
custom operator's vmap rule making one batched call."""
import warnings

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import jax  # noqa: E402

from repro.data import federated as ref_fed  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import engine, prng  # noqa: E402
from repro_torch.data import federated as fed  # noqa: E402
from repro_torch.kernels.echo_aggregate import ops, ref  # noqa: E402

from _torch_fl_small import (EXACT, M, _close, _leaves,  # noqa: E402,I100
                             assert_carry_equal, drive, run_seeds, setup)

SEEDS, T, K = 3, 5, 2
MIDROUND = dict(upload_survival=0.7, sanitize=True)
GEOM = dict(tau_max=3, kind="geom", p_next=0.5, gamma=0.7)

#: (strategy, fault, stale, sampling, kind, use_kernel)
CASES = {
    "fedawe-uniform-sine": ("fedawe", None, None, "uniform", "sine", False),
    "fedawe-uniform-sine-kernel": ("fedawe", None, None, "uniform", "sine",
                                   True),
    "fedawe-epoch-markov-kernel": ("fedawe", None, None, "epoch", "markov",
                                   True),
    "fedawe-epoch-markov": ("fedawe", None, None, "epoch", "markov", False),
    "fedavg_active-epoch-sine": ("fedavg_active", None, None, "epoch",
                                 "sine", False),
    "mifa-uniform-markov": ("mifa", None, None, "uniform", "markov", False),
    "fedawe-faults-stale-kernel": ("fedawe", MIDROUND, GEOM, "uniform",
                                   "sine", True),
    "fedawe-faults-stale": ("fedawe", MIDROUND, GEOM, "epoch", "sine",
                            False),
}


def _run(pkg, case):
    strategy, fault, stale, sampling, kind, use_kernel = CASES[case]
    return run_seeds(pkg, SEEDS, strategy, fault, stale, T=T, K=K,
                     sampling=sampling, kind=kind, use_kernel=use_kernel)


def _singles(case):
    """The S single-seed chunked port runs of ``case``: ``(state,
    history, sampler carry)`` per seed."""
    strategy, fault, stale, sampling, kind, use_kernel = CASES[case]
    return [drive("port", setup("port", strategy, fault, stale,
                                sampling=sampling, kind=kind,
                                use_kernel=use_kernel, seed=j),
                  T, chunk=True, K=K, carry=True) for j in range(SEEDS)]


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _exact(got, want, what):
    w = _np(want)
    if w.dtype == np.uint32:
        w = w.astype(np.int64)
    np.testing.assert_array_equal(_np(got), w, err_msg=what)


def _assert_seed(port_state, port_hist, port_ss, want_state, want_hist,
                 want_ss, tol):
    """Seed j of the port's batched run against one of the same seed:
    counts, τ, key, markov state, sampler carry and ring ages to the bit,
    states and losses within ``tol``."""
    assert len(port_hist) == len(want_hist) == T
    for g, w in zip(port_hist, want_hist):
        assert set(g) == set(w), (set(g), set(w))
        for k in w:
            if k in EXACT:
                assert g[k] == w[k], (k, g[k], w[k])
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=tol, atol=tol)
    for name in ("tau", "rng", "t", "markov"):
        _exact(getattr(port_state, name), getattr(want_state, name), name)
    assert_carry_equal(port_ss, want_ss)

    def close(got, want):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                                   equal_nan=True)

    close(port_state.global_tr, want_state.global_tr)
    assert (port_state.clients_tr is None) == (want_state.clients_tr is None)
    if want_state.clients_tr is not None:
        close(port_state.clients_tr, want_state.clients_tr)
    got, want = _leaves(port_state.extra), _leaves(want_state.extra)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])
    assert (port_state.stale is None) == (want_state.stale is None)
    if want_state.stale is not None:
        _exact(port_state.stale["ages"], want_state.stale["ages"], "ages")
        close(port_state.stale["buf"], want_state.stale["buf"])


@pytest.mark.parametrize("case", list(CASES))
def test_seed_batch_matches_reference_and_single_seed_runs(case):
    """The port's seed-batched run against the reference's
    ``make_seeds_chunk_fn`` run (within 1e-4) and against S single-seed
    port runs (within 1e-6), seed by seed; no ``torch.func.vmap`` slow
    path anywhere in the port's seed chunks."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        states, hists, sss = _run("port", case)
    ref_states, ref_hists, ref_sss = _run("ref", case)
    for j, (st, h, ss) in enumerate(zip(_singles(case), hists, [
            engine.index_seed(sss, j) for j in range(SEEDS)])):
        pj = engine.index_seed(states, j)
        rj = jax.tree.map(lambda x: x[j], ref_states._replace(spec=None))
        _assert_seed(pj, h, ss, rj, ref_hists[j],
                     jax.tree.map(lambda x: x[j], ref_sss), 1e-4)
        _assert_seed(pj, h, ss, st[0], st[1], st[2], 1e-6)


def test_stack_and_index_seed_round_trip():
    """``stack_seeds`` stacks every tensor leaf (an FLState with its
    FlatSpec, None fields and an empty extra) and ``index_seed`` gives
    each seed back bit for bit; mismatched trees are refused."""
    parts = [setup("port", "fedawe", seed=j)["state"] for j in range(SEEDS)]
    stacked = engine.stack_seeds(parts)
    assert stacked.spec == parts[0].spec and stacked.fault is None
    assert stacked.global_tr.shape == (SEEDS,) + parts[0].global_tr.shape
    for j, p in enumerate(parts):
        back = engine.index_seed(stacked, j)
        assert back.spec == p.spec and back.extra == ()
        for name in ("global_tr", "clients_tr", "tau", "t", "markov", "rng"):
            assert torch.equal(getattr(back, name), getattr(p, name)), name
    with pytest.raises(ValueError, match="structure"):
        engine.stack_seeds([parts[0], parts[1]._replace(clients_tr=None)])
    with pytest.raises(ValueError, match="at least one"):
        engine.stack_seeds([])


def test_seed_keys_and_sampler_states_equal_the_reference():
    """``seed_data_keys`` is row j = fold_in(key, j), bit-equal to the
    reference's; ``init_seed_sampler_states`` stacks each seed's epoch
    carry, bit-equal to the reference's."""
    keys = fed.seed_data_keys(prng.PRNGKey(42, "cpu"), 4)
    want = ref_fed.seed_data_keys(jax.random.PRNGKey(42), 4)
    _exact(keys, want, "seed_data_keys")
    for j in range(4):
        assert torch.equal(keys[j], prng.fold_in(prng.PRNGKey(42, "cpu"), j))
    port = setup("port", sampling="epoch")
    refp = setup("ref", sampling="epoch")
    got = fed.init_seed_sampler_states(port["init_fn"], port["store"], keys)
    ref_ss = ref_fed.init_seed_sampler_states(refp["init_fn"], refp["store"],
                                              want)
    assert_carry_equal(got, ref_ss)
    assert got["perm"].shape[0] == 4
    assert fed.init_seed_sampler_states(
        setup("port")["init_fn"], port["store"], keys) == {}


def test_executor_checks_its_arguments():
    """K and S must be >= 1, the round function must carry its seeds
    form, and the states must hold the executor's seed count."""
    p = setup("port")
    with pytest.raises(ValueError, match="chunk_rounds"):
        core.make_seeds_chunk_fn(None, p["round_fn"], p["sample_fn"], 0, 2)
    with pytest.raises(ValueError, match="n_seeds"):
        core.make_seeds_chunk_fn(None, p["round_fn"], p["sample_fn"], 2, 0)
    with pytest.raises(ValueError, match="seed-batched form"):
        core.make_seeds_chunk_fn(None, lambda st, b: (st, {}),
                                 p["sample_fn"], 2, 2)
    chunk = core.make_seeds_chunk_fn(None, p["round_fn"], p["sample_fn"],
                                     1, 3)
    states = engine.stack_seeds([p["state"]] * 2)
    with pytest.raises(ValueError, match="built for 3"):
        chunk(states, {}, p["store"], fed.seed_data_keys(p["data_key"], 2))
    with pytest.raises(ValueError, match="at least one cell"):
        core.make_grid_chunk_fn([], 1, 2)


@pytest.mark.parametrize("strategy", ["fedavg_active", "fedawe"])
def test_stateless_seed_start_stays_a_view(strategy, monkeypatch):
    """At S > 1 a stateless strategy's local SGD starts from
    ``global[:, None].expand(S, m, N)``: every leaf a stride-0 view over
    the client axis of the seed-stacked global's storage (no [S·m, N]
    copy), each seed's clients at that seed's global; FedAWE starts from
    its stack."""
    seen = []
    real = engine.local_sgd

    def spy(trainable, *a, **kw):
        seen.append(trainable)
        return real(trainable, *a, **kw)

    monkeypatch.setattr(engine, "local_sgd", spy)
    p = setup("port", strategy)
    states = engine.stack_seeds([setup("port", strategy, seed=j)["state"]
                                 for j in range(SEEDS)])
    chunk = core.make_seeds_chunk_fn(None, p["round_fn"], p["sample_fn"],
                                     1, SEEDS)
    chunk(states, {}, p["store"], fed.seed_data_keys(p["data_key"], SEEDS))
    leaves = [seen[0]["w"], seen[0]["b"]]
    for leaf in leaves:
        assert leaf.shape[:2] == (SEEDS, M)
    if strategy == "fedawe":
        assert all(leaf.stride(1) != 0 for leaf in leaves)
        return
    ptr = states.global_tr.untyped_storage().data_ptr()
    for leaf in leaves:
        assert leaf.stride(1) == 0
        assert leaf.untyped_storage().data_ptr() == ptr
    for j in range(SEEDS):
        g = states.spec.unflatten(states.global_tr[j])
        for leaf, want in zip(leaves, (g["w"], g["b"])):
            for i in range(M):
                assert torch.equal(leaf[j, i], want)


# ---------------------------------------------------------------------------
# the echo-aggregate kernel's seed axis (its plain version here)
# ---------------------------------------------------------------------------

def _seed_operands(S, m, n, seed, upload=False):
    rng = np.random.default_rng(seed)
    a = dict(x=rng.normal(size=(S, m, n)), y=rng.normal(size=(S, m, n)),
             g=rng.normal(size=(S, n)),
             mask=(rng.random((S, m)) < 0.6).astype(np.float32),
             echo=rng.integers(1, 9, (S, m)).astype(np.float32),
             upload=(0.8 ** rng.integers(0, 4, (S, m))) if upload else None)
    return {k: None if v is None else torch.from_numpy(
        np.asarray(v, np.float32)) for k, v in a.items()}


@pytest.mark.parametrize("upload", [False, True])
def test_batched_plain_k1_bit_equal_per_seed(upload, monkeypatch):
    """Under ``torch.func.vmap`` over seeds, ``ops.echo_aggregate_flat``
    reaches its custom operator's vmap rule, which makes ONE call on the
    [S, m, N] stacks; each seed's row is bit-equal to the single-seed
    call, to ``echo_aggregate_fused_ref`` on the stacks and to the split
    oracle's per-seed rows up to its own roundings.  A seed with an
    all-zero mask returns its global exactly."""
    S, m, n = 4, 9, 37
    a = _seed_operands(S, m, n, seed=3, upload=upload)
    a["mask"][2] = 0.0
    shapes = []
    real = ops.echo_aggregate_fused_ref

    def spy(x, *args, **kw):
        shapes.append(tuple(x.shape))
        return real(x, *args, **kw)

    monkeypatch.setattr(ops, "echo_aggregate_fused_ref", spy)

    def one(x, y, g, mask, echo, up):
        return ops.echo_aggregate_flat(x, y, g, mask, echo, 1.7, upload=up)

    if upload:
        got = torch.func.vmap(one)(a["x"], a["y"], a["g"], a["mask"],
                                   a["echo"], a["upload"])
    else:
        got = torch.func.vmap(lambda *t: one(*t, None))(
            a["x"], a["y"], a["g"], a["mask"], a["echo"])
    assert shapes == [(S, m, n)]
    singles = torch.stack([ops.echo_aggregate_flat(
        a["x"][j], a["y"][j], a["g"][j], a["mask"][j], a["echo"][j], 1.7,
        upload=None if a["upload"] is None else a["upload"][j])
        for j in range(S)])
    assert torch.equal(got, singles)
    assert torch.equal(got, real(a["x"], a["y"], a["g"], a["mask"],
                                 a["echo"], 1.7, upload=a["upload"]))
    assert torch.equal(got[2], a["g"][2])
    split = ref.echo_aggregate_split_ref(a["x"], a["y"], a["g"], a["mask"],
                                         a["echo"], 1.7, slices=2,
                                         upload=a["upload"])
    for j in range(S):
        assert torch.equal(split[j], ref.echo_aggregate_split_ref(
            a["x"][j], a["y"][j], a["g"][j], a["mask"][j], a["echo"][j],
            1.7, slices=2,
            upload=None if a["upload"] is None else a["upload"][j]))
    np.testing.assert_allclose(split.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_vmap_rule_broadcasts_unbatched_operands():
    """The vmap rule brings an operand that is not batched (one global for
    every seed, a stride-0 start) to the seed axis, as the batched round
    can hand it over."""
    S, m, n = 3, 5, 11
    a = _seed_operands(S, m, n, seed=5)
    g0 = a["g"][0]
    x0 = a["x"][0]
    got = torch.func.vmap(
        lambda y, mask, echo: ops.echo_aggregate_flat(
            x0, y, g0, mask, echo, 0.5))(a["y"], a["mask"], a["echo"])
    for j in range(S):
        assert torch.equal(got[j], ops.echo_aggregate_flat(
            x0, a["y"][j], g0, a["mask"][j], a["echo"][j], 0.5))


def test_seed_stack_checks_and_geometry():
    """``_check`` takes [S, m, N] stacks with [S, m] vectors and [S, N]
    globals and refuses mismatches; ``launch_geometry`` counts the seed
    axis in its one-wave test, so seeds can lower the slice count."""
    a = _seed_operands(2, 4, 6, seed=1)
    ops._check(a["x"], a["y"], dict(mask=a["mask"], echo=a["echo"]),
               g=a["g"])
    with pytest.raises(ValueError, match="mask"):
        ops._check(a["x"], a["y"], dict(mask=a["mask"][0], echo=a["echo"]),
                   g=a["g"])
    with pytest.raises(ValueError, match="global"):
        ops._check(a["x"], a["y"], dict(mask=a["mask"], echo=a["echo"]),
                   g=a["g"][0])
    with pytest.raises(ValueError, match=r"\[m, N\]"):
        ops._check(a["x"][None], a["y"][None], {})
    assert ops.launch_geometry(16384, 27370, 4, 132) == (256, 3)
    assert ops.launch_geometry(16384, 27370, 4, 132, seeds=1) == (256, 3)
    assert ops.launch_geometry(16384, 27370, 4, 132, seeds=4) == (256, 1)
    assert ops.launch_geometry(100, 27370, 4, 132, seeds=4) == (256, 1)
    out = ops.echo_aggregate_flat(a["x"], a["y"], a["g"], a["mask"],
                                  a["echo"], 1.0)
    assert out.shape == (2, 6) and out.dtype == torch.float32


def test_custom_operator_passes_opcheck():
    """The operator's schema, fake implementation and dispatch agree
    (``torch.library.opcheck``), with and without upload weights."""
    a = _seed_operands(2, 4, 6, seed=2, upload=True)
    for up in (None, a["upload"][0]):
        torch.library.opcheck(
            ops._fused_op, (a["x"][0], a["y"][0], a["g"][0], a["mask"][0],
                            a["echo"][0], 1.5, up),
            test_utils=("test_schema", "test_faketensor"))


def test_unit_floats_need_no_dtype_view():
    """``prng._unit_floats`` takes a batching rule in every supported
    torch (a dtype ``view`` has none in some) and gives the bits of the
    reference's construction, ``float32(0x3F800000 | mantissa) - 1``, for
    every one of the 2**23 mantissas; under ``torch.func.vmap`` a key
    stack draws what each key draws alone."""
    mant = torch.arange(1 << 23, dtype=torch.int64)
    want = (mant | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    assert torch.equal(mant.to(torch.float32) * 2.0 ** -23, want)
    keys = prng.split(prng.PRNGKey(7, "cpu"), 3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = torch.func.vmap(lambda k: prng.uniform(k, (5,)))(keys)
    for j in range(3):
        assert torch.equal(got[j], prng.uniform(keys[j], (5,)))
