"""The port's tree-state round (``FLConfig.flat_state=False``, the JAX
package's default substrate) against the JAX package's, on the small
problem of tests/_torch_fl_small.py (a two-leaf linear model, M = 8
clients, s = 3) and on the paper harness's two MLP models, from the same
numpy inputs and keys.

Held against the reference: all ten strategies, fault-free and under
mid-round dropout with sanitization, FedAWE and FedAWE-M with the kernel
off and on (the reference's Pallas kernel in interpret mode, the port's
plain version of K1 / K2 on the CPU).  Masks, τ, keys and counts
bit-equal; globals, client stacks and memories within 1e-4
(tests/test_engine_kernel_path.py's bound).  Inside the port: the host
loop against the chunked executor exactly, tree state against the flat
substrate, and every seed of a 2-seed tree run against its single-seed
run, the kernel route one call a round for both seeds; a tree-state grid
cell through ``run_scenario`` as the reference's.  Checkpoints of
tree state cross between the packages both ways, and a resumed tree run
lands on its uninterrupted twin bit for bit.  Building a state or a round
through the engine applies the float32 policy (TF32 off), and only
staleness and the cohort refuse tree state."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpointing as ref_ckpt  # noqa: E402
from repro import core as ref_core  # noqa: E402
from repro.data import FederatedDataset as RefDataset  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch import checkpointing as ckpt  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.checkpointing import params_from_numpy  # noqa: E402
from repro_torch.core import FlatSpec, engine, prng  # noqa: E402
from repro_torch.data import FederatedDataset  # noqa: E402
from repro_torch.data import dirichlet_partition  # noqa: E402
from repro_torch.data import make_image_classification  # noqa: E402
from repro_torch.kernels.echo_aggregate import ops  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

from _torch_fl_small import (EXACT, _leaves,  # noqa: E402,I100
                             assert_carry_equal, assert_parity,
                             assert_same_port, drive, run, setup)

STRATEGIES = ("fedawe", "fedawe_m", "fedavg_active", "fedavg_all",
              "fedavg_known_p", "fedau", "f3ast", "mifa", "fedvarp",
              "fedar")
MIDROUND = dict(upload_survival=0.7, sanitize=True)
FAULTS = {"sync": None, "midround": MIDROUND}
#: (strategy, use_kernel): the kernel changes only FedAWE's server update
CASES = [(s, False) for s in STRATEGIES] + [("fedawe", True),
                                           ("fedawe_m", True)]


def _ids(case):
    return f"{case[0]}-kernel" if case[1] else case[0]


@pytest.fixture
def k1_calls(monkeypatch):
    """Shapes of the stacks each plain K1 / K2 call gets on the CPU (the
    operator's one call a round, whatever the leaf or seed count)."""
    calls = []
    plain = ops.echo_aggregate_fused_ref

    def counting(x, *args, **kw):
        calls.append(tuple(x.shape))
        return plain(x, *args, **kw)

    monkeypatch.setattr(ops, "echo_aggregate_fused_ref", counting)
    return calls


# ---------------------------------------------------------------------------
# the round against the reference's tree path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tree_round_matches_reference(case, fault, k1_calls):
    """T = 6: the reference's host loop against the port's chunked
    executor (two chunks of K = 3), and the port's host loop against its
    chunked run exactly.  Every strategy keeps a tree client stack, as in
    the reference; the kernel route is one K1 (K2 under faults) call a
    round on the raveled [M, 23] stack."""
    strategy, use_kernel = case
    kw = dict(flat=False, use_kernel=use_kernel)
    port = run("port", strategy, FAULTS[fault], chunk=True, K=3, **kw)
    assert_parity(run("ref", strategy, FAULTS[fault], **kw), port)
    state, hist = port
    assert state.spec is None
    assert set(state.global_tr) == set(state.clients_tr) == {"w", "b"}
    assert state.clients_tr["w"].shape == (8, 4, 4)
    assert all(bool(torch.isfinite(x).all())
               for x in state.global_tr.values())
    assert sum(r["n_active"] for r in hist) > 0
    if fault != "sync":
        assert sum(r["n_dropped"] for r in hist) > 0
    assert k1_calls == ([(8, 23)] * 6 if use_kernel else [])
    assert_same_port(run("port", strategy, FAULTS[fault], **kw), port)


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tree_against_flat_in_the_port(case, fault):
    """The same run on both substrates of the port: histories' counts, τ,
    keys and the sampler stream bit-equal, the tree global raveled within
    1e-4 of the flat one."""
    strategy, use_kernel = case
    tree = run("port", strategy, FAULTS[fault], flat=False,
               use_kernel=use_kernel)
    flat = run("port", strategy, FAULTS[fault], use_kernel=use_kernel)
    for g, w in zip(tree[1], flat[1]):
        assert {k: g[k] for k in EXACT if k in g} \
            == {k: w[k] for k in EXACT if k in w}
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4,
                                   atol=1e-4)
    for name in ("tau", "rng", "t", "markov"):
        assert torch.equal(getattr(tree[0], name), getattr(flat[0], name))
    spec = FlatSpec.from_tree(tree[0].global_tr)
    np.testing.assert_allclose(spec.flatten(tree[0].global_tr).numpy(),
                               flat[0].global_tr.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", [("fedawe", True), ("fedawe_m", True),
                                  ("mifa", False)], ids=_ids)
def test_tree_seeds_match_single_runs(case, k1_calls):
    """2 seeds of the tree run through the seed executor (T = 5, K = 2,
    a tail chunk), under faults: each seed's counts, τ, keys and sampler
    carry bit-equal to its single-seed chunked run, its global and client
    stack equal; with the kernel one K1 / K2 call a round over the
    [2, M, 23] stack of both seeds."""
    from repro_torch.launch import experiments as ex

    strategy, use_kernel = case
    kw = dict(flat=False, use_kernel=use_kernel)
    p = setup("port", strategy, MIDROUND, **kw)
    states, sss, dks = ex.build_seed_batch(
        p["cfg"], p["template"], prng.PRNGKey(0, "cpu"),
        prng.PRNGKey(42, "cpu"), p["init_fn"], p["store"], 2,
        fault=p["fault"])
    got = {}

    def chunk_of(k):
        return core.make_seeds_chunk_fn(p["cfg"], p["round_fn"],
                                        p["sample_fn"], k, 2)

    states, hists = ex.run_seed_rounds(
        states, chunk_of(2), 5, 2, sampler_states=sss, store=p["store"],
        data_keys=dks, n_seeds=2, make_tail_fn=chunk_of,
        ckpt_fn=lambda st, done, ss: got.update(ss=ss), ckpt_every=5)
    assert k1_calls == ([(2, 8, 23)] * 5 if use_kernel else [])
    for j in range(2):
        single, hist, carry = drive(
            "port", setup("port", strategy, MIDROUND, seed=j, **kw), 5,
            chunk=True, K=2, carry=True)
        sj = engine.index_seed(states, j)
        assert hists[j] == hist
        for name in ("tau", "rng", "t", "markov"):
            assert torch.equal(getattr(sj, name), getattr(single, name))
        for name in ("global_tr", "clients_tr", "extra"):
            a, b = _leaves(getattr(sj, name)), _leaves(getattr(single,
                                                                name))
            assert set(a) == set(b)
            for k in a:
                assert torch.equal(a[k], b[k]), (name, k)
        assert_carry_equal(engine.index_seed(got["ss"], j), carry)


def test_tree_scenario_cell_matches_the_reference():
    """A grid cell on tree state (``Scenario(flat_state=False)``) runs
    through ``run_scenario`` in both packages (the reduced CNN, 3 seeds,
    a tail chunk, the kernel's plain version on the CPU): counts
    bit-equal per seed and round, losses within 1e-4."""
    import dataclasses

    from repro.launch import experiments as rx
    from repro_torch.launch import experiments as px

    small = dict(seeds=3, rounds=5, chunk_rounds=2, m=6, s=2, batch=4,
                 n_samples=600, use_kernel=True)
    got = px.run_scenario(dataclasses.replace(
        px.get_scenario("fedawe/sine"), flat_state=False), device="cpu",
        **small)
    want = rx.run_scenario(dataclasses.replace(
        rx.get_scenario("fedawe/sine"), flat_state=False), **small)
    for hg, hw in zip(got["histories"], want["histories"]):
        assert len(hg) == len(hw) == small["rounds"]
        for g, w in zip(hg, hw):
            assert set(g) == set(w)
            for k in w:
                if k in EXACT:
                    assert g[k] == w[k], (k, g[k], w[k])
                else:
                    np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                               atol=1e-4)


# ---------------------------------------------------------------------------
# the paper harness's models on the tree round
# ---------------------------------------------------------------------------

def _harness_run(pkg, hidden, T=6, m=8, s=2, b=4):
    """The harness's run_fl loop (benchmarks/common.py) at a small size:
    FedAWE with the kernel on tree state, host batches from
    ``round_batches``, the MLP's weights drawn by the reference and
    carried across as numpy."""
    task = make_image_classification(seed=0, n=800, shape=(8, 8, 1))
    idx, nu = dirichlet_partition(np.random.default_rng(0), task.labels, m,
                                  alpha=0.05, min_per_client=b)
    arrays = dict(images=task.images, labels=task.labels)
    params = jax.tree.map(np.asarray, ref_cnn.init_mlp(
        jax.random.PRNGKey(0), d_in=64, n_classes=10, hidden=hidden))
    base_p = np.clip(nu @ np.linspace(1.0, 0.05, 10), 0.02, 1.0)
    av = dict(kind="sine", gamma=0.9, period=8)
    if pkg == "ref":
        ds = RefDataset(arrays, idx, seed=0)
        cfg = ref_core.FLConfig(m=m, s=s, strategy="fedawe",
                                use_kernel=True)
        rf = jax.jit(ref_core.make_round_fn(
            cfg, ref_cnn.make_image_loss_fn(ref_cnn.mlp_apply), {},
            ref_core.AvailabilityCfg(**av),
            jnp.asarray(base_p.astype(np.float32))))
        state = ref_core.init_fl_state(jax.random.PRNGKey(0), cfg,
                                       jax.tree.map(jnp.asarray, params))
        put = jnp.asarray
    else:
        ds = FederatedDataset(arrays, idx, seed=0)
        cfg = core.FLConfig(m=m, s=s, strategy="fedawe", use_kernel=True)
        rf = core.make_round_fn(
            cfg, cnn.make_image_loss_fn(cnn.mlp_apply), {},
            core.AvailabilityCfg(**av),
            torch.from_numpy(base_p.astype(np.float32)))
        state = core.init_fl_state(prng.PRNGKey(0, "cpu"), cfg,
                                   params_from_numpy(params, "cpu"))
        put = torch.from_numpy
    hist = []
    for t in range(T):
        batches = {k: put(v) for k, v in ds.round_batches(t, s, b).items()}
        state, metrics = rf(state, batches)
        hist.append({k: float(v) for k, v in metrics.items()})
    return state, hist


@pytest.mark.parametrize("hidden", [(), (64,)], ids=["linear", "mlp"])
def test_harness_models_on_the_tree_round(hidden):
    """The harness's ``"linear"`` (N = 650) and ``"mlp"`` (N = 4 810)
    models: counts and τ bit-equal, losses, global and client stack
    within 1e-4 of the reference's tree run."""
    ref, port = _harness_run("ref", hidden), _harness_run("port", hidden)
    assert FlatSpec.from_tree(port[0].global_tr).size == \
        (650 if not hidden else 4810)
    for g, w in zip(port[1], ref[1]):
        assert g["n_active"] == w["n_active"]
        assert g["mean_echo"] == w["mean_echo"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4,
                                   atol=1e-4)
    assert 0 < sum(h["n_active"] for h in port[1]) < 6 * 8
    np.testing.assert_array_equal(port[0].tau.numpy(),
                                  np.asarray(ref[0].tau))
    for name in ("global_tr", "clients_tr"):
        got, want = _leaves(getattr(port[0], name)), _leaves(getattr(
            ref[0], name))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# checkpoints of tree state
# ---------------------------------------------------------------------------

#: a memory strategy under faults (its memory a tree), FedAWE-M's
#: momentum tree with the kernel
CKPT_RUNS = {"mifa-faults": ("mifa", MIDROUND, False),
             "fedawe_m-kernel": ("fedawe_m", None, True)}


def _ckpt_parts(pkg, name):
    strategy, fault, use_kernel = CKPT_RUNS[name]
    return setup(pkg, strategy, fault, sampling="epoch", flat=False,
                 use_kernel=use_kernel)


def _save_at(pkg, name, path, T):
    save = (ckpt if pkg == "port" else ref_ckpt).save_run_state
    state, _ = drive(pkg, _ckpt_parts(pkg, name), T, chunk=True, K=2,
                     ckpt_fn=lambda st, t, ss: save(path, st, ss,
                                                    round_t=t),
                     ckpt_every=T)
    return state


def _resume(pkg, name, path, T, *, chunk=True):
    parts = _ckpt_parts(pkg, name)
    restore = (ckpt if pkg == "port" else ref_ckpt).restore_run_state
    parts["state"], parts["sampler_state"] = restore(
        path, parts["state"], parts["sampler_state"])
    return drive(pkg, parts, T, chunk=chunk, K=2, carry=True)


@pytest.mark.parametrize("name", list(CKPT_RUNS))
def test_tree_checkpoint_crosses_both_ways(tmp_path, name):
    """The manifests of both packages' round-2 artifacts are equal (leaf
    paths such as ``fl/global_tr/w`` and ``fl/extra/mem/b``, shapes,
    dtypes); the reference's artifact continues in the port as in the
    reference, and the port's is read by the reference bit for bit and
    continues there alike."""
    for pkg in ("ref", "port"):
        _save_at(pkg, name, str(tmp_path / pkg), 2)
    got = json.load(open(tmp_path / "port.json"))
    assert got == json.load(open(tmp_path / "ref.json"))
    paths = [e["path"] for e in got["leaves"]]
    assert "fl/global_tr/w" in paths and "fl/clients_tr/b" in paths

    ref = _resume("ref", name, str(tmp_path / "ref"), 4)
    port = _resume("port", name, str(tmp_path / "ref"), 4)
    assert int(port[0].t) == 6
    assert_parity(ref, port)
    assert_carry_equal(port[2], ref[2])

    state = _save_at("port", name, str(tmp_path / "port"), 2)
    rparts = _ckpt_parts("ref", name)
    loaded = ref_ckpt.load_pytree(str(tmp_path / "port"), {
        "fl": rparts["state"]._asdict(), "sampler": rparts["sampler_state"]})
    for k, v in state.global_tr.items():
        np.testing.assert_array_equal(np.asarray(loaded["fl"]["global_tr"][k]),
                                      v.numpy())
    ref = _resume("ref", name, str(tmp_path / "port"), 2)
    port = _resume("port", name, str(tmp_path / "port"), 2)
    assert_parity(ref, port)
    assert_carry_equal(port[2], ref[2])


@pytest.mark.parametrize("name", list(CKPT_RUNS))
def test_tree_resume_bit_equal_to_uninterrupted(tmp_path, name):
    """Chunked to round 2 with an artifact, restored and finished in the
    host loop: bit for bit the uninterrupted 4-round run, carry
    included."""
    path = str(tmp_path / "tree")
    full = drive("port", _ckpt_parts("port", name), 4, chunk=True, K=2,
                 carry=True)
    _save_at("port", name, path, 2)
    rest = _resume("port", name, path, 2, chunk=False)
    assert full[1][2:] == [dict(r, t=r["t"] + 2) for r in rest[1]]
    assert_same_port(full[:2], (rest[0], full[1]))
    assert_carry_equal(full[2], rest[2])


# ---------------------------------------------------------------------------
# the engine's precision policy and the refusals left
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flat", [False, True], ids=["tree", "flat"])
def test_engine_builds_apply_the_float32_policy(flat):
    """With both TF32 flags set, building a state and a round through the
    engine (no launcher, no ``resolve_device``) turns both off."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    try:
        for f in flags:
            f.allow_tf32 = True
        cfg = core.FLConfig(m=4, flat_state=flat)
        core.init_fl_state(prng.PRNGKey(0, "cpu"), cfg,
                           {"w": torch.zeros(3)})
        assert not any(f.allow_tf32 for f in flags)
        for f in flags:
            f.allow_tf32 = True
        core.make_round_fn(cfg, None, {}, core.AvailabilityCfg(),
                           torch.full((4,), 0.5))
        assert not any(f.allow_tf32 for f in flags)
    finally:
        for f in flags:
            f.allow_tf32 = False


def test_only_staleness_and_the_cohort_refuse_tree_state():
    """As the reference asserts (engine.py:327, FLConfig): the ring and
    the cohort ride the flat substrate; tau_max = 0 is the synchronous
    round and builds."""
    cfg = core.FLConfig(m=4)
    with pytest.raises(ValueError, match="flat"):
        core.make_round_fn(cfg, None, {}, core.AvailabilityCfg(),
                           torch.full((4,), 0.5),
                           staleness_cfg=core.StalenessCfg(tau_max=2))
    core.make_round_fn(cfg, None, {}, core.AvailabilityCfg(),
                       torch.full((4,), 0.5),
                       staleness_cfg=core.StalenessCfg(tau_max=0))
    with pytest.raises(ValueError, match="flat"):
        core.FLConfig(m=4, sparse_cohort=2)
