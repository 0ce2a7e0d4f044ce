"""The port's seed mesh (``launch/mesh.py``) and the grid's seed-mesh
runners (``launch/experiments.py``: ``seed_shards``,
``build_seed_executor(mesh=)``, ``place_seed_batch``,
``run_packed_group(mesh=)``, ``--seed-mesh``), on CPU "devices".

A seed mesh splits the ``[S, ...]`` carries into its seed-axis size of
contiguous shards, each run by its own seed chunk on the first device of
its sub-mesh.  Placement changes no number, so the mesh run is held
against the port's own unsplit S-seed chunk: counts, τ, keys, markov
states and sampler carries bit-equal, states within 1e-6 (the
tolerances of tests/test_torch_seeds.py).  It is held against the
reference's single-seed chunked runs too (within 1e-4, counts and keys
bit-equal): the reference's own seed-mesh executor fails its tests here,
so it is no oracle.  Both replication modes, a ``T % K`` tail, unpacked
and packed, over 2 and 4 devices."""
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import jax  # noqa: E402

from repro import core as ref_core  # noqa: E402
from repro.launch.mesh import seed_mesh_shape as ref_shape  # noqa: E402
from repro_torch.core import index_seed, prng  # noqa: E402
from repro_torch.launch import experiments as ex  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402

from _torch_fl_small import (DIM, EXACT, _leaves,  # noqa: E402,I100
                             assert_parity, drive, setup)

SEEDS, T, K = 4, 5, 2
#: two cells: FedAWE through the kernel's route (its plain version on the
#: CPU) under uniform sampling, MIFA (a strategy memory) under markov
#: availability and epoch sampling (a sampler carry)
CELLS = {"fedawe-sine-uniform": dict(strategy="fedawe", kind="sine",
                                     sampling="uniform", use_kernel=True),
         "mifa-markov-epoch": dict(strategy="mifa", kind="markov",
                                   sampling="epoch")}


# ---------------------------------------------------------------------------
# sizing
# ---------------------------------------------------------------------------

def test_seed_mesh_shape_equals_the_reference():
    for s in range(1, 13):
        for n in range(0, 17):
            for multi_pod in (False, True):
                assert mesh.seed_mesh_shape(s, n, multi_pod=multi_pod) == \
                    ref_shape(s, n, multi_pod=multi_pod), (s, n, multi_pod)


def test_make_seed_mesh_over_explicit_devices():
    cpu = torch.device("cpu")
    m = mesh.make_seed_mesh(SEEDS, devices=["cpu"] * 6)
    assert m.axis_names == ("seed", "pod", "data")
    assert m.shape == (2, 1, 3) and m.devices == (cpu,) * 6
    assert mesh.mesh_axis_sizes(m) == {"seed": 2, "pod": 1, "data": 3}
    assert mesh.n_chips(m) == 6
    assert mesh.make_seed_mesh(SEEDS, devices=[cpu] * 4).shape == (4, 1, 1)
    assert mesh.make_seed_mesh(SEEDS, multi_pod=True,
                               devices=[cpu] * 4).shape == (2, 2, 1)
    # test caps the mesh at 8 devices
    m = mesh.make_seed_mesh(8, test=True, devices=[cpu] * 12)
    assert m.shape == (8, 1, 1) and len(m.devices) == 8
    # shards: contiguous seed rows, each on its sub-mesh's first device
    m = mesh.SeedMesh(("seed", "pod", "data"), (2, 1, 2),
                      (cpu, torch.device("meta"), cpu, cpu))
    assert ex.seed_shards(m, 6) == [(cpu, slice(0, 3)), (cpu, slice(3, 6))]
    with pytest.raises(ValueError, match="do not split"):
        ex.seed_shards(m, 5)
    with pytest.raises(ValueError, match="needs 4 devices"):
        mesh.SeedMesh(("seed", "pod", "data"), (2, 1, 2), (cpu,))


def test_make_seed_mesh_falls_back_without_a_seed_axis():
    """When even the pod axis does not fit, the mesh has no 'seed' axis
    and every seed stays in one shard on its first device."""
    cpu = torch.device("cpu")
    m = mesh.make_seed_mesh(SEEDS, multi_pod=True, devices=[cpu])
    assert "seed" not in m.axis_names
    assert m.axis_names == ("data",) and m.devices == (cpu,)
    assert ex.seed_shards(m, SEEDS) == [(cpu, slice(0, SEEDS))]
    with pytest.raises(RuntimeError, match="at least one device"):
        mesh.make_seed_mesh(SEEDS, devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="at least one device"):
            mesh.make_seed_mesh(SEEDS)


# ---------------------------------------------------------------------------
# the executor under the mesh
# ---------------------------------------------------------------------------

def _port_template(key):
    k1, k2 = prng.split(key)
    return {"w": prng.normal(k1, (DIM, DIM)) * 0.1,
            "b": prng.normal(k2, (7,)) * 0.01}


def _ref_template(key):
    k1, k2 = jax.random.split(key)
    return {"w": jax.random.normal(k1, (DIM, DIM)) * 0.1,
            "b": jax.random.normal(k2, (7,)) * 0.01}


def _cell(name, replicate):
    """A fresh packed-cell dict of the port (the carry of S seeds)."""
    kw = CELLS[name]
    p = setup("port", kw["strategy"], kind=kw["kind"],
              sampling=kw["sampling"], use_kernel=kw.get("use_kernel", False))
    states, sss, dks = ex.build_seed_batch(
        p["cfg"], p["template"], prng.PRNGKey(0, "cpu"),
        prng.PRNGKey(42, "cpu"), p["init_fn"], p["store"], SEEDS,
        template_fn=_port_template if replicate == "full" else None)
    return dict(fl=p["cfg"], round_fn=p["round_fn"],
                sample_fn=p["sample_fn"], store=p["store"], states=states,
                sampler_states=sss, data_keys=dks, eval_fn=None, seeds=SEEDS,
                rounds=T, K=K)


def _run(cell, m):
    """``(states, histories, sampler carry)`` of T rounds of ``cell``'s S
    seeds, K per call with a tail, over the mesh ``m`` (None: unsplit)."""
    b = ex.build_seed_executor(cell["fl"], cell["round_fn"],
                               cell["sample_fn"], SEEDS, mesh=m)
    st, ss, store, dk = ex.place_seed_batch(
        b.shards, cell["states"], cell["sampler_states"], cell["store"],
        cell["data_keys"])
    if m is not None:
        assert isinstance(st, ex.SeedShards) and len(st) == len(b.shards)
    got = {}

    def grab(states, done, sampler_states):
        got["ss"] = sampler_states

    st, hists = ex.run_seed_rounds(
        st, b(K), T, K, sampler_states=ss, store=store, data_keys=dk,
        n_seeds=SEEDS, make_tail_fn=b, ckpt_fn=grab, ckpt_every=T)
    return st, hists, got["ss"]


@functools.lru_cache(maxsize=None)
def _ref_singles(name, replicate):
    """The reference's S single-seed chunked runs of ``name``: seed j
    keyed fold_in(0, j) / fold_in(42, j), under full replication its
    template drawn from fold_in(0, j)."""
    kw = CELLS[name]
    out = []
    for j in range(SEEDS):
        p = setup("ref", kw["strategy"], kind=kw["kind"],
                  sampling=kw["sampling"],
                  use_kernel=kw.get("use_kernel", False), seed=j)
        if replicate == "full":
            key = jax.random.fold_in(jax.random.PRNGKey(0), j)
            p["state"] = ref_core.init_fl_state(key, p["cfg"],
                                                _ref_template(key))
        out.append(drive("ref", p, T, chunk=True, K=K, carry=True))
    return out


def _same_bits(a, b, what):
    assert torch.equal(a, b), what


def _assert_split_equals_unsplit(got, want):
    """The mesh run against the unsplit one: counts, τ, keys, t, markov
    and the sampler carry bit-equal; losses and states within 1e-6."""
    (gs, gh, gss), (ws, wh, wss) = got, want
    assert len(gh) == len(wh) == SEEDS
    for g_seed, w_seed in zip(gh, wh):
        assert len(g_seed) == len(w_seed) == T
        for g, w in zip(g_seed, w_seed):
            assert set(g) == set(w)
            for k in w:
                if k in EXACT:
                    assert g[k] == w[k], (k, g[k], w[k])
                else:
                    np.testing.assert_allclose(g[k], w[k], rtol=1e-6,
                                               atol=1e-6)
    for name in ("tau", "rng", "t", "markov"):
        _same_bits(getattr(gs, name), getattr(ws, name), name)
    for name in ("global_tr", "clients_tr", "extra"):
        ga, wa = _leaves(getattr(gs, name)), _leaves(getattr(ws, name))
        assert set(ga) == set(wa), name
        for k in wa:
            np.testing.assert_allclose(ga[k].numpy(), wa[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    ga, wa = _leaves(gss), _leaves(wss)
    assert set(ga) == set(wa)
    for k in wa:
        _same_bits(ga[k], wa[k], k)


def _assert_against_reference(states, hists, name, replicate):
    for j, ref in enumerate(_ref_singles(name, replicate)):
        assert_parity(ref, (index_seed(states, j), hists[j]), tol=1e-4)


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("replicate", ["shared", "full"])
def test_mesh_executor_equals_the_unsplit_chunk(n_dev, replicate):
    m = mesh.make_seed_mesh(SEEDS, devices=["cpu"] * n_dev)
    assert m.shape == (n_dev, 1, 1)
    for name in CELLS:
        got = _run(_cell(name, replicate), m)
        want = _run(_cell(name, replicate), None)
        _assert_split_equals_unsplit(got, want)
        _assert_against_reference(got[0], got[1], name, replicate)
        for j, ref in enumerate(_ref_singles(name, replicate)):
            ss = {k: v[j] for k, v in _leaves(got[2]).items()}
            want_ss = _leaves(ref[2])
            assert set(ss) == set(want_ss)
            for k in want_ss:
                np.testing.assert_array_equal(
                    ss[k].numpy(),
                    np.asarray(want_ss[k]).astype(ss[k].numpy().dtype))


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("replicate", ["shared", "full"])
def test_packed_mesh_equals_the_unsplit_cells(n_dev, replicate):
    """Both cells packed into one group over the mesh (the tail kept on
    the mesh) against each cell's unsplit, unpacked run."""
    m = mesh.make_seed_mesh(SEEDS, devices=["cpu"] * n_dev)
    states_t, hists_t = ex.run_packed_group(
        [_cell(name, replicate) for name in CELLS], mesh=m)
    for name, st, hs in zip(CELLS, states_t, hists_t):
        assert not isinstance(st, ex.SeedShards)
        ws, wh, _ = _run(_cell(name, replicate), None)
        assert len(hs) == SEEDS
        for g_seed, w_seed in zip(hs, wh):
            for g, w in zip(g_seed, w_seed):
                assert set(g) == set(w)
                for k in w:
                    if k in EXACT:
                        assert g[k] == w[k], (k, g[k], w[k])
                    else:
                        np.testing.assert_allclose(g[k], w[k], rtol=1e-6,
                                                   atol=1e-6)
        for f in ("tau", "rng", "t", "markov"):
            _same_bits(getattr(st, f), getattr(ws, f), f)
        np.testing.assert_allclose(st.global_tr.numpy(),
                                   ws.global_tr.numpy(), rtol=1e-6,
                                   atol=1e-6)
        _assert_against_reference(st, hs, name, replicate)


def test_mesh_refuses_tree_state():
    p = setup("port", "fedawe", flat=False)
    m = mesh.make_seed_mesh(SEEDS, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="flat"):
        ex.build_seed_executor(p["cfg"], p["round_fn"], p["sample_fn"],
                               SEEDS, mesh=m)


def test_each_shard_device_gets_its_round():
    """A round carrying ``on`` is built once per distinct shard device; a
    round without it runs on every shard as it is."""
    built = []

    def rf(state, batches):
        return state, {}

    rf.on = lambda dev: built.append(dev) or rf
    cpu = torch.device("cpu")
    shards = [(cpu, slice(0, 1)), (cpu, slice(1, 2))]
    assert ex._round_fns(rf, shards) == {cpu: rf} and built == [cpu]

    def plain(state, batches):
        return state, {}

    assert ex._round_fns(plain, shards) == {cpu: plain}


def test_join_seed_shards_restores_seed_order():
    a = {"x": torch.arange(6.).reshape(3, 2), "s": None}
    shards = ex.SeedShards(ex._on(a, "cpu", r)
                           for r in (slice(0, 1), slice(1, 3)))
    assert shards[1]["x"].shape == (2, 2)
    joined = ex.join_seed_shards(shards)
    assert torch.equal(joined["x"], a["x"]) and joined["s"] is None
    assert ex.join_seed_shards(a) is a
    # a shard is a copy: writing it leaves the original alone
    shards[0]["x"].zero_()
    assert a["x"][0, 1] == 1.0


def test_cli_seed_mesh_prints_the_mesh_and_matches_the_unsplit_grid(capsys):
    flags = ["--scenario", "fedawe/sine", "--seeds", "2", "--rounds", "3",
             "--chunk-rounds", "2", "--m", "6", "--s", "2", "--batch", "4",
             "--n-samples", "600", "--use-kernel", "--no-save", "--device",
             "cpu"]
    rows = ex.main(flags + ["--seed-mesh"])
    out = capsys.readouterr().out
    assert "seed mesh: {'seed': 1, 'pod': 1, 'data': 1}\n" in out
    assert rows == ex.main(flags)
    packed = ex.main(flags + ["--seed-mesh", "--packed"])
    assert packed == rows
