"""The port's FedAWE flat training slice against repro.core.run_rounds:
T = 8 rounds, m = 8 clients, s = 2 local steps, batch 4, sine dynamics
(empty rounds occur), flat state, the echo-aggregate kernel path; from
the same weights (params_from_numpy) and the same keys.

n_active, τ and mean_echo must be exact (the port's PRNG draws the
reference's masks and batch columns bit for bit); the global [N] and the
losses within 1e-4, the reference's own kernel-vs-jnp bound
(tests/test_engine_kernel_path.py).  The port's host loop and chunked
mode must agree exactly.  A CLI case compares the two launchers' --out
histories."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import core as ref_core  # noqa: E402
from repro.core import availability as ref_av  # noqa: E402
from repro.data import federated as ref_fed  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.checkpointing import params_from_numpy  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import federated as fed  # noqa: E402
from repro_torch.data import make_image_classification  # noqa: E402
from repro_torch.data import dirichlet_partition  # noqa: E402
from repro_torch.kernels.echo_aggregate import ops  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

M, S, B, T, K = 8, 2, 4, 8, 4
WIDTHS = dict(channels=(8, 8), hidden=(16,))


@pytest.fixture(scope="module")
def setup():
    task = make_image_classification(seed=0, n=800)
    idx, nu = dirichlet_partition(np.random.default_rng(0), task.labels, M,
                                  alpha=0.1, min_per_client=B)
    arrays = dict(images=task.images, labels=task.labels)
    base_p = ref_av.base_probs_from_data(jax.random.PRNGKey(0),
                                         jax.numpy.asarray(nu))
    params = jax.tree.map(np.asarray, ref_cnn.init_cnn(
        jax.random.PRNGKey(0), in_shape=(8, 8, 1), **WIDTHS))
    return arrays, idx, base_p, params


def _reference(setup):
    arrays, idx, base_p, params = setup
    cfg = ref_core.FLConfig(m=M, s=S, strategy="fedawe", use_kernel=True,
                            flat_state=True)
    av = ref_av.AvailabilityCfg(kind="sine", gamma=0.9, period=8)
    round_fn = ref_core.make_round_fn(
        cfg, ref_cnn.make_image_loss_fn(ref_cnn.cnn_apply), {}, av, base_p)
    state = ref_core.init_fl_state(jax.random.PRNGKey(0), cfg,
                                   jax.tree.map(jax.numpy.asarray, params))
    store = ref_fed.device_store(arrays, idx)
    init, sample = ref_fed.make_device_sampler(M, S, B)
    data_key = jax.random.PRNGKey(1)
    state, hist = ref_core.run_rounds(
        state, round_fn, None, T, chunk_rounds=K, sample_fn=sample,
        store=store, data_key=data_key,
        sampler_state=init(store, data_key))
    return state, hist


def _port(setup, chunk_rounds):
    arrays, idx, base_p, params = setup
    cfg = core.FLConfig(m=M, s=S, strategy="fedawe", use_kernel=True,
                        flat_state=True)
    av = core.AvailabilityCfg(kind="sine", gamma=0.9, period=8)
    round_fn = core.make_round_fn(
        cfg, cnn.make_image_loss_fn(cnn.cnn_apply), {}, av,
        torch.from_numpy(np.array(base_p)))
    state = core.init_fl_state(prng.PRNGKey(0, "cpu"), cfg,
                               params_from_numpy(params, "cpu"))
    store = fed.device_store(arrays, idx, "cpu")
    init, sample = fed.make_device_sampler(M, S, B)
    data_key = prng.PRNGKey(1, "cpu")
    return core.run_rounds(
        state, round_fn, None, T, chunk_rounds=chunk_rounds,
        sample_fn=sample, store=store, data_key=data_key,
        sampler_state=init(store, data_key))


def test_slice_matches_reference_host_and_chunked(setup):
    ref_state, ref_hist = _reference(setup)
    ops.echo_aggregate_flat.launches = 0
    host_state, host_hist = _port(setup, 0)
    chunk_state, chunk_hist = _port(setup, K)
    # CPU tensors take the plain version: no kernel launch is counted
    assert ops.echo_aggregate_flat.launches == 0

    n_active = [h["n_active"] for h in ref_hist]
    assert 0.0 in n_active and max(n_active) > 0, n_active
    assert host_hist == chunk_hist
    for name in ("global_tr", "clients_tr", "tau", "t", "markov", "rng"):
        assert torch.equal(getattr(host_state, name),
                           getattr(chunk_state, name)), name

    for got, want in zip(chunk_hist, ref_hist):
        assert got["t"] == want["t"]
        assert got["n_active"] == want["n_active"]
        assert got["mean_echo"] == want["mean_echo"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal(chunk_state.tau.numpy(),
                                  np.asarray(ref_state.tau))
    np.testing.assert_array_equal(chunk_state.rng.numpy(),
                                  np.asarray(ref_state.rng).astype(np.int64))
    np.testing.assert_allclose(chunk_state.global_tr.numpy(),
                               np.asarray(ref_state.global_tr), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(chunk_state.clients_tr.numpy(),
                               np.asarray(ref_state.clients_tr), rtol=1e-4,
                               atol=1e-4)


def test_tree_path_and_unported_flags_refuse():
    with pytest.raises(NotImplementedError, match="tree-state"):
        core.init_fl_state(prng.PRNGKey(0, "cpu"), core.FLConfig(m=2), {})
    with pytest.raises(NotImplementedError, match="tree-state"):
        core.make_round_fn(core.FLConfig(m=2), None, {},
                           core.AvailabilityCfg(), None)
    with pytest.raises(KeyError, match="not ported"):
        core.get_strategy("mifa")


CLI = ["--strategy", "fedawe", "--dynamics", "sine", "--flat-state",
       "--use-kernel", "--rounds", "8", "--m", "8", "--s", "2", "--batch",
       "4", "--n-samples", "800", "--eval-every", "4"]


@pytest.mark.parametrize("chunk", ["0", "4"])
def test_cli_history_matches_reference_cli(tmp_path, chunk):
    from repro.launch import train as ref_train
    from repro_torch.launch import train

    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    flags = CLI + ["--chunk-rounds", chunk]
    train.main(flags + ["--device", "cpu", "--out", str(a)])
    ref_train.main(flags + ["--out", str(b)])
    got, want = json.load(open(a)), json.load(open(b))
    assert set(got) == set(want) == {"args", "final", "history"}
    assert len(got["history"]) == len(want["history"]) == 8
    for g, w in zip(got["history"], want["history"]):
        assert set(g) == set(w)
        assert g["n_active"] == w["n_active"]
        assert g["mean_echo"] == w["mean_echo"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4,
                                   atol=1e-4)
        if "eval_acc" in w:
            assert abs(g["eval_acc"] - w["eval_acc"]) <= 2 / 1024
    assert abs(got["final"]["eval_acc"]
               - want["final"]["eval_acc"]) <= 2 / 1024


def test_cli_refuses_without_card_or_flat_state():
    from repro_torch.launch import train

    with pytest.raises(NotImplementedError, match="tree-state"):
        train.main(["--device", "cpu", "--rounds", "1"])
    with pytest.raises(SystemExit):
        train.main(["--flat-state", "--sparse-cohort", "4"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--flat-state", "--rounds", "1"])
