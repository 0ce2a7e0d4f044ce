"""The port's semi-async rounds (repro_torch/core/staleness.py and the
engine's pending ring) against the JAX package, on the small problem of
tests/test_staleness.py from the same numpy inputs and keys.

Held against the reference: det, geom and trace delays, alone and
composed with mid-round dropout (the 5-key split, ``k_up`` before
``k_delay``), the discounted upload weights through the kernel's path,
the stale NaN scrubbed at delivery, and the launchers' ``--out``
histories.  Held within the port: conservation, the det cadence, and
``tau_max = 0`` being the synchronous round bit for bit.  The geometric
delay ``1 + floor(log1p(-u) / log1p(-p))`` can differ from XLA's by a
whole round when the two ``log1p``s differ by an ulp at a floor
boundary; such flips are counted (at most 2 allowed)."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import staleness as ref_stale  # noqa: E402
from repro_torch.core import prng, staleness  # noqa: E402

from _torch_fl_small import (M, assert_parity,  # noqa: E402,I100
                             assert_same_port, run)

DET1 = dict(tau_max=2, kind="det", delay=1)
DET2 = dict(tau_max=3, kind="det", delay=2)
GEOM = dict(tau_max=4, kind="geom", p_next=0.5)
TRACE = dict(tau_max=4, kind="trace")
MIDROUND = dict(upload_survival=0.7, sanitize=True)


def _dtrace(stale, T):
    if stale.get("kind") != "trace":
        return None
    return np.array(ref_stale.staircase_delay_trace(jax.random.PRNGKey(9),
                                                     M, T))


# ---------------------------------------------------------------------------
# the staleness functions alone
# ---------------------------------------------------------------------------

def test_geometric_delay_flips():
    """400 rounds of geometric delays for 100 clients at three arrival
    probabilities: a delay that differs from the reference's must be a
    floor-boundary flip, and there are at most 2 (none expected)."""
    flips, draws = 0, 0
    for p in (0.3, 0.5, 0.8):
        kw = dict(tau_max=64, kind="geom", p_next=p)
        rcfg, pcfg = ref_stale.StalenessCfg(**kw), staleness.StalenessCfg(**kw)
        ref_fn = jax.jit(jax.vmap(
            lambda k: ref_stale.draw_delay(rcfg, None, k, 0, 100)))
        keys = jax.random.split(jax.random.PRNGKey(11), 400)
        want = np.asarray(ref_fn(keys))
        pkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
        got = np.stack([staleness.draw_delay(pcfg, None, k, None, 100).numpy()
                        for k in pkeys])
        assert got.dtype == want.dtype == np.int32
        flips += int((got != want).sum())
        draws += want.size
        assert (np.abs(got - want) <= 1).all()
        assert want.min() >= 1
    print(f"geometric delay flips: {flips} in {draws} draws")
    assert flips <= 2


@pytest.mark.parametrize("gamma", [0.3, 0.7, 0.95])
def test_discount_weights(gamma):
    """``gamma ** age`` in float32 for every age a ring of depth 64 can
    hold: within 1e-6 relative of ``jnp.power``."""
    ages = np.arange(65, dtype=np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.power(jnp.float32(gamma), a))(
        jnp.asarray(ages)))
    got = torch.pow(torch.full((), gamma, dtype=torch.float32),
                    torch.from_numpy(ages)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_staircase_delay_trace_matches():
    want = np.asarray(ref_stale.staircase_delay_trace(
        jax.random.PRNGKey(3), 40, 30))
    got = staleness.staircase_delay_trace(prng.PRNGKey(3, "cpu"), 40, 30)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("t", [0, 5])
def test_drain_and_step_buffer_match(t):
    """One round of ring bookkeeping on a random ring with a NaN row,
    every delay 1..tau_max (d = tau_max refills the slot just drained):
    arrivals and the new ring bit-equal; the drained copy is untouched
    by the step that refills its slot."""
    tau, m, n = 3, 6, 5
    rng = np.random.default_rng(t)
    ages = rng.integers(0, tau + 1, (tau, m)).astype(np.float32)
    buf = rng.normal(size=(tau, m, n)).astype(np.float32)
    G = rng.normal(size=(m, n)).astype(np.float32)
    G[1] = np.nan
    defer = (rng.random(m) < 0.7).astype(np.float32)
    d = rng.integers(1, tau + 1, m).astype(np.int32)
    d[0], defer[0] = tau, 1.0
    rst = dict(ages=jnp.asarray(ages), buf=jnp.asarray(buf))
    pst = dict(ages=torch.from_numpy(ages), buf=torch.from_numpy(buf))
    tt = torch.tensor(t, dtype=torch.int32)
    want_arr = ref_stale.drain(rst, jnp.int32(t))
    got_arr = staleness.drain(pst, tt)
    want = ref_stale.step_buffer(rst, jnp.int32(t), jnp.asarray(defer),
                                 jnp.asarray(d), jnp.asarray(G))
    got = staleness.step_buffer(pst, tt, torch.from_numpy(defer),
                                torch.from_numpy(d), torch.from_numpy(G))
    for g, w in zip(got_arr, want_arr):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for k in ("ages", "buf"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert float(staleness.pending_count(got)) == float(
        ref_stale.pending_count(want))
    np.testing.assert_array_equal(staleness.busy_mask(got).numpy(),
                                  np.asarray(ref_stale.busy_mask(want)))


# ---------------------------------------------------------------------------
# the engine with the ring live
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault", [None, MIDROUND],
                         ids=["alone", "dropout"])
@pytest.mark.parametrize("stale", [DET2, GEOM, TRACE],
                         ids=["det", "geom", "trace"])
def test_stale_matches_reference(stale, fault):
    """T = 6 chunked at K = 4 (a tail chunk of 2); with dropout the round
    splits 5 keys, k_up before k_delay.  The port's host loop gives the
    same run exactly."""
    kw = dict(fault=fault, stale=stale, dtrace=_dtrace(stale, 6))
    port = run("port", chunk=True, **kw)
    assert_parity(run("ref", chunk=True, **kw), port)
    assert_same_port(run("port", **kw), port)
    assert sum(r["n_stale"] for r in port[1]) > 0


@pytest.mark.parametrize("strategy", ["fedawe", "fedawe_m"])
def test_discounted_kernel_path_matches_reference(strategy):
    """Geometric delays discounted by gamma = 0.7 under dropout: the
    upload kernel's path takes non-binary weights."""
    kw = dict(fault=MIDROUND, stale=dict(GEOM, tau_max=3, gamma=0.7),
              use_kernel=True)
    assert_parity(run("ref", strategy, **kw), run("port", strategy, **kw))


@pytest.mark.parametrize("stale", [DET1, DET2, GEOM, TRACE],
                         ids=["det1", "det2", "geom", "trace"])
def test_conservation(stale):
    """Every computed update is delivered within tau_max rounds or still
    pending: sum(n_active) == sum(n_stale) + pending(final ring)."""
    state, hist = run("port", stale=stale, T=12, dtrace=_dtrace(stale, 12))
    assert sum(r["n_active"] for r in hist) == sum(
        r["n_stale"] for r in hist) + float(
            staleness.pending_count(state.stale))
    assert float(state.stale["ages"].max()) <= stale["tau_max"]
    assert bool(torch.isfinite(state.global_tr).all())


def test_det_delay_cadence():
    """Stationary p = 1, det delay 1: n_active alternates m, 0 and
    n_stale 0, m, every delivery aged exactly 1."""
    _, hist = run("port", stale=DET1, base_p=1.0, kind="stationary")
    assert [r["n_active"] for r in hist] == [M, 0.0] * 3
    assert [r["n_stale"] for r in hist] == [0.0, M] * 3
    assert all(r["mean_staleness"] == 1.0 for r in hist[1::2])


@pytest.mark.parametrize("chunk", [False, True], ids=["host", "chunked"])
def test_tau_max_zero_is_synchronous(chunk):
    """tau_max = 0 is the synchronous round: the same keys, metrics keys
    and values, bit for bit."""
    off = run("port", stale=dict(tau_max=0), chunk=chunk)
    assert off[0].stale is None
    assert_same_port(run("port", chunk=chunk), off)
    assert set(off[1][0]) == {"loss", "n_active", "mean_echo", "t"}


def test_stale_nan_scrubbed_at_delivery():
    """Client 0's NaN update parks in the ring for a round; sanitization
    at delivery rejects it, so the model stays finite while the ring
    holds the raw NaN."""
    T = 6
    kw = dict(fault=dict(trace=True, sanitize=True), stale=DET1, T=T,
              trace=np.ones((T, M), np.float32), nan_client=0, base_p=1.0,
              kind="stationary")
    port = run("port", **kw)
    assert_parity(run("ref", **kw), port)
    state, hist = port
    assert bool(torch.isfinite(state.global_tr).all())
    assert bool(torch.isfinite(state.clients_tr).all())
    for r in hist[1::2]:
        assert r["n_stale"] == M and r["n_rejected"] == 1.0
        assert np.isfinite(r["loss"])


def test_metrics_keys_contract():
    base = {"loss", "n_active", "mean_echo", "n_stale", "mean_staleness",
            "t"}
    for fault, want in ((None, base),
                        (MIDROUND, base | {"n_dropped", "n_rejected"})):
        got = set(run("port", fault=fault, stale=DET1, T=1)[1][0])
        assert got == set(run("ref", fault=fault, stale=DET1,
                              T=1)[1][0]) == want


def test_launcher_builds_the_reference_carries():
    """``--stale-kind trace`` replays ``staircase_delay_trace(PRNGKey(seed
    + 3), m, rounds)`` in a zeroed ring, and the dataset keeps the
    reference's ν (the fault scenarios' handle)."""
    from repro.launch import train as ref_train
    from repro_torch.launch import train

    flags = ["--stale-max", "4", "--stale-kind", "trace", "--rounds", "12",
             "--m", "8", "--batch", "4", "--n-samples", "800", "--seed",
             "2", "--flat-state"]
    args = train.build_parser().parse_args(flags + ["--device", "cpu"])
    parts = train.setup(args, torch.device("cpu"))
    stale = parts["state"].stale
    want = ref_stale.staircase_delay_trace(jax.random.PRNGKey(5), 8, 12)
    np.testing.assert_array_equal(stale["dtrace"].numpy(), np.asarray(want))
    assert stale["buf"].shape == (4, 8, parts["state"].spec.size)
    assert not stale["buf"].any() and not stale["ages"].any()
    ref_args = ref_train.build_parser().parse_args(flags)
    ref_args.alpha = 0.1
    ref_ds = ref_train.build_image_task(ref_args, jax.random.PRNGKey(2))[2]
    np.testing.assert_array_equal(parts["ds"].nu, np.asarray(ref_ds.nu))


CLI = ["--midround-drop", "0.3", "--sanitize", "--stale-max", "3",
       "--stale-kind", "geom", "--stale-gamma", "0.7", "--use-kernel",
       "--chunk-rounds", "4", "--rounds", "8", "--m", "8", "--s", "2",
       "--batch", "4", "--n-samples", "800", "--eval-every", "4"]


def test_cli_history_matches_reference_cli(tmp_path):
    """``--stale-max`` implies ``--flat-state`` in both launchers; the
    histories agree as tests/test_torch_slice.py's CLI case holds them."""
    from repro.launch import train as ref_train
    from repro_torch.launch import train

    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    train.main(CLI + ["--device", "cpu", "--out", str(a)])
    ref_train.main(CLI + ["--out", str(b)])
    got, want = json.load(open(a)), json.load(open(b))
    assert got["args"]["flat_state"] and want["args"]["flat_state"]
    assert len(got["history"]) == len(want["history"]) == 8
    for g, w in zip(got["history"], want["history"]):
        assert set(g) == set(w)
        for k in ("n_active", "n_dropped", "n_rejected", "n_stale",
                  "mean_echo", "mean_staleness"):
            assert g[k] == w[k], k
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4,
                                   atol=1e-4)
        if "eval_acc" in w:
            assert abs(g["eval_acc"] - w["eval_acc"]) <= 2 / 1024
    assert sum(g["n_dropped"] for g in got["history"]) > 0
    assert abs(got["final"]["eval_acc"]
               - want["final"]["eval_acc"]) <= 2 / 1024
