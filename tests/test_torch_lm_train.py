"""Full-parameter federated LM training in the port (``lm_loss``,
``split_trainable`` / ``merge_trainable``, remat, the training routes of
the Mamba2 and MoE blocks, ``train --preset lm``, the grid's LM cell and
``optim/``) against the JAX package on the CPU.  Weights are the
reference's ``init_params`` carried across by ``params_from_numpy``;
batches are drawn with numpy in the shapes of
``tests/test_archs.py::_batch`` (B 2, L 16; a frontend's first positions
masked).

For every ``fl_mode="full"`` config of the registry at ``reduced()``:

  * ``lm_loss`` within 1e-5 of the reference's and its
    ``torch.autograd`` gradients within 1e-4 of ``jax.grad``'s;
  * one FedAWE round (m 4, s 2, the JAX test's round) on tree and flat
    state, with and without the kernel's plain version: the global within
    1e-4 of the reference round's, the loss within 1e-5, τ, t, the key and
    n_active bit-equal.

Then: the chunked cross-entropy against the unchunked one (1e-6); remat
"full" and "dots" against no remat, with no client axis and through the
client vmap (1e-6, and fewer bytes saved for the backward); the
attention's checkpointed query chunks; a Mamba2 model's training never
calling the SSD chunk kernel's wrapper (its prefill does); the port's
key-driven init against the reference's draws and the trainable count,
the LoRA configs' (adapters and base) too (their training is
tests/test_torch_lora.py's); ``train --preset lm`` (seven runs) and one
``--preset lm`` grid cell against the reference launchers (1e-4); the
optimizers and schedules against ``repro.optim`` (1e-6).

The JAX results are computed once per architecture (module-scoped
cache)."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import AvailabilityCfg as JAvailabilityCfg  # noqa: E402
from repro.core import FLConfig as JFLConfig  # noqa: E402
from repro.core import init_fl_state as j_init_fl_state  # noqa: E402
from repro.core import make_round_fn as j_make_round_fn  # noqa: E402
from repro.launch import experiments as rx  # noqa: E402
from repro.launch import train as rtrain  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import reduced as jreduced  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.checkpointing import params_from_numpy  # noqa: E402
from repro_torch.configs import _MODULES, get_config  # noqa: E402
from repro_torch.core import (AvailabilityCfg, FLConfig,  # noqa: E402
                              global_trainables, init_fl_state,
                              make_round_fn, prng)
from repro_torch.core.tree_util import (tree_from_paths,  # noqa: E402
                                        tree_leaves, tree_map, tree_paths)
from repro_torch.kernels.ssd_chunk import ops as ssd_ops  # noqa: E402
from repro_torch.launch import experiments as px  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import reduced  # noqa: E402

FULL = [a for a in _MODULES if get_config(a).fl_mode == "full"]
LORA = [a for a in _MODULES if get_config(a).fl_mode == "lora"]
M, S, B, L = 4, 2, 2, 16
ROUND = dict(m=M, s=S, eta_l=0.01, eta_g=1.0, strategy="fedawe",
             lr_schedule=False, grad_clip=0.0)
VARIANTS = {"tree": dict(flat_state=False, use_kernel=False),
            "flat": dict(flat_state=True, use_kernel=False),
            "flat_kernel": dict(flat_state=True, use_kernel=True),
            "tree_kernel": dict(flat_state=False, use_kernel=True)}


def _batch(cfg, seed):
    """tests/test_archs.py::_batch's shapes, drawn with numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    b = dict(tokens=toks, labels=toks, mask=np.ones((B, L), np.float32))
    if cfg.frontend != "none":
        b["embeds"] = rng.normal(
            size=(B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        b["mask"][:, :cfg.frontend_len] = 0.0
    if cfg.enc_dec:
        b["enc_embeds"] = rng.normal(
            size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return b


def _t(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _round_batches(b):
    return {k: np.broadcast_to(v[None, None], (M, S) + v.shape).copy()
            for k, v in b.items()}


def _reference(arch):
    """The reference's loss, gradients and one FedAWE round on the
    reduced config, and its weights."""
    jcfg = jreduced(jget_config(arch))
    jp = jm.init_params(jax.random.PRNGKey(1), jcfg)
    b = _batch(jcfg, FULL.index(arch))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, bb: jm.lm_loss(p, jcfg, bb)))(jp, _j(b))
    fl = JFLConfig(**ROUND)
    state = j_init_fl_state(jax.random.PRNGKey(1), fl, jp)
    round_fn = jax.jit(j_make_round_fn(
        fl, lambda tr, fz, bb, key: jm.lm_loss(tr, jcfg, bb), {},
        JAvailabilityCfg(kind="stationary"), jnp.full((M,), 0.8)))
    state, metrics = round_fn(state, _j(_round_batches(b)))
    to_np = jax.tree.map(np.asarray, {
        "params": jp, "grads": grads, "global": state.global_tr,
        "tau": state.tau, "t": state.t, "rng": state.rng})
    return dict(to_np, batch=b, loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread while this module runs: its operations are
    small, and with several test processes sharing the cores the
    threads of every process would wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _reference(arch)
        return cache[arch]

    return get


def _port_params(r, cfg):
    return tm.split_trainable(params_from_numpy(r["params"], "cpu"), cfg)[0]


def _loss_and_grads(params, cfg, batch, lead=0):
    """lm_loss (summed over the clients when ``lead``) and its gradients,
    leaf by leaf in flatten order."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    tree = tree_from_paths([p for p, _ in tree_paths(params)], leaves)
    loss = tm.lm_loss(tree, cfg, batch, lead=lead)
    grads = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach(), [g.float() for g in grads]


# ---------------------------------------------------------------------------
# lm_loss and its gradients, every full-mode architecture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FULL)
def test_lm_loss_and_gradients_match_reference(arch, ref):
    r = ref(arch)
    cfg = reduced(get_config(arch))
    loss, grads = _loss_and_grads(_port_params(r, cfg), cfg,
                                  _t(r["batch"]))
    assert abs(loss.item() - r["loss"]) <= 1e-5, (loss.item(), r["loss"])
    want = jax.tree.leaves(r["grads"])
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["tiny", "gemma2-2b", "olmoe-1b-7b",
                                  "zamba2-7b"])
def test_chunked_loss_equals_unchunked(arch, ref):
    """``loss_chunk`` dividing L sums the cross-entropy chunk by chunk:
    within 1e-6 of the one-piece loss (gemma2-2b: with the logit
    soft-cap), and within 1e-5 of the reference's."""
    r = ref(arch)
    cfg = reduced(get_config(arch))
    params, batch = _port_params(r, cfg), _t(r["batch"])
    whole = tm.lm_loss(params, cfg, batch).item()
    chunked = tm.lm_loss(params, cfg.replace(loss_chunk=4), batch).item()
    assert abs(chunked - whole) <= 1e-6
    assert abs(chunked - r["loss"]) <= 1e-5


# ---------------------------------------------------------------------------
# remat: memory, not values
# ---------------------------------------------------------------------------

def _remat_run(params, cfg, batch, lead):
    """``_loss_and_grads``, and the bytes autograd kept for the backward
    by the forward (tensors packed by the saved-tensor hooks outside any
    checkpoint; the backward runs after the hooks' context)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    tree = tree_from_paths([p for p, _ in tree_paths(params)], leaves)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = tm.lm_loss(tree, cfg, batch, lead=lead)
    grads = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach(), [g.float() for g in grads], total[0]


@pytest.mark.parametrize("lead", [0, 1, 2])
@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "zamba2-7b", "olmoe-1b-7b",
                                  "seamless-m4t-large-v2", "mamba2-130m"])
def test_remat_changes_memory_not_values(arch, policy, lead, ref):
    """Remat on against off, for both policies, with no client axis,
    through the client vmap (two clients) and through the seed executor's
    two client axes (two seeds of two clients): the same loss and
    gradients within 1e-6, and fewer bytes kept for the backward.
    gemma2-2b runs with attn_chunk 8 (its checkpointed query chunks),
    seamless through its encoder."""
    r = ref(arch)
    cfg = reduced(get_config(arch))
    if arch == "gemma2-2b":
        cfg = cfg.replace(attn_chunk=8)
    params, batch = _port_params(r, cfg), _t(r["batch"])
    for _ in range(lead):
        params = tree_map(lambda t: torch.stack([t, t * 0.5]), params)
        batch = {k: torch.stack([v, v.flip(-2)]) for k, v in batch.items()}
    l0, g0, bytes_off = _remat_run(params, cfg.replace(remat=False),
                                   batch, lead)
    l1, g1, bytes_on = _remat_run(
        params, cfg.replace(remat=True, remat_policy=policy), batch, lead)
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=0, atol=1e-6)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    assert bytes_on < bytes_off, (bytes_on, bytes_off)


@pytest.mark.parametrize("lead", [0, 1, 2])
def test_attention_query_chunks_recompute_in_backward(lead, ref):
    """Query-chunked attention (attn_chunk 4 at L 16) against the one-piece
    attention: loss within 1e-6 and gradients within 1e-5, with every
    chunk's score block recomputed by the backward (its forward runs
    twice per chunk per layer)."""
    from repro_torch.models import layers

    r = ref("gemma2-2b")
    cfg = reduced(get_config("gemma2-2b"))
    params, batch = _port_params(r, cfg), _t(r["batch"])
    for _ in range(lead):
        params = tree_map(lambda t: t[None], params)
        batch = {k: v[None] for k, v in batch.items()}
    calls = [0]
    orig = layers._gqa_scores

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    layers._gqa_scores = counted
    try:
        l0, g0 = _loss_and_grads(params, cfg, batch, lead)
        n_plain = calls[0]
        calls[0] = 0
        l1, g1 = _loss_and_grads(params, cfg.replace(attn_chunk=4), batch,
                                 lead)
        n_chunked = calls[0]
    finally:
        layers._gqa_scores = orig
    assert n_plain == cfg.n_layers
    assert n_chunked == 2 * cfg.n_layers * (L // 4)
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=0, atol=1e-6)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# one FedAWE round, every full-mode architecture, both substrates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", FULL)
def test_fedawe_round_matches_reference(arch, variant, ref):
    r = ref(arch)
    cfg = reduced(get_config(arch))
    fl = FLConfig(**ROUND, **VARIANTS[variant])
    state = init_fl_state(prng.PRNGKey(1, "cpu"), fl, _port_params(r, cfg))
    round_fn = make_round_fn(fl, tm.lm_loss_fn(cfg), {},
                             AvailabilityCfg(kind="stationary"),
                             torch.full((M,), 0.8))
    state, metrics = round_fn(state, _t(_round_batches(r["batch"])))
    got = tree_leaves(global_trainables(state))
    want = jax.tree.leaves(r["global"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal(state.tau.numpy(), r["tau"])
    assert int(state.t) == int(r["t"]) == 1
    np.testing.assert_array_equal(state.rng.numpy().astype(np.uint32),
                                  np.asarray(r["rng"]).astype(np.uint32))
    assert metrics["n_active"].item() == r["metrics"]["n_active"]
    assert abs(metrics["loss"].item() - r["metrics"]["loss"]) <= 1e-5


# ---------------------------------------------------------------------------
# the Mamba2 block's training route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_mamba_training_never_calls_the_ssd_kernel(arch, ref, monkeypatch):
    """``mode="train"`` runs the plain scan: neither the loss with its
    backward nor a FedAWE round through the client vmap calls
    ``ssd_ops.ssd_chunk`` (K5's wrapper), and every Mamba2 weight gets a
    nonzero gradient.  A prefill of the same model calls it once per
    Mamba2 layer (the positive control)."""
    calls = [0]
    wrapped = ssd_ops.ssd_chunk

    def counted(*a, **k):
        calls[0] += 1
        return wrapped(*a, **k)

    monkeypatch.setattr(ssd_ops, "ssd_chunk", counted)
    r = ref(arch)
    cfg = reduced(get_config(arch))
    params = _port_params(r, cfg)
    _, grads = _loss_and_grads(params, cfg, _t(r["batch"]))
    for (path, _), g in zip(tree_paths(params), grads):
        if path[0] == "stack" and path[-1] in ("in_proj", "conv_w", "A_log",
                                               "dt_bias", "out_proj"):
            assert bool((g != 0).any()), path
    fl = FLConfig(**ROUND, flat_state=True)
    round_fn = make_round_fn(fl, tm.lm_loss_fn(cfg), {},
                             AvailabilityCfg(kind="stationary"),
                             torch.full((M,), 0.8))
    round_fn(init_fl_state(prng.PRNGKey(1, "cpu"), fl, params),
             _t(_round_batches(r["batch"])))
    assert calls[0] == 0
    cache = tm.init_cache(cfg, B, L, device="cpu")
    tm.prefill(params, cfg, cache, _t(r["batch"])["tokens"])
    n_mamba = sum(b.kind == "mamba" for b in cfg.layer_blocks())
    assert calls[0] == n_mamba > 0


# ---------------------------------------------------------------------------
# the init and the counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tiny", "olmoe-1b-7b", "zamba2-7b",
                                  "seamless-m4t-large-v2", "mamba2-130m"]
                         + LORA)
def test_init_from_key_follows_the_reference_draws(arch):
    """``init_params_from_key`` against the reference's ``init_params``
    under the same key: the same tree (a LoRA config's adapters and
    frozen base both) and every leaf within float32 rounding (1e-6 of its
    scale)."""
    cfg = reduced(get_config(arch))
    got = tm.merge_trainable(*tm.split_trainable(
        tm.init_params_from_key(prng.PRNGKey(3, "cpu"), cfg), cfg), cfg)
    want = jm.init_params(jax.random.PRNGKey(3), jreduced(jget_config(arch)))
    got = dict(tree_paths(got))
    want = {tuple(str(k.key) for k in p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == getattr(torch, w.dtype.name), path
        w = w.astype(np.float32)
        np.testing.assert_allclose(got[path].float().numpy(), w, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(w).max()),
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", FULL + LORA)
def test_trainable_count_matches_reference(arch):
    """Full mode trains every parameter; LoRA mode its adapters, a small
    share of the whole."""
    cfg = get_config(arch)
    got = tm.count_params(cfg, trainable_only=True)
    assert got == jm.count_params(jget_config(arch), trainable_only=True)
    if arch in LORA:
        assert 0 < got < tm.count_params(cfg) // 100
    else:
        assert got == tm.count_params(cfg)


# ---------------------------------------------------------------------------
# the launchers: train --preset lm and the grid's LM cell
# ---------------------------------------------------------------------------

CLI_CASES = {
    # tests/test_launchers.py::test_train_cli_lm_preset's arguments
    "host_loop": ["--strategy", "fedau"],
    "chunked_flat_kernel_faults": ["--strategy", "fedawe", "--flat-state",
                                   "--use-kernel", "--chunk-rounds", "2",
                                   "--midround-drop", "0.3", "--sanitize"],
    "kernel_staleness": ["--strategy", "fedawe", "--use-kernel",
                              "--chunk-rounds", "2", "--stale-max", "2",
                              "--stale-kind", "geom", "--stale-gamma",
                              "0.7"],
    "sparse_cohort": ["--strategy", "fedawe", "--sparse-cohort", "4"],
    "epoch_sampling": ["--strategy", "fedawe", "--sampling", "epoch"],
    "seeds": ["--strategy", "fedawe", "--seeds", "2"],
    "mifa_flat": ["--strategy", "mifa", "--flat-state"],
}


def _cli_record(path):
    """A launcher's ``--out`` JSON: (its per-seed histories, its final
    eval loss; under ``--seeds`` the mean over the seeds)."""
    rec = json.loads(path.read_text())
    final = rec["final"]["eval_loss"]
    return (rec.get("history_per_seed") or [rec["history"]],
            final["mean"] if isinstance(final, dict) else final)


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_train_cli_lm_preset_matches_reference(case, tmp_path):
    argv = (["--preset", "lm", "--dynamics", "stationary", "--rounds", "4",
             "--m", "6", "--s", "2", "--batch", "8", "--eval-every", "2"]
            + CLI_CASES[case])
    rtrain.main(argv + ["--out", str(tmp_path / "ref.json")])
    ptrain.main(argv + ["--device", "cpu", "--out",
                        str(tmp_path / "port.json")])
    want, want_final = _cli_record(tmp_path / "ref.json")
    got, got_final = _cli_record(tmp_path / "port.json")
    assert len(got) == len(want) == (2 if case == "seeds" else 1)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws) == 4
        for g, w in zip(gs, ws):
            assert sorted(g) == sorted(w)
            for key in w:
                assert abs(g[key] - w[key]) <= 1e-4, (key, g, w)
    assert abs(got_final - want_final) <= 1e-4


def test_grid_lm_cell_matches_reference():
    """One ``--preset lm`` cell (fedawe/sine, 2 seeds, 4 rounds in chunks
    of 2) through the seed-batched executor: every seed's history within
    1e-4 of the reference grid's, and the CLI takes the preset."""
    kw = dict(seeds=2, rounds=4, chunk_rounds=2, m=6, s=2, batch=8,
              preset="lm", seed=0)
    want = rx.run_scenario(rx.get_scenario("fedawe/sine"), **kw)
    got = px.run_scenario(px.get_scenario("fedawe/sine"), device="cpu",
                          **kw)
    for gs, ws in zip(got["histories"], want["histories"]):
        assert len(gs) == len(ws) == 4
        for g, w in zip(gs, ws):
            for key in w:
                assert abs(float(g[key]) - float(w[key])) <= 1e-4, \
                    (key, g, w)
    rows = px.main(["--scenario", "fedawe/sine", "--preset", "lm",
                    "--seeds", "2", "--rounds", "2", "--chunk-rounds", "2",
                    "--m", "6", "--s", "2", "--batch", "8", "--no-save",
                    "--device", "cpu"])
    assert len(rows) == 1


# ---------------------------------------------------------------------------
# optim/
# ---------------------------------------------------------------------------

def _opt_tree(rng):
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("momentum", {}),
                                     ("momentum", {"nesterov": True}),
                                     ("adam", {})])
def test_optimizer_steps_match_reference(name, kw):
    """Three update steps on the same parameters and gradients, float32 and
    bfloat16 leaves: within 1e-6 of ``repro.optim`` (bfloat16 leaves bit
    for bit once rounded)."""
    rng = np.random.default_rng(5)
    p0 = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(3)]
    for dtype in ("float32", "bfloat16"):
        jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), p0)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        jo, to = getattr(jopt, name)(**kw), getattr(optim, name)(**kw)
        js, ts = jo.init(jp), to.init(tp)
        for i, g in enumerate(grads):
            lr = 0.1 / (i + 1)
            jp, js = jo.update(jp, jax.tree.map(jnp.asarray, g), js, lr)
            tp, ts = to.update(tp, params_from_numpy(g, "cpu"), ts, lr)
        got = dict(tree_paths(tp))
        for path, w in jax.tree_util.tree_flatten_with_path(jp)[0]:
            key = tuple(str(k.key) for k in path)
            assert got[key].dtype == getattr(torch, dtype)
            np.testing.assert_allclose(got[key].float().numpy(),
                                       np.asarray(w, np.float32), rtol=0,
                                       atol=1e-6)


def test_schedules_match_reference():
    ts = [0, 1, 5, 10, 37, 100, 250]
    pairs = [(jopt.paper_schedule(0.05), optim.paper_schedule(0.05)),
             (jopt.constant_schedule(0.3), optim.constant_schedule(0.3)),
             (jopt.cosine_schedule(0.1, 200, warmup=10, floor=0.01),
              optim.cosine_schedule(0.1, 200, warmup=10, floor=0.01)),
             (jopt.cosine_schedule(0.1, 50), optim.cosine_schedule(0.1, 50))]
    for jf, tf in pairs:
        for t in ts:
            got = tf(t)
            assert got.dtype == torch.float32 and got.shape == ()
            assert abs(got.item() - float(jf(t))) <= 1e-6, t
