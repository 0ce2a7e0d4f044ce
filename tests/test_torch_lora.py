"""LoRA in the port (``fl_mode="lora"``: adapters over a frozen base,
``make_round_fn_with_frozen`` and the executors' ``with_frozen``)
against the JAX package on the CPU, at gemma3-27b's and mixtral-8x22b's
``reduced()`` configs in float32.  Weights are the reference's
``init_params`` carried across by ``params_from_numpy``; where the
adapters must act, their leaves get a numpy draw added (``b_*`` start at
zero).

  * the adapter tree, shapes, dtypes and ``count_params`` (whole and
    trainable-only) equal to the reference's at reduced and full size;
    ``init_params_from_key`` within 1e-6 of the reference's draws;
  * ``forward_hidden`` and the logits within 1e-5 of the reference's at a
    batch that is not ``n_units``, and within 1e-3 of the base with the
    adapters folded into wq / wk / wv / wo (tests/test_lora.py's check);
  * ``lm_loss`` within 1e-5 and its adapter gradients within 1e-4 of
    ``jax.grad``'s, ``b_*`` getting a gradient from zero;
  * one FedAWE round (m 4, s 2: tests/test_archs.py's) on tree and flat
    state, with and without the kernel's plain version, through
    ``make_round_fn`` and ``make_round_fn_with_frozen``: the global
    within 1e-4, τ, t, the key and n_active bit-equal, every frozen leaf
    unchanged bit for bit and not requiring a gradient; the same at m =
    ``n_units`` (2), where a base leaf wrongly mapped over the clients
    would pass silently;
  * ``make_chunk_fn(..., with_frozen=True)`` and
    ``make_seeds_chunk_fn(..., with_frozen=True)`` (2 seeds) against the
    reference's executors within 1e-4;
  * ``prefill`` (xla and flash backends) within 2e-4 and 4 ``serve_step``s
    within 1e-3 with nonzero adapters;
  * ``params_from_numpy`` carrying the ``"lora"`` subtree bit for bit.

The reference's results are computed once per architecture
(module-scoped caches)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import AvailabilityCfg as JAvailabilityCfg  # noqa: E402
from repro.core import FLConfig as JFLConfig  # noqa: E402
from repro.core import init_fl_state as j_init_fl_state  # noqa: E402
from repro.core import stack_seeds as j_stack_seeds  # noqa: E402
from repro.core.engine import make_chunk_fn as j_make_chunk_fn  # noqa: E402
from repro.core.engine import make_round_fn as j_make_round_fn  # noqa: E402
from repro.core.engine import \
    make_round_fn_with_frozen as j_make_round_fn_with_frozen  # noqa: E402
from repro.core.engine import \
    make_seeds_chunk_fn as j_make_seeds_chunk_fn  # noqa: E402
from repro.data import federated as jfed  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import reduced as jreduced  # noqa: E402
from repro_torch.checkpointing import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (AvailabilityCfg, FLConfig,  # noqa: E402
                              global_trainables, init_fl_state,
                              make_chunk_fn, make_round_fn,
                              make_round_fn_with_frozen, make_seeds_chunk_fn,
                              prng, stack_seeds)
from repro_torch.core.tree_util import (tree_from_paths,  # noqa: E402
                                        tree_leaves, tree_paths)
from repro_torch.data import federated as fed  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import reduced  # noqa: E402

ARCHS = ["gemma3-27b", "mixtral-8x22b"]
#: the full configs' adapters (the reference's ``count_params``)
FULL_ADAPTERS = {"gemma3-27b": 33_521_664, "mixtral-8x22b": 34_865_152}
M, S, B, L = 4, 2, 2, 16
#: the forward's batch: not n_units (2 at reduced size)
B_FWD = 3
ROUND = dict(s=S, eta_l=0.01, eta_g=1.0, strategy="fedawe",
             lr_schedule=False, grad_clip=0.0)
VARIANTS = {"tree": dict(flat_state=False, use_kernel=False),
            "flat": dict(flat_state=True, use_kernel=False),
            "flat_kernel": dict(flat_state=True, use_kernel=True),
            "tree_kernel": dict(flat_state=False, use_kernel=True)}
#: the executors' runs: sequences per client in the store, rounds a
#: chunk, seeds
PER_CLIENT, K, SEEDS = 4, 2, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread while this module runs (its operations are
    small; several test processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (jreduced(jget_config(arch)).replace(**kw),
            reduced(get_config(arch)).replace(**kw))


def _with_adapters(jp, seed=5, scale=0.05):
    """``jp`` with a numpy draw (``scale`` times N(0, 1)) added to every
    adapter leaf, so that ``b_*`` act."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(jp["lora"])
    moved = [x + jnp.asarray(scale * rng.normal(size=x.shape), x.dtype)
             for x in leaves]
    return dict(jp, lora=jax.tree.unflatten(treedef, moved))


def _weights(arch, nonzero=True, **kw):
    """(jax cfg, port cfg, jax params, port params)."""
    jcfg, cfg = _cfgs(arch, **kw)
    jp = jm.init_params(jax.random.PRNGKey(1), jcfg)
    if nonzero:
        jp = _with_adapters(jp)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _batch(cfg, seed, b=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, L)).astype(np.int32)
    return dict(tokens=toks, labels=toks, mask=np.ones((b, L), np.float32))


def _t(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _round_batches(b, m):
    return {k: np.broadcast_to(v[None, None], (m, S) + v.shape).copy()
            for k, v in b.items()}


def _jloss(jcfg):
    def loss_fn(tr, fz, batch, key):
        batch = dict(batch)
        batch.setdefault("mask", jnp.ones_like(batch["labels"], jnp.float32))
        return jm.lm_loss(jm.merge_trainable(tr, fz, jcfg), jcfg, batch)
    return loss_fn


def _paths(tree):
    """{path: leaf as numpy} of a JAX tree."""
    return {tuple(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_close(port_tree, jax_tree, tol):
    got, want = dict(tree_paths(port_tree)), _paths(jax_tree)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path].float().numpy(),
                                   w.astype(np.float32), rtol=tol, atol=tol,
                                   err_msg=str(path))


def _snapshot(tree):
    return [(p, v.clone()) for p, v in tree_paths(tree)]


def _assert_frozen_kept(frozen, snap):
    """Every frozen leaf bit-equal to its snapshot and outside autograd."""
    now = dict(tree_paths(frozen))
    assert sorted(now) == sorted(p for p, _ in snap)
    for path, before in snap:
        assert torch.equal(now[path], before), path
        assert not now[path].requires_grad, path


# ---------------------------------------------------------------------------
# trees, counts and draws
# ---------------------------------------------------------------------------

def _shapes(tree):
    return {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for p, v in tree_paths(tree)}


def _jshapes(tree):
    return {tuple(str(k.key) for k in p): (tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_tree_and_counts_match_reference(arch):
    """At reduced size in bfloat16: the whole tree (adapters included),
    its shapes and dtypes; the counts whole and trainable-only."""
    jcfg, cfg = _cfgs(arch, dtype="bfloat16")
    got = tm.init_params(torch.Generator().manual_seed(0), cfg)
    want = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    assert _shapes(got) == _jshapes(want)
    assert "lora" in got and got["lora"]["stack"]["pos0"]["b_q"].abs().max() \
        == 0
    tr, fz = tm.split_trainable(got, cfg)
    assert _shapes(tr) == _jshapes(jm.split_trainable(want, jcfg)[0])
    assert "lora" not in fz and "embed" in fz
    for only in (False, True):
        assert tm.count_params(cfg, trainable_only=only) \
            == jm.count_params(jcfg, trainable_only=only)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_adapters_and_counts_match_reference(arch):
    """At full size: the adapter tree ``init_lora`` draws (tens of
    millions of leaves' elements, small enough to draw here) against the
    reference's shapes and dtypes; the counts whole and trainable-only,
    the adapters' being the published widths' 33 521 664 / 34 865 152."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = tm.init_lora(torch.Generator().manual_seed(0), cfg)
    want = jax.eval_shape(lambda: jm.init_lora(jax.random.PRNGKey(0), jcfg))
    assert _shapes(got) == _jshapes(want)
    assert sum(v.numel() for v in tree_leaves(got)) == FULL_ADAPTERS[arch]
    assert tm.count_params(cfg, trainable_only=True) \
        == jm.count_params(jcfg, trainable_only=True) == FULL_ADAPTERS[arch]
    assert tm.count_params(cfg) == jm.count_params(jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_from_key_follows_the_reference_draws(arch):
    """``init_params_from_key`` against the reference's ``init_params``
    under the same key, the adapters drawn from its sixth key: every leaf
    within float32 rounding (1e-6 of its scale)."""
    jcfg, cfg = _cfgs(arch)
    got = dict(tree_paths(tm.init_params_from_key(prng.PRNGKey(3, "cpu"),
                                                  cfg)))
    want = _paths(jm.init_params(jax.random.PRNGKey(3), jcfg))
    assert sorted(got) == sorted(want)
    assert any(p[0] == "lora" for p in want)
    for path, w in want.items():
        assert got[path].dtype == getattr(torch, w.dtype.name), path
        w = w.astype(np.float32)
        np.testing.assert_allclose(got[path].float().numpy(), w, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(w).max()),
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_carries_the_adapters_bit_for_bit(arch):
    jcfg, _ = _cfgs(arch, dtype="bfloat16")
    jp = _with_adapters(jm.init_params(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jp, "cpu")
    got, want = dict(tree_paths(tp["lora"])), _paths(jp["lora"])
    assert sorted(got) == sorted(want) and want
    for path, w in want.items():
        assert got[path].dtype == torch.bfloat16, path
        np.testing.assert_array_equal(got[path].view(torch.int16).numpy(),
                                      w.view(np.int16), err_msg=str(path))


# ---------------------------------------------------------------------------
# the forward, the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_logits_match_reference(arch):
    jcfg, cfg, jp, tp = _weights(arch)
    toks = _batch(cfg, 2, B_FWD)["tokens"]
    jh, _ = jm.forward_hidden(jp, jcfg, jnp.asarray(toks))
    th, _ = tm.forward_hidden(tp, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tm.lm_logits(th, tp, cfg).numpy(),
                               np.asarray(jm.lm_logits(jh, jp, jcfg)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_adapters_equal_their_fold_into_the_base(arch):
    """The logits with nonzero adapters against the base alone (full
    mode) with each unit's and tail block's ``rank**-0.5 * a @ b`` folded
    into wq / wk / wv / wo: within 1e-3; and the adapters change them."""
    _, cfg, _, tp = _weights(arch)
    toks = torch.from_numpy(_batch(cfg, 2, B_FWD)["tokens"])
    h, _ = tm.forward_hidden(tp, cfg, toks)
    scale = cfg.lora_rank ** -0.5
    base = {k: v for k, v in tp.items() if k != "lora"}
    folded = dict(base, stack=dict(base["stack"]), tail=dict(base["tail"]))
    for part, eq in (("stack", "udr,uro->udo"), ("tail", "dr,ro->do")):
        for key, lp in tp["lora"][part].items():
            bp = dict(base[part][key])
            for n in "qkvo":
                bp[f"w{n}"] = bp[f"w{n}"] + scale * torch.einsum(
                    eq, lp[f"a_{n}"], lp[f"b_{n}"])
            folded[part][key] = bp
    full = cfg.replace(fl_mode="full")
    h2, _ = tm.forward_hidden(folded, full, toks)
    h0, _ = tm.forward_hidden(base, full, toks)
    lg, lg2 = tm.lm_logits(h, tp, cfg), tm.lm_logits(h2, folded, full)
    np.testing.assert_allclose(lg.numpy(), lg2.numpy(), atol=1e-3)
    assert (lg - tm.lm_logits(h0, base, full)).abs().max() > 1e-2


@pytest.fixture(scope="module")
def loss_ref():
    cache = {}

    def get(arch, nonzero):
        if (arch, nonzero) not in cache:
            jcfg, cfg, jp, tp = _weights(arch, nonzero)
            b = _batch(cfg, 3)
            jtr, jfz = jm.split_trainable(jp, jcfg)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda tr, bb: jm.lm_loss(jm.merge_trainable(tr, jfz, jcfg),
                                          jcfg, bb)))(jtr, _j(b))
            cache[(arch, nonzero)] = (cfg, tp, b, float(loss), grads)
        return cache[(arch, nonzero)]

    return get


@pytest.mark.parametrize("nonzero", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_adapter_gradients_match_reference(arch, nonzero,
                                                       loss_ref):
    """The loss over ``merge_trainable`` and its gradients in the adapters
    alone: from the init (``b_*`` zero, so only they get a gradient, and
    a nonzero one) and with the adapters moved."""
    cfg, tp, b, want_loss, want = loss_ref(arch, nonzero)
    tr, fz = tm.split_trainable(tp, cfg)
    paths = [p for p, _ in tree_paths(tr)]
    leaves = [v.detach().requires_grad_(True) for v in tree_leaves(tr)]
    loss = tm.lm_loss(tm.merge_trainable(tree_from_paths(paths, leaves), fz,
                                         cfg), cfg, _t(b))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - want_loss) <= 1e-5
    _assert_close(tree_from_paths(paths, grads), want, 1e-4)
    for path, g in zip(paths, grads):
        if path[-1].startswith("b_"):
            assert g.abs().max() > 0, path
    assert not any(v.requires_grad for v in tree_leaves(fz))


# ---------------------------------------------------------------------------
# one FedAWE round over the frozen base
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def round_ref():
    cache = {}

    def get(arch, m):
        if (arch, m) not in cache:
            jcfg, cfg, jp, tp = _weights(arch)
            b = _batch(cfg, 4)
            jtr, jfz = jm.split_trainable(jp, jcfg)
            fl = JFLConfig(m=m, **ROUND)
            state = j_init_fl_state(jax.random.PRNGKey(1), fl, jtr)
            round_fn = jax.jit(j_make_round_fn(
                fl, _jloss(jcfg), jfz, JAvailabilityCfg(kind="stationary"),
                jnp.full((m,), 0.8)))
            state, met = round_fn(state, _j(_round_batches(b, m)))
            cache[(arch, m)] = dict(
                cfg=cfg, tp=tp, batch=b, global_=state.global_tr,
                tau=np.asarray(state.tau), t=int(state.t),
                rng=np.asarray(state.rng).astype(np.uint32),
                metrics={k: float(v) for k, v in met.items()})
        return cache[(arch, m)]

    return get


def _port_round(r, m, variant, builder):
    cfg = r["cfg"]
    tr, fz = tm.split_trainable(r["tp"], cfg)
    fl = FLConfig(m=m, **ROUND, **VARIANTS[variant])
    state = init_fl_state(prng.PRNGKey(1, "cpu"), fl, tr)
    av, base_p = AvailabilityCfg(kind="stationary"), torch.full((m,), 0.8)
    snap = _snapshot(fz)
    batches = _t(_round_batches(r["batch"], m))
    if builder == "with_frozen":
        round_fn = make_round_fn_with_frozen(fl, tm.lm_loss_fn(cfg), av,
                                             base_p)
        state, met = round_fn(state, fz, batches)
    else:
        round_fn = make_round_fn(fl, tm.lm_loss_fn(cfg), fz, av, base_p)
        state, met = round_fn(state, batches)
    _assert_frozen_kept(fz, snap)
    return state, met


def _assert_round(state, met, r):
    _assert_close(global_trainables(state), r["global_"], 1e-4)
    np.testing.assert_array_equal(state.tau.numpy(), r["tau"])
    assert int(state.t) == r["t"] == 1
    np.testing.assert_array_equal(state.rng.numpy().astype(np.uint32),
                                  r["rng"])
    assert met["n_active"].item() == r["metrics"]["n_active"]
    assert abs(met["loss"].item() - r["metrics"]["loss"]) <= 1e-5


@pytest.mark.parametrize("builder", ["closed", "with_frozen"])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_fedawe_round_matches_reference(arch, variant, builder, round_ref):
    r = round_ref(arch, M)
    state, met = _port_round(r, M, variant, builder)
    _assert_round(state, met, r)


@pytest.mark.parametrize("variant", ["tree", "flat_kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_round_with_as_many_clients_as_units(arch, variant, round_ref):
    """m = n_units = 2: a base leaf mapped over the clients would take
    unit u's weights for client u and raise nothing."""
    cfg = reduced(get_config(arch))
    assert cfg.n_units == 2
    r = round_ref(arch, cfg.n_units)
    state, met = _port_round(r, cfg.n_units, variant, "with_frozen")
    _assert_round(state, met, r)


# ---------------------------------------------------------------------------
# the executors with the frozen base as an argument
# ---------------------------------------------------------------------------

def _tokens_store(pkg, cfg):
    """Both packages' device store of PER_CLIENT sequences of L + 1
    numpy-drawn tokens per client (tokens and next-token labels)."""
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab, (M * PER_CLIENT, L + 1)).astype(np.int32)
    arrays = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
    if pkg == "jax":
        return jfed.device_store(
            arrays, padded=jfed.contiguous_client_index(M, PER_CLIENT))
    return fed.device_store(arrays, None, "cpu",
                            padded=fed.contiguous_client_index(M, PER_CLIENT))


@pytest.fixture(scope="module")
def chunk_ref():
    cache = {}

    def get(arch, seeds):
        if (arch, seeds) not in cache:
            jcfg, cfg, jp, tp = _weights(arch)
            jtr, jfz = jm.split_trainable(jp, jcfg)
            fl = JFLConfig(m=M, **ROUND, flat_state=True)
            round_fn = j_make_round_fn_with_frozen(
                fl, _jloss(jcfg), JAvailabilityCfg(kind="sine"),
                jnp.full((M,), 0.8))
            init, sample = jfed.make_device_sampler(M, S, B)
            store = _tokens_store("jax", cfg)
            if seeds:
                states = j_stack_seeds([
                    j_init_fl_state(jax.random.PRNGKey(10 + j), fl, jtr)
                    for j in range(seeds)])
                keys = jnp.stack([jax.random.PRNGKey(20 + j)
                                  for j in range(seeds)])
                ss = j_stack_seeds([init(store, k) for k in keys])
                chunk = j_make_seeds_chunk_fn(fl, round_fn, sample, K,
                                              seeds, with_frozen=True)
                states, _, met = chunk(states, jfz, ss, store, keys)
                glob = [jax.tree.map(lambda x: x[j], states.global_tr)
                        for j in range(seeds)]
            else:
                state = j_init_fl_state(jax.random.PRNGKey(10), fl, jtr)
                key = jax.random.PRNGKey(20)
                chunk = j_make_chunk_fn(fl, round_fn, sample, K,
                                        with_frozen=True)
                states, _, met = chunk(state, jfz, init(store, key), store,
                                       key)
                glob = [states.global_tr]
            cache[(arch, seeds)] = dict(
                cfg=cfg, tp=tp, global_=[np.asarray(g) for g in glob],
                tau=np.asarray(states.tau),
                metrics={k: np.asarray(v) for k, v in met.items()})
        return cache[(arch, seeds)]

    return get


def _port_chunk(r, seeds):
    cfg = r["cfg"]
    tr, fz = tm.split_trainable(r["tp"], cfg)
    fl = FLConfig(m=M, **ROUND, flat_state=True)
    round_fn = make_round_fn_with_frozen(fl, tm.lm_loss_fn(cfg),
                                         AvailabilityCfg(kind="sine"),
                                         torch.full((M,), 0.8))
    init, sample = fed.make_device_sampler(M, S, B)
    store = _tokens_store("port", cfg)
    snap = _snapshot(fz)
    if seeds:
        states = stack_seeds([init_fl_state(prng.PRNGKey(10 + j, "cpu"), fl,
                                            tr) for j in range(seeds)])
        keys = torch.stack([prng.PRNGKey(20 + j, "cpu")
                            for j in range(seeds)])
        ss = stack_seeds([init(store, k) for k in keys])
        chunk = make_seeds_chunk_fn(fl, round_fn, sample, K, seeds,
                                    with_frozen=True)
        states, _, met = chunk(states, fz, ss, store, keys)
        glob = [states.global_tr[j] for j in range(seeds)]
    else:
        key = prng.PRNGKey(20, "cpu")
        chunk = make_chunk_fn(fl, round_fn, sample, K, with_frozen=True)
        states, _, met = chunk(init_fl_state(prng.PRNGKey(10, "cpu"), fl,
                                             tr), fz, init(store, key),
                               store, key)
        glob = [states.global_tr]
    _assert_frozen_kept(fz, snap)
    return states, glob, met


@pytest.mark.parametrize("seeds", [0, SEEDS])
@pytest.mark.parametrize("arch", ARCHS)
def test_executors_with_frozen_match_reference(arch, seeds, chunk_ref):
    """``make_chunk_fn(..., with_frozen=True)`` (seeds 0) and
    ``make_seeds_chunk_fn(..., with_frozen=True)`` over 2 seeds, K = 2
    rounds of sine availability on the flat state: the globals within
    1e-4, τ and n_active bit-equal, the losses within 1e-4."""
    r = chunk_ref(arch, seeds)
    states, glob, met = _port_chunk(r, seeds)
    assert len(glob) == len(r["global_"])
    for g, w in zip(glob, r["global_"]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(states.tau.numpy(), r["tau"])
    np.testing.assert_array_equal(met["n_active"].numpy(),
                                  r["metrics"]["n_active"])
    np.testing.assert_allclose(met["loss"].numpy(), r["metrics"]["loss"],
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# serving with adapters
# ---------------------------------------------------------------------------

#: the prompt (a multiple of 128, the flash branch's condition), decode
#: steps
PROMPT, STEPS = 128, 4


@pytest.mark.parametrize("backend", ["xla", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, backend):
    """``prefill`` of a 128-token prompt (logits and caches within 2e-4)
    then 4 greedy ``serve_step``s fed the reference's tokens (logits
    within 1e-3), with nonzero adapters."""
    jcfg, cfg, jp, tp = _weights(arch, attn_backend=backend)
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    seq = PROMPT + STEPS
    jcache = jm.init_cache(jcfg, B, seq, dtype=jnp.float32)
    tcache = tm.init_cache(cfg, B, seq, torch.float32, device="cpu")
    jl, jcache = jm.prefill(jp, jcfg, jcache, jnp.asarray(toks))
    tl, tcache = tm.prefill(tp, cfg, tcache, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                               atol=2e-4)
    _assert_close(tcache, jcache, 2e-4)
    step = jax.jit(lambda p, c, t, q: jm.serve_step(p, jcfg, c, t, q))
    for i in range(STEPS):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        pos = np.full((B,), PROMPT + i, np.int32)
        jl, jcache = step(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tcache = tm.serve_step(tp, cfg, tcache, torch.from_numpy(nxt),
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    """``launch.serve --arch`` builds the reduced LoRA config with its
    adapters and finishes every request."""
    from repro_torch.launch import serve

    stats = serve.main(["--arch", arch, "--device", "cpu", "--requests",
                        "3", "--slots", "2", "--max-new", "4"])
    assert stats["decode_steps"] > 0
    out = capsys.readouterr().out
    assert all(f"req{i}:" in out for i in range(3))
