"""The port's flat substrate, tree helpers, Table-6 CNN and the paper
harness's MLP against the JAX package: FlatSpec layout, round trip and
per-leaf views; every tree_util helper on the same trees; forward, loss
and the clipped gradient from the same weights (carried over by
params_from_numpy); the MLP's init within 1e-5 and its forward from the
same weights within 1e-5."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import engine as ref_engine  # noqa: E402
from repro.core import tree_util as ref_tu  # noqa: E402
from repro.core.flatten import FlatSpec as RefSpec  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch.checkpointing import params_from_numpy  # noqa: E402
from repro_torch.core import engine, prng  # noqa: E402
from repro_torch.core import tree_util as tu  # noqa: E402
from repro_torch.core.flatten import FlatSpec, resident_dtype  # noqa: E402
from repro_torch.core.tree_util import (tree_from_paths,  # noqa: E402
                                        tree_leaves, tree_paths)
from repro_torch.models import cnn  # noqa: E402

WIDTHS = [dict(channels=(4, 8), hidden=(16,)),
          dict(channels=(32, 32), hidden=(128,))]


def _ref_params(seed=0, **widths):
    p = ref_cnn.init_cnn(jax.random.PRNGKey(seed), in_shape=(8, 8, 1),
                         **widths)
    return jax.tree.map(np.asarray, p)


def _batch(seed, B=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 8, 8, 1)).astype(np.float32),
            rng.integers(0, 10, B).astype(np.int32))


@pytest.mark.parametrize("widths", WIDTHS)
def test_flatspec_layout_and_round_trip(widths):
    ref_p = _ref_params(**widths)
    tp = params_from_numpy(ref_p, "cpu")
    ref_spec, spec = RefSpec.from_tree(ref_p), FlatSpec.from_tree(tp)
    assert spec.offsets == ref_spec.offsets
    assert spec.sizes == ref_spec.sizes
    assert spec.shapes == ref_spec.shapes
    assert spec.paths[:2] == (("conv0", "b"), ("conv0", "w"))
    flat = spec.flatten(tp)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(ref_spec.flatten(ref_p)))
    back = spec.unflatten(flat)
    for a, b in zip(tree_leaves(back), tree_leaves(tp)):
        assert torch.equal(a, b)
        # narrow().view(): every leaf shares the flat buffer's storage
        assert a.untyped_storage().data_ptr() == \
            flat.untyped_storage().data_ptr()
    stack = torch.stack([flat, 2 * flat, -flat])
    leaves = tree_leaves(spec.unflatten_stacked(stack))
    assert all(leaf.shape[0] == 3 for leaf in leaves)
    assert torch.equal(spec.flatten_stacked(spec.unflatten_stacked(stack)),
                       stack)
    if widths["channels"] == (32, 32):
        assert spec.size == 27370


def test_resident_dtype_names():
    assert resident_dtype("float32") is torch.float32
    assert resident_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(NotImplementedError):
        resident_dtype("int8")
    with pytest.raises(ValueError):
        resident_dtype("float16")


@pytest.mark.parametrize("seed", [0, 3])
def test_init_cnn_within_tolerance(seed):
    ref_p = _ref_params(seed)
    got = cnn.init_cnn(prng.PRNGKey(seed, "cpu"))
    for a, b in zip(tree_leaves(got), tree_leaves(params_from_numpy(ref_p, "cpu"))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("widths", WIDTHS)
def test_forward_loss_accuracy_match(widths):
    ref_p = _ref_params(1, **widths)
    x, y = _batch(1)
    want = np.asarray(ref_cnn.cnn_apply(ref_p, jnp.asarray(x)))
    tp = params_from_numpy(ref_p, "cpu")
    got = cnn.cnn_apply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(cnn.xent_loss(got, torch.from_numpy(y))),
        float(ref_cnn.xent_loss(jnp.asarray(want), jnp.asarray(y))),
        rtol=1e-5, atol=1e-5)
    batch = dict(images=torch.from_numpy(x), labels=torch.from_numpy(y))
    assert float(cnn.accuracy(cnn.cnn_apply, tp, batch)) == float(
        ref_cnn.accuracy(ref_cnn.cnn_apply, ref_p,
                         dict(images=jnp.asarray(x), labels=jnp.asarray(y))))


@pytest.mark.parametrize("max_norm", [0.5, 0.0, 1e3])
def test_clipped_gradient_matches(max_norm):
    """One client's clipped gradient: jax.grad + engine._clip against the
    port's client-stacked backward + per-client clip (a [1, ...] stack)."""
    ref_p = _ref_params(2)
    x, y = _batch(2)
    loss_fn = ref_cnn.make_image_loss_fn(ref_cnn.cnn_apply)
    rb = dict(images=jnp.asarray(x), labels=jnp.asarray(y))
    loss, g = jax.value_and_grad(loss_fn)(ref_p, {}, rb, None)
    g = ref_engine._clip(g, max_norm)

    tp = params_from_numpy(ref_p, "cpu")
    stacked = {k: {kk: v[None].clone().requires_grad_(True)
                   for kk, v in d.items()} for k, d in tp.items()}
    t_loss = cnn.make_image_loss_fn(cnn.cnn_apply)
    per = torch.func.vmap(t_loss, in_dims=(0, None, 0, None))
    tb = dict(images=torch.from_numpy(x)[None],
              labels=torch.from_numpy(y)[None])
    out = per(stacked, {}, tb, None)
    grads = torch.autograd.grad(out.sum(), tree_leaves(stacked))
    tg = engine._clip(tree_from_paths(
        [p for p, _ in tree_paths(tp)], list(grads)), max_norm)
    np.testing.assert_allclose(out[0].item(), float(loss), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(tree_leaves(tg), jax.tree.leaves(g)):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("widths", WIDTHS[:1])
def test_flatspec_leaf_views_and_n_leaves(widths):
    """``n_leaves`` and ``leaf_views`` of [N], [m, N] and [S, m, N]
    buffers: the reference's views, in the buffer's dtype."""
    ref_p = _ref_params(**widths)
    ref_spec = RefSpec.from_tree(ref_p)
    spec = FlatSpec.from_tree(params_from_numpy(ref_p, "cpu"))
    assert spec.n_leaves == ref_spec.n_leaves == 8
    rng = np.random.default_rng(4)
    for lead in ((), (3,), (2, 3)):
        buf = rng.normal(size=lead + (spec.size,)).astype(np.float32)
        t = torch.from_numpy(buf)
        got = spec.leaf_views(t)
        want = ref_spec.leaf_views(jnp.asarray(buf))
        assert len(got) == len(want) == spec.n_leaves
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert a.untyped_storage().data_ptr() == \
                t.untyped_storage().data_ptr()
    views = spec.leaf_views(torch.zeros(spec.size, dtype=torch.bfloat16))
    assert all(v.dtype == torch.bfloat16 for v in views)


def _trees(seed, m=5):
    """Two client-stacked trees, a model tree and a mask, from numpy."""
    rng = np.random.default_rng(seed)

    def tree(lead):
        return {"a": {"w": rng.normal(size=lead + (3, 2)),
                      "b": rng.normal(size=lead + (2,))},
                "c": rng.normal(size=lead + (4,))}

    f32 = lambda t: jax.tree.map(lambda x: x.astype(np.float32), t)  # noqa
    mask = np.array([1, 0, 1, 1, 0], np.float32)[:m]
    return f32(tree((m,))), f32(tree((m,))), f32(tree(())), mask


def _both(fn_name, *args, **kw):
    """``fn_name`` of the reference on numpy inputs and of the port on the
    same values as tensors."""
    def to_t(x):
        if isinstance(x, list):
            return [to_t(v) for v in x]
        if isinstance(x, dict):
            return params_from_numpy(x, "cpu")
        return torch.from_numpy(x) if isinstance(x, np.ndarray) else x

    def to_j(x):
        if isinstance(x, list):
            return [to_j(v) for v in x]
        if isinstance(x, (dict, np.ndarray)):
            return jax.tree.map(jnp.asarray, x)
        return x

    want = getattr(ref_tu, fn_name)(*[to_j(a) for a in args], **kw)
    got = getattr(tu, fn_name)(*[to_t(a) for a in args], **kw)
    return got, want


def _assert_tree_close(got, want, tol=1e-6):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_close(g, w, tol)
        return
    if not isinstance(want, dict):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=tol, atol=tol)
        return
    assert [p for p, _ in tree_paths(got)] == [
        tuple(k.key for k in p) for p, _ in
        jax.tree_util.tree_flatten_with_path(want)[0]]
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)


def test_tree_util_matches_reference():
    """The fifteen helpers the tree round uses, on the same trees."""
    x, y, g, mask = _trees(5)
    for name, args in (("tree_sub", (x, y)), ("tree_add", (x, y)),
                       ("tree_scale", (0.3, x)), ("tree_zeros_like", (x,)),
                       ("tree_axpy", (-1.7, x, y)),
                       ("tree_masked_mean", (x, mask)),
                       ("tree_masked_mean", (x, np.zeros(5, np.float32))),
                       ("tree_mean", (x,)), ("tree_select", (mask, x, y)),
                       ("tree_select_broadcast", (mask, g, x)),
                       ("tree_broadcast", (g, 4)), ("tree_dot", (x, y)),
                       ("tree_norm", (x,)), ("global_norm_finite", (x,)),
                       ("tree_unstack", (x, 5))):
        _assert_tree_close(*_both(name, *args))
    _assert_tree_close(*_both("tree_stack",
                              [g, jax.tree.map(lambda a: 2 * a, g)]))
    x["c"][1, 2] = np.nan
    got, want = _both("global_norm_finite", x)
    assert bool(got) is False and bool(want) is False


@pytest.mark.parametrize("hidden", [(), (64,)], ids=["linear", "mlp"])
@pytest.mark.parametrize("seed", [0, 3])
def test_init_mlp_within_tolerance(seed, hidden):
    """The harness's ``"linear"`` (``hidden=()``, N = 650 at d_in 64) and
    ``"mlp"`` (N = 4 810) models: the same leaves, drawn within 1e-5."""
    ref_p = jax.tree.map(np.asarray, ref_cnn.init_mlp(
        jax.random.PRNGKey(seed), d_in=64, hidden=hidden))
    got = cnn.init_mlp(prng.PRNGKey(seed, "cpu"), d_in=64, hidden=hidden)
    want = params_from_numpy(ref_p, "cpu")
    assert [p for p, _ in tree_paths(got)] == [p for p, _ in
                                               tree_paths(want)]
    assert FlatSpec.from_tree(got).size == (650 if not hidden else 4810)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("hidden", [(), (64,)], ids=["linear", "mlp"])
def test_mlp_forward_loss_match(hidden):
    ref_p = jax.tree.map(np.asarray, ref_cnn.init_mlp(
        jax.random.PRNGKey(1), d_in=64, hidden=hidden))
    x, y = _batch(3)
    want = np.asarray(ref_cnn.mlp_apply(ref_p, jnp.asarray(x)))
    got = cnn.mlp_apply(params_from_numpy(ref_p, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(cnn.xent_loss(got, torch.from_numpy(y))),
        float(ref_cnn.xent_loss(jnp.asarray(want), jnp.asarray(y))),
        rtol=1e-5, atol=1e-5)
