"""The port's flat substrate and Table-6 CNN against the JAX package:
FlatSpec layout and round trip, forward, loss and the clipped gradient
from the same weights (carried over by params_from_numpy)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import engine as ref_engine  # noqa: E402
from repro.core.flatten import FlatSpec as RefSpec  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch.checkpointing import params_from_numpy  # noqa: E402
from repro_torch.core import engine, prng  # noqa: E402
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
