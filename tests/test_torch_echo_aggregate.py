"""The port's echo-aggregate plain version against the JAX package's
oracle and its Pallas kernel in interpret mode, over the shapes of
tests/test_kernels.py::test_echo_aggregate_sweep; and the ops wrapper's
device dispatch on CPU tensors (plain version, no launch counted)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.echo_aggregate import kernel as ref_kernel  # noqa: E402
from repro.kernels.echo_aggregate import ref as ref_ref  # noqa: E402
from repro_torch.kernels.echo_aggregate import ops, ref  # noqa: E402

SWEEP = [(2, 17, "float32", 8), (4, 100, "float32", 64),
         (16, 4096, "float32", 1024), (8, 1000, "bfloat16", 256),
         (32, 5000, "bfloat16", 2048), (3, 1, "float32", 8)]


def _inputs(m, N, dtype, seed=None, mask_p=0.7):
    rng = np.random.default_rng(m * N if seed is None else seed)
    x = rng.normal(size=(m, N)).astype(np.float32)
    y = rng.normal(size=(m, N)).astype(np.float32)
    g = rng.normal(size=(N,)).astype(np.float32)
    mask = (rng.random(m) < mask_p).astype(np.float32)
    echo = rng.integers(1, 12, m).astype(np.float32)
    upload = (0.8 ** rng.integers(0, 4, m)).astype(np.float32)
    jx = {"x": jnp.asarray(x, dtype), "y": jnp.asarray(y, dtype),
          "g": jnp.asarray(g), "mask": jnp.asarray(mask),
          "echo": jnp.asarray(echo), "upload": jnp.asarray(upload)}
    tdt = getattr(torch, dtype)
    tx = {"x": torch.from_numpy(x).to(tdt), "y": torch.from_numpy(y).to(tdt),
          "g": torch.from_numpy(g), "mask": torch.from_numpy(mask),
          "echo": torch.from_numpy(echo), "upload": torch.from_numpy(upload)}
    return jx, tx


def _tol(dtype):
    return 1e-5 if dtype == "float32" else 5e-2


@pytest.mark.parametrize("m,N,dtype,block", SWEEP)
def test_plain_matches_reference_and_pallas(m, N, dtype, block):
    jx, tx = _inputs(m, N, dtype)
    got = ref.echo_aggregate_ref(tx["x"], tx["y"], tx["mask"], tx["echo"],
                                 1.7).numpy()
    want = np.asarray(ref_ref.echo_aggregate_ref(
        jx["x"], jx["y"], jx["mask"], jx["echo"], 1.7))
    pallas = np.asarray(ref_kernel.echo_aggregate_pallas(
        jx["x"], jx["y"], jx["mask"], jx["echo"], 1.7, block_n=block))
    tol = _tol(dtype)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)


@pytest.mark.parametrize("m,N,dtype,block", SWEEP)
@pytest.mark.parametrize("with_upload", [False, True])
def test_fused_plain_matches_reference_and_pallas(m, N, dtype, block,
                                                  with_upload):
    jx, tx = _inputs(m, N, dtype)
    up_j = jx["upload"] if with_upload else None
    up_t = tx["upload"] if with_upload else None
    got = ref.echo_aggregate_fused_ref(
        tx["x"], tx["y"], tx["g"], tx["mask"], tx["echo"], 0.9,
        upload=up_t).numpy()
    want = np.asarray(ref_ref.echo_aggregate_fused_ref(
        jx["x"], jx["y"], jx["g"], jx["mask"], jx["echo"], 0.9,
        upload=up_j))
    pallas = np.asarray(ref_kernel.echo_aggregate_fused_pallas(
        jx["x"], jx["y"], jx["g"], jx["mask"], jx["echo"], 0.9,
        block_n=block, upload=up_j))
    tol = _tol(dtype)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_empty_mask_returns_global_exactly(dtype):
    jx, tx = _inputs(8, 300, dtype, mask_p=0.0)
    assert float(tx["mask"].sum()) == 0.0
    got = ops.echo_aggregate_flat(tx["x"], tx["y"], tx["g"], tx["mask"],
                                  tx["echo"], 1.3)
    assert torch.equal(got, tx["g"])
    pallas = np.asarray(ref_kernel.echo_aggregate_fused_pallas(
        jx["x"], jx["y"], jx["g"], jx["mask"], jx["echo"], 1.3,
        block_n=128))
    np.testing.assert_array_equal(got.numpy(), pallas)
    # upload zeroes every delivering client: the same W = I guard
    _, tx1 = _inputs(8, 300, dtype, mask_p=1.0)
    got = ops.echo_aggregate_flat(tx1["x"], tx1["y"], tx1["g"], tx1["mask"],
                                  tx1["echo"], 1.3,
                                  upload=torch.zeros(8))
    assert torch.equal(got, tx1["g"])


def test_wrappers_take_plain_version_on_cpu_and_count_nothing():
    ops.echo_aggregate_flat.launches = 0
    ops.echo_aggregate_flat.upload_launches = 0
    ops.echo_aggregate.launches = 0
    _, tx = _inputs(5, 77, "float32")
    got = ops.echo_aggregate_flat(tx["x"], tx["y"], tx["g"], tx["mask"],
                                  tx["echo"], 1.1, upload=tx["upload"])
    want = ref.echo_aggregate_fused_ref(tx["x"], tx["y"], tx["g"],
                                        tx["mask"], tx["echo"], 1.1,
                                        upload=tx["upload"])
    assert torch.equal(got, want)
    got = ops.echo_aggregate(tx["x"].reshape(5, 7, 11),
                             tx["y"].reshape(5, 7, 11), tx["mask"],
                             tx["echo"], 1.1)
    assert got.shape == (7, 11)
    assert torch.equal(got.reshape(-1), ref.echo_aggregate_ref(
        tx["x"], tx["y"], tx["mask"], tx["echo"], 1.1))
    assert ops.echo_aggregate_flat.launches == 0
    assert ops.echo_aggregate_flat.upload_launches == 0
    assert ops.echo_aggregate.launches == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, tx = _inputs(4, 64, "float32")
    args = (tx["g"], tx["mask"], tx["echo"], 1.0)
    with pytest.raises(TypeError):
        ops.echo_aggregate_flat(tx["x"].half(), tx["y"].half(), *args)
    with pytest.raises(TypeError):
        ops.echo_aggregate_flat(tx["x"], tx["y"].bfloat16(), *args)
    with pytest.raises(ValueError):
        ops.echo_aggregate_flat(tx["x"], tx["y"][:, :32], *args)
    with pytest.raises(ValueError):
        ops.echo_aggregate_flat(tx["x"].t().contiguous().t(), tx["y"], *args)
    with pytest.raises(ValueError):
        ops.echo_aggregate_flat(tx["x"], tx["y"], tx["g"][:10], tx["mask"],
                                tx["echo"], 1.0)
    with pytest.raises(ValueError):
        ops.echo_aggregate_flat(tx["x"], tx["y"], tx["g"], tx["mask"][:3],
                                tx["echo"], 1.0)
    with pytest.raises(TypeError):
        ops.echo_aggregate_flat(tx["x"], tx["y"], tx["g"], tx["mask"],
                                tx["echo"], torch.tensor(1.0))
