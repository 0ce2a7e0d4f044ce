"""The port's SSD chunk kernel module (``repro_torch.kernels.ssd_chunk``)
against the JAX package on the CPU, over the shapes of
tests/test_kernel_ssd.py with that file's bounds:

  * the plain version (``ref.ssd_chunk_ref``) and the checked wrapper
    (``ops.ssd_chunk``, which takes the plain version on CPU tensors)
    against the Pallas kernel in interpret mode and the jnp oracle: 1e-5
    in float32, the decay within 1e-6 relative; the wrapper on the
    strided ``[b, l, h, .]`` views and the stride-0 group expansion the
    model hands it, at K = 1 too;
  * the scan (``ops.ssd_chunked``) against ``ssd_chunked_pallas``: 1e-5
    in float32, 5e-2 in bfloat16, and against the recurrence oracle;
  * the bfloat16 SSD drift witness: the reference's own spread between
    its jnp ``ssd_chunked`` and its drop-in equals
    ``chip_smoke.REF_SSD_DRIFT``, and the port's scan stays within
    ``SSD_WITNESS_RATIO`` times it of the reference's drop-in;
  * what the wrapper refuses.

chip_smoke.py holds the CUDA kernel against the plain version on the card."""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssd_chunk.kernel import ssd_chunk_pallas  # noqa: E402
from repro.kernels.ssd_chunk.ops import ssd_chunked_pallas  # noqa: E402
from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as jax_chunk_ref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels.ssd_chunk import ops, ref  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke",
    pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# tests/test_kernel_ssd.py::test_ssd_chunk_kernel_vs_ref
SHAPES = [(1, 8, 1, 4, 4, 4), (2, 32, 3, 8, 4, 8), (1, 64, 2, 16, 8, 16),
          (2, 24, 2, 8, 16, 12)]


def _inputs(seed, b, l, h, p, n, groups=None):
    """tests/test_kernel_ssd.py's draw, as numpy [b, l, h, .] arrays; with
    ``groups`` B and C are drawn per group [b, l, groups, n]."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = np.abs(rng.normal(size=(b, l, h)).astype(np.float32)) * 0.3 + 0.01
    A = -np.abs(rng.normal(size=(h,)).astype(np.float32)) - 0.1
    g = h if groups is None else groups
    B_ = rng.normal(size=(b, l, g, n)).astype(np.float32)
    C_ = rng.normal(size=(b, l, g, n)).astype(np.float32)
    return x * dt[..., None], dt * A, B_, C_


def _grp(v, b, c, chunk, h, feat):
    v = v.reshape((b, c, chunk, h) + ((feat,) if feat else ()))
    return v.transpose((0, 3, 1, 2, 4) if feat else (0, 3, 1, 2))


def _assert_chunk_close(got, want):
    for g, w, name in zip(got[:2], want[:2], ("y_diag", "states")):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6, err_msg="decay")


@pytest.mark.parametrize("b,l,h,p,n,chunk", SHAPES)
def test_ssd_chunk_ref_matches_pallas(b, l, h, p, n, chunk):
    xdt, dA, B_, C_ = _inputs(l + h, b, l, h, p, n)
    c = l // chunk
    args = (_grp(xdt, b, c, chunk, h, p), _grp(dA, b, c, chunk, h, 0),
            _grp(B_, b, c, chunk, h, n), _grp(C_, b, c, chunk, h, n))
    got = ref.ssd_chunk_ref(*(torch.from_numpy(np.ascontiguousarray(a))
                              for a in args))
    jargs = [jnp.asarray(a) for a in args]
    _assert_chunk_close(got, ssd_chunk_pallas(*jargs))
    _assert_chunk_close(got, jax_chunk_ref(*jargs))


@pytest.mark.parametrize("b,l,h,p,n,chunk", SHAPES + [(2, 5, 3, 8, 4, 1)])
def test_ssd_chunk_wrapper_on_model_views(b, l, h, p, n, chunk):
    """The wrapper on what the model hands it: regrouped views of
    [b, l, h, .] tensors, B and C one group expanded over the heads with
    stride 0.  On CPU tensors it launches nothing."""
    xdt, dA, B1, C1 = _inputs(l + 7 * h, b, l, h, p, n, groups=1)
    c = l // chunk
    tx, tA, tB, tC = (torch.from_numpy(a) for a in (xdt, dA, B1, C1))
    tB, tC = (t.expand(b, l, h, n) for t in (tB, tC))
    assert h == 1 or tB.stride(2) == 0
    views = [ops.regroup(t, chunk) for t in (tx, tA, tB, tC)]
    assert views[2].data_ptr() == tB.data_ptr()  # no copy
    before = ops.ssd_chunk.launches
    got = ops.ssd_chunk(*views)
    assert ops.ssd_chunk.launches == before
    Bh, Ch = (np.broadcast_to(a, (b, l, h, n)) for a in (B1, C1))
    want = ssd_chunk_pallas(
        jnp.asarray(_grp(xdt, b, c, chunk, h, p)),
        jnp.asarray(_grp(dA, b, c, chunk, h, 0)),
        jnp.asarray(_grp(Bh, b, c, chunk, h, n)),
        jnp.asarray(_grp(Ch, b, c, chunk, h, n)))
    _assert_chunk_close(got, want)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 5e-2)])
def test_ssd_chunked_matches_pallas_pipeline(dtype, tol):
    """tests/test_kernel_ssd.py::test_ssd_pipeline_vs_recurrence's inputs:
    the port's scan against the reference's drop-in, and against the
    recurrence oracle within that test's bound."""
    xdt, dA, B_, C_ = _inputs(0, 2, 32, 2, 8, 4)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    jargs = (jnp.asarray(xdt).astype(jd), jnp.asarray(dA),
             jnp.asarray(B_).astype(jd), jnp.asarray(C_).astype(jd))
    targs = (torch.from_numpy(xdt).to(td), torch.from_numpy(dA),
             torch.from_numpy(B_).to(td), torch.from_numpy(C_).to(td))
    y, f = ops.ssd_chunked(*targs, 8)
    yp, fp = ssd_chunked_pallas(*jargs, 8)
    assert y.dtype == td and tuple(f.shape) == (2, 2, 8, 4)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yp, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(f.numpy(), np.asarray(fp), rtol=tol, atol=tol)
    yr, fr = jssm.ssd_recurrence_ref(*jargs)
    rtol = 1e-4 if dtype == "float32" else tol
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yr, np.float32),
                               rtol=rtol, atol=rtol)
    np.testing.assert_allclose(f.numpy(), np.asarray(fr), rtol=rtol,
                               atol=rtol)


def test_ssd_chunked_initial_state_and_plain_route():
    """An initial state carries through as in the reference's drop-in;
    the plain route (chip_smoke's oracle on the card) equals the wrapper's
    on CPU tensors bit for bit."""
    xdt, dA, B_, C_ = _inputs(3, 2, 48, 3, 8, 6)
    s0 = np.random.default_rng(4).normal(size=(2, 3, 8, 6)).astype(
        np.float32)
    targs = [torch.from_numpy(a) for a in (xdt, dA, B_, C_)]
    y, f = ops.ssd_chunked(*targs, 16, initial_state=torch.from_numpy(s0))
    yp, fp = ssd_chunked_pallas(*(jnp.asarray(a) for a in (xdt, dA, B_, C_)),
                                16, initial_state=jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(f.numpy(), np.asarray(fp), rtol=1e-5,
                               atol=1e-5)
    y2, f2 = ops.ssd_chunked_plain(*targs, 16,
                                   initial_state=torch.from_numpy(s0))
    assert torch.equal(y, y2) and torch.equal(f, f2)


def _chunk_args(K=8, P=4, N=4, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(1, 2, 3, K, P, generator=g).to(dtype),
            -torch.rand(1, 2, 3, K, generator=g),
            torch.randn(1, 2, 3, K, N, generator=g).to(dtype),
            torch.randn(1, 2, 3, K, N, generator=g).to(dtype)]


@pytest.mark.parametrize("case", ["K129", "P129", "N129", "dtypes",
                                  "dA_bf16", "rank", "float16"])
def test_ssd_chunk_rejects(case):
    """Shapes outside 1 <= K, P, N <= 128 and dtypes the kernel does not
    take raise on every device (never a silent plain path)."""
    args = {
        "K129": lambda: _chunk_args(K=129),
        "P129": lambda: _chunk_args(P=129),
        "N129": lambda: _chunk_args(N=129),
        "dtypes": lambda: (lambda a: [a[0], a[1], a[2].bfloat16(), a[3]])(
            _chunk_args()),
        "dA_bf16": lambda: (lambda a: [a[0], a[1].bfloat16(), a[2], a[3]])(
            _chunk_args()),
        "rank": lambda: (lambda a: [a[0][0], a[1][0], a[2][0], a[3][0]])(
            _chunk_args()),
        "float16": lambda: _chunk_args(dtype=torch.float16),
    }[case]()
    with pytest.raises((ValueError, TypeError)):
        ops.ssd_chunk(*args)


def test_ssd_chunk_takes_the_limits():
    """K = P = N = 128 (the largest tile the kernel takes) and K = 1."""
    for K, P, N in ((128, 128, 128), (1, 3, 5)):
        y, st, dec = ops.ssd_chunk(*_chunk_args(K, P, N))
        assert tuple(y.shape) == (1, 2, 3, K, P)
        assert tuple(st.shape) == (1, 2, 3, N, P)
        assert tuple(dec.shape) == (1, 2, 3)


# ---------------------------------------------------------------------------
# the bfloat16 SSD drift witness
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ssd_witness():
    a = chip_smoke.ssd_witness_arrays(np)
    jargs = (jnp.asarray(a["xdt"]).astype(jnp.bfloat16), jnp.asarray(a["dA"]),
             jnp.asarray(a["B"]).astype(jnp.bfloat16),
             jnp.asarray(a["C"]).astype(jnp.bfloat16))
    targs = (torch.from_numpy(a["xdt"]).bfloat16(), torch.from_numpy(a["dA"]),
             torch.from_numpy(a["B"]).bfloat16(),
             torch.from_numpy(a["C"]).bfloat16())
    return jargs, targs, chip_smoke.SSD_WITNESS["chunk"]


def test_reference_ssd_drift_matches_record(ssd_witness):
    jargs, _, chunk = ssd_witness
    y1, _ = jssm.ssd_chunked(*jargs, chunk)
    y2, _ = ssd_chunked_pallas(*jargs, chunk)
    y1, y2 = np.asarray(y1, np.float32), np.asarray(y2, np.float32)
    ref_ = chip_smoke.REF_SSD_DRIFT
    assert float(np.abs(y1 - y2).max()) == pytest.approx(ref_["y"], rel=1e-6)
    assert float(np.abs(y1).max()) == pytest.approx(ref_["y_absmax"],
                                                    rel=1e-6)
    assert float(np.abs(y1 - y2).max() / np.abs(y1).max()) == \
        pytest.approx(ref_["rel"], rel=1e-6)


def test_port_ssd_bf16_matches_reference(ssd_witness):
    """The port's scan (plain route on the CPU) against the reference's
    drop-in, and the port's jnp-port ``ssd_chunked`` against the
    reference's: each within SSD_WITNESS_RATIO times the reference's own
    spread, as a share of the largest output."""
    from repro_torch.models import ssm

    jargs, targs, chunk = ssd_witness
    ratio = chip_smoke.SSD_WITNESS_RATIO
    bound = ratio * chip_smoke.REF_SSD_DRIFT["rel"]
    for port, jax_fn in ((ops.ssd_chunked, ssd_chunked_pallas),
                         (ssm.ssd_chunked, jssm.ssd_chunked)):
        y, f = port(*targs, chunk)
        yj, fj = jax_fn(*jargs, chunk)
        yj = np.asarray(yj, np.float32)
        rel = float(np.abs(y.float().numpy() - yj).max() / np.abs(yj).max())
        assert rel <= bound, (port.__module__, rel, bound)
        np.testing.assert_allclose(f.numpy(), np.asarray(fj), rtol=1e-5,
                                   atol=1e-5)
