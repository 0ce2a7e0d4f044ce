"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX package's Pallas kernel in interpret mode and its jnp
oracle, over the cases of tests/test_kernels.py (the six-case sweep, the
dtype case and the model-layout wrapper case) with that file's bounds:
1e-4 in float32, 3e-2 in bfloat16, and bfloat16 at head dim 256 with
chip_smoke.py's row-scaled bound, which a test here also holds against
tile faults.  On CPU tensors ``flash_mha`` runs the plain version;
chip_smoke.py holds the CUDA kernel against the plain version on the card
over the same cases."""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention  # noqa: E402
from repro.kernels.flash_attention.ops import flash_mha as jax_flash_mha  # noqa: E402
from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke",
    pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# tests/test_kernels.py::test_flash_attention_sweep, plus the window's
# lower edge: window 5 under 16-wide tiles leaves rows fully masked inside
# live key tiles (query row 31 attends keys 27..31 only, yet the key tile
# 0..15 is live for the block of rows 16..31)
SWEEP = [
    (2, 4, 4, 64, 64, 32, None, 0.0, True),
    (1, 4, 2, 32, 64, 16, None, 0.0, True),       # GQA + suffix alignment
    (2, 2, 2, 64, 64, 32, 24, 0.0, True),          # sliding window
    (1, 2, 1, 64, 64, 64, None, 20.0, True),       # softcap
    (1, 2, 2, 64, 64, 32, None, 0.0, False),       # bidirectional
    (1, 8, 4, 128, 128, 64, 48, 30.0, True),       # everything at once
]
WINDOW_EDGE = (1, 4, 2, 64, 64, 32, 5, 0.0, True)


def _qkv(B, H, K, L, S, D, seed, dtype=np.float32):
    """[B, H, L, D] / [B, K, S, D] numpy inputs, as the reference test
    draws them."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, L, D)).astype(dtype)
    k = rng.normal(size=(B, K, S, D)).astype(dtype)
    v = rng.normal(size=(B, K, S, D)).astype(dtype)
    return q, k, v


def _port_bhld(q, k, v, dtype=torch.float32, **kw):
    """The port's flash_mha on [B, H, L, D] numpy inputs (it takes the
    model layout), returned as [B, H, L, D] float32 numpy."""
    t = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
         .to(dtype) for x in (q, k, v)]
    out = ops.flash_mha(*t, **kw)
    return out.transpose(1, 2).float().numpy()


@pytest.mark.parametrize("B,H,K,L,S,D,window,softcap,causal",
                         SWEEP + [WINDOW_EDGE])
def test_flash_mha_matches_pallas_and_oracle(B, H, K, L, S, D, window,
                                             softcap, causal):
    q, k, v = _qkv(B, H, K, L, S, D, seed=L + S)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _port_bhld(q, k, v, **kw)
    pallas = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), block_l=16,
                                        block_s=16, **kw))
    G = H // K
    oracle = np.asarray(jax_mha_ref(jnp.asarray(q),
                                    jnp.repeat(jnp.asarray(k), G, 1),
                                    jnp.repeat(jnp.asarray(v), G, 1), **kw))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)
    # the plain version alone, in the reference oracle's own layout
    plain = ref.mha_ref(torch.from_numpy(q),
                        torch.from_numpy(k).repeat_interleave(G, 1),
                        torch.from_numpy(v).repeat_interleave(G, 1), **kw)
    np.testing.assert_allclose(plain.numpy(), oracle, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
def test_flash_mha_dtypes(dtype, tol):
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=s) for s in
               ((1, 4, 64, 32), (1, 2, 64, 32), (1, 2, 64, 32)))
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    want = np.asarray(flash_attention(jq, jk, jv, block_l=32, block_s=32),
                      np.float32)
    # the same rounded inputs on both sides
    got = _port_bhld(*(np.asarray(x, np.float32) for x in (jq, jk, jv)),
                     dtype=getattr(torch, dtype))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# head dim 256 (gemma2-2b's, the main path's build of the CUDA kernel) at
# short lengths, where outputs are O(1)
@pytest.mark.parametrize("B,H,K,L,S,D,window,softcap,causal",
                         chip_smoke.HEAD256_CASES)
def test_flash_mha_head_dim_256_bf16(B, H, K, L, S, D, window, softcap,
                                     causal):
    """bfloat16 against the Pallas kernel in interpret mode: 3e-2 as in
    tests/test_kernels.py, and every output row within 2e-2 of its own
    largest element (chip_smoke.py's row-scaled bound)."""
    q, k, v = _qkv(B, H, K, L, S, D, seed=L + S + 1)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(flash_attention(jq, jk, jv, **kw), np.float32)
    got = _port_bhld(*(np.asarray(x, np.float32) for x in (jq, jk, jv)),
                     dtype=torch.bfloat16, **kw)
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
    row_err = np.abs(got - want).max(-1) / np.abs(want).max(-1)
    assert row_err.max() <= 2e-2, row_err.max()


@pytest.mark.parametrize("fault", [None, "diagonal_tile", "window_shift",
                                   "late_rows_scaled"])
def test_row_bound_separates_rounding_from_tile_faults(fault):
    """chip_smoke.py's row-scaled bound at a long windowed row (L 4096,
    window 2048, D 256, soft-cap 50, bfloat16): rounding p and p.v in
    float32 instead of bfloat16 stays within it; a fault confined to the
    late rows, which average over thousands of keys (a dropped diagonal
    32-key tile, the window shifted by 32 keys, the output scaled by
    0.75), does not."""
    L, D, W, cap = 4096, 256, 2048, 50.0
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 1, L, D, generator=gen).bfloat16()
               for _ in range(3))
    qp = torch.arange(L)[:, None]
    kp = torch.arange(L)[None, :]
    late = qp >= L // 2

    def attn(mask, dtype=torch.bfloat16):
        s = torch.einsum("bhld,bhsd->bhls", q.float(), k.float()) * D ** -0.5
        s = torch.tanh(s / cap) * cap
        p = torch.softmax(s.masked_fill(~mask, ref.NEG_INF), -1)
        return torch.einsum("bhls,bhsd->bhld", p.to(dtype),
                            v.to(dtype)).bfloat16()

    base = (qp >= kp) & (qp - kp < W)
    plain = attn(base)
    if fault is None:
        out = attn(base, torch.float32)
    elif fault == "diagonal_tile":
        out = attn(base & ~(late & (kp // 32 == qp // 32)))
    elif fault == "window_shift":
        out = attn((qp >= kp) & (qp - kp < W + 32 * late))
    else:
        out = plain.clone()
        out[:, :, L // 2:] = (plain[:, :, L // 2:].float() * 0.75).bfloat16()
    err = chip_smoke.row_rel_err(out, plain)
    tol = chip_smoke.FLASH_ROW_TOL["bfloat16"]
    assert (err <= tol) == (fault is None), err


def test_flash_mha_model_layout():
    """tests/test_kernels.py::test_flash_mha_wrapper_model_layout."""
    rng = np.random.default_rng(9)
    q = rng.normal(size=(2, 32, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    before = ops.flash_mha.launches
    got = ops.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v))
    assert ops.flash_mha.launches == before  # CPU tensors: no launch
    assert got.shape == (2, 32, 4, 16)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    pallas = jax_flash_mha(jq, jk, jv, block_l=16, block_s=16)
    oracle = jax_flash_mha(jq, jk, jv, use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-4,
                               atol=1e-4)


def _kernel_operands(which):
    """CPU operands (q, k) that only the CUDA kernels' own check refuses:
    views with size-1 or stride-0 dims, so nothing large is allocated."""
    z = torch.zeros(1, 1, 1, 8, dtype=torch.bfloat16)
    if which == "head_dim_12":
        return torch.zeros(1, 1, 1, 12), torch.zeros(1, 1, 1, 12)
    if which == "head_dim_264":
        return torch.zeros(1, 1, 1, 264), torch.zeros(1, 1, 1, 264)
    if which == "last_stride":
        t = torch.zeros(1, 1, 1, 16, dtype=torch.bfloat16)[..., ::2]
        return t, z
    if which == "misaligned":
        t = torch.zeros(1, 1, 1, 9, dtype=torch.bfloat16)[..., 1:]
        return t, z
    if which == "row_stride":
        t = torch.zeros(1, 2, 1, 12, dtype=torch.bfloat16)[..., :8]
        return t, z
    if which == "stride_2_40":
        # a batch stride of 2^40 bytes on a size-1 dim: no storage needed
        t = torch.as_strided(torch.zeros(8, dtype=torch.bfloat16),
                             (1, 1, 1, 8), (2 ** 39, 8, 8, 1))
        return t, z
    if which == "batch_65536":
        return z.expand(65536, 1, 1, 8), z
    if which == "heads_65536":
        return z.expand(1, 1, 65536, 8), z
    if which == "query_tiles_65536":
        return z.expand(1, 65535 * 128 + 1, 1, 8), z
    raise AssertionError(which)


@pytest.mark.parametrize("change,exc", [
    (dict(L=65), ValueError),                      # L > S
    (dict(H=3), ValueError),                       # H % K != 0
    (dict(window=0), ValueError),
    (dict(window=True), ValueError),
    (dict(softcap=-1.0), ValueError),
    (dict(dtype=torch.float16), TypeError),
    # what only the CUDA kernels refuse (ops._check_kernel_operands, called
    # on CPU tensors here: flash_mha runs it on CUDA tensors only)
    (dict(kernel="head_dim_12"), ValueError),
    (dict(kernel="head_dim_264"), ValueError),
    (dict(kernel="last_stride"), ValueError),
    (dict(kernel="misaligned"), ValueError),
    (dict(kernel="row_stride"), ValueError),
    (dict(kernel="stride_2_40"), ValueError),      # TMA strides < 2^40 B
    (dict(kernel="batch_65536"), ValueError),      # grid axes <= 65 535
    (dict(kernel="heads_65536"), ValueError),
    (dict(kernel="query_tiles_65536"), ValueError),
])
def test_flash_mha_rejects(change, exc):
    if "kernel" in change:
        q, k = _kernel_operands(change["kernel"])
        with pytest.raises(exc):
            ops._check_kernel_operands(q, k, k)
        return
    p = dict(B=1, L=64, S=64, H=4, K=2, D=16, window=None, softcap=0.0,
             dtype=torch.float32)
    p.update(change)
    q = torch.zeros(p["B"], p["L"], p["H"], p["D"], dtype=p["dtype"])
    k = torch.zeros(p["B"], p["S"], p["K"], p["D"], dtype=p["dtype"])
    with pytest.raises(exc):
        ops.flash_mha(q, k, k, window=p["window"], softcap=p["softcap"])


def test_kernel_operands_accept_the_limits():
    """The largest grid and the model layouts pass the kernels' check."""
    z = torch.zeros(1, 1, 1, 8, dtype=torch.bfloat16)
    ops._check_kernel_operands(z.expand(65535, 65535 * 128, 1, 8), z, z)
    ops._check_kernel_operands(z.expand(1, 1, 65535, 8), z, z)
    for D in (16, 112, 256):
        q = torch.zeros(2, 64, 8, D, dtype=torch.bfloat16)
        k = torch.zeros(2, 64, 4, D, dtype=torch.bfloat16)
        ops._check_kernel_operands(q, k, k)
        ops._check_kernel_operands(q.float(), k.float(), k.float())
