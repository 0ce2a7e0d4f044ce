"""The bf16 flash kernel's algorithm, tile by tile, on the CPU.

``ref.flash_mha_tiled_ref`` mirrors the CUDA kernel (128-query blocks of
two 64-row warpgroups, 64-key tiles, base-2 online softmax with the scale
folded in, the exp2 form of the soft-cap's tanh, masks only on edge
tiles, p rounded to bf16 per tile).  Here it is held against the JAX
package's Pallas kernel in interpret mode where that kernel's blocks divide
L and S (its kernel.py:102 asserts that), otherwise against the JAX
package's ``ref.py``, and against the port's ``flash_mha_ref``: 1e-4 in
float32, chip_smoke.py's FLASH_TOL and FLASH_ROW_TOL in bfloat16.  The
edge-tile classification and chip_smoke.py's issued-flop count are held
against brute force over every (query, key) pair."""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention  # noqa: E402
from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke",
    pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CASES = (chip_smoke.FLASH_CASES + chip_smoke.HEAD256_CASES
         + chip_smoke.FLASH_RAGGED_CASES)


def _jax_reference(q, k, v, dtype, **kw):
    """[B, H, L, D] numpy inputs through the Pallas kernel (interpret
    mode) when some block size divides L and S, else the JAX oracle;
    returned as float32 [B, L, H, D]."""
    L, S = q.shape[2], k.shape[2]
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    block = next((b for b in (128, 64, 32, 16)
                  if L % min(b, L) == 0 and S % min(b, S) == 0), None)
    if block is not None:
        out = flash_attention(jq, jk, jv, block_l=block, block_s=block, **kw)
    else:
        G = q.shape[1] // k.shape[1]
        out = jax_mha_ref(jq, jnp.repeat(jk, G, 1), jnp.repeat(jv, G, 1),
                          **kw)
    return np.asarray(out, np.float32).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,L,S,D,window,softcap,causal", CASES)
def test_tiled_ref_matches_jax_and_plain(B, H, K, L, S, D, window, softcap,
                                         causal, dtype):
    rng = np.random.default_rng(L + S + D)
    q = rng.normal(size=(B, H, L, D)).astype(np.float32)
    k = rng.normal(size=(B, K, S, D)).astype(np.float32)
    v = rng.normal(size=(B, K, S, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = _jax_reference(q, k, v, jdt, **kw)
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 1, 3))).to(getattr(torch, dtype))
        for x in (q, k, v))
    got = ref.flash_mha_tiled_ref(tq, tk, tv, **kw)
    plain = ref.flash_mha_ref(tq, tk, tv, **kw)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    got, plain = got.float(), plain.float()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4,
                                   atol=1e-4)
        return
    tol = chip_smoke.FLASH_TOL["bfloat16"]
    row_tol = chip_smoke.FLASH_ROW_TOL["bfloat16"]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=tol,
                               atol=tol)
    assert chip_smoke.row_rel_err(got, torch.from_numpy(want)) <= row_tol
    assert chip_smoke.row_rel_err(got, plain) <= row_tol


def _live(L, S, causal, window):
    """[L, S] bool: the (query, key) pairs the masks leave."""
    qp = np.arange(L)[:, None] + S - L
    kp = np.arange(S)[None, :]
    ok = np.ones((L, S), bool)
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= qp - kp < window
    return ok


TILE_CASES = [(L, S, causal, window)
              for L, S in ((64, 64), (100, 100), (130, 130), (200, 333),
                           (129, 257), (70, 300), (256, 256), (384, 640))
              for causal in (True, False)
              for window in (None, 1, 3, 40, 77, 200)]


@pytest.mark.parametrize("L,S,causal,window", TILE_CASES)
def test_edge_tiles_brute_force(L, S, causal, window):
    """Every key tile the kernel loads holds a live pair of the block, every
    tile it does not load holds none, and every loaded tile that holds a
    masked pair of a warpgroup's rows (or a key past S) is an edge tile
    for that warpgroup."""
    live = _live(L, S, causal, window)
    BM, WG, BN = ref.BLOCK_M, ref.WG_ROWS, ref.BLOCK_N
    n_tiles = -(-S // BN)
    for qt in range(-(-L // BM)):
        t0, nt = ref.block_key_tiles(L, S, causal, window, qt)
        rows = slice(qt * BM, min(qt * BM + BM, L))
        for t in range(n_tiles):
            keys = slice(t * BN, min(t * BN + BN, S))
            any_live = live[rows, keys].any()
            assert (t0 <= t < t0 + nt) == any_live, (qt, t)
        for t in range(t0, t0 + nt):
            key0 = t * BN
            for row_lo in range(qt * BM, min(qt * BM + BM, L), WG):
                wg_rows = slice(row_lo, min(row_lo + WG, L))
                masked = (not live[wg_rows, key0:key0 + BN].all()
                          or key0 + BN > S)
                if masked:
                    assert ref.edge_tile(L, S, causal, window, row_lo,
                                         key0), (qt, t, row_lo)


@pytest.mark.parametrize("case", [
    (1, 1, 1, 64, 64, 64, None, 0.0, True),
    (2, 3, 1, 200, 333, 112, 77, 50.0, True),
    (1, 2, 2, 130, 130, 256, None, 0.0, False),
    (1, 1, 1, 384, 640, 128, 40, 0.0, True),
    (1, 1, 1, 129, 257, 16, 3, 20.0, True),
])
def test_issued_flops_brute_force(case):
    """chip_smoke.flash_issued_flops: per 128-query block, the key tiles
    holding any live pair of its rows (found pair by pair), times two
    warpgroups, times q.k^T and p.v over DP head dims."""
    B, H, K, L, S, D, window, _, causal = case
    live = _live(L, S, causal, window)
    BM, BN = chip_smoke.FLASH_BM, chip_smoke.FLASH_BN
    DP = chip_smoke.flash_product_dims(D)
    tiles = sum(live[r0:r0 + BM, t:t + BN].any()
                for r0 in range(0, L, BM) for t in range(0, S, BN))
    want = B * H * tiles * 2 * 2 * (2 * 64 * BN * DP)
    assert chip_smoke.flash_issued_flops(case, BM, BN, DP) == want
    # and never less than the live flops over the padded head dims
    assert want >= 4 * DP * B * H * live.sum()


def test_ptxas_report_names_instantiations():
    """chip_smoke.py's build phase: ptxas -v's lines become one entry per
    kernel instantiation (int and bool template arguments kept apart),
    with registers, spills and any wgmma-serialisation remark."""
    fn = ("_ZN38_GLOBAL__N__6ce9d4e7_18_flash_attention_cu_2c13897914"
          "flash_fwd_bf16ILi128ELi112ELb{}EEEv14CUtensorMap_stS1_S1_"
          "NS_4AttnE")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{fn.format(0)}' for "
        "'sm_90a'",
        f"ptxas info    : Function properties for {fn.format(0)}",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : (C7513) Potential Performance Loss: wgmma.mma_async"
        " instructions are serialized due to non wgmma instructions in the "
        f"function '{fn.format(1)}'",
        f"ptxas info    : Compiling entry function '{fn.format(1)}' for "
        "'sm_90a'",
        "ptxas info    : Used 96 registers, used 1 barriers",
    ])
    report = chip_smoke.ptxas_report(log)
    assert report == {
        "flash_fwd_bf16<128,112,0>": dict(stack_bytes=0, spill_stores=8,
                                          spill_loads=4, registers=168),
        "flash_fwd_bf16<128,112,1>": dict(
            remarks=["(C7513) Potential Performance Loss: wgmma.mma_async "
                     "instructions are serialized due to non wgmma "
                     "instructions"], registers=96),
    }
