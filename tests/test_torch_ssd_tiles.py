"""The bf16 tensor-core SSD chunk kernel's algorithm, its route and its
bound, on the CPU.

``ref.ssd_chunk_tiled_ref`` mirrors the CUDA kernel (csrc/ssd_chunk_wgmma.cu:
a_cs in float64, one C.B^T for all heads when B and C are stride-0, L from
its factors R and E where ``l_fast`` allows, S in two bf16 terms and w o x
in three, float32 accumulation in k-steps of 16).  Here it is held against
the JAX package's Pallas kernel in interpret mode and the port's plain
``ssd_chunk_ref`` in bfloat16, at chip_smoke.py's SSD_ROW_TOL, SSD_STATE_TOL
and SSD_DECAY_TOL, at zamba2-7b's widths (K 128, P 64, N 64) and at N 128,
with B and C stride-0 over the heads and copied, and at the kernel's
ragged edges; the scan built on it against the reference's drop-in on the
SSD drift witness.  Two bf16 terms of w o x would miss SSD_STATE_TOL: that
is why the kernel takes three.  ``ops.wgmma_route`` (which kernel a CUDA
call launches) is held to the views mamba_block builds and to what the
tensor maps cannot describe; chip_smoke.py's ``ssd_chunk_bound`` and
``ssd_issued_flops`` to hand counts."""
import importlib.util
import pathlib
import types

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssd_chunk.kernel import ssd_chunk_pallas  # noqa: E402
from repro.kernels.ssd_chunk.ops import ssd_chunked_pallas  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ssd_chunk import ops, ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke",
    pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ROW_TOL = chip_smoke.SSD_ROW_TOL["bfloat16"]
STATE_TOL, DECAY_TOL = chip_smoke.SSD_STATE_TOL, chip_smoke.SSD_DECAY_TOL

#: (b, l, h, p, n, chunk), options: zamba2-7b's widths and N 128 (B and C
#: stride-0 and copied), the kernel's ragged K, P and N, and dA partly
#: positive (L taken directly)
CASES = [((1, 256, 4, 64, 64, 128), {}),
         ((1, 256, 4, 64, 64, 128), dict(copied=True)),
         ((1, 256, 3, 64, 128, 128), {}),
         ((1, 256, 3, 64, 128, 128), dict(copied=True)),
         ((1, 256, 2, 64, 64, 64), {}),
         ((1, 192, 2, 64, 64, 96), {}),
         ((1, 256, 2, 40, 64, 128), {}),
         ((1, 256, 2, 64, 24, 128), {}),
         ((1, 256, 4, 64, 64, 128), dict(rising=True))]


def _draw(seed, b, l, h, p, n, copied=False, rising=False, a_max=2.0):
    """chip_smoke.ssd_inputs's distributions, drawn with numpy: xdt
    [b, l, h, p] and B, C [b, l, g, n] (g = h when ``copied``, else 1)
    rounded to bf16 (as float32 arrays), dA [b, l, h] float32 with
    A = -linspace(1, a_max, h).  a_max 2 (chip_smoke's is 16) keeps a
    chunk's prefix sums small enough that the reference's float32 cumsum
    (the Pallas kernel's) stays within SSD_DECAY_TOL of the float64 one
    that the port takes (at 4 it is 1.02e-6 off on these cases)."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)) - 4.6))
    A = -np.linspace(1.0, a_max, h)
    x = rng.standard_normal((b, l, h, p)) * dt[..., None]
    g = h if copied else 1
    B = rng.standard_normal((b, l, g, n))
    C = rng.standard_normal((b, l, g, n))
    dA = dt * A
    if rising:
        dA = dA + 0.02 * rng.random((b, l, h))

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float() \
            .numpy()

    return bf16(x), dA.astype(np.float32), bf16(B), bf16(C)


def _views(arrays, chunk):
    """The torch operands as the model hands them: bf16 [b, l, h, .]
    regrouped by views, B and C expanded over the heads (stride 0) when
    drawn as one group."""
    x, dA, B, C = arrays
    h = x.shape[2]
    tB, tC = (torch.from_numpy(a).bfloat16() for a in (B, C))
    if tB.shape[2] != h:
        tB, tC = (t.expand(t.shape[:2] + (h, t.shape[3])) for t in (tB, tC))
    ts = (torch.from_numpy(x).bfloat16(), torch.from_numpy(dA), tB, tC)
    return [ops.regroup(t, chunk) for t in ts]


def _pallas(arrays, chunk):
    """The JAX package's Pallas kernel (interpret mode) on the same
    values, as torch float32 tensors."""
    x, dA, B, C = arrays
    b, l, h = x.shape[:3]
    c = l // chunk

    def grp(v, feat):
        v = np.broadcast_to(v, (b, l, h) + v.shape[3:]) if feat else v
        v = v.reshape((b, c, chunk, h) + v.shape[3:])
        return v.transpose((0, 3, 1, 2, 4) if feat else (0, 3, 1, 2))

    out = ssd_chunk_pallas(
        jnp.asarray(grp(x, True)).astype(jnp.bfloat16),
        jnp.asarray(grp(dA, False)),
        jnp.asarray(grp(B, True)).astype(jnp.bfloat16),
        jnp.asarray(grp(C, True)).astype(jnp.bfloat16))
    return [torch.from_numpy(np.array(o, np.float32)) for o in out]


def _assert_within(got, want, what):
    e = chip_smoke.ssd_errors(got, want)
    assert chip_smoke.ssd_within(e, "bfloat16"), (what, e)


@pytest.mark.parametrize("case,opts", CASES)
def test_tiled_ref_matches_jax_and_plain(case, opts):
    b, l, h, p, n, chunk = case
    arrays = _draw(l + 7 * h + n + p, b, l, h, p, n, **opts)
    views = _views(arrays, chunk)
    assert (views[2].stride(1) == 0) != bool(opts.get("copied"))
    got = ref.ssd_chunk_tiled_ref(*views)
    assert got[0].dtype == torch.bfloat16
    assert tuple(got[1].shape) == (b, h, l // chunk, n, p)
    assert bool(ref.l_fast(views[1], chunk).all()) != bool(opts.get("rising"))
    _assert_within(got, ref.ssd_chunk_ref(*views), "plain")
    _assert_within(got, _pallas(arrays, chunk), "pallas")


def test_factored_l_matches_direct():
    """Where ``l_fast`` holds, the kernel's factors D[m, kk] F[i] E[j]
    (m = i // 16, kk = j // 16; D = exp(a_cs[16 m] - a_cs[16 kk]), F =
    exp(a_cs[i] - a_cs[16 m]), E = exp(a_cs[16 kk] - a_cs[j])) equal
    exp(a_cs[i] - a_cs[j]) within a few float32 ulps (the model's decay
    range, A down to -16); a positive dA, or a step of decay past MAX_E
    inside a column block (E's exponent), turns the factors off for that
    chunk alone."""
    dA = torch.from_numpy(_draw(5, 2, 256, 8, 8, 8, a_max=16.0)[1])
    A = dA.reshape(2, 2, 128, 8).permute(0, 3, 1, 2)             # [b,h,c,K]
    a = torch.cumsum(A.double(), -1)
    idx = torch.arange(128)
    refp = a[..., (idx // 16) * 16]
    e = (refp - a).float()
    D = torch.exp((refp[..., :, None] - refp[..., None, :]).float())
    fact = D * torch.exp(-e)[..., :, None] * torch.exp(e)[..., None, :]
    direct = torch.exp((a[..., :, None] - a[..., None, :]).float())
    lower = idx[:, None] >= idx[None, :]
    rel = ((fact - direct).abs() / direct.clamp_min(1e-30))[..., lower]
    assert bool(ref.l_fast(A, 128).all())
    assert rel.max().item() < 1e-5
    for k, v in ((37, 1e-3), (37, -(ref.MAX_E + 1.0)), (48, -200.0)):
        A2 = A.clone()
        A2[0, 3, 1, k] = v
        fast = ref.l_fast(A2, 128)
        # a step at a block's first row (48) leaves E's exponents alone
        assert bool(fast[0, 3, 1]) == (k == 48)
        fast[0, 3, 1] = True
        assert bool(fast.all())


def test_two_state_terms_miss_the_bound():
    """The number of bf16 terms of w o x, decided here: at zamba2-7b's
    widths (the model's decay range) over 32 heads and 32 chunks two terms
    put the states past SSD_STATE_TOL of the plain version, three keep
    them within half of it."""
    arrays = _draw(0, 1, 4096, 32, 64, 64, a_max=16.0)
    views = _views(arrays, 128)
    plain = ref.ssd_chunk_ref(*views)
    two = ref.ssd_chunk_tiled_ref(*views, w_terms=2)
    three = ref.ssd_chunk_tiled_ref(*views)
    assert ref.W_TERMS == chip_smoke.SSD_W_TERMS == 3
    assert chip_smoke.rows_rel(two[1], plain[1]) > STATE_TOL
    assert chip_smoke.rows_rel(three[1], plain[1]) < STATE_TOL / 2


@pytest.mark.parametrize("layout", ["stride0", "copied"])
def test_tiled_scan_on_ssd_witness(layout):
    """The scan built on the tiled oracle (ops._scan) against the
    reference's drop-in on the SSD drift witness: y within
    SSD_WITNESS_RATIO times the reference's own spread, as a share of the
    largest output; the final state within 1e-5."""
    a = chip_smoke.ssd_witness_arrays(np)
    chunk = chip_smoke.SSD_WITNESS["chunk"]
    jargs = (jnp.asarray(a["xdt"]).astype(jnp.bfloat16), jnp.asarray(a["dA"]),
             jnp.asarray(a["B"]).astype(jnp.bfloat16),
             jnp.asarray(a["C"]).astype(jnp.bfloat16))
    tB, tC = (torch.from_numpy(a[k]).bfloat16() for k in "BC")
    if layout == "stride0":  # the witness's B and C are one group, copied
        tB, tC = (t[:, :, :1].expand(t.shape) for t in (tB, tC))
        assert tB.stride(2) == 0
    targs = (torch.from_numpy(a["xdt"]).bfloat16(), torch.from_numpy(a["dA"]),
             tB, tC)
    y, f = ops._scan(*targs, chunk, None, ref.ssd_chunk_tiled_ref)
    yj, fj = ssd_chunked_pallas(*jargs, chunk)
    yj = np.asarray(yj, np.float32)
    rel = float(np.abs(y.float().numpy() - yj).max() / np.abs(yj).max())
    bound = chip_smoke.SSD_WITNESS_RATIO * chip_smoke.REF_SSD_DRIFT["rel"]
    assert rel <= bound, (rel, bound)
    np.testing.assert_allclose(f.numpy(), np.asarray(fj), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the route: which kernel a CUDA call launches
# ---------------------------------------------------------------------------

def _mamba_views(arch, L=256):
    """The operands ``mamba_block`` hands the scan in prefill (the route
    that reaches the kernel) at ``arch``'s SSM widths (d_model cut to 64:
    it shapes only the projections) in bf16, captured and regrouped as
    ``ops.ssd_chunked`` regroups them."""
    cfg = get_config(arch).replace(d_model=64, dtype="bfloat16")
    di, H, N = cfg.ssm_inner, cfg.ssm_heads, cfg.ssm_state
    gn = cfg.ssm_groups * N
    g = torch.Generator().manual_seed(0)

    def rand(*shape, scale=0.02):
        return (torch.randn(*shape, generator=g) * scale).bfloat16()

    bp = dict(in_proj=rand(64, 2 * di + 2 * gn + H),
              conv_w=rand(cfg.ssm_conv_dim, cfg.ssm_conv, scale=0.3),
              conv_b=rand(cfg.ssm_conv_dim), dt_bias=rand(H),
              A_log=torch.log(torch.linspace(1.0, 16.0, H)),
              D=rand(H), ln_out=torch.zeros(di), out_proj=rand(di, 64))
    seen = []

    def spy(xdt, dA, B_, C_, chunk, initial_state=None):
        seen.append([ops.regroup(t, chunk) for t in (xdt, dA, B_, C_)])
        b, l, h, p = xdt.shape
        return (torch.zeros_like(xdt),
                torch.zeros((b, h, p, B_.shape[-1]), dtype=torch.float32))

    orig = ssm.ssd_ops
    ssm.ssd_ops = types.SimpleNamespace(ssd_chunked=spy)
    try:
        ssm.mamba_block(rand(1, L, 64, scale=1.0), bp, cfg,
                        mode="prefill")
    finally:
        ssm.ssd_ops = orig
    return cfg, seen[0]


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-130m"])
def test_model_views_take_the_wgmma_route(arch):
    """x dt contiguous, B and C column slices of the SiLU output at byte
    offsets 2 di and 2 (di + N), expanded over the heads by a stride-0
    view: every tensor map exists, so the main path's shapes take the
    tensor-core kernel, one C.B^T for all heads of a block."""
    cfg, views = _mamba_views(arch)
    x, dA, B_, C_ = views
    assert x.dtype == torch.bfloat16 and B_.stride(1) == C_.stride(1) == 0
    row = 2 * cfg.ssm_conv_dim
    assert B_.stride(3) * 2 == row and row % 16 == 0
    assert (C_.data_ptr() - B_.data_ptr()) == 2 * cfg.ssm_state
    assert ops.wgmma_route(*views)


def _small(P=64, N=64, h=4, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 256, h, P, generator=g).to(dtype)
    dA = -torch.rand(1, 256, h, generator=g)
    B = torch.randn(1, 256, 1, N, generator=g).to(dtype).expand(
        1, 256, h, N)
    return [x, dA, B, B]


@pytest.mark.parametrize("case", [
    "float32", "P4", "P60", "P72", "N4_rows", "misaligned_x",
    "misaligned_B", "one_stride0", "x_row_stride"])
def test_what_the_wgmma_route_refuses(case):
    """float32 operands, P past one 128-byte panel or not a multiple of 8,
    rows that are not whole 16-byte chunks, bases off 16 bytes, and B
    stride-0 over the heads while C is not go to the FP32-pipe kernel
    (which takes every one of them)."""
    ops_args = {
        "float32": lambda: _small(dtype=torch.float32),
        "P4": lambda: _small(P=4),
        "P60": lambda: _small(P=60),
        "P72": lambda: _small(P=72),
        "N4_rows": lambda: _small(N=4),
        "misaligned_x": lambda: (lambda a: [
            torch.randn(1, 256 * 4 * 64 + 1).bfloat16()[0, 1:]
            .view(1, 256, 4, 64)] + a[1:])(_small()),
        "misaligned_B": lambda: (lambda a: [a[0], a[1], torch.randn(
            1, 256, 1, 65).bfloat16()[..., 1:].expand(1, 256, 4, 64),
            a[3]])(_small()),
        "one_stride0": lambda: (lambda a: [a[0], a[1], a[2],
                                           a[3].contiguous()])(_small()),
        "x_row_stride": lambda: (lambda a: [torch.randn(
            1, 256, 4, 68).bfloat16()[..., :64]] + a[1:])(_small()),
    }[case]()
    views = [ops.regroup(t, 128) for t in ops_args]
    ops._check(*views)  # the FP32-pipe kernel and the plain version take it
    assert not ops.wgmma_route(*views)


def test_wgmma_route_takes_copied_groups_and_small_edges():
    """B and C with nonzero head strides (several groups, copied by
    repeat_interleave), P 8 and 40, N 24 with 48-byte rows: the tensor
    maps exist."""
    a = _small()
    copied = [a[0], a[1], a[2].contiguous(), a[3].contiguous()]
    assert ops.wgmma_route(*[ops.regroup(t, 128) for t in copied])
    for P, N in ((8, 64), (40, 64), (64, 24)):
        assert ops.wgmma_route(*[ops.regroup(t, 128)
                                 for t in _small(P=P, N=N)])


def test_head_run():
    """One block a (batch, chunk) pair and all its heads when the pairs
    fill the SMs; more runs when they do not; one head a block when B and
    C are not shared."""
    assert ops.head_run(2, 112, 64, True, 132) == 112
    assert ops.head_run(2, 24, 64, True, 132) == 24
    assert ops.head_run(1, 8, 2, True, 132) == 1
    assert ops.head_run(1, 112, 16, True, 132) == 14  # 8 runs of 14
    assert ops.head_run(2, 112, 64, False, 132) == 1


# ---------------------------------------------------------------------------
# the bound and the issued flops, against hand counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,bound_ms,fp32_ms", [
    ("zamba2-7b", 0.2138, 0.6766), ("mamba2-130m", 0.0631, 0.2415)])
def test_ssd_chunk_bound_main_paths(arch, bound_ms, fp32_ms):
    """B 2 x 8192 tokens in bf16: bound by bytes on the tensor cores' route
    (B and C once per (batch, chunk, group)); the FP32-pipe reckoning
    (B and C per head, flops at 67 TFLOP/s) beside it, as recorded."""
    r = chip_smoke.ssd_chunk_bound(get_config(arch), 2, 8192, 2)
    assert r["bound_by"] == "bytes" and r["fp32_bound_by"] == "operations"
    assert r["bound_ms"] == pytest.approx(bound_ms, abs=5e-5)
    assert r["fp32_bound_ms"] == pytest.approx(fp32_ms, abs=5e-5)
    r4 = chip_smoke.ssd_chunk_bound(get_config(arch), 2, 8192, 4)
    assert r4["bound_ms"] == r4["fp32_bound_ms"]


def test_ssd_chunk_bound_hand_count():
    """A small config counted by hand: b 1, 2 heads, 2 chunks of K 4, P 2,
    N 3, one group, bf16."""
    cfg = get_config("mamba2-130m").replace(
        ssm_chunk=4, ssm_head_dim=2, ssm_state=3, ssm_heads=2)
    r = chip_smoke.ssd_chunk_bound(cfg, 1, 8, 2)
    programs, tri = 1 * 2 * 2, 4 * 5 // 2
    flops = programs * (2 * tri * 3 + 2 * tri * 2 + 2 * 3 * 2 * 4)
    per = 2 * 2 * 4 * 2 + 4 * (4 + 3 * 2 + 1)   # x, y; dA, states, decay
    bc = 2 * 2 * 4 * 3                           # B and C of one chunk
    assert r["flops"] == flops
    assert r["bytes"] == programs * per + 1 * 2 * 1 * bc
    assert r["fp32_bytes"] == programs * (per + bc)
    want = 1e3 * max(r["bytes"] / chip_smoke.HBM_BYTES_PER_S,
                     flops / chip_smoke.BF16_FLOP_PER_S)
    assert r["bound_ms"] == pytest.approx(want, rel=1e-12)


def test_ssd_issued_flops_hand_count():
    """zamba2-7b's prefill shape, 112 heads a block: per block G over
    64 x 64 and 64 x 128 tiles of depth 64; per head y over 64 + 128
    columns in two terms and the states over 128 rows in three."""
    b, h, c, N, run = 2, 112, 64, 64, 112
    per_block = 2 * 64 * 64 * 64 + 2 * 64 * 128 * 64
    per_head = 2 * (2 * 64 * 64 * 64 + 2 * 64 * 64 * 128) \
        + 3 * 2 * 64 * 64 * 128
    assert chip_smoke.ssd_issued_flops(b, h, c, N, run) == \
        b * c * per_block + b * h * c * per_head
    assert chip_smoke.ssd_issued_flops(1, 4, 2, 128, 1) == \
        8 * 2 * 64 * 192 * 128 + 8 * (2 * 2 * 64 * 64 * 192
                                      + 3 * 2 * 64 * 128 * 128)
