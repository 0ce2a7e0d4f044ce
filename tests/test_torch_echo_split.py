"""The CUDA echo-aggregate kernel's arithmetic on the CPU: its oracle
``ref.echo_aggregate_split_ref`` (row slices, rows added in order, the
slices' partials combined in rank order) against the JAX package's Pallas
kernels in interpret mode, its jnp oracle and the port's plain version;
and ``ops.launch_geometry``, which chooses the kernel's grid."""
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.echo_aggregate import kernel as ref_kernel  # noqa: E402
from repro.kernels.echo_aggregate import ref as ref_ref  # noqa: E402
from repro_torch.kernels.echo_aggregate import ops, ref  # noqa: E402

ETA_G = 1.7
H100_SMS = 132
SOURCE = (pathlib.Path(ops.__file__).resolve().parent / "csrc"
          / "echo_aggregate.cu")

#: (m, N, dtype, slices): N odd; the FL path's N = 27 370; m = 1; m < S;
#: m not a multiple of S; one slice; bfloat16 at N odd and at 27 370
CASES = [(5, 77, "float32", 2), (3, 27370, "float32", 3),
         (1, 300, "float32", 1), (1, 300, "float32", 4),
         (3, 129, "float32", 8), (10, 301, "float32", 4),
         (37, 1000, "float32", 8), (9, 515, "float32", 1),
         (6, 77, "bfloat16", 4), (4, 27370, "bfloat16", 3),
         (10, 1001, "bfloat16", 8)]


def _tol(dtype):
    return 1e-5 if dtype == "float32" else 5e-2


def _inputs(m, N, dtype, seed, mask_p=0.7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, N)).astype(np.float32)
    y = rng.normal(size=(m, N)).astype(np.float32)
    g = rng.normal(size=(N,)).astype(np.float32)
    mask = (rng.random(m) < mask_p).astype(np.float32)
    if mask_p > 0:
        mask[0] = 1.0          # at least one delivering client
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


@pytest.mark.parametrize("m,N,dtype,slices", CASES)
@pytest.mark.parametrize("with_upload", [False, True])
def test_split_ref_matches_fused_pallas_and_plain(m, N, dtype, slices,
                                                  with_upload):
    jx, tx = _inputs(m, N, dtype, seed=m * 1000 + N)
    up_j = jx["upload"] if with_upload else None
    up_t = tx["upload"] if with_upload else None
    got = ref.echo_aggregate_split_ref(
        tx["x"], tx["y"], tx["g"], tx["mask"], tx["echo"], ETA_G,
        slices=slices, upload=up_t)
    assert got.dtype == torch.float32 and got.shape == (N,)
    pallas = np.asarray(ref_kernel.echo_aggregate_fused_pallas(
        jx["x"], jx["y"], jx["g"], jx["mask"], jx["echo"], ETA_G,
        block_n=512, interpret=True, upload=up_j))
    oracle = np.asarray(ref_ref.echo_aggregate_fused_ref(
        jx["x"], jx["y"], jx["g"], jx["mask"], jx["echo"], ETA_G,
        upload=up_j))
    plain = ref.echo_aggregate_fused_ref(
        tx["x"], tx["y"], tx["g"], tx["mask"], tx["echo"], ETA_G,
        upload=up_t)
    tol = _tol(dtype)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("m,N,dtype,slices", CASES)
def test_split_ref_without_guard_matches_pallas(m, N, dtype, slices):
    jx, tx = _inputs(m, N, dtype, seed=m * 1000 + N + 1)
    got = ref.echo_aggregate_split_ref(
        tx["x"], tx["y"], None, tx["mask"], tx["echo"], ETA_G,
        slices=slices)
    pallas = np.asarray(ref_kernel.echo_aggregate_pallas(
        jx["x"], jx["y"], jx["mask"], jx["echo"], ETA_G, block_n=512,
        interpret=True))
    plain = ref.echo_aggregate_ref(tx["x"], tx["y"], tx["mask"], tx["echo"],
                                   ETA_G)
    tol = _tol(dtype)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slices", [1, 3, 8])
def test_all_zero_weights_return_the_global_bit_for_bit(dtype, slices):
    jx, tx = _inputs(10, 301, dtype, seed=5, mask_p=0.0)
    assert float(tx["mask"].sum()) == 0.0
    got = ref.echo_aggregate_split_ref(
        tx["x"], tx["y"], tx["g"], tx["mask"], tx["echo"], ETA_G,
        slices=slices)
    assert torch.equal(got, tx["g"])
    pallas = np.asarray(ref_kernel.echo_aggregate_fused_pallas(
        jx["x"], jx["y"], jx["g"], jx["mask"], jx["echo"], ETA_G,
        block_n=128, interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)
    # every delivering client dropped: upload zeroes all the weights
    _, tx1 = _inputs(10, 301, dtype, seed=6, mask_p=1.0)
    got = ref.echo_aggregate_split_ref(
        tx1["x"], tx1["y"], tx1["g"], tx1["mask"], tx1["echo"], ETA_G,
        slices=slices, upload=torch.zeros(10))
    assert torch.equal(got, tx1["g"])


def test_split_ref_rounds_as_the_kernel_does():
    """The oracle's combine is the kernel's: one slice is a single ordered
    pass over the rows, and S slices are S ordered passes whose partials
    are added in rank order; the sum of weights comes the same way."""
    _, tx = _inputs(6, 50, "float32", seed=9)
    x, y, mask, echo, g = (tx[k] for k in ("x", "y", "mask", "echo", "g"))
    w, c = mask, ETA_G * echo

    def rows(lo, hi):
        acc, ws = torch.zeros(50), torch.zeros(())
        for i in range(lo, hi):
            acc = acc + w[i] * (x[i] - c[i] * (x[i] - y[i]))
            ws = ws + w[i]
        return acc, ws

    for slices in (1, 2, 4, 6):
        parts = [rows(lo, hi) for lo, hi in ref.slice_bounds(6, slices)]
        acc, ws = parts[0]
        for a, s in parts[1:]:
            acc, ws = acc + a, ws + s
        want = torch.where(ws > 0, acc / torch.clamp(ws, min=1.0), g)
        got = ref.echo_aggregate_split_ref(x, y, g, mask, echo, ETA_G,
                                           slices=slices)
        assert torch.equal(got, want)


@pytest.mark.parametrize("m", [1, 2, 7, 8, 9, 100, 1023, 16384])
@pytest.mark.parametrize("slices", [1, 2, 3, 5, 8])
def test_slices_cover_every_row_once(m, slices):
    bounds = ref.slice_bounds(m, slices)
    assert len(bounds) == slices
    covered = [r for lo, hi in bounds for r in range(lo, hi)]
    assert covered == list(range(m))
    sizes = [hi - lo for lo, hi in bounds]
    assert max(sizes) - min(sizes) <= 1


SHAPES = [(100, 27370), (1024, 262144), (16384, 27370), (1, 27370),
          (7, 27370), (8, 1), (37, 773), (64, 4099), (16, 1000),
          (100000, 27370), (3, 10 ** 7), (2048, 4099), (600, 100)]


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("n_sm", [132, 114])
def test_launch_geometry_covers_the_stack_once(m, n, esize, n_sm):
    bn, s = ops.launch_geometry(m, n, esize, n_sm)
    assert 1 <= s <= ops.MAX_SLICES
    assert bn * esize == ops.TILE_ROW_BYTES
    assert bn % (ops.VEC_BYTES // esize) == 0
    tiles = -(-n // bn)
    assert (tiles - 1) * bn < n <= tiles * bn
    if n <= 300000:
        cols = [c for t in range(tiles)
                for c in range(t * bn, min(n, (t + 1) * bn))]
        assert cols == list(range(n))
    rows = [r for lo, hi in ref.slice_bounds(m, s) for r in range(lo, hi)]
    assert rows == list(range(m))
    if s > 1:
        # long slices only, and one wave of resident blocks
        assert m // s >= ops.MIN_SLICE_ROWS
        assert tiles * s <= ops.blocks_per_sm(esize, s) * n_sm
        # the most slices that allows
        more = s + 1
        assert (more > ops.MAX_SLICES or m // more < ops.MIN_SLICE_ROWS
                or tiles * more > ops.blocks_per_sm(esize, more) * n_sm)


@pytest.mark.parametrize("m,n", [(1024, 262144), (16384, 27370)])
def test_launch_geometry_fills_the_card_at_the_long_shapes(m, n):
    for esize in (4, 2):
        bn, s = ops.launch_geometry(m, n, esize, H100_SMS)
        assert -(-n // bn) * s >= 2 * H100_SMS
    assert ops.launch_geometry(16384, 27370, 4, H100_SMS) == (256, 3)
    assert ops.launch_geometry(1024, 262144, 4, H100_SMS) == (256, 1)


def test_launch_geometry_takes_one_slice_when_short():
    """m = 100 (the FL path) keeps one slice: 107 blocks of 100 rows;
    split in 3 (321 blocks) it was slower on the card (``PERF.md``)."""
    assert ops.launch_geometry(100, 27370, 4, H100_SMS) == (256, 1)
    assert ops.launch_geometry(100, 27370, 2, H100_SMS) == (512, 1)
    for m in (1, 7, 511, 1023):
        assert ops.launch_geometry(m, 27370, 4, H100_SMS)[1] == 1
    assert ops.launch_geometry(8, 1, 4, H100_SMS)[1] == 1


def test_blocks_per_sm_follows_shared_memory():
    # the ring: 2 stages x 16 rows x (x, y) x (1 KB + 16 B), 48 B of
    # barriers
    assert ops.block_smem_bytes(4, 1) == 2 * 16 * 2 * 1040 + 48
    assert ops.blocks_per_sm(4, 1) == 3
    assert ops.blocks_per_sm(4, 8) == 3
    # bfloat16 partials are 512 columns a rank: 2 blocks an SM from 6 ranks
    assert ops.blocks_per_sm(2, 5) == 3
    assert ops.blocks_per_sm(2, 6) == 2


def test_geometry_constants_match_the_cuda_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    assert const("kTileRowBytes") == ops.TILE_ROW_BYTES
    assert const("kMaxSlices") == ops.MAX_SLICES
    assert const("kRows") == ops.STAGE_ROWS
    assert const("kStages") == ops.STAGES
    assert const("kConsumerWarps") * 32 + 32 == 160


def test_card_only_entries_refuse_cpu_tensors():
    _, tx = _inputs(4, 64, "float32", seed=1)
    args = (tx["x"], tx["y"], tx["g"], tx["mask"], tx["echo"], ETA_G)
    with pytest.raises(ValueError):
        ops._echo_aggregate_cuda(*args)
    with pytest.raises(ValueError):
        ops._echo_aggregate_triton(*args)
