"""The port's sparse cohort round (repro_torch/core/cohort.py and the
engine's cohort path) against the JAX package's, on the CPU.

Held, from the same numpy inputs:
  * the index machinery bit for bit: ``cohort_select``, ``cohort_gather``,
    ``cohort_scatter`` (bfloat16 NaN confinement, unwritten rows
    bit-stable, the write in place), ``upload_mask_cohort``,
    ``gather_batches_at``, ``contiguous_client_index`` and the samplers'
    ``emit="cols"`` (uniform and epoch), and the seed axis of the gather
    and scatter against one seed at a time;
  * the cohort round of all ten strategies against the reference's:
    float32, bfloat16 residency, the chunked executor with a T % K tail,
    faults with a NaN client, staleness.  Counts, τ, keys and
    ``n_deferred`` bit-equal; states and memories within 1e-4, bfloat16
    within the reference's own 2e-2 (tests/test_sparse_cohort.py);
  * faults × staleness × cohort through the chunked executor against the
    reference's DENSE run (the reference's own composed sparse test is
    red, ROADMAP.md §3);
  * overflow deferral with fewer slots than actives, a 2-seed cohort run
    against the reference's seed executor, and ``FLConfig``'s checks."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import core as ref_core  # noqa: E402
from repro.core import cohort as ref_cohort  # noqa: E402
from repro.core import faults as ref_faults  # noqa: E402
from repro.data import federated as ref_fed  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import cohort, faults, prng  # noqa: E402
from repro_torch.data import federated as fed  # noqa: E402

import _torch_fl_small as small  # noqa: E402,I100
from _torch_fl_small import M, assert_parity, run, run_seeds  # noqa: E402

FAULT = dict(upload_survival=0.6, sanitize=True, norm_cap=50.0)
STALE = dict(tau_max=3, kind="det", delay=2)
#: fewer slots than the sine process's busiest rounds: some rounds defer
C_MAX = 6
STRATEGIES = sorted(core.REGISTRY)


def _bits(x):
    """A tensor or array of either package as float32 numpy."""
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _masks():
    rng = np.random.default_rng(3)
    out = [np.zeros(9, np.float32), np.ones(9, np.float32),
           np.array([0, 1, 0, 1, 1, 1], np.float32)]
    out += [(rng.random(n) < p).astype(np.float32)
            for n, p in ((1, 0.5), (7, 0.3), (24, 0.6), (40, 0.1))]
    return out


# ---------------------------------------------------------------------------
# the index machinery, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [1, 3, 8, 64])
def test_cohort_select_matches_reference(cap):
    for mask in _masks():
        c = min(cap, mask.shape[0])
        ridx, rdef = ref_cohort.cohort_select(jnp.asarray(mask), c)
        idx, n_def = cohort.cohort_select(torch.from_numpy(mask), c)
        assert idx.dtype == torch.int64
        np.testing.assert_array_equal(idx.numpy().astype(np.int32),
                                      np.asarray(ridx))
        assert float(n_def) == float(rdef)
        assert len(set(idx.tolist())) == c


@pytest.mark.parametrize("rdt", ["float32", "bfloat16"])
def test_gather_and_scatter_match_reference(rdt):
    rng = np.random.default_rng(7)
    for mask in _masks()[2:]:
        m = mask.shape[0]
        c = min(5, m)
        base = rng.normal(size=(m, 6)).astype(np.float32)
        rows = rng.normal(size=(c, 6)).astype(np.float32)
        rows[0, 1] = np.nan
        if c > 1:
            rows[1, 2] = np.inf
        ridx, _ = ref_cohort.cohort_select(jnp.asarray(mask), c)
        idx, _ = cohort.cohort_select(torch.from_numpy(mask), c)
        write = mask[np.asarray(ridx)]
        res_ref = jnp.asarray(base).astype(getattr(jnp, rdt))
        res = torch.from_numpy(base).to(getattr(torch, rdt))
        g = cohort.cohort_gather(res, idx)
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(ref_cohort.cohort_gather(res_ref, ridx)))
        want = ref_cohort.cohort_scatter(res_ref, ridx, jnp.asarray(rows),
                                         jnp.asarray(write))
        before = res.clone()
        got = cohort.cohort_scatter(res, idx, torch.from_numpy(rows),
                                    torch.from_numpy(write))
        assert got is res and got.dtype == res.dtype  # in place
        np.testing.assert_array_equal(_bits(got), _bits(want))
        written = np.zeros(m, bool)
        written[idx.numpy()[write > 0]] = True
        assert torch.equal(got[torch.from_numpy(~written)],
                           before[torch.from_numpy(~written)])


def test_bf16_demote_confines_nonfinite_rows():
    """A NaN or inf working row demoted into a bfloat16 stack keeps the old
    row; a float32 stack takes it as it is (the dense round's NaN)."""
    rows = torch.stack([torch.full((4,), float("nan")),
                        torch.full((4,), float("inf")),
                        torch.full((4,), 2.0)])
    idx, write = torch.arange(3), torch.ones(3)
    out = cohort.cohort_scatter(torch.ones((3, 4), dtype=torch.bfloat16),
                                idx, rows, write)
    assert out.float().tolist() == [[1.0] * 4, [1.0] * 4, [2.0] * 4]
    out32 = cohort.cohort_scatter(torch.ones((3, 4)), idx, rows, write)
    assert torch.isnan(out32[0]).all() and torch.isinf(out32[1]).all()


def test_seed_axis_gather_and_scatter_equal_one_seed_at_a_time():
    """[S, m, N] stacks with [S, c] indices: one gather and one write on
    the [S·m, N] view, equal to each seed's own."""
    gen = torch.Generator().manual_seed(0)
    stack = torch.randn((3, 10, 5), generator=gen).to(torch.bfloat16)
    idx = torch.stack([torch.randperm(10, generator=gen)[:4]
                       for _ in range(3)])
    rows = torch.randn((3, 4, 5), generator=gen)
    write = (torch.rand((3, 4), generator=gen) < 0.6).float()
    per_seed = [cohort.cohort_scatter(stack[j].clone(), idx[j], rows[j],
                                      write[j]) for j in range(3)]
    got = cohort.cohort_gather(stack, idx)
    for j in range(3):
        assert torch.equal(got[j], cohort.cohort_gather(stack[j], idx[j]))
    cohort.cohort_scatter(stack, idx, rows, write)
    for j in range(3):
        assert torch.equal(stack[j], per_seed[j])


def test_upload_mask_cohort_matches_reference():
    m, c = 12, 5
    rng = np.random.default_rng(2)
    G = rng.normal(size=(c, 7)).astype(np.float32) * 20
    G[1, 3] = np.nan
    mask_c = np.array([1, 1, 0, 1, 1], np.float32)
    idx = np.array([0, 3, 11, 4, 7])
    for fc in (FAULT, dict(upload_survival=0.5), dict(sanitize=True)):
        want = ref_faults.upload_mask_cohort(
            ref_faults.FaultCfg(**fc), jax.random.PRNGKey(5), m,
            jnp.asarray(idx, jnp.int32), jnp.asarray(mask_c),
            jnp.asarray(G))
        got = faults.upload_mask_cohort(
            faults.FaultCfg(**fc), prng.PRNGKey(5, "cpu"), m,
            torch.from_numpy(idx), torch.from_numpy(mask_c),
            torch.from_numpy(G))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_contiguous_index_and_gather_batches_at_match_reference():
    m, n_per, s, b = 9, 3, 2, 2
    pad_ref = ref_fed.contiguous_client_index(m, n_per)
    pad = fed.contiguous_client_index(m, n_per)
    for k in ("idx", "counts"):
        assert pad[k].dtype == pad_ref[k].dtype
        np.testing.assert_array_equal(pad[k], pad_ref[k])
    rng = np.random.default_rng(4)
    arrays = dict(x=rng.normal(size=(m * n_per, 3)).astype(np.float32),
                  y=rng.integers(0, 5, size=(m * n_per,)).astype(np.int32))
    rstore = ref_fed.device_store(arrays, padded=pad_ref)
    store = fed.device_store(arrays, None, "cpu", padded=pad)
    cols = rng.integers(0, n_per, size=(4, s * b))
    rows = np.array([8, 0, 3, 5])
    want = ref_fed.gather_batches_at(rstore, jnp.asarray(cols, jnp.int32),
                                     jnp.asarray(rows, jnp.int32), s, b)
    got = fed.gather_batches_at(store, torch.from_numpy(cols),
                                torch.from_numpy(rows), s, b)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("mode", ["uniform", "epoch"])
def test_emit_cols_matches_reference(mode):
    """Three rounds of column draws and the carry, bit for bit; the store
    rides along unchanged."""
    x, idx = small.arrays()
    rstore = ref_fed.device_store(x, idx)
    store = fed.device_store(x, idx, "cpu")
    rinit, rsample = ref_fed.make_device_sampler(M, 3, 4, mode=mode,
                                                 emit="cols")
    init, sample = fed.make_device_sampler(M, 3, 4, mode=mode, emit="cols")
    rkey, key = jax.random.PRNGKey(42), prng.PRNGKey(42, "cpu")
    rss, ss = rinit(rstore, rkey), init(store, key)
    for t in range(3):
        rb, rss = rsample(rstore, rss, jax.random.fold_in(rkey, t))
        b, ss = sample(store, ss, prng.fold_in(key, t))
        assert set(b) == {"cols", "store"} and b["store"] is store
        np.testing.assert_array_equal(b["cols"].numpy(),
                                      np.asarray(rb["cols"]))
        small.assert_carry_equal(ss, rss)
    with pytest.raises(ValueError, match="emit"):
        fed.make_device_sampler(M, 3, 4, emit="rows")


# ---------------------------------------------------------------------------
# the cohort round of the ten strategies against the reference's
# ---------------------------------------------------------------------------

#: (run kwargs, tolerance): the kernel's plain version under faults and
#: in bfloat16 (the baselines ignore ``use_kernel``)
VARIANTS = {
    "f32": (dict(sparse=C_MAX), 1e-4),
    "bf16": (dict(sparse=C_MAX, rdt="bfloat16", use_kernel=True), 2e-2),
    "chunked-tail": (dict(sparse=C_MAX, chunk=True, T=7, K=4), 1e-4),
    "faults-nan": (dict(sparse=C_MAX, fault=FAULT, nan_client=2,
                        use_kernel=True), 1e-4),
    "staleness": (dict(sparse=C_MAX, stale=STALE, T=8), 1e-4),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_cohort_round_matches_reference(strategy, variant):
    kw, tol = VARIANTS[variant]
    ref = run("ref", strategy, **kw)
    port = run("port", strategy, **kw)
    assert_parity(ref, port, tol=tol)
    assert all("n_deferred" in r for r in port[1])
    if variant == "f32":
        assert any(r["n_deferred"] > 0 for r in port[1])
    if variant == "faults-nan":
        assert sum(r["n_rejected"] for r in port[1]) > 0


def test_faults_staleness_cohort_chunked_matches_reference_dense():
    """Faults x staleness x the cohort (c = m) through the chunked executor
    with a T % K tail, against the reference's DENSE host-loop run: the
    cohort's dense lanes are the synchronous path's."""
    for strategy in ("fedawe", "mifa"):
        ref = run("ref", strategy, fault=FAULT, stale=STALE, T=9,
                  nan_client=2)
        port = run("port", strategy, fault=FAULT, stale=STALE, T=9,
                   nan_client=2, sparse=M, chunk=True, K=4,
                   use_kernel=True)
        assert all(r.pop("n_deferred") == 0.0 for r in port[1])
        assert_parity(ref, port)


def test_cohort_round_writes_the_stacks_in_place():
    """The round consumes its state: the client stack and MIFA's memory
    keep their storage, and rows of clients that never computed keep
    their bits."""
    for strategy, key in (("fedawe", None), ("mifa", "mem")):
        parts = small.setup("port", strategy, sparse=3, rdt="bfloat16")
        st0 = parts["state"]
        stack = st0.clients_tr if key is None else st0.extra[key]
        ptr, first = stack.data_ptr(), stack.clone()
        st, _ = small.drive("port", parts, 3)
        after = st.clients_tr if key is None else st.extra[key]
        assert after.data_ptr() == ptr and after.dtype == torch.bfloat16
        idle = st.tau < 0
        assert idle.any()
        assert torch.equal(after[idle], first[idle])


def test_overflow_defers_deterministically():
    """p = 1 (all m active), c_max = 2: the two lowest client indices
    compute every round, the rest are deferred and counted, their τ never
    advances — as in the reference."""
    def go(pkg):
        p = small.setup(pkg, "fedawe", sparse=2, kind="stationary",
                        base_p=1.0)
        return small.drive(pkg, p, 5, chunk=True, K=2)

    ref, port = go("ref"), go("port")
    assert_parity(ref, port)
    for r in port[1]:
        assert r["n_deferred"] == float(M - 2) and r["n_active"] == 2.0
    tau = port[0].tau.numpy()
    assert (tau[:2] == 4).all() and (tau[2:] == -1).all()


@pytest.mark.parametrize("kw", [
    dict(strategy="fedawe", use_kernel=True),
    dict(strategy="mifa", rdt="bfloat16", sampling="epoch"),
    dict(strategy="fedvarp", fault=FAULT, stale=STALE)],
    ids=["fedawe-kernel", "mifa-bf16-epoch", "fedvarp-faults-stale"])
def test_two_seed_cohort_run_matches_reference_seed_executor(kw):
    """Two seeds through either package's seed executor with a T % K tail:
    each seed's counts, τ, keys and carry bit-equal, states within the
    bounds above."""
    tol = 2e-2 if kw.get("rdt") else 1e-4
    kw = dict(kw, sparse=5)
    rs, rh, rss = run_seeds("ref", 2, **kw)
    ps, ph, pss = run_seeds("port", 2, **kw)
    for j in range(2):
        assert_parity((jax.tree.map(lambda x: x[j], rs), rh[j]),
                      (core.index_seed(ps, j), ph[j]), tol=tol)
        small.assert_carry_equal(core.index_seed(pss, j),
                                 jax.tree.map(lambda x: x[j], rss))


# ---------------------------------------------------------------------------
# FLConfig
# ---------------------------------------------------------------------------

def test_flconfig_checks():
    with pytest.raises(NotImplementedError, match="per-row quantization"):
        core.FLConfig(m=4, flat_state=True, sparse_cohort=2,
                      resident_dtype="int8")
    with pytest.raises(ValueError, match="unknown resident_dtype"):
        core.FLConfig(m=4, flat_state=True, sparse_cohort=2,
                      resident_dtype="float16")
    with pytest.raises(ValueError, match="sparse_cohort"):
        core.FLConfig(m=4, flat_state=True, resident_dtype="bfloat16")
    with pytest.raises(ValueError, match="flat"):
        core.FLConfig(m=4, sparse_cohort=2)
    with pytest.raises(ValueError, match=">= 0"):
        core.FLConfig(m=4, flat_state=True, sparse_cohort=-1)
    cfg = core.FLConfig(m=4, flat_state=True, sparse_cohort=2,
                        resident_dtype="bfloat16")
    ref = ref_core.FLConfig(m=4, flat_state=True, sparse_cohort=2,
                            resident_dtype="bfloat16")
    assert (cfg.sparse_cohort, cfg.resident_dtype) == \
        (ref.sparse_cohort, ref.resident_dtype)
