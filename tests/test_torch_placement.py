"""The client placement (``sharding/placement.py``) on the CPU: four
``gloo`` processes (``tests/_torch_placed_worker.py``, a ``FileStore`` in
``tmp_path``, no ports), each group joined within 60 s, run every case as
ranks of a mesh; the results come back gathered through DTensor.

  * single-seed cases on the ``(2, 2, 1)`` test mesh (two of the eight
    clients a rank): the ten strategies synchronous and under faults and
    staleness, FedAWE under each alone, markov availability, epoch
    sampling, and ``use_kernel`` (on the CPU the partial form's plain
    version, the all-reduce and the finalize's): against the port's
    unplaced chunk, counts, τ, keys, t, markov, ring ages and the sampler
    carry bit-equal, states and losses within 1e-5; five of them against
    the reference's unsharded run within 1e-4; a FedAWE round on the
    kernel route makes two all-reduces;
  * the grid on the ``(2, 1, 2)`` seed mesh (each seed's clients over two
    ranks), a cell and a packed group, against the unplaced runs: counts
    and evals equal, losses within 1e-5; what a rank builds and runs is
    its share of every carry by the specs, and no more;
  * the partial form's plain versions: summed over row splits (an empty
    block, an all-zero mask, upload weights, a seed axis) and finalized,
    within 1e-6 of ``echo_aggregate_fused_ref``; the wrappers' CPU route
    and their seed-vmap rules."""
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_placed_worker as W  # noqa: E402,I100
from _torch_fl_small import (EXACT, _leaves, assert_parity,  # noqa: E402
                             drive, setup)
from repro_torch.kernels.echo_aggregate import ops, ref  # noqa: E402

RANKS, JOIN_S = 4, 60
GROUPS = {
    "strategies": [f"{s}/sync" for s in W.STRATEGIES],
    "faults": [f"{s}/faults+stale" for s in W.STRATEGIES],
    "fedawe": [n for n in W.SINGLE if n.split("/")[1] not in
               ("sync", "faults+stale")],
    "grid": list(W.GRID_CASES) + ["grid/cli", "grid/share"],
}
GROUP_OF = {n: g for g, names in GROUPS.items() for n in names}
VS_REFERENCE = ("fedawe/sync", "fedawe/faults+stale", "mifa/faults+stale",
                "fedawe/kernel+faults", "fedawe/epoch")


def _spawn(names, tmp):
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        W.run_rank, args=(RANKS, os.path.join(tmp, "store"), tmp, names),
        nprocs=RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, \
                f"ranks still running after {JOIN_S} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    assert all(not p.is_alive() for p in ctx.processes)
    return torch.load(os.path.join(tmp, "results.pt"), weights_only=False)


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    """``placed(name)``: the gathered result of case ``name``, its group
    run once."""
    done = {}

    def get(name):
        group = GROUP_OF[name]
        if group not in done:
            tmp = str(tmp_path_factory.mktemp(f"placed-{group}"))
            done[group] = _spawn(GROUPS[group], tmp)
        return done[group][name]
    return get


def _unplaced(name):
    kw = W.setup_kwargs(W.SINGLE[name])
    parts = setup("port", kw.pop("strategy"), kw.pop("fault"),
                  kw.pop("stale"), **kw)
    return parts, drive("port", parts, W.CASE_T, chunk=True, K=W.CASE_K,
                        carry=True)


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, equal_nan=True)


@pytest.mark.parametrize("name", list(W.SINGLE))
def test_placed_round_matches_the_unplaced_chunk(placed, name):
    got = placed(name)
    parts, (state, hist, carry) = _unplaced(name)
    ps = got["state"]
    assert len(got["history"]) == len(hist) == W.CASE_T
    for g, w in zip(got["history"], hist):
        assert set(g) == set(w)
        for k in w:
            if k in EXACT:
                assert g[k] == w[k], (k, g[k], w[k])
            else:
                _close(g[k], w[k], 1e-5)
    for field in ("tau", "rng", "t", "markov"):
        assert torch.equal(getattr(ps, field), getattr(state, field)), field
    assert (ps.clients_tr is None) == (state.clients_tr is None)
    for field in ("global_tr", "clients_tr", "extra"):
        a, b = _leaves(getattr(ps, field)), _leaves(getattr(state, field))
        assert set(a) == set(b), field
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            _close(a[k].numpy(), b[k].numpy(), 1e-5)
    assert (ps.stale is None) == (state.stale is None)
    if state.stale is not None:
        assert torch.equal(ps.stale["ages"], state.stale["ages"])
        _close(ps.stale["buf"].numpy(), state.stale["buf"].numpy(), 1e-5)
    a, b = _leaves(got["carry"]), _leaves(carry)
    assert set(a) == set(b)
    for k in b:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", ["fedawe/kernel", "fedawe/kernel+faults"])
def test_placed_fedawe_kernel_round_makes_two_all_reduces(placed, name):
    """A placed FedAWE round on the kernel route makes two collectives:
    the all-reduce of the kernel's ``[N + 1]`` partial and one of the
    round's metric sums stacked (the fault counts among them)."""
    assert placed(name)["all_reduces"] == 2 * W.CASE_T


@pytest.mark.parametrize("name", VS_REFERENCE)
def test_placed_round_matches_the_reference(placed, name):
    """The placed run against the reference's unsharded run of the same
    case: counts, τ and keys bit-equal, states within 1e-4."""
    got = placed(name)
    kw = W.setup_kwargs(W.SINGLE[name])
    want = drive("ref", setup("ref", kw.pop("strategy"), kw.pop("fault"),
                              kw.pop("stale"), **kw),
                 W.CASE_T, chunk=True, K=W.CASE_K)
    spec = _unplaced(name)[0]["state"].spec
    assert_parity(want, (got["state"]._replace(spec=spec), got["history"]),
                  tol=1e-4)


@pytest.mark.parametrize("name", list(W.GRID_CASES))
def test_placed_grid_matches_the_unplaced_grid(placed, name):
    """The seed mesh's cell (and packed group) against the same runs
    without a mesh: every history's counts equal and losses within 1e-5,
    the final evals equal."""
    from repro_torch.launch import experiments as ex

    got = placed(name)
    kw = dict(W.GRID_CASES[name])
    names, packed = kw.pop("names"), kw.pop("packed", False)
    want = (ex.run_packed_grid(names, **W.GRID, **kw) if packed else
            [ex.run_scenario(ex.get_scenario(n), **W.GRID, **kw)
             for n in names])
    assert len(got) == len(want) == len(names)
    for g, w in zip(got, want):
        assert g["final"] == w["final"]
        assert len(g["histories"]) == len(w["histories"]) == W.GRID["seeds"]
        for hg, hw in zip(g["histories"], w["histories"]):
            assert len(hg) == len(hw) == W.GRID["rounds"]
            for rg, rw in zip(hg, hw):
                assert set(rg) == set(rw)
                for k in rw:
                    if k in EXACT:
                        assert rg[k] == rw[k], (k, rg, rw)
                    else:
                        _close(rg[k], rw[k], 1e-5)


@pytest.mark.parametrize("name", list(W.SHARE_CELLS) + ["run_multi_seed"])
def test_placed_rank_holds_its_share(placed, name):
    """What a rank of the ``(2, 1, 2)`` seed mesh builds and runs is its
    share and no more: every leaf of its states, sampler carries, store
    and data keys (of ``run_multi_seed``'s returned states) has the shape
    of its block of the unplaced cell's leaf by the placing spec, and
    the client-stacked leaves are smaller than the whole."""
    for carry, (got, want, whole) in placed("grid/share")[name].items():
        assert got == want, (carry, got, want)
        if carry in ("states", "store"):
            assert got != whole, carry


def test_placed_cli_prints_the_unplaced_rows(placed):
    """``experiments --seed-mesh`` inside the ranks' group (the fault and
    stale cell, K2's partial form) prints the rows of the run without a
    mesh in one process."""
    from repro_torch.launch import experiments as ex

    assert placed("grid/cli") == ex.main(W.CLI)


PARTIAL_SPLITS = {
    "halves": dict(m=8, bounds=(0, 4, 8)),
    "empty-block": dict(m=8, bounds=(0, 0, 3, 8)),
    "zero-mask-block": dict(m=9, bounds=(0, 3, 6, 9), zero=1),
    "upload": dict(m=8, bounds=(0, 2, 8), upload=True),
    "upload-zero-mask": dict(m=8, bounds=(0, 5, 5, 8), upload=True, zero=0),
    "all-empty-round": dict(m=6, bounds=(0, 3, 6), zero=(0, 1)),
    "seeds": dict(m=8, bounds=(0, 4, 8), seeds=3, upload=True),
}


def _partial_inputs(m, n=37, seeds=0, upload=False, seed=0):
    rng = np.random.default_rng(seed)
    lead = (seeds,) if seeds else ()

    def t(*shape):
        return torch.from_numpy(rng.normal(size=lead + shape)
                                .astype(np.float32))
    mask = torch.from_numpy((rng.random(lead + (m,)) < 0.7)
                            .astype(np.float32))
    echo = torch.from_numpy(rng.integers(1, 9, lead + (m,))
                            .astype(np.float32))
    up = (torch.from_numpy((0.8 ** rng.integers(0, 4, lead + (m,)))
                           .astype(np.float32)) if upload else None)
    return dict(x=t(m, n), y=t(m, n), g=t(n), mask=mask, echo=echo,
                upload=up)


@pytest.mark.parametrize("case", list(PARTIAL_SPLITS))
def test_partial_plain_versions_sum_to_the_fused_update(case):
    """Over each row split, the plain partials summed in block order and
    finalized are the fused plain update within 1e-6; the wrappers on
    CPU tensors are the plain versions, an empty block gives zeros, and
    under ``torch.func.vmap`` over seeds the operators give the batched
    call's values."""
    spec = PARTIAL_SPLITS[case]
    a = _partial_inputs(spec["m"], seeds=spec.get("seeds", 0),
                        upload=spec.get("upload", False))
    blocks = list(zip(spec["bounds"][:-1], spec["bounds"][1:]))
    zero = spec.get("zero", ())
    for j in (zero if isinstance(zero, tuple) else (zero,)):
        a["mask"][..., blocks[j][0]:blocks[j][1]] = 0.0
    total = None
    for lo, hi in blocks:
        cut = {k: None if v is None else v[..., lo:hi] for k, v in
               a.items() if k in ("mask", "echo", "upload")}
        args = (a["x"][..., lo:hi, :], a["y"][..., lo:hi, :], cut["mask"],
                cut["echo"], 1.3)
        want = ref.echo_aggregate_partial_ref(*args, upload=cut["upload"])
        got = ops.echo_aggregate_partial(*(v.contiguous() if torch.is_tensor(v)
                                           else v for v in args),
                                         upload=cut["upload"])
        assert torch.equal(got, want)
        assert got.shape == a["x"].shape[:-2] + (a["x"].shape[-1] + 1,)
        if hi == lo:
            assert not got.any()
        total = want if total is None else total + want
    out = ref.echo_aggregate_finalize_ref(total, a["g"])
    fused = ref.echo_aggregate_fused_ref(a["x"], a["y"], a["g"], a["mask"],
                                         a["echo"], 1.3, upload=a["upload"])
    _close(out.numpy(), fused.numpy(), 1e-6)
    assert torch.equal(ops.echo_aggregate_finalize(total, a["g"]), out)
    if "all-empty" in case:
        assert torch.equal(out, a["g"])
    if spec.get("seeds"):
        vm = torch.func.vmap(
            lambda x, y, mk, e, u: ops.echo_aggregate_partial(
                x, y, mk, e, 1.3, upload=u))
        parts = vm(a["x"], a["y"], a["mask"], a["echo"], a["upload"])
        direct = ops.echo_aggregate_partial(a["x"], a["y"], a["mask"],
                                            a["echo"], 1.3,
                                            upload=a["upload"])
        assert torch.equal(parts, direct)
        fin = torch.func.vmap(ops.echo_aggregate_finalize)(parts, a["g"])
        assert torch.equal(fin, ops.echo_aggregate_finalize(direct, a["g"]))
        shared = torch.func.vmap(ops.echo_aggregate_finalize,
                                 in_dims=(0, None))(parts, a["g"][0])
        assert torch.equal(shared[0], fin[0])
