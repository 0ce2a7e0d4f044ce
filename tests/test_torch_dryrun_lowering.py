"""The dry run's lowering half (``launch/dryrun.py``,
``launch/analysis.py``): each combination's step run once over its
placements on a fake process group, under the per-rank counters.

  * the counters on known programs: a matmul's flops and bytes, one
    all-gather / all-reduce per redistribution on a 4-rank fake group,
    the port's client all-reduce, DTensor's shape propagation not
    counted, memory and aliasing;
  * ``tiny`` on both test meshes at every supported shape, and the chunk
    variants, with the reference's assertions (``tests/test_dryrun.py``)
    and an exact account of the placed round's collectives: a round's
    two all-reduces (K1's ``[N + 1]`` partial, the stacked metric sums),
    K times in a chunk, once per seed row;
  * the DTensor serving step computes the unplaced step's function: four
    gloo ranks (``tests/_torch_dryrun_worker.py``), prefill then decode,
    logits and caches within 1e-5, rank 0's collectives those of the
    fake-group record;
  * the knobs: ``seq_shard``, ``dots_remat``, the MoE hint
    (``REPRO_MOE_CONSTRAIN``) on a reduced MoE config;
  * K4 and K5 as custom operators: fake implementations and flop
    formulas equal to their plain versions'."""
import json
import math
import os
import time

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import get_config, supported_shapes  # noqa: E402
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.models import reduced  # noqa: E402
from repro_torch.models.model import count_params  # noqa: E402

#: the placed round's metric sums: mu, loss, n_active, echo (+ the fault
#: layer's n_dropped / n_rejected, or the stale layer's two)
METRIC_SUMS = {"baseline": 4, "faults": 6, "staleness": 6}


# ---------------------------------------------------------------------------
# the counters on known programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fake", [False, True])
def test_matmul_flops_and_bytes_are_exact(fake):
    m, k, n = 8, 16, 4
    ctx = FakeTensorMode() if fake else torch.no_grad()
    with ctx:
        a, b = torch.randn(m, k), torch.randn(k, n)
        with analysis.CollectiveCounter() as c:
            y = a @ b
    cost = analysis.cost_numbers(c)
    assert cost["flops"] == 2 * m * n * k
    assert cost["bytes accessed"] == 4 * (m * k + k * n + m * n)
    assert c.peak_bytes == 4 * m * n
    mem = analysis.memory_numbers(c, (a, b), y)
    assert mem == dict(argument_size_in_bytes=4 * (m * k + k * n),
                       output_size_in_bytes=4 * m * n,
                       temp_size_in_bytes=4 * m * n,
                       alias_size_in_bytes=0.0)
    assert c.collective_bytes()["count"] == 0


def test_views_count_nothing_and_in_place_results_alias():
    with FakeTensorMode():
        x = torch.randn(32, 8)
        with analysis.CollectiveCounter() as c:
            v = x.t().reshape(8, 32)[:4]
            w = x.add_(1.0)
    assert c.flops == 0 and c.peak_bytes == 0
    # the view moved nothing; the in-place add read and wrote x
    assert c.bytes_accessed == 2 * 32 * 8 * 4
    mem = analysis.memory_numbers(c, (x,), (v, w))
    assert mem["alias_size_in_bytes"] == 4 * 32 * 8 + 4 * 4 * 32


def test_freed_storage_leaves_the_peak():
    with FakeTensorMode():
        x = torch.randn(64, 64)
        with analysis.CollectiveCounter() as c:
            for _ in range(3):
                y = x * 2.0
                del y
    assert c.peak_bytes == 64 * 64 * 4 and c.live_bytes == 0


def _dtensors(world=4):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("data",))


def test_redistributions_on_a_fake_group():
    """Shard(0) -> Replicate of an [8, 16] float32 DTensor is one
    all-gather of the rank's [2, 16] block; Partial -> Replicate one
    all-reduce of the whole; the port's client all-reduce one all-reduce
    of its operand; DTensor's propagation on global shapes is not
    counted (a sharded matmul counts the rank's product)."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)

    from repro_torch.sharding.placement import client_placement

    with dryrun.fake_group(4):
        mesh = _dtensors()
        with FakeTensorMode():
            d = DTensor.from_local(torch.empty(2, 16), mesh, [Shard(0)],
                                   run_check=False)
            p = DTensor.from_local(torch.empty(8, 16), mesh, [Partial()],
                                   run_check=False)
            w = DTensor.from_local(torch.empty(16, 4), mesh, [Replicate()],
                                   run_check=False)
            with analysis.CollectiveCounter() as c:
                d.redistribute(mesh, [Replicate()])
            assert c.collective_bytes() == {
                "all-reduce": 0, "all-gather": 2 * 16 * 4,
                "reduce-scatter": 0, "all-to-all": 0,
                "collective-permute": 0, "count": 1, "total": 128}
            assert c.collective_top() == [
                "all-gather f32[2,16] x1: 0.00GB"]
            with analysis.CollectiveCounter() as c:
                p.redistribute(mesh, [Replicate()])
            got = c.collective_bytes()
            assert got["all-reduce"] == 8 * 16 * 4 and got["count"] == 1
            with analysis.CollectiveCounter() as c:
                y = d @ w
            assert c.flops == 2 * 2 * 16 * 4 and c.calls == 0
            assert y.placements == (Shard(0),)
        with torch.no_grad():
            place = client_placement(mesh, 8)
        with FakeTensorMode():
            with analysis.CollectiveCounter() as c:
                torch.ops.repro_torch.client_all_reduce(torch.empty(5, 3),
                                                        place.group)
        got = c.collective_bytes()
        assert got["all-reduce"] == 5 * 3 * 4 and got["count"] == 1


@pytest.mark.parametrize("table_placement", ["d_on_model", "fsdp"])
def test_embed_gathers_its_table_once(table_placement):
    """A table held otherwise than the lookup wants it (a vocab that does
    not divide: ``P(None, 'model')``; a LoRA base under fsdp: dim 1 on
    'data', the vocab on 'model') is gathered once in the embed step, and
    the only other collective is the reduction of the blocks' sum."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models.placed import embed

    V, d, B, L = 12, 8, 4, 3
    pt = {"d_on_model": (Replicate(), Shard(1)),
          "fsdp": (Shard(1), Shard(0))}[table_placement]
    with dryrun.fake_group(4):
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            rows = V // 2 if Shard(0) in pt else V    # the rank's block
            table = DTensor.from_local(
                torch.empty(rows, d // 2), mesh, pt, run_check=False)
            tokens = DTensor.from_local(
                torch.zeros(B // 2, L, dtype=torch.long), mesh,
                (Shard(0), Replicate()), run_check=False)
            with analysis.CollectiveCounter() as c:
                out = embed(table, tokens)
        assert tuple(out.shape) == (B, L, d)
        got = c.collective_bytes()
        assert got["all-gather"] == 4 * rows * (d // 2)
        assert [t for t in c.collective_top()
                if t.startswith("all-gather")] == [
            f"all-gather f32[{rows},{d // 2}] x1: 0.00GB"]
        vocab_sharded = pt[1] == Shard(0)
        assert got["count"] == 1 + vocab_sharded
        assert got["all-reduce"] == (4 * (B // 2) * L * d if vocab_sharded
                                     else 0)


# ---------------------------------------------------------------------------
# tiny on the test meshes
# ---------------------------------------------------------------------------

def _round_bytes(cfg, kind="baseline"):
    """One placed round's collective bytes: K1's [N + 1] float32 partial
    and the stacked float32 metric sums."""
    return 4 * (count_params(cfg) + 1) + 4 * METRIC_SUMS[kind]


def _common(rec):
    assert rec["ok"], rec.get("error", "") + rec.get("traceback", "")
    assert rec["chips"] == 4
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert set(rec["collectives"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute", "count", "total"}
    assert rec["collectives"]["total"] == sum(
        v for k, v in rec["collectives"].items()
        if k not in ("count", "total"))
    assert rec["run_s"] >= 0 and "roofline_counted" in rec


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("shape_name", supported_shapes("tiny"))
def test_tiny_runs_every_shape_on_the_test_meshes(mesh_kind, shape_name):
    rec = dryrun.run_one("tiny", shape_name, mesh_kind, test_mesh=True,
                         verbose=False)
    _common(rec)
    ax = rec["mesh_axes"]
    assert ax == ({"data": 2, "model": 2} if mesh_kind == "single"
                  else {"pod": 2, "data": 2, "model": 1})
    if shape_name == "train_4k":
        # the baseline: one placed tree round; its two client all-reduces
        # exactly, and DTensor's over 'model' as the placements give them
        assert rec["state"] == "tree"
        _tree_account(rec, mesh_kind, "baseline")
        assert rec["memory"]["alias_size_in_bytes"] > 0
        ana = rec["analytic"]["coll_bytes_per_dev"]
        assert rec["roofline"]["collective_s"] == pytest.approx(
            max(ana, rec["collectives"]["total"]) / 450e9)
    else:
        assert rec["memory"]["argument_size_in_bytes"] == sum(
            rec["memory"]["by_argument"].values())
        # the cache is written in place: an output aliases it
        assert rec["memory"]["alias_size_in_bytes"] >= \
            rec["memory"]["by_argument"]["cache"]


CLIENT_OP = "repro_torch::client_all_reduce"


def _local_numel(cfg, mesh_kind, mode):
    """N_local: the elements of a rank's blocks of the trainable tree on
    the test mesh, as ``param_pspecs(mode=)`` places them."""
    from torch.utils._pytree import tree_flatten

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import local_shape, param_pspecs
    from repro_torch.sharding.rules import _is_spec

    params = _fake_params(cfg)
    with dryrun.fake_group(4):
        mesh = make_test_mesh(multi_pod=mesh_kind == "multi",
                              device_type="cpu")
        specs = param_pspecs(cfg, mesh, params, mode=mode)
        leaves = tree_flatten(params)[0]
        return sum(math.prod(local_shape(tuple(v.shape), p, mesh))
                   for v, p in zip(leaves, tree_flatten(
                       specs, is_leaf=_is_spec)[0]))


def _fake_params(cfg):
    from repro_torch.models.model import init_params

    with FakeTensorMode():
        return init_params(torch.Generator(), cfg)


def _top(rec):
    """``collective_top``'s entries as {(kind, shapes): executions}."""
    out = {}
    for entry in rec["collective_top"]:
        kind, sig, n = entry.split(":")[0].split(" ")
        out[(kind, sig)] = int(n[1:])
    return out


def _tree_account(rec, mesh_kind, variant):
    """The tree step's collectives on the test mesh: the two client
    all-reduces exactly (K1's ``[N_local + 1]`` float32 partial on the
    rank's column shards, the four metric sums); on the (2, 2, 1) mesh
    ('model' of one rank) nothing else; on the (2, 2) mesh what the
    placements give: under "tp" storage with the batch replicated, the
    residual stream's all-reduce (``[b, L, d]``) once per embedding and
    sub-block forward (the "g" operator) and once per norm backward (the
    "f" operator) in each of the s local steps, and no weight moves;
    under ``dp_client`` each replicated weight's gradient is
    all-reduced."""
    cfg = get_config("tiny")
    mode, batch_mode = dryrun.train_modes(variant)
    n_local = _local_numel(cfg, mesh_kind, mode)
    ops = rec["collective_ops"]
    assert ops[CLIENT_OP] == [2, 4 * (n_local + 1) + 4 * 4]
    if mesh_kind == "multi":
        assert list(ops) == [CLIENT_OP]
        assert rec["collectives"]["total"] == ops[CLIENT_OP][1]
        return
    s, shape = cfg.local_steps, dryrun.SHAPES["train_4k"]
    b = shape.global_batch // rec["clients"]
    top = _top(rec)
    weights = {f"f32[{','.join(map(str, v.shape))}]"
               for v in torch.utils._pytree.tree_leaves(_fake_params(cfg))}
    if batch_mode == "tp":
        resid = ("all-reduce", f"f32[{b},{shape.seq_len},{cfg.d_model}]")
        assert top[resid] == 2 * s * (2 * cfg.n_layers + 1)
        assert not any(sig in weights for _, sig in top)
    if mode == "dp":
        # the stacked leaves' gradients, per local step and unit
        n_units = cfg.n_layers // len(cfg.pattern)
        for sig in weights:
            if sig.count(",") == 2:
                assert top.get(("all-reduce", sig), 0) >= s * n_units, sig


CHUNKS = {
    "flat_chunk4": dict(K=4, S=1, sampling="uniform"),
    "flat_chunk4+epoch": dict(K=4, S=1, sampling="epoch"),
    "flat_chunk2+seeds4": dict(K=2, S=4, sampling="uniform"),
    "flat_chunk2+seeds4+mesh": dict(K=2, S=2, sampling="uniform"),
    "flat_chunk4+faults": dict(K=4, S=1, sampling="uniform",
                               kind="faults"),
    "flat_chunk4+staleness": dict(K=4, S=1, sampling="uniform",
                                  kind="staleness"),
}


@pytest.mark.parametrize("variant", list(CHUNKS))
def test_chunk_variants_count_k_rounds_of_collectives(variant):
    """The reference's flat_chunk assertions (``test_dryrun.py``) and the
    exact account: K rounds of the round's two all-reduces, each over the
    rank's S seed rows at once (S = all four seeds without a seed axis,
    two of them on the (2, 2, 1) seed mesh)."""
    want = CHUNKS[variant]
    rec = dryrun.run_one("tiny", "train_4k", "multi", test_mesh=True,
                         verbose=False, variant=variant)
    _common(rec)
    assert rec["chunk_rounds"] == want["K"]
    assert rec["sampling"] == want["sampling"]
    assert rec.get("seeds") == (4 if "seeds" in variant else None)
    assert rec.get("faults") == ("faults" in variant or None)
    assert rec.get("staleness") == ("staleness" in variant or None)
    if variant.endswith("+mesh"):
        assert rec["mesh_axes"] == {"seed": 2, "pod": 2, "data": 1}
    else:
        assert rec["mesh_axes"] == {"pod": 2, "data": 2, "model": 1}
    assert rec["memory"]["alias_size_in_bytes"] > 0
    coll = rec["collectives"]
    assert coll["all-reduce"] > 0
    assert coll["count"] == 2 * want["K"]
    assert coll["all-reduce"] == coll["total"] == want["K"] * want["S"] \
        * _round_bytes(get_config("tiny"), want.get("kind", "baseline"))
    # the analytic terms cover K rounds x S seeds; the collective term
    # is the counted one for a variant
    base = dryrun.roofline.analytic_costs(
        get_config("tiny"), dryrun.SHAPES["train_4k"], rec["mesh_axes"])
    mul = want["K"] * (4 if "seeds" in variant else 1)
    assert rec["analytic"]["flops_per_dev"] == pytest.approx(
        base["flops_per_dev"] * mul)
    assert rec["roofline"]["collective_s"] == pytest.approx(
        coll["total"] / 450e9)


# ---------------------------------------------------------------------------
# the DTensor serving step against the unplaced one
# ---------------------------------------------------------------------------

RANKS, JOIN_S = 4, 240


def _spawn(tmp):
    import torch.multiprocessing as mp

    import _torch_dryrun_worker as W

    ctx = mp.start_processes(
        W.run_rank, args=(RANKS, os.path.join(tmp, "store"), tmp),
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
    return torch.load(os.path.join(tmp, "results.pt"), weights_only=False)


def test_placed_serving_matches_unplaced_and_the_fake_count(tmp_path):
    import torch.utils._pytree as pytree

    import _torch_dryrun_worker as W

    got = _spawn(str(tmp_path))
    for step, shape in zip(("prefill", "decode"), W.shapes()):
        want, placed, counted = got[step]
        w_leaves, w_def = pytree.tree_flatten(want)
        p_leaves, p_def = pytree.tree_flatten(placed)
        assert w_def == p_def
        for w, p in zip(w_leaves, p_leaves):
            assert w.shape == p.shape and w.dtype == p.dtype
            if w.is_floating_point():
                torch.testing.assert_close(p, w, rtol=0, atol=1e-5)
            else:
                assert torch.equal(p, w)
        rec = dryrun.run_one("tiny", shape.name, "single", test_mesh=True,
                             verbose=False, shape=shape)
        _common(rec)
        assert counted == rec["collectives"], step
        assert counted["count"] > 0


# ---------------------------------------------------------------------------
# the knobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,shape_name", [
    ("seq_shard", "prefill_32k"), ("dots_remat", "train_4k")])
def test_seq_shard_and_dots_remat(variant, shape_name):
    rec = dryrun.run_one("tiny", shape_name, "single", test_mesh=True,
                         verbose=False, variant=variant)
    _common(rec)
    assert rec["variant"] == variant
    if variant == "seq_shard":
        base = dryrun.run_one("tiny", shape_name, "single", test_mesh=True,
                              verbose=False)
        # the prompt's sequence over 'model' moves other tensors
        assert rec["collectives"] != base["collectives"]


@pytest.fixture
def moe_env():
    old = os.environ.pop("REPRO_MOE_CONSTRAIN", None)
    yield
    os.environ.pop("REPRO_MOE_CONSTRAIN", None)
    if old is not None:
        os.environ["REPRO_MOE_CONSTRAIN"] = old


def test_moe_hint_changes_the_collectives_not_the_plain_layer(moe_env):
    from repro_torch.models.moe import moe_ffn

    cfg = reduced(get_config("olmoe-1b-7b"))
    recs = {}
    for variant, env in (("baseline", None), ("moe_hint", "1"),
                         ("moe_dshard", "D")):
        rec = dryrun.run_one("olmoe-1b-7b", "prefill_32k", "single",
                             test_mesh=True, verbose=False, variant=variant,
                             cfg=cfg)
        _common(rec)
        assert os.environ.get("REPRO_MOE_CONSTRAIN") == env
        recs[variant] = json.dumps(rec["collectives"], sort_keys=True)
    assert len(set(recs.values())) == 3
    # on plain tensors the hint does nothing: bit-equal either way
    gen = torch.Generator().manual_seed(0)
    d, E, eff = cfg.d_model, cfg.n_experts, cfg.expert_ff
    bp = dict(router=torch.randn(d, E, generator=gen),
              wi_e=torch.randn(E, d, 2 * eff, generator=gen) * d ** -0.5,
              wd_e=torch.randn(E, eff, d, generator=gen) * eff ** -0.5)
    x = torch.randn(2, 16, d, generator=gen)
    outs = []
    for env in (None, "1", "D"):
        os.environ.pop("REPRO_MOE_CONSTRAIN", None)
        if env:
            os.environ["REPRO_MOE_CONSTRAIN"] = env
        outs.append(moe_ffn(x, bp, cfg))
    for y, aux in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(aux, outs[0][1])


def test_cli_variant_and_skip_done(tmp_path, capsys):
    out = tmp_path / "dry.json"
    argv = ["--arch", "tiny", "--shape", "train_4k", "--test-mesh",
            "--mesh", "multi", "--variant", "flat_chunk2", "--out", str(out)]
    dryrun.main(argv)
    dryrun.main(["--arch", "tiny", "--shape", "train_4k", "--test-mesh",
                 "--mesh", "multi", "--out", str(out)])
    recs = json.loads(out.read_text())
    assert [(r["variant"], r["ok"]) for r in recs] == [
        ("flat_chunk2", True), ("baseline", True)]
    capsys.readouterr()
    dryrun.main(argv + ["--skip-done"])
    assert "skip tiny train_4k multi flat_chunk2" in capsys.readouterr().out
    assert len(json.loads(out.read_text())) == 2


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("variant", ["dp_client", "zero_client"])
def test_tree_knobs_run_on_the_test_meshes(variant, mesh_kind):
    """``dp_client`` and ``zero_client`` run the tree step with their
    storage and batch modes: ``ok``, ``"state": "tree"``, the client
    all-reduces exactly and DTensor's collectives as the placements give
    them; a rank's arguments grow under ``dp_client`` and stay under
    ``zero_client``."""
    rec = dryrun.run_one("tiny", "train_4k", mesh_kind, test_mesh=True,
                         verbose=False, variant=variant)
    _common(rec)
    assert rec["state"] == "tree" and rec["variant"] == variant
    _tree_account(rec, mesh_kind, variant)
    base = dryrun.run_one("tiny", "train_4k", mesh_kind, test_mesh=True,
                          verbose=False)
    got = rec["memory"]["by_argument"]["state"]
    want = base["memory"]["by_argument"]["state"]
    if variant == "dp_client" and mesh_kind == "single":
        assert got > want
    else:
        assert got == want


@pytest.mark.parametrize("variant", [
    "flat_chunk4+dp_client", "flat_chunk2+zero_client", "flat_chunkx",
    "flat_chunk4+epochs", "moe-hint"])
def test_unported_and_unknown_variants_raise(variant, capsys):
    """A tree-state knob beside a flat chunk (where it would change
    nothing) and any unknown token are refused before anything runs: no
    record describes a run that did not happen."""
    with pytest.raises(ValueError, match="tree-state round|unknown knob"):
        dryrun.run_one("tiny", "train_4k", "single", test_mesh=True,
                       variant=variant)
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "tiny", "--shape", "train_4k", "--test-mesh",
                     "--variant", variant, "--out", ""])
    assert "--variant" in capsys.readouterr().err
    assert dryrun.check_variant("flat_chunk+seeds+mesh") == (
        "flat_chunk+seeds+mesh")


# ---------------------------------------------------------------------------
# K4 and K5 as custom operators
# ---------------------------------------------------------------------------

def test_k4_k5_fakes_and_flop_formulas_match_their_plain_versions():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_mha_ref
    from repro_torch.kernels.ssd_chunk import ops as sops
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref

    gen = torch.Generator().manual_seed(1)
    q = torch.randn(2, 64, 4, 16, generator=gen)
    k, v = (torch.randn(2, 96, 2, 16, generator=gen) for _ in range(2))
    xdt = torch.randn(2, 3, 4, 8, 16, generator=gen)
    dA = -torch.rand(2, 3, 4, 8, generator=gen)
    B_, C_ = (torch.randn(2, 3, 4, 8, 5, generator=gen) for _ in range(2))
    launches = (fops.flash_mha.launches, sops.ssd_chunk.launches)
    cases = ((lambda: fops.flash_mha(q, k, v, window=8, softcap=3.0),
              lambda: flash_mha_ref(q, k, v, window=8, softcap=3.0),
              4 * 2 * 64 * 4 * 96 * 16),
             (lambda: sops.ssd_chunk(xdt, dA, B_, C_),
              lambda: ssd_chunk_ref(xdt, dA, B_, C_),
              2 * 2 * 3 * 4 * 8 * (8 * 5 + 8 * 16 + 5 * 16)))
    for op, plain, flops in cases:
        with FlopCounterMode(display=False) as f_op:
            got = op()
        with FlopCounterMode(display=False) as f_plain:
            want = plain()
        assert f_op.get_total_flops() == f_plain.get_total_flops() == flops
        for g, w in zip(*(t if isinstance(t, tuple) else (t,)
                          for t in (got, want))):
            assert torch.equal(g, w)
        with analysis.CollectiveCounter() as c:
            op()
        assert c.flops == flops
    # the fakes give the kernels' outputs without running them, on both
    # devices
    for dev in ("cpu", "cuda"):
        with FakeTensorMode(allow_non_fake_inputs=True):
            fq = torch.empty(2, 128, 4, 16, device=dev)
            fk = torch.empty(2, 128, 2, 16, device=dev)
            out = fops._flash_op(fq, fk, fk, True, None, 0.0)
            y, st, dec = sops._ssd_op(
                torch.empty(2, 3, 4, 8, 16, device=dev),
                torch.empty(2, 3, 4, 8, device=dev),
                torch.empty(2, 3, 4, 8, 5, device=dev),
                torch.empty(2, 3, 4, 8, 5, device=dev))
        assert out.shape == (2, 128, 4, 16) and out.device.type == dev
        assert (y.shape, st.shape, dec.shape) == (
            (2, 3, 4, 8, 16), (2, 3, 4, 5, 16), (2, 3, 4))
        assert st.dtype == dec.dtype == torch.float32
    assert (fops.flash_mha.launches, sops.ssd_chunk.launches) == launches
