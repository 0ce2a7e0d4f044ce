"""The port's experiment grid (``repro_torch/launch/experiments.py``,
``launch/analysis.py`` and ``train --seeds/--scenario``) against the JAX
package's, on the CPU.

Held against the reference: the scenario registry and its grids, cell
for cell; the seed batch in both template modes; the results-table
functions on the same histories; one reduced CNN cell (fault and stale,
with the kernel's plain version) end to end; the CLI's ``--list``.  Then
the port's own properties: padding and packing change no result, the
launcher's ``--seeds`` is ``run_multi_seed``, and the runners refuse what
the reference refuses."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import analysis as ref_analysis  # noqa: E402
from repro.launch import experiments as rx  # noqa: E402
from repro_torch.core import engine, prng  # noqa: E402
from repro_torch.launch import analysis, experiments as px  # noqa: E402
from repro_torch.launch import train  # noqa: E402

from _torch_fl_small import (EXACT, DIM, assert_carry_equal,  # noqa: E402
                             setup)

#: a reduced CNN cell: 6 clients, 2 local steps, 600 samples
SMALL = dict(seeds=3, rounds=5, chunk_rounds=2, m=6, s=2, batch=4,
             n_samples=600)


def _port(name, **kw):
    return px.run_scenario(px.get_scenario(name), device="cpu",
                           **dict(SMALL, **kw))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_and_grids_equal_the_reference():
    """Every scenario's fields, and every grid, as the reference's."""
    assert list(px.SCENARIOS) == list(rx.SCENARIOS)
    for name, sc in rx.SCENARIOS.items():
        assert dataclasses.asdict(px.SCENARIOS[name]) == \
            dataclasses.asdict(sc), name
    assert px.GRIDS == rx.GRIDS
    for cells in px.GRIDS.values():
        assert all(c in px.SCENARIOS for c in cells)


@pytest.mark.parametrize("name", ["fedawe/markov", "fig2_midround_dropout",
                                  "blackout_cluster", "trace_diurnal",
                                  "fedar/semi_async", "fedawe/stale_trace",
                                  "fedawe/interleaved_sine@floor"])
def test_scenario_configs_equal_the_reference(name):
    """A cell's availability, fault and staleness configs carry the
    reference's fields (None where the reference's is None)."""
    sc, rsc = px.get_scenario(name), rx.get_scenario(name)
    assert dataclasses.asdict(sc.availability()) == \
        dataclasses.asdict(rsc.availability())
    for got, want in ((sc.fault(), rsc.fault()),
                      (sc.staleness(), rsc.staleness())):
        assert (got is None) == (want is None)
        if want is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_lookup_and_patterns():
    """Patterns expand as the reference expands them; a pattern matching
    nothing and an unknown name raise; a bad field is refused."""
    pats = ["fedau/*", "fedawe/sine", "fedawe/sine", "*stale_d2*"]
    assert px.match_scenarios(pats) == rx.match_scenarios(pats)
    with pytest.raises(KeyError, match="matches no scenario"):
        px.match_scenarios(["nope/*"])
    with pytest.raises(KeyError, match="unknown scenario"):
        px.get_scenario("nope")
    with pytest.raises(ValueError, match="strategy"):
        px.Scenario(name="x", strategy="sgd")
    with pytest.raises(ValueError, match="duplicate"):
        px.register_scenario(px.Scenario(name="fedawe/sine"))


def test_cli_list_equals_the_reference(capsys):
    """``--list`` prints the reference's names, columns and grids."""
    px.main(["--list", "--device", "cpu"])
    port = capsys.readouterr().out
    rx.main(["--list"])
    assert port == capsys.readouterr().out


def test_cli_refuses_what_is_not_ported():
    """Every flag of the reference's grid is defined here (the mesh and
    compile-cache flags too: tests/test_torch_mesh.py and
    tests/test_torch_compilecache.py run them); a flag of neither is
    refused, and ``--seed-mesh`` without a card raises rather than
    falling back to the CPU."""
    def flags(parser):
        return {o for a in parser._actions for o in a.option_strings}

    assert flags(rx.build_parser()) <= flags(px.build_parser())
    with pytest.raises(SystemExit):
        px.main(["--scenario", "fedawe/sine", "--no-such-flag"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            px.main(["--scenario", "fedawe/sine", "--seed-mesh"])


# ---------------------------------------------------------------------------
# the runners
# ---------------------------------------------------------------------------

def test_chunk_rounds_zero_or_negative_rejected():
    """``chunk_rounds <= 0`` raises before a task is built, in both entry
    points; positive values clamp to the run length."""
    assert px._resolve_chunk_rounds(8, 5) == 5
    assert px._resolve_chunk_rounds(2, 5) == 2
    for bad in (0, -3):
        with pytest.raises(ValueError, match="must be >= 1"):
            px._resolve_chunk_rounds(bad, 8)
    kw = dict(SMALL, chunk_rounds=0, preset="image", seed=0, device="cpu")
    with pytest.raises(ValueError, match="chunk_rounds=0"):
        px.run_scenario(px.get_scenario("fedawe/sine"), **kw)
    with pytest.raises(ValueError, match="chunk_rounds=0"):
        px.build_cell(px.get_scenario("fedawe/sine"), **kw)


def test_tail_executor_is_demanded_up_front():
    """T % K != 0 without ``make_tail_fn`` raises before the first call."""
    calls = []

    def chunk(*a):
        calls.append(a)
        raise AssertionError("must not be called")

    with pytest.raises(ValueError, match="make_tail_fn"):
        px.run_seed_rounds(None, chunk, 5, 2, sampler_states={}, store={},
                           data_keys=None, n_seeds=2)
    assert not calls


def test_pad_m_eligibility_is_strict():
    """Client-axis padding only where zero-mass rows are inert, as the
    reference rules it."""
    from repro_torch.core import FLConfig

    fl = FLConfig(m=6, s=2, eta_l=0.05, strategy="fedawe", flat_state=True)
    p = torch.full((6,), 0.5)
    ok = px.Scenario(name="ok", strategy="fedawe")
    fl2, p2 = px._pad_m_config(ok, fl, p, 8, has_fault=False,
                               has_stale=False)
    assert fl2.m == 8 and p2.shape == (8,) and float(p2[6:].sum()) == 0.0
    assert px._pad_m_config(ok, fl, p, 6, has_fault=True,
                            has_stale=True) == (fl, p)
    for sc, kw, match in (
            (px.Scenario(name="e", sampling="epoch"), {}, "sampling"),
            (px.Scenario(name="f", delta_floor=0.05), {}, "delta_floor"),
            (ok, dict(has_fault=True), "fault"),
            (ok, dict(has_stale=True), "fault/staleness")):
        args = dict(dict(has_fault=False, has_stale=False), **kw)
        with pytest.raises(ValueError, match=match):
            px._pad_m_config(sc, fl, p, 8, **args)
    with pytest.raises(ValueError, match="flat_state"):
        px._pad_m_config(ok, dataclasses.replace(fl, flat_state=False), p,
                         8, has_fault=False, has_stale=False)
    with pytest.raises(ValueError, match="below"):
        px._pad_m_config(ok, fl, p, 4, has_fault=False, has_stale=False)


def _template_fns():
    """Bit-exact model initializers of the two packages (uniform draws)."""
    def port(key):
        return {"w": prng.uniform(key, (DIM, DIM)), "b": torch.zeros((7,))}

    def ref(key):
        return {"w": jax.random.uniform(key, (DIM, DIM)),
                "b": jnp.zeros((7,))}

    return port, ref


@pytest.mark.parametrize("mode", ["shared", "full"])
def test_build_seed_batch_equals_the_reference(mode):
    """Both template modes: every stacked leaf (states, epoch sampler
    carries, data keys) bit-equal to the reference's batch; in full mode
    the seeds start from different models."""
    port_fn, ref_fn = _template_fns()
    p, r = setup("port", sampling="epoch"), setup("ref", sampling="epoch")
    got = px.build_seed_batch(
        p["cfg"], p["template"], prng.PRNGKey(0, "cpu"),
        prng.PRNGKey(42, "cpu"), p["init_fn"], p["store"], 3,
        template_fn=port_fn if mode == "full" else None)
    want = rx.build_seed_batch(
        r["cfg"], r["template"], jax.random.PRNGKey(0),
        jax.random.PRNGKey(42), r["init_fn"], r["store"], 3,
        template_fn=ref_fn if mode == "full" else None)
    states, rstates = got[0], want[0]
    for name in ("global_tr", "clients_tr", "tau", "t", "markov", "rng"):
        w = np.asarray(getattr(rstates, name))
        if w.dtype == np.uint32:
            w = w.astype(np.int64)
        np.testing.assert_array_equal(getattr(states, name).numpy(), w,
                                      err_msg=name)
    assert_carry_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(),
                                  np.asarray(want[2]).astype(np.int64))
    same = torch.equal(states.global_tr[0], states.global_tr[1])
    assert same == (mode == "shared")


def test_permuted_seed_ids_permute_the_results():
    """Row i of a batch built with ``seed_ids`` is seed ``seed_ids[i]``
    of the default batch: states and histories permute with the ids."""
    port_fn, _ = _template_fns()
    p = setup("port", kind="markov")
    ids = [2, 0, 1]
    runs = {}
    for key, seed_ids in (("plain", None), ("perm", ids)):
        states, sss, dks = px.build_seed_batch(
            p["cfg"], p["template"], prng.PRNGKey(0, "cpu"),
            prng.PRNGKey(42, "cpu"), p["init_fn"], p["store"], 3,
            template_fn=port_fn, seed_ids=seed_ids)
        chunk = engine.make_seeds_chunk_fn(None, p["round_fn"],
                                           p["sample_fn"], 2, 3)
        runs[key] = px.run_seed_rounds(states, chunk, 4, 2,
                                       sampler_states=sss, store=p["store"],
                                       data_keys=dks, n_seeds=3)
    (sa, ha), (sb, hb) = runs["plain"], runs["perm"]
    for i, j in enumerate(ids):
        assert hb[i] == ha[j]
        for name in ("global_tr", "tau", "rng", "markov"):
            assert torch.equal(getattr(sb, name)[i], getattr(sa, name)[j])
    with pytest.raises(ValueError, match="seed_ids"):
        px.build_seed_batch(p["cfg"], p["template"],
                            prng.PRNGKey(0, "cpu"), prng.PRNGKey(42, "cpu"),
                            p["init_fn"], p["store"], 3, seed_ids=[0, 1])


def test_reduced_cnn_cell_matches_the_reference():
    """One cell end to end on the reduced CNN: the fault and stale FedAWE
    cell through ``run_scenario`` with the kernel's plain version, three
    seeds, a tail chunk and an eval: counts bit-equal per seed and round,
    losses within 1e-4, eval accuracy within 2 of 1 024 samples."""
    name = "fedawe/stale_d2+midround"
    got = _port(name, use_kernel=True, eval_every=4)
    want = rx.run_scenario(rx.get_scenario(name), use_kernel=True,
                           eval_every=4, **SMALL)
    assert {k: got[k] for k in ("scenario", "seeds", "rounds",
                                "chunk_rounds")} == \
        {k: want[k] for k in ("scenario", "seeds", "rounds", "chunk_rounds")}
    for hg, hw in zip(got["histories"], want["histories"]):
        assert len(hg) == len(hw) == SMALL["rounds"]
        for g, w in zip(hg, hw):
            assert set(g) == set(w)
            for k in w:
                if k in EXACT:
                    assert g[k] == w[k], (k, g[k], w[k])
                elif k == "eval_acc":
                    assert abs(g[k] - w[k]) <= 2 / 1024
                else:
                    np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                               atol=1e-4)
    assert got["final"]["eval_acc"]["seeds"] == 3


def test_cap_padded_packing_equals_unpacked_runs():
    """Cells of different Dirichlet alpha differ only in the sampler cap:
    ``pack_cells(pad=True)`` pads one into the other's bucket and merges
    every cell into one group, and each packed record equals its unpacked
    ``run_scenario`` to the bit; without padding they stay apart."""
    names = ["fedawe/sine", "fedawe/sine@iid", "mifa/sine",
             "fedawe/sine+epoch"]
    kw = dict(SMALL, preset="image", seed=0, use_kernel=True, device="cpu")
    cells = [px.build_cell(px.get_scenario(n), **kw) for n in names]
    caps = [c["store"]["idx"].shape[1] for c in cells[:2]]
    assert caps[0] != caps[1]
    assert len(px.pack_cells(cells)) == 4
    groups = px.pack_cells(cells, pad=True)
    assert len(groups) == 1
    assert sum(1 for c in cells if c.get("padded_cap")) == 1
    assert not cells[3].get("padded_cap")       # epoch cells are not padded
    packed = px.run_packed_grid(names, **kw)
    for name, rec in zip(names, packed):
        assert json.dumps(rec) == json.dumps(_port(name, use_kernel=True))


def test_cli_writes_the_cells_and_the_table(tmp_path):
    """The grid CLI on the CPU writes one JSON per cell and the results
    table under ``--out-dir``; its rows are the cells' ``_cell_row``."""
    rows = px.main(["--scenario", "fedawe/sine", "--scenario",
                    "fedau/midround", "--seeds", "2", "--rounds", "3",
                    "--chunk-rounds", "2", "--m", "6", "--s", "2",
                    "--batch", "4", "--n-samples", "600", "--eval-every",
                    "3", "--packed", "--out-dir", str(tmp_path),
                    "--device", "cpu"])
    assert [r["scenario"] for r in rows] == ["fedawe/sine", "fedau/midround"]
    assert "±" in rows[0]["eval_acc"] and "±" in rows[0]["last_loss"]
    rec = json.load(open(tmp_path / "experiments" / "fedau_midround.json"))
    assert rec["seeds"] == 2 and len(rec["histories"]) == 2
    assert json.load(open(tmp_path / "experiments_table.json")) == rows
    table = open(tmp_path / "experiments_table.md").read()
    assert "| scenario | strategy |" in table and "fedau/midround" in table


def test_train_seeds_is_run_multi_seed(tmp_path):
    """``train --scenario fedawe/stale_geom --seeds 3`` records, per seed,
    the histories ``run_multi_seed`` gives for the launcher's own setup,
    and the mean±std of its finals; flags passed explicitly win over the
    scenario cell."""
    flags = ["--scenario", "fedawe/stale_geom", "--seeds", "3", "--rounds",
             "5", "--chunk-rounds", "2", "--m", "6", "--s", "2", "--batch",
             "4", "--n-samples", "600", "--eval-every", "4", "--device",
             "cpu"]
    out = tmp_path / "seeds.json"
    final = train.main(flags + ["--out", str(out)])
    rec = json.load(open(out))
    args = train.build_parser().parse_args(flags)
    parts = train.setup(args, torch.device("cpu"))
    assert (args.strategy, args.dynamics, args.sampling) == \
        ("fedawe", "sine", "uniform")
    assert parts["stale"]["buf"].shape[0] == 4
    _, hists, finals = px.run_multi_seed(
        parts["fl"], parts["round_fn"], parts["params"], parts["ds"],
        sampling="uniform", batch=4, seeds=3, rounds=5, chunk_rounds=2,
        rng=parts["rng"], data_key=parts["data_key"],
        eval_fn=parts["eval_fn"], eval_every=4, fault=parts["fault"],
        stale=parts["stale"])
    assert rec["history_per_seed"] == hists
    assert final == analysis.seed_summary(finals) == rec["final"]
    assert rec["curves"] == analysis.aggregate_seed_histories(hists)
    explicit = train.build_parser().parse_args(
        flags + ["--dynamics", "stationary", "--eta-l", "0.05"])
    train.resolve_flags(explicit)
    assert explicit.dynamics == "stationary" and explicit.eta_l == 0.05
    plain = train.build_parser().parse_args(["--device", "cpu"])
    assert train.resolve_flags(plain) is None
    assert (plain.strategy, plain.dynamics, plain.alpha) == \
        ("fedawe", "stationary", 0.1)


# ---------------------------------------------------------------------------
# the results table
# ---------------------------------------------------------------------------

HISTORIES = [
    [{"t": 0, "loss": 1.0, "n_active": 3.0},
     {"t": 1, "loss": 0.5, "n_active": 2.0, "eval_acc": 0.25}],
    [{"t": 0, "loss": 2.0, "n_active": 1.0},
     {"t": 1, "loss": 0.25, "n_active": 4.0}],
    [{"t": 0, "loss": 1.5, "n_active": 0.0},
     {"t": 1, "loss": 0.75, "n_active": 5.0, "eval_acc": 0.5}],
]


def test_seed_aggregation_equals_the_reference(tmp_path):
    """``aggregate_seed_histories`` (sparse eval keys included),
    ``seed_summary`` and ``write_results_table`` give the reference's
    output for the same inputs; ragged histories raise."""
    assert analysis.aggregate_seed_histories(HISTORIES) == \
        ref_analysis.aggregate_seed_histories(HISTORIES)
    finals = [{"eval_acc": 0.5, "loss": 1.0}, {"eval_acc": 0.75}]
    assert analysis.seed_summary(finals) == ref_analysis.seed_summary(finals)
    rows = [{"scenario": "a/b", "strategy": "a", "seeds": 2, "x": "1±0"},
            {"scenario": "c/d", "dynamics": "sine", "y": 3}]
    paths = [analysis.write_results_table(rows, str(tmp_path / "p.md")),
             ref_analysis.write_results_table(rows, str(tmp_path / "r.md"))]
    assert open(paths[0]).read() == open(paths[1]).read()
    assert open(tmp_path / "p.json").read() == \
        open(tmp_path / "r.json").read()
    with pytest.raises(ValueError, match="ragged"):
        analysis.aggregate_seed_histories([HISTORIES[0], HISTORIES[1][:1]])
