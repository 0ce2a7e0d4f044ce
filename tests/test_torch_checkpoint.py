"""The port's checkpoint I/O (repro_torch/checkpointing/io.py) and the
train CLI's ``--ckpt`` / ``--ckpt-every`` / ``--resume`` against the JAX
package's, on the small problem of tests/_torch_fl_small.py.

Held: a port round trip is bit-equal; the manifest (leaf order, path
strings, shapes, dtypes) equals the reference's for the same run; a
checkpoint written by either package restores in the other and continues
there as it continues at home (masks, τ, keys and the sampler carry
bit-equal, states within 1e-4); wrong shapes and missing leaves are
refused; a chunked run resumed and finished in the host loop lands on the
uninterrupted run bit for bit, and so does a bfloat16-resident MIFA
cohort run, whose artifact the reference restores too; and the two
launchers agree, a resumed run included."""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import checkpointing as ref_ckpt  # noqa: E402
from repro_torch import checkpointing as ckpt  # noqa: E402

from _torch_fl_small import (M, assert_carry_equal,  # noqa: E402,I100
                             assert_parity, drive, setup)

MIDROUND = dict(upload_survival=0.7, sanitize=True)
GEOM = dict(tau_max=3, kind="geom", p_next=0.5, gamma=0.7)
#: (strategy, fault, stale): a memory strategy on the ring, FedAU's
#: scalar state (``extra/K`` sorts first), F3AST's, FedAWE-M's stack
RUNS = {"fedvarp-faults-geom": ("fedvarp", MIDROUND, GEOM),
        "fedau": ("fedau", None, None),
        "f3ast-geom": ("f3ast", None, GEOM),
        "fedawe_m-faults": ("fedawe_m", MIDROUND, None)}


def _parts(pkg, name, **kw):
    strategy, fault, stale = RUNS[name]
    return setup(pkg, strategy, fault, stale, sampling="epoch", **kw)


def _save_at(pkg, parts, path, T):
    """Run T rounds of ``parts``, writing the resumable artifact at T
    through the executor's 3-argument hook; returns the final state."""
    save = (ckpt if pkg == "port" else ref_ckpt).save_run_state
    state, _ = drive(pkg, parts, T, chunk=True, K=2,
                     ckpt_fn=lambda st, t, ss: save(path, st, ss,
                                                    round_t=t),
                     ckpt_every=T)
    return state


def _resume(pkg, name, path, T, *, chunk):
    """Restore ``path`` into ``pkg``'s fresh templates and run T more
    rounds: ``(state, history, sampler carry)``."""
    parts = _parts(pkg, name)
    restore = (ckpt if pkg == "port" else ref_ckpt).restore_run_state
    parts["state"], parts["sampler_state"] = restore(
        path, parts["state"], parts["sampler_state"])
    return drive(pkg, parts, T, chunk=chunk, K=2, carry=True)


def _leaf_dict(state, sampler):
    out = {}
    for k, v in state._asdict().items():
        if torch.is_tensor(v):
            out[k] = v
        elif isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in v.items()})
    out.update({f"sampler/{k}": v for k, v in sampler.items()})
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_port_round_trip_bit_equal(tmp_path, name):
    parts = _parts("port", name)
    path = str(tmp_path / "ck")
    state, _, carry = drive("port", parts, 3, carry=True)
    ckpt.save_run_state(path, state, carry)
    fresh = _parts("port", name)
    got, got_ss = ckpt.restore_run_state(path, fresh["state"],
                                         fresh["sampler_state"])
    assert (got.clients_tr is None) == (state.clients_tr is None)
    assert got.spec == state.spec
    want, have = _leaf_dict(state, carry), _leaf_dict(got, got_ss)
    assert set(want) == set(have)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        assert torch.equal(have[k].nan_to_num(), want[k].nan_to_num()), k
    assert json.load(open(path + ".json"))["meta"] == {"t": 3}


@pytest.mark.parametrize("name", list(RUNS))
def test_manifest_equals_the_reference(tmp_path, name):
    """Leaf keys, path strings, shapes and dtypes, in order."""
    for pkg in ("ref", "port"):
        _save_at(pkg, _parts(pkg, name), str(tmp_path / pkg), 2)
    got = json.load(open(tmp_path / "port.json"))
    want = json.load(open(tmp_path / "ref.json"))
    assert got == want
    paths = [e["path"] for e in got["leaves"]]
    assert "fl/rng" in paths and "sampler/perm" in paths
    if RUNS[name][0] == "fedau":
        assert paths.index("fl/extra/K") < paths.index("fl/extra/interval")


@pytest.mark.parametrize("chunk", [False, True], ids=["host", "chunked"])
@pytest.mark.parametrize("name", list(RUNS))
def test_reference_checkpoint_continues_in_the_port(tmp_path, name, chunk):
    """The reference writes at round 2; both packages restore it and run
    4 more rounds."""
    path = str(tmp_path / "ref")
    _save_at("ref", _parts("ref", name), path, 2)
    ref = _resume("ref", name, path, 4, chunk=chunk)
    port = _resume("port", name, path, 4, chunk=chunk)
    assert int(port[0].t) == 6
    assert_parity(ref, port)
    assert_carry_equal(port[2], ref[2])


@pytest.mark.parametrize("name", list(RUNS))
def test_port_checkpoint_read_by_the_reference(tmp_path, name):
    """The port writes at round 2; the reference's ``load_pytree`` reads
    every leaf bit for bit (keys as uint32), and both continue from it
    alike."""
    path = str(tmp_path / "port")
    state = _save_at("port", _parts("port", name), path, 2)
    rparts = _parts("ref", name)
    tmpl = {"fl": rparts["state"]._asdict(),
            "sampler": rparts["sampler_state"]}
    loaded = ref_ckpt.load_pytree(path, tmpl)
    assert np.asarray(loaded["fl"]["rng"]).dtype == np.uint32
    np.testing.assert_array_equal(
        np.asarray(loaded["fl"]["rng"]).astype(np.int64), state.rng.numpy())
    np.testing.assert_array_equal(np.asarray(loaded["fl"]["global_tr"]),
                                  state.global_tr.numpy())
    np.testing.assert_array_equal(np.asarray(loaded["fl"]["tau"]),
                                  state.tau.numpy())
    ref = _resume("ref", name, path, 2, chunk=True)
    port = _resume("port", name, path, 2, chunk=True)
    assert_parity(ref, port)
    assert_carry_equal(port[2], ref[2])


def test_restore_rejects_wrong_shapes_and_missing_leaves(tmp_path):
    path = str(tmp_path / "ck")
    parts = setup("port", "fedawe", sampling="epoch")
    ckpt.save_run_state(path, parts["state"], parts["sampler_state"])
    # more clients than the checkpoint holds
    big = setup("port", "fedawe", sampling="epoch")
    tau = torch.full((M + 2,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape mismatch at fl/tau"):
        ckpt.restore_run_state(path, big["state"]._replace(tau=tau),
                               big["sampler_state"])
    # a memory strategy's template needs a leaf FedAWE never wrote
    mifa = setup("port", "mifa", sampling="epoch")
    with pytest.raises(KeyError, match="missing leaf 'fl/extra/mem'"):
        ckpt.restore_run_state(path, mifa["state"], mifa["sampler_state"])
    # the FLState alone holds no sampler carry
    ckpt.save_fl_state(path, parts["state"])
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore_run_state(path, parts["state"],
                               parts["sampler_state"])
    assert ckpt.restore_fl_state(path, parts["state"]).t == 0


def test_chunked_resume_finishes_in_the_host_loop(tmp_path):
    """Chunked to round 2 with a checkpoint, restored, finished by the host
    loop (keyed by the global round counter): bit for bit the
    uninterrupted chunked run of 4 rounds, carry included."""
    name, path = "fedvarp-faults-geom", str(tmp_path / "single")
    full = drive("port", _parts("port", name), 4, chunk=True, K=2,
                 carry=True)
    _save_at("port", _parts("port", name), path, 2)
    rest = _resume("port", name, path, 2, chunk=False)
    assert full[1][2:] == [dict(r, t=r["t"] + 2) for r in rest[1]]
    a, b = full[0], rest[0]
    for k in ("global_tr", "tau", "t", "markov", "rng"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(a.extra["y"], b.extra["y"])
    for k in a.stale:
        assert torch.equal(a.stale[k], b.stale[k]), k
    assert_carry_equal(full[2], rest[2])


def test_bf16_cohort_resume_bit_equal_and_read_by_the_reference(tmp_path):
    """A MIFA cohort run with its memory resident in bfloat16 (beside the
    float32 ``mem_sum``), written at round 2 and resumed, lands on the
    uninterrupted 4-round run bit for bit; the reference writes the same
    manifest and restores the port's artifact, bfloat16 memory included."""
    kw = dict(sampling="epoch", sparse=5, rdt="bfloat16")
    path = str(tmp_path / "cohort")
    full = drive("port", setup("port", "mifa", **kw), 4, chunk=True, K=2,
                 carry=True)
    _save_at("port", setup("port", "mifa", **kw), path, 2)
    parts = setup("port", "mifa", **kw)
    parts["state"], parts["sampler_state"] = ckpt.restore_run_state(
        path, parts["state"], parts["sampler_state"])
    assert parts["state"].extra["mem"].dtype == torch.bfloat16
    rest = drive("port", parts, 2, chunk=True, K=2, carry=True)
    assert full[1][2:] == [dict(r, t=r["t"] + 2) for r in rest[1]]
    a, b = full[0], rest[0]
    for k in ("global_tr", "tau", "t", "markov", "rng"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in ("mem", "mem_sum"):
        assert a.extra[k].dtype == b.extra[k].dtype
        assert torch.equal(a.extra[k], b.extra[k]), k
    assert_carry_equal(full[2], rest[2])

    _save_at("ref", setup("ref", "mifa", **kw), str(tmp_path / "ref"), 2)
    assert json.load(open(path + ".json")) == \
        json.load(open(tmp_path / "ref.json"))
    rparts = setup("ref", "mifa", **kw)
    rstate, rss = ref_ckpt.restore_run_state(path, rparts["state"],
                                             rparts["sampler_state"])
    mem = np.asarray(rstate.extra["mem"])
    assert str(mem.dtype) == "bfloat16"
    saved = ckpt.restore_run_state(path, parts["state"],
                                   parts["sampler_state"])[0]
    np.testing.assert_array_equal(mem.astype(np.float32),
                                  saved.extra["mem"].float().numpy())
    np.testing.assert_array_equal(np.asarray(rstate.extra["mem_sum"]),
                                  saved.extra["mem_sum"].numpy())
    np.testing.assert_array_equal(np.asarray(rstate.tau),
                                  saved.tau.numpy())


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

CLI = ["--strategy", "mifa", "--sampling", "epoch", "--chunk-rounds", "2",
       "--flat-state", "--dynamics", "sine", "--m", "8", "--s", "2",
       "--batch", "4", "--n-samples", "800", "--eval-every", "4"]


def _history_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("n_active", "mean_echo", "t"):
            assert g[k] == w[k], k
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4,
                                   atol=1e-4)


def test_cli_matches_reference_cli(tmp_path):
    """``--strategy mifa --sampling epoch --chunk-rounds 2`` through both
    launchers; the port's final ``--ckpt`` restores in the reference."""
    from repro.launch import train as ref_train
    from repro_torch.launch import train

    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    flags = CLI + ["--rounds", "8"]
    train.main(flags + ["--device", "cpu", "--out", str(a),
                        "--ckpt", str(tmp_path / "final")])
    ref_train.main(flags + ["--out", str(b)])
    got, want = json.load(open(a)), json.load(open(b))
    _history_close(got["history"], want["history"])
    assert abs(got["final"]["eval_acc"]
               - want["final"]["eval_acc"]) <= 2 / 1024
    man = json.load(open(tmp_path / "final.json"))
    assert man["meta"] == {"t": 8}
    assert "extra/mem" in [e["path"] for e in man["leaves"]]
    assert "clients_tr" not in [e["path"] for e in man["leaves"]]


def test_cli_resumes_the_reference_artifact(tmp_path):
    """The reference launcher runs 4 of 8 rounds into ``--resume P
    --ckpt-every 4``; the port's launcher resumes P and finishes; the
    result equals the reference's uninterrupted 8 rounds, and the
    port's own artifact (rewritten at round 8) restores there too."""
    from repro.launch import train as ref_train
    from repro_torch.launch import train

    art = str(tmp_path / "run")
    flags = CLI + ["--ckpt-every", "4"]
    ref_train.main(flags + ["--rounds", "4", "--resume", art])
    assert json.load(open(art + ".json"))["meta"] == {"t": 4}
    out = tmp_path / "port.json"
    train.main(flags + ["--rounds", "8", "--resume", art, "--device",
                        "cpu", "--out", str(out)])
    got = json.load(open(out))["history"]
    full = tmp_path / "ref.json"
    ref_train.main(flags + ["--rounds", "8", "--resume",
                            str(tmp_path / "full"), "--out", str(full)])
    want = json.load(open(full))["history"]
    assert len(got) == 4
    _history_close(got, [dict(w, t=w["t"] - 4) for w in want[4:]])
    args = train.build_parser().parse_args(flags + ["--device", "cpu"])
    parts = train.setup(args, torch.device("cpu"))
    from repro_torch.data import make_device_sampler
    store = parts["ds"].device_store("cpu")
    init, _ = make_device_sampler(8, 2, 4, mode="epoch")
    port_state, port_ss = ckpt.restore_run_state(
        art, parts["state"], init(store, parts["data_key"]))
    ref_state, ref_ss = ckpt.restore_run_state(
        str(tmp_path / "full"), parts["state"],
        init(store, parts["data_key"]))
    assert int(port_state.t) == int(ref_state.t) == 8
    assert torch.equal(port_state.tau, ref_state.tau)
    assert torch.equal(port_state.rng, ref_state.rng)
    assert_carry_equal(port_ss, ref_ss)
    np.testing.assert_allclose(port_state.global_tr.numpy(),
                               ref_state.global_tr.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_cli_bf16_cohort_resumes_bit_equal(tmp_path):
    """``--strategy mifa --sparse-cohort 5 --resident-dtype bfloat16``
    through the port's launcher, stopped at round 4 of 8 by ``--resume P
    --ckpt-every 4`` and resumed: the artifact at round 8 equals the
    uninterrupted run's bit for bit (τ, key, global, the bf16 memory, its
    float32 column sum and the sampler carry)."""
    from repro_torch.data import make_device_sampler
    from repro_torch.launch import train

    flags = CLI + ["--ckpt-every", "4", "--sparse-cohort", "5",
                   "--resident-dtype", "bfloat16", "--device", "cpu"]
    art, full = str(tmp_path / "run"), str(tmp_path / "full")
    train.main(flags + ["--rounds", "4", "--resume", art])
    train.main(flags + ["--rounds", "8", "--resume", art])
    train.main(flags + ["--rounds", "8", "--resume", full])
    args = train.build_parser().parse_args(flags)
    got = []
    for path in (art, full):
        parts = train.setup(args, torch.device("cpu"))
        store = parts["ds"].device_store("cpu")
        init, _ = make_device_sampler(8, 2, 4, mode="epoch", emit="cols")
        got.append(ckpt.restore_run_state(path, parts["state"],
                                          init(store, parts["data_key"])))
    (a, ssa), (b, ssb) = got
    assert int(a.t) == int(b.t) == 8
    assert a.extra["mem"].dtype == torch.bfloat16
    for k in ("global_tr", "tau", "rng", "markov"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in ("mem", "mem_sum"):
        assert torch.equal(a.extra[k], b.extra[k]), k
    assert_carry_equal(ssa, ssb)


def test_cli_lm_resume_bit_equal_and_matches_reference(tmp_path):
    """``train --preset lm --chunk-rounds 2`` stopped at round 4 of 8 by
    ``--resume P --ckpt-every 2`` (the launchers' resumable artifact: a
    ``--ckpt`` artifact holds no sampler carry) and resumed in a new
    process, as a resume is: its metrics and final eval equal the
    uninterrupted 8-round run's bit for bit, and the reference launcher's
    resumed run within 1e-4 (n_active and mean_echo equal).  The port's
    processes run torch on one thread: on several, the CPU's reductions
    split by thread scheduling, and two runs of the same uninterrupted
    command differed in the last bit of a round's loss."""
    import os
    import subprocess
    import sys

    from repro.launch import train as ref_train

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    flags = ["--preset", "lm", "--strategy", "fedawe", "--chunk-rounds", "2",
             "--m", "6", "--s", "2", "--batch", "8", "--ckpt-every", "2"]
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
               OMP_NUM_THREADS="1")

    def port(rounds, art, out=None):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", *flags,
               "--rounds", str(rounds), "--resume", art, "--device", "cpu"]
        if out:
            cmd += ["--out", out]
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=repo, timeout=600)
        assert r.returncode == 0, r.stdout + r.stderr
        return r.stdout

    art, full = str(tmp_path / "run"), str(tmp_path / "full")
    port(4, art)
    assert json.load(open(art + ".json"))["meta"] == {"t": 4}
    assert "resumed" in port(8, art, str(tmp_path / "resumed.json"))
    port(8, full, str(tmp_path / "full.json"))
    got = json.load(open(tmp_path / "resumed.json"))
    want = json.load(open(tmp_path / "full.json"))
    assert len(got["history"]) == 4
    assert got["history"] == [dict(w, t=w["t"] - 4)
                              for w in want["history"][4:]]
    assert got["final"] == want["final"]

    ref_art = str(tmp_path / "ref")
    ref_train.main(flags + ["--rounds", "4", "--resume", ref_art])
    ref_train.main(flags + ["--rounds", "8", "--resume", ref_art, "--out",
                            str(tmp_path / "ref.json")])
    ref = json.load(open(tmp_path / "ref.json"))
    assert len(ref["history"]) == 4
    for g, w in zip(got["history"], ref["history"]):
        assert set(g) == set(w)
        for k in ("n_active", "mean_echo", "t"):
            assert g[k] == w[k], k
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(got["final"]["eval_loss"],
                               ref["final"]["eval_loss"], rtol=1e-4,
                               atol=1e-4)
