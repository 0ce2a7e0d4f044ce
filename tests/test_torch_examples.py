"""The port's example scripts (``examples/torch/``) against the JAX
package's (``examples/``), each run on the CPU at a short length, the
reference script loaded by ``importlib`` from its path:

  * quickstart at T = 200: both strategies' long-run outputs within 1e-4,
    and FedAWE's bias below FedAvg's;
  * federated_lm at 3 rounds: the per-round losses within 1e-4, and the
    loss falling;
  * federated_image at m = 8 for 4 rounds, into ``tmp_path``: the final
    metrics within 1e-4 (the eval accuracy equal);
  * serve_demo: the greedy tokens equal to the reference's, its weights
    carried across."""
import contextlib
import importlib.util
import io
import json
import os
import re
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_quickstart_matches_the_reference():
    port = _load("examples/torch/quickstart.py", "torch_quickstart")
    ref = _load("examples/quickstart.py", "ref_quickstart")
    ref.T = 200
    x_avg, x_awe = port.main(["--rounds", "200", "--device", "cpu"])
    _close([x_avg, x_awe], [ref.run("fedavg_active"), ref.run("fedawe")])
    assert abs(x_awe - 50) < abs(x_avg - 50)


def test_federated_lm_matches_the_reference(monkeypatch):
    port = _load("examples/torch/federated_lm.py", "torch_federated_lm")
    ref = _load("examples/federated_lm.py", "ref_federated_lm")
    hist = port.main(["--rounds", "3", "--device", "cpu"])
    got = {}
    run_rounds = ref.run_rounds

    def spy(*a, **kw):
        state, h = run_rounds(*a, **kw)
        got["h"] = h
        return state, h

    monkeypatch.setattr(ref, "run_rounds", spy)
    monkeypatch.setattr(sys, "argv", ["federated_lm.py", "--rounds", "3"])
    ref.main()
    want = got["h"]
    assert len(hist) == len(want) == 3
    for g, w in zip(hist, want):
        assert g["n_active"] == w["n_active"]
        _close(g["loss"], w["loss"])
    assert hist[-1]["loss"] < hist[0]["loss"]
    with pytest.raises(SystemExit):
        port.main(["--device", "tpu"])


def test_federated_image_matches_the_reference(monkeypatch, tmp_path):
    port = _load("examples/torch/federated_image.py", "torch_fed_image")
    ref = _load("examples/federated_image.py", "ref_fed_image")
    results = port.main(["--rounds", "4", "--m", "8", "--device", "cpu",
                         "--out-dir", str(tmp_path / "port")])
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["federated_image.py", "--rounds", "4",
                                      "--m", "8"])
    ref.main()
    for strategy in ("fedawe", "fedavg_active"):
        name = f"example_image_{strategy}"
        got = json.load(open(tmp_path / "port" / f"{name}.json"))
        want = json.load(open(tmp_path / "results" / f"{name}.json"))
        assert got["final"] == want["final"] == \
            {"eval_acc": results[strategy]}
        assert len(got["history"]) == len(want["history"]) == 4
        for g, w in zip(got["history"], want["history"]):
            assert g["n_active"] == w["n_active"]
            _close(g["loss"], w["loss"])
        assert (tmp_path / "port" / f"{name}_ckpt.npz").exists()


def test_serve_demo_matches_the_reference(monkeypatch):
    """The port's demo with the reference server's weights carried
    across greedy-decodes the reference demo's tokens."""
    from repro.launch import serve as ref_serve
    from repro_torch.checkpointing.convert import params_from_numpy
    from repro_torch.launch import serve

    port = _load("examples/torch/serve_demo.py", "torch_serve_demo")
    ref = _load("examples/serve_demo.py", "ref_serve_demo")
    weights = {}
    ref_init, port_init = ref_serve.Server.__init__, serve.Server.__init__

    def keep(self, *a, **kw):
        ref_init(self, *a, **kw)
        weights["p"] = self.params

    def carry(self, *a, **kw):
        port_init(self, *a, **kw)
        self.params = params_from_numpy(weights["p"], self.device)

    monkeypatch.setattr(ref_serve.Server, "__init__", keep)
    monkeypatch.setattr(serve.Server, "__init__", carry)
    monkeypatch.setattr(sys, "argv", ["serve_demo.py"])

    def tokens(main, *args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(*args)
        return re.findall(r"req\d+: prompt=\d+t -> \[.*\]", buf.getvalue())

    want = tokens(ref.main)
    got = tokens(port.main, ["--device", "cpu"])
    assert len(want) == 6 and got == want
