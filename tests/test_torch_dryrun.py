"""The port's dry run, placement half (``launch/dryrun.py``): the reduced
``tiny`` config on the 4- and 8-rank test meshes, and every arch x
supported shape on the (16, 16) and (2, 16, 16) production meshes over a
fake process group, shapes only.

Every combination gets a record, ``ok`` with its numbers: the train
state is the tree state the reference places (each client's leaves over
'model' as well as the clients over ('pod', 'data')), so every
full-parameter model's share fits a card.  The per-rank argument bytes
equal an independent count, each leaf's bytes over the product of the
mesh axes its spec names; the analytic terms are
``launch/roofline.analytic_costs``' own."""
import json
import math

import pytest

torch = pytest.importorskip("torch")

import torch.utils._pytree as pytree  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import (ARCHS, SHAPES, get_config,  # noqa: E402
                                 supported_shapes)
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.sharding.rules import _is_spec, spec_axes  # noqa: E402

def _independent_bytes(arch, shape_name, mesh_kind, test_mesh=False):
    """Σ leaf bytes / Π sizes of the axes in its spec, over every argument
    of the combination, rebuilt here."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    multi = mesh_kind == "multi"
    with dryrun.fake_group(dryrun.mesh_world(mesh_kind, test_mesh)):
        from repro_torch.launch import mesh as meshes

        mesh = (meshes.make_test_mesh(multi_pod=multi, device_type="cpu")
                if test_mesh else
                meshes.make_production_mesh(multi_pod=multi,
                                            device_type="cpu"))
        ax = meshes.mesh_axis_sizes(mesh)
        with FakeTensorMode():
            args, specs = (dryrun.train_args(cfg, shape, mesh, multi)
                           if shape.kind == "train"
                           else dryrun.serve_args(cfg, shape, mesh))
    total = 0.0
    for name in args:
        leaves = pytree.tree_flatten(args[name])[0]
        sp = pytree.tree_flatten(specs[name], is_leaf=_is_spec)[0]
        assert len(leaves) == len(sp)
        for leaf, spec in zip(leaves, sp):
            if not torch.is_tensor(leaf):
                continue
            k = math.prod(ax[a] for e in spec for a in spec_axes(e))
            total += leaf.numel() * leaf.element_size() / k
    return total, ax


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_tiny_places_on_the_test_meshes(mesh_kind):
    for shape_name in supported_shapes("tiny"):
        rec = dryrun.run_one("tiny", shape_name, mesh_kind, test_mesh=True,
                             verbose=False)
        assert rec["ok"], rec.get("error")
        assert rec["chips"] == 4
        want, ax = _independent_bytes("tiny", shape_name, mesh_kind,
                                      test_mesh=True)
        assert rec["mesh_axes"] == ax
        assert rec["memory"]["argument_size_in_bytes"] == pytest.approx(
            want, rel=1e-12)
        assert rec["sharded_leaves"] > 0


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_every_combination_is_recorded_on_the_production_meshes(
        tmp_path, mesh_kind, capsys, monkeypatch):
    """``--all`` writes one record per arch x supported shape, each
    ``ok`` with bytes equal to the independent count and the roofline's
    analytic terms; ``--skip-done`` skips what is done.  The placement half only: each step is built but
    not run (``execute`` a no-op; ``test_torch_dryrun_lowering.py`` and
    ``test_torch_dryrun_production.py`` run steps)."""
    from repro_torch.launch import analysis

    monkeypatch.setattr(dryrun, "execute",
                        lambda step, args: (None,
                                            analysis.CollectiveCounter()))
    out = tmp_path / "dry.json"
    dryrun.main(["--all", "--mesh", mesh_kind, "--out", str(out)])
    recs = json.loads(out.read_text())
    want = {(a, s) for a in ARCHS for s in supported_shapes(a)}
    assert {(r["arch"], r["shape"]) for r in recs} == want
    assert len(recs) == len(want)
    chips = 512 if mesh_kind == "multi" else 256
    for r in recs:
        assert r["mesh"] == mesh_kind and r["chips"] == chips
        key = (r["arch"], r["shape"])
        assert r["ok"], (key, r.get("error"))
        assert r["memory"]["argument_size_in_bytes"] <= dryrun.CARD_BYTES
        ana = roofline.analytic_costs(get_config(r["arch"]),
                                      SHAPES[r["shape"]], r["mesh_axes"])
        assert r["analytic"] == json.loads(json.dumps(ana))
        assert r["roofline"]["compute_s"] == pytest.approx(
            ana["flops_per_dev"] / 989e12)
        if SHAPES[r["shape"]].kind == "train":
            assert r["clients"] == chips // 16     # pod x data
    # the independent count on three of them (each rebuilds its inputs)
    for arch, shape_name in (("gemma2-2b", "train_4k"),
                             ("mixtral-8x22b", "prefill_32k"),
                             ("zamba2-7b", "long_500k")):
        rec = next(r for r in recs if (r["arch"], r["shape"])
                   == (arch, shape_name))
        want_bytes, _ = _independent_bytes(arch, shape_name, mesh_kind)
        assert rec["memory"]["argument_size_in_bytes"] == pytest.approx(
            want_bytes, rel=1e-12)
    capsys.readouterr()
    dryrun.main(["--arch", "gemma2-2b", "--shape", "decode_32k", "--mesh",
                 mesh_kind, "--out", str(out), "--skip-done"])
    assert "skip gemma2-2b decode_32k" in capsys.readouterr().out
