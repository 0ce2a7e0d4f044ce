"""The port's roofline and model-flops helpers (``launch/roofline.py``,
``launch/analysis.py``'s ``roofline_terms``, ``active_param_count`` and
``model_flops``) against the reference's, for every config of the
registry, and their seconds against the H100 SXM constants of
``launch/mesh.py``.

The figures (flops, HBM bytes, collective bytes per device) are the
reference's formulas on the same config fields, so they agree within
1e-12 relative; the seconds divide them by the card's constants, not the
TPU's."""
import pytest

pytest.importorskip("torch")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import analysis as ref_analysis  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro_torch.configs import (SHAPES, _MODULES, get_config,  # noqa: E402
                                 supported_shapes)
from repro_torch.launch import analysis, mesh, roofline  # noqa: E402

ARCHS = list(_MODULES)
#: the production meshes the reference's dry run sizes its figures for
#: (tests/test_dryrun.py): single pod and two pods
MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]


#: the terms over the card's constants, where the reference divides by v5e's
SECONDS = ("compute_s", "memory_s", "collective_s")


def _rel(a, b):
    return abs(a - b) <= 1e-12 * abs(b)


def test_all_twelve_configs():
    assert len(ARCHS) == 12


def test_h100_constants():
    assert mesh.PEAK_FLOPS_BF16 == 989e12
    assert mesh.HBM_BW == 3.35e12
    assert mesh.ICI_BW == 450e9


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_costs_equal_the_reference(arch):
    cfg, ref = get_config(arch), ref_config(arch)
    for sh in supported_shapes(arch):
        for ax in MESHES:
            got = roofline.analytic_costs(cfg, SHAPES[sh], ax)
            want = ref_roofline.analytic_costs(ref, REF_SHAPES[sh], ax)
            assert set(got) == set(want), (arch, sh)
            for k, v in want.items():
                if k not in SECONDS:
                    assert _rel(got[k], v), (arch, sh, ax, k, got[k], v)
            assert got["compute_s"] == \
                got["flops_per_dev"] / mesh.PEAK_FLOPS_BF16
            assert got["memory_s"] == got["hbm_bytes_per_dev"] / mesh.HBM_BW
            assert got["collective_s"] == \
                got["coll_bytes_per_dev"] / mesh.ICI_BW
            assert roofline.dominant(got) == max(SECONDS, key=got.get)


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_and_model_flops_equal_the_reference(arch):
    cfg, ref = get_config(arch), ref_config(arch)
    n = analysis.active_param_count(cfg)
    assert n == ref_analysis.active_param_count(ref)
    for kind, mult in (("train", 6.0), ("prefill", 2.0), ("decode", 2.0)):
        f = analysis.model_flops(cfg, 4096, kind)
        assert f == ref_analysis.model_flops(ref, 4096, kind)
        assert f == mult * n * 4096


def test_roofline_terms_on_the_card_constants():
    t = analysis.roofline_terms(989e12, 3.35e12, 450e9)
    assert t["compute_s"] == t["memory_s"] == t["collective_s"] == 1.0
    t = analysis.roofline_terms(989e12, 2 * 3.35e12, 0.0)
    assert t["dominant"] == "memory_s" and t["bound_fraction"] == 0.5
    assert analysis.roofline_terms(0, 0, 0)["bound_fraction"] == 0.0
    want = ref_analysis.roofline_terms(1e15, 4e12, 1e11)
    got = analysis.roofline_terms(1e15, 4e12, 1e11)
    assert set(got) == set(want)
    # the same terms, over the H100's constants instead of v5e's
    assert got["compute_s"] == 1e15 / 989e12
    assert got["memory_s"] == 4e12 / 3.35e12
    assert got["collective_s"] == 1e11 / 450e9
