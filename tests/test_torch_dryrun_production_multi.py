"""The dry run's step on the multi-pod production mesh ((2, 16, 16) over
a fake group of 512 ranks): ``test_torch_dryrun_production.py``'s three
combinations, in a file of their own so that the two meshes' runs (a
minute or two each) can go to different test workers."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun_production import COMBOS, _check  # noqa: E402


@pytest.mark.parametrize("arch,shape_name", COMBOS)
def test_production_combinations_run_multi_pod(arch, shape_name):
    _check(arch, shape_name, "multi")
