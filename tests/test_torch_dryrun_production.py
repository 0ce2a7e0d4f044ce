"""The dry run's step on the single-pod production mesh ((16, 16) over a
fake group of 256 ranks; the (2, 16, 16) mesh is
``test_torch_dryrun_production_multi.py``'s): three combinations, one of
each step kind, run under the per-rank counters (``launch/dryrun.py``).

  gemma2-2b x decode_32k      -> serve_step over DTensors
  mixtral-8x22b x prefill_32k -> prefill over DTensors (MoE, LoRA base)
  mamba2-130m x train_4k      -> the placed tree-state FedAWE round"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402

COMBOS = [("gemma2-2b", "decode_32k"), ("mixtral-8x22b", "prefill_32k"),
          ("mamba2-130m", "train_4k")]


def _local_numel(arch, mesh_kind):
    """The elements of rank 0's blocks of the trainable tree, as
    ``param_pspecs`` places them on the production mesh."""
    import math

    import torch.utils._pytree as pytree
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import init_params, split_trainable
    from repro_torch.sharding import local_shape, param_pspecs
    from repro_torch.sharding.rules import _is_spec

    cfg = get_config(arch)
    with FakeTensorMode():
        trainable = split_trainable(init_params(torch.Generator(), cfg),
                                    cfg)[0]
    with dryrun.fake_group(dryrun.mesh_world(mesh_kind, False)):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                    device_type="cpu")
        specs = pytree.tree_flatten(param_pspecs(cfg, mesh, trainable),
                                    is_leaf=_is_spec)[0]
        return sum(math.prod(local_shape(tuple(v.shape), p, mesh))
                   for v, p in zip(pytree.tree_leaves(trainable), specs))


def _check(arch, shape_name, mesh_kind):
    rec = dryrun.run_one(arch, shape_name, mesh_kind, verbose=False)
    assert rec["ok"], rec.get("error", "") + rec.get("traceback", "")
    assert rec["chips"] == (512 if mesh_kind == "multi" else 256)
    assert rec["cost"]["flops"] > 0
    assert rec["memory"]["argument_size_in_bytes"] <= dryrun.CARD_BYTES
    assert rec["memory"]["temp_size_in_bytes"] > 0
    coll = rec["collectives"]
    assert coll["count"] > 0 and coll["total"] > 0
    if shape_name == "train_4k":
        # the round's two client all-reduces exactly: K1's [N_local + 1]
        # partial on rank 0's column shards and the four metric sums;
        # DTensor's collectives over 'model' beside them
        assert rec["state"] == "tree"
        n_local = _local_numel(arch, mesh_kind)
        assert rec["collective_ops"]["repro_torch::client_all_reduce"] == [
            2, 4 * (n_local + 1) + 4 * 4]
        assert coll["count"] > 2


@pytest.mark.parametrize("arch,shape_name", COMBOS)
def test_production_combinations_run_single_pod(arch, shape_name):
    _check(arch, shape_name, "single")
