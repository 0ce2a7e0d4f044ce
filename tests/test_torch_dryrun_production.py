"""The dry run's step on the single-pod production mesh ((16, 16) over a
fake group of 256 ranks; the (2, 16, 16) mesh is
``test_torch_dryrun_production_multi.py``'s): three combinations, one of
each step kind, run under the per-rank counters (``launch/dryrun.py``).

  gemma2-2b x decode_32k      -> serve_step over DTensors
  mixtral-8x22b x prefill_32k -> prefill over DTensors (MoE, LoRA base)
  mamba2-130m x train_4k      -> the placed flat FedAWE round"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402

COMBOS = [("gemma2-2b", "decode_32k"), ("mixtral-8x22b", "prefill_32k"),
          ("mamba2-130m", "train_4k")]


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
        # the round's two all-reduces: K1's [N + 1] partial and the
        # stacked metric sums
        assert coll["count"] == 2 and coll["all-reduce"] == coll["total"]


@pytest.mark.parametrize("arch,shape_name", COMBOS)
def test_production_combinations_run_single_pod(arch, shape_name):
    _check(arch, shape_name, "single")
