"""The dry run's tree step (``launch/dryrun.py``) against the reference's
compiled step on the (2, 2) test mesh: the port's counted flops a rank
within 0.67–1.5x of the trip-weighted ``dot`` flops of
``repro.launch.dryrun.build_train_step``'s compiled HLO
(``tests/_torch_ref_hlo.py``), on reduced configs that reach the tree
step's splits over 'model':

  * a gemma2-like config with one kv head (which 'model' = 2 does not
    divide): the attention, replicated before, split over the batch;
  * a reduced Mamba2 with an odd vocab (509): the mixer split over the
    batch, and the tied head's vocab undivided, so that the loss splits
    the tokens and no ``[tokens, vocab]`` all-reduce of partial logits
    remains.

The reference compiles in a subprocess started first; the port's steps
run beside it."""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_ref_hlo import ReferenceRun  # noqa: E402,I100
from repro_torch.configs import InputShape, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402

#: name -> (arch, overrides of ``reduced``, seq_len, global batch): m = 2
#: clients on the test mesh, so b = 2 rows a client
CASES = {
    "gemma2/kv1": ("gemma2-2b", dict(n_layers=2, n_kv_heads=1, d_model=64,
                                     d_ff=64), 256, 4),
    "mamba2/vocab509": ("mamba2-130m", dict(n_layers=2, vocab=509), 64, 4),
}
RATIO = (0.67, 1.5)


@pytest.fixture(scope="module")
def records():
    """Each case's reference object and port record."""
    ref = ReferenceRun(*(dict(arch=a, test_mesh=True, reduced=kw,
                              seq_len=L, global_batch=B)
                         for a, kw, L, B in CASES.values()))
    ours = {}
    for name, (arch, kw, L, B) in CASES.items():
        ours[name] = dryrun.run_one(
            arch, "train_4k", "single", test_mesh=True, verbose=False,
            cfg=reduced(get_config(arch), **kw),
            shape=InputShape("train_4k", "train", L, B))
    return dict(zip(CASES, ref.result())), ours


@pytest.mark.parametrize("name", list(CASES))
def test_tree_step_flops_are_the_reference_steps(records, name):
    ref, ours = records[0][name], records[1][name]
    assert ours["ok"], ours.get("error", "") + ours.get("traceback", "")
    ratio = ours["cost"]["flops"] / ref["dot_flops"]
    assert RATIO[0] <= ratio <= RATIO[1], (ratio, ref["dots"])


def test_no_partial_logits_cross_ranks(records):
    """The tied head's vocab (509) does not divide 'model': the tokens
    are split instead, and no collective carries a ``[..., vocab]``
    tensor but the table's own gather and its gradient's reduction."""
    rec = records[1]["mamba2/vocab509"]
    vocab = CASES["mamba2/vocab509"][1]["vocab"]
    for entry in rec["collective_top"]:
        kind, sig = entry.split(":")[0].split(" ")[:2]
        dims = [int(d) for d in sig[sig.index("[") + 1:-1].split(",") if d]
        assert not (dims and dims[-1] == vocab), entry


@pytest.mark.parametrize("groups", [1, 6])
def test_convolution_backward_counts_its_groups(groups):
    """A convolution's backward counts each gradient it computes at the
    forward's products (a Mamba2 mixer's depthwise conv: 1/groups of a
    dense one's), and its dense case the registry's count; the operators
    counted the most lead ``flops_top``."""
    import torch.nn.functional as F
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import analysis

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 10, generator=gen, requires_grad=True)
    w = torch.randn(6, 6 // groups, 4, generator=gen, requires_grad=True)
    y = F.conv1d(x, w, groups=groups)
    g = torch.randn(y.shape, generator=gen)
    with analysis.CollectiveCounter() as counter:
        torch.autograd.grad(y, (x, w), g)
    assert counter.flops == 2 * (2 * y.numel() * (6 // groups) * 4)
    if groups == 1:
        y = F.conv1d(x, w)
        with FlopCounterMode(display=False) as ref:
            torch.autograd.grad(y, (x, w), g)
        assert counter.flops == ref.get_total_flops()
    assert counter.flops_top()[0].startswith(
        "convolution_backward f32[2,6,7],f32[2,6,10] x1:")
