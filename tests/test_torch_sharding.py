"""The port's sharding rules (``repro_torch.sharding``) against the
reference's ``repro/sharding/rules.py``, spec for spec.

Every rule is given the same mesh, a stand-in with ``axis_names`` and
``devices.shape`` only (what the reference's rules read), on the five
shapes of the pod tier: ``(16, 16)``, ``(2, 16, 16)``, ``(2, 2)``,
``(2, 2, 1)`` and the ``(2, 1, 3)`` seed mesh.  The parameter and cache
trees are full width: the reference's from ``jax.eval_shape``, the
port's built under ``FakeTensorMode`` (shapes only).  Specs compare as
tuples, leaf by leaf by path.  ``placements`` is checked on a
``DeviceMesh`` over a fake process group of 512 ranks: DTensor's block of
a rank is the reference's ``P(('pod', 'data'))`` block."""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.data import federated as ref_fed  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.sharding import rules as ref_rules  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

from _torch_fl_small import setup  # noqa: E402,I100

ARCHS = list(configs._MODULES)            # the twelve, extras included
MESHES = {
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "2x2": (("data", "model"), (2, 2)),
    "2x2x1": (("pod", "data", "model"), (2, 2, 1)),
    "seed2x1x3": (("seed", "pod", "data"), (2, 1, 3)),
}


def _mesh(key):
    names, shape = MESHES[key]
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _ref_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(_key(k) for k in path): tuple(s) for path, s in flat}


def _port_specs(tree):
    flat = pytree.tree_flatten_with_path(tree, is_leaf=rules._is_spec)[0]
    out = {}
    for path, s in flat:
        if s is None:                  # an absent field (jax has no leaf)
            continue
        assert isinstance(s, rules.P), (path, s)
        out["/".join(_key(k) for k in path)] = tuple(s)
    return out


def assert_same_specs(port, ref):
    got, want = _port_specs(port), _ref_specs(ref)
    assert set(got) == set(want), (set(got) ^ set(want))
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])
    return len(want)


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """Full-width shapes of both packages: params, trainables and the
    decode caches at each decode shape's batch and length."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rcfg, pcfg = ref_configs.get_config(arch), configs.get_config(arch)
    ref_p = jax.eval_shape(
        lambda: ref_model.init_params(jax.random.PRNGKey(0), rcfg))
    decode = [s for s in configs.SHAPES.values() if s.kind == "decode"]
    ref_c = {s.name: jax.eval_shape(lambda s=s: ref_model.init_cache(
        rcfg, s.global_batch, s.seq_len)) for s in decode}
    with FakeTensorMode():
        port_p = model.init_params(torch.Generator(), pcfg)
        port_c = {s.name: model.init_cache(pcfg, s.global_batch, s.seq_len,
                                           device="cpu") for s in decode}
    return dict(
        rcfg=rcfg, pcfg=pcfg, ref_p=ref_p, port_p=port_p,
        ref_tr=ref_model.split_trainable(ref_p, rcfg)[0],
        port_tr=model.split_trainable(port_p, pcfg)[0],
        ref_c=ref_c, port_c=port_c,
        batch={s.name: s.global_batch for s in decode})


def _train_batch(cfg, m, lib):
    """The train_4k round batch's leaves [m, s, b, L] (and a frontend's
    embeddings), as shape records of either side."""
    shape = configs.SHAPES["train_4k"]
    b, s, L = max(1, shape.global_batch // m), cfg.local_steps, shape.seq_len
    out = dict(tokens=(m, s, b, L), labels=(m, s, b, L), mask=(m, s, b, L))
    if cfg.frontend != "none":
        out["embeds"] = (m, s, b, cfg.frontend_len, cfg.d_model)
    if cfg.enc_dec:
        out["enc_embeds"] = (m, s, b, cfg.enc_len, cfg.d_model)
    if lib == "ref":
        return {k: jax.ShapeDtypeStruct(v, jnp.float32)
                for k, v in out.items()}
    return {k: types.SimpleNamespace(shape=v) for k, v in out.items()}


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_specs_match_the_reference(arch, mesh_key):
    """param_pspecs (tp, fsdp, dp), client_stack_pspecs (one pod and
    multi-pod), batch_pspecs (tp, dp), serve_batch_pspecs and
    cache_pspecs at both decode shapes: every leaf's spec equal."""
    t = _trees(arch)
    mesh = _mesh(mesh_key)
    n = 0
    for kw in (dict(), dict(fsdp=True), dict(mode="dp"),
               dict(fsdp=True, mode="dp")):
        n += assert_same_specs(
            rules.param_pspecs(t["pcfg"], mesh, t["port_p"], **kw),
            ref_rules.param_pspecs(t["rcfg"], mesh, t["ref_p"], **kw))
    for mp in (False, True):
        for mode in ("tp", "dp"):
            n += assert_same_specs(
                rules.client_stack_pspecs(t["pcfg"], mesh, t["port_tr"],
                                          multi_pod=mp, mode=mode),
                ref_rules.client_stack_pspecs(t["rcfg"], mesh, t["ref_tr"],
                                              multi_pod=mp, mode=mode))
            n += assert_same_specs(
                rules.batch_pspecs(mesh, _train_batch(t["pcfg"], 32, "port"),
                                   multi_pod=mp, mode=mode),
                ref_rules.batch_pspecs(mesh,
                                       _train_batch(t["rcfg"], 32, "ref"),
                                       multi_pod=mp, mode=mode))
    for name, B in t["batch"].items():
        n += assert_same_specs(
            rules.cache_pspecs(t["pcfg"], mesh, t["port_c"][name], B),
            ref_rules.cache_pspecs(t["rcfg"], mesh, t["ref_c"][name], B))
        for b in (B, 1, 3):
            got = rules.serve_batch_pspecs(mesh, b)
            want = ref_rules.serve_batch_pspecs(mesh, b)
            assert tuple(map(tuple, got)) == tuple(map(tuple, want))
    assert n > 100


FL_VARIANTS = {
    "fedawe": dict(strategy="fedawe"),
    "mifa+faults+stale": dict(
        strategy="mifa", fault=dict(upload_survival=0.7, trace=True),
        stale=dict(tau_max=3, kind="trace"),
        trace=np.ones((5, 8), np.float32),
        dtrace=np.ones((4, 8), np.int32)),
    "fedau": dict(strategy="fedau"),
    "fedawe_m+blackout": dict(
        strategy="fedawe_m",
        fault=dict(blackout_len=2, blackout_start=1, blackout_cluster=0),
        clusters=np.arange(8) % 3),
}


@pytest.mark.parametrize("variant", list(FL_VARIANTS))
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_fl_state_specs_match_the_reference(mesh_key, variant):
    """flat_pspecs of the small problem's flat FLState (fault and stale
    carries included), one pod and multi-pod, and seed_pspecs of it over
    ``seed_axes_for`` the mesh, over None and over the client axes."""
    mesh = _mesh(mesh_key)
    kw = FL_VARIANTS[variant]
    ref_state = setup("ref", **kw)["state"]
    port_state = setup("port", **kw)["state"]
    for mp in (False, True):
        got = rules.flat_pspecs(mesh, port_state, multi_pod=mp)
        want = ref_rules.flat_pspecs(mesh, ref_state, multi_pod=mp)
        assert got.spec is port_state.spec
        assert_same_specs(got._replace(spec=None), want._replace(spec=None))
        axes = [ref_rules.seed_axes_for(mesh), None, ("pod", "data"),
                ref_rules.seed_axes_for(mesh, multi_pod=False)]
        assert rules.seed_axes_for(mesh) == axes[0]
        assert rules.seed_axes_for(mesh, multi_pod=False) == axes[3]
        for sa in axes:
            assert_same_specs(
                rules.seed_pspecs(got, seed_axes=sa)._replace(spec=None),
                ref_rules.seed_pspecs(want, seed_axes=sa)._replace(
                    spec=None))


@pytest.mark.parametrize("m", [2, 8])
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_sampler_and_cohort_specs_match_the_reference(mesh_key, m):
    """sampler_pspecs of the epoch sampler's carry (at m = 2 the [2] key
    is exempt from the client axes) and of the uniform sampler's empty
    one; cohort_pspecs at caps that do and do not divide the client
    extent."""
    mesh = _mesh(mesh_key)
    counts = np.full((m,), 3, np.int32)
    cap = 5
    ref_store = dict(arrays={}, idx=jnp.zeros((m, cap), jnp.int32),
                     counts=jnp.asarray(counts))
    port_store = dict(arrays={}, idx=torch.zeros((m, cap), dtype=torch.long),
                      counts=torch.from_numpy(counts).long())
    from repro_torch.core import prng
    from repro_torch.data import federated as fed

    for mode in ("epoch", "uniform"):
        ref_init = ref_fed.make_device_sampler(m, 2, 2, mode=mode)[0]
        port_init = fed.make_device_sampler(m, 2, 2, mode=mode)[0]
        ref_ss = ref_init(ref_store, jax.random.PRNGKey(0))
        port_ss = port_init(port_store, prng.PRNGKey(0, "cpu"))
        for mp in (False, True):
            got = rules.sampler_pspecs(mesh, port_ss, m, multi_pod=mp)
            want = ref_rules.sampler_pspecs(mesh, ref_ss, m, multi_pod=mp)
            assert_same_specs(got, want)
            if mode == "epoch":
                assert tuple(got["key"]) == (None,)
    for c_max in (1, 2, 4, 6, 12):
        for mp in (False, True):
            assert_same_specs(
                rules.cohort_pspecs(mesh, c_max, multi_pod=mp),
                ref_rules.cohort_pspecs(mesh, c_max, multi_pod=mp))


def test_sharding_rules_divisibility():
    """tests/test_dryrun.py's cases of the reference's ``_base_spec``: the
    rules emit only axes that divide the dim."""
    ax = {"data": 16, "model": 16}
    P = rules.P
    assert rules._base_spec("wq", (100, 96), ax) == P(None, "model")
    assert rules._base_spec("wq", (100, 97), ax) == P(None, None)
    assert rules._base_spec("wi_e", (8, 64, 512), ax) == P(None, None,
                                                          "model")
    assert rules._base_spec("wi_e", (64, 64, 512), ax) == P("model", None,
                                                           None)
    assert rules._base_spec("embed", (256000, 2304), ax) == P("model", None)
    assert rules._base_spec("embed", (50280, 768), ax) == P(None, "model")
    for shape in ((100, 96), (100, 97), (64, 64, 512), (50280, 768)):
        for name in ("wq", "wo", "wi_e", "wd_e", "embed", "unembed", "b_q",
                     "norm"):
            if len(shape) == 3 or name not in ("wi_e", "wd_e"):
                got = rules._base_spec(name, shape, ax)
                assert tuple(got) == tuple(
                    ref_rules._base_spec(name, shape, ax)), (name, shape)
    for shape in ((4096, 4096), (4096, 17), (10, 10), (2048, 16, 3)):
        spec = rules._base_spec("wq", shape, ax) if len(shape) == 2 \
            else rules.P(None, None, None)
        assert tuple(rules._fsdp_augment(spec, shape, ax)) == tuple(
            ref_rules._fsdp_augment(PartitionSpec(*spec), shape, ax))
    for n, k in ((16, 16), (17, 16), (0, 4), (8, 0)):
        assert rules._div(n, k) == ref_rules._div(n, k)


@pytest.fixture
def fake_group():
    """A fake process group of ``world`` ranks in this process, as
    ``rank``; destroyed after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(rank, world):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("rank", [0, 1, 17, 255, 256, 300, 511])
def test_placements_keep_the_reference_block_order(fake_group, rank):
    """On the (2, 16, 16) production mesh of a fake group of 512 ranks:
    ``placements(P(('pod', 'data'), None))`` gives the rank at (p, d, ·)
    rows [(p·16 + d)·m/32, (p·16 + d + 1)·m/32), as the reference's
    spec places them; 'model' replicates; a spec out of mesh order or
    naming an axis twice raises."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_production_mesh

    fake_group(rank, 512)
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    spec = rules.P(("pod", "data"), None)
    pl = rules.placements(spec, mesh)
    assert pl == [Shard(0), Shard(0), Replicate()]
    m = 64
    full = torch.arange(m * 3).reshape(m, 3)
    local = distribute_tensor(full, mesh, pl, src_data_rank=None).to_local()
    p, d, _ = mesh.get_coordinate()
    blk = p * 16 + d
    per = m // 32
    assert torch.equal(local, full[blk * per:(blk + 1) * per])
    assert rules.local_shape((m, 3), spec, mesh) == (per, 3)
    assert rules.placements(rules.P(None, "model"), mesh) == [
        Replicate(), Replicate(), Shard(1)]
    with pytest.raises(ValueError):
        rules.placements(rules.P(("data", "pod"), None), mesh)
    with pytest.raises(ValueError):
        rules.placements(rules.P("data", "data"), mesh)
    with pytest.raises(ValueError):
        rules.local_shape((63, 3), spec, mesh)
