"""The port's Mamba2 / SSD blocks (``repro_torch.models.ssm``) and the
Mamba2 and shared-attention paths of ``repro_torch.models.model``
against the JAX package on the CPU, inputs drawn with numpy and weights
made by the reference's ``init_params``, carried across by
``params_from_numpy``:

  * every ``ssm.py`` function: 1e-5 for the elementwise and conv
    functions, 2e-4 for ``ssd_chunked`` and the recurrence
    (tests/test_ssm.py's bound);
  * ``mamba_block`` in train, prefill (with its cache) and decode modes,
    and reduced zamba2-7b and mamba2-130m prefills (logits and caches):
    2e-4 in float32;
  * prefill-then-decode against the full forward for the mamba and
    hybrid_shared families of tests/test_decode_parity.py: 1e-3.

In prefill the port's mamba_block runs the SSD scan through
``kernels/ssd_chunk/ops.ssd_chunked`` (the port of the reference's
drop-in ``ssd_chunked_pallas``), the reference's through its jnp
``ssd_chunked``: in float32 they differ only in summation order.  In
training (``mode="train"``) both run the plain scan."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import model as jm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.config import BlockCfg as JBlockCfg  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch.checkpointing import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import BlockCfg, ModelConfig, reduced  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import ssm  # noqa: E402


def _jcfg(cfg):
    fields = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    fields["pattern"] = tuple(JBlockCfg(b.kind, b.window)
                              for b in cfg.pattern)
    return JModelConfig(**fields)


def _params(cfg, seed=0):
    jp = jm.init_params(jax.random.PRNGKey(seed), _jcfg(cfg))
    return jp, params_from_numpy(jp, "cpu")


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


def _assert_trees_close(port_tree, jax_tree, tol):
    a, b = dict(_leaves(port_tree)), dict(_leaves(jax_tree))
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_allclose(a[key].float().numpy(),
                                   np.asarray(b[key], np.float32),
                                   rtol=tol, atol=tol, err_msg=key)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# tests/test_decode_parity.py's two Mamba families
FAMILIES = {
    "mamba": ModelConfig(
        "s", 4, 64, 0, 0, 0, 0, 97, pattern=(BlockCfg("mamba"),),
        ssm_state=16, ssm_heads=4, ssm_head_dim=16, ssm_chunk=8,
        dtype="float32", remat=False),
    "hybrid_shared": ModelConfig(
        "h", 6, 64, 4, 4, 16, 128, 97,
        pattern=(BlockCfg("mamba"), BlockCfg("mamba"),
                 BlockCfg("shared_attn")),
        ssm_state=16, ssm_heads=4, ssm_head_dim=16, ssm_chunk=8,
        dtype="float32", remat=False),
}
SSM_CFG = FAMILIES["mamba"]


# ---------------------------------------------------------------------------
# functions of ssm.py, 1e-5
# ---------------------------------------------------------------------------

def _fn_cases():
    rng = np.random.default_rng(11)
    B, L, C, W = 2, 10, 6, 4
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    w = rng.normal(size=(C, W)).astype(np.float32)
    bias = rng.normal(size=(C,)).astype(np.float32)
    cache = rng.normal(size=(B, W - 1, C)).astype(np.float32)
    seg_in = (-np.abs(rng.normal(size=(2, 3, 12))) * 0.4).astype(np.float32)
    sp_in = np.concatenate([np.linspace(-40, 40, 81),
                            rng.normal(size=50) * 6]).astype(np.float32)
    cfg = SSM_CFG
    proj = rng.normal(size=(B, L, 2 * cfg.ssm_inner + 2 * cfg.ssm_state
                            + cfg.ssm_heads)).astype(np.float32)
    groups = rng.normal(size=(B, L, 1, 16)).astype(np.float32)
    st = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    xt = rng.normal(size=(2, 3, 4)).astype(np.float32)
    da = -np.abs(rng.normal(size=(2, 3))).astype(np.float32)
    bt = rng.normal(size=(2, 3, 5)).astype(np.float32)
    ct = rng.normal(size=(2, 3, 5)).astype(np.float32)
    return {
        "segsum": lambda m, a: m.segsum(a(seg_in)),
        "conv1d_causal": lambda m, a: m.conv1d_causal(a(x), a(w), a(bias)),
        "conv1d_step": lambda m, a: m.conv1d_step(a(cache), a(x[:, 0]),
                                                  a(w), a(bias)),
        "softplus": lambda m, a: (m.softplus(a(sp_in)) if m is ssm
                                  else jax.nn.softplus(a(sp_in))),
        "split_proj": lambda m, a: m._split_proj(a(proj), cfg),
        "expand_groups": lambda m, a: m._expand_groups(a(groups), cfg),
        "ssd_decode_step": lambda m, a: m.ssd_decode_step(
            a(st), a(xt), a(da), a(bt), a(ct)),
    }


@pytest.mark.parametrize("name", list(_fn_cases()))
def test_ssm_functions_match(name):
    fn = _fn_cases()[name]
    got = fn(ssm, _t)
    want = fn(jssm, jnp.asarray)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape
        finite = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), finite)
        np.testing.assert_array_equal(g[~finite], w[~finite])
        tol = 1e-6 if name == "softplus" else 1e-5
        np.testing.assert_allclose(g[finite], w[finite], rtol=tol, atol=tol)


def test_conv_step_matches_causal():
    """tests/test_ssm.py::test_conv_step_matches_causal in the port."""
    rng = np.random.default_rng(1)
    B, L, C, W = 2, 10, 6, 4
    x, w, bias = (_t(rng.normal(size=s).astype(np.float32))
                  for s in ((B, L, C), (C, W), (C,)))
    full = ssm.conv1d_causal(x, w, bias)
    cache = torch.zeros(B, W - 1, C)
    for t in range(L):
        y, cache = ssm.conv1d_step(cache, x[:, t], w, bias)
        torch.testing.assert_close(y, full[:, t], rtol=1e-5, atol=1e-5)


def test_init_mamba_cache_matches():
    cfg = SSM_CFG
    got = ssm.init_mamba_cache(cfg, 3, torch.bfloat16, "cpu")
    want = jssm.init_mamba_cache(_jcfg(cfg), 3, jnp.bfloat16)
    for key in ("conv", "state"):
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == torch.bfloat16
        assert not got[key].any()


# ---------------------------------------------------------------------------
# the SSD scan, 2e-4 (tests/test_ssm.py)
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b, l, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = np.abs(rng.normal(size=(b, l, h)).astype(np.float32) * 0.5) + 0.01
    A = -np.abs(rng.normal(size=(h,)).astype(np.float32)) - 0.1
    B_ = rng.normal(size=(b, l, h, n)).astype(np.float32)
    C_ = rng.normal(size=(b, l, h, n)).astype(np.float32)
    return x * dt[..., None], dt * A, B_, C_


@pytest.mark.parametrize("b,l,h,p,n,chunk", [
    (1, 8, 1, 4, 4, 4), (2, 16, 3, 8, 5, 4), (1, 32, 2, 4, 8, 8),
    (2, 24, 4, 16, 16, 12), (1, 64, 2, 8, 4, 16),
])
def test_ssd_chunked_and_recurrence_match(b, l, h, p, n, chunk):
    """The plain port of the jnp ``ssd_chunked``, the recurrence oracle and
    the kernel module's scan, each against the reference's jnp function
    and its recurrence."""
    args = _ssd_inputs(b * 100 + l, b, l, h, p, n)
    targs = [_t(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    yj, fj = jssm.ssd_chunked(*jargs, chunk)
    yr, fr = jssm.ssd_recurrence_ref(*jargs)
    for got in (ssm.ssd_chunked(*targs, chunk),
                ssm.ssd_recurrence_ref(*targs),
                ssm.ssd_ops.ssd_chunked(*targs, chunk)):
        for g, w in zip(got, (yj, fj)):
            np.testing.assert_allclose(_np(g), _np(w), rtol=2e-4, atol=2e-4)
        for g, w in zip(got, (yr, fr)):
            np.testing.assert_allclose(_np(g), _np(w), rtol=2e-4, atol=2e-4)


def test_ssd_decode_continues_prefill():
    """tests/test_ssm.py::test_ssd_decode_continues_prefill in the port."""
    b, l, h, p, n = 2, 12, 2, 4, 4
    xdt, dA, B_, C_ = (_t(a) for a in _ssd_inputs(0, b, l + 1, h, p, n))
    full, _ = ssm.ssd_recurrence_ref(xdt, dA, B_, C_)
    _, state = ssm.ssd_ops.ssd_chunked(xdt[:, :l], dA[:, :l], B_[:, :l],
                                       C_[:, :l], 4)
    y_dec, _ = ssm.ssd_decode_step(state, xdt[:, l], dA[:, l], B_[:, l],
                                   C_[:, l])
    torch.testing.assert_close(y_dec, full[:, l], rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# mamba_block and the models, 2e-4
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_params():
    cfg = SSM_CFG
    jp, tp = _params(cfg, seed=3)
    bp_j = jax.tree.map(lambda a: a[0], jp["stack"]["pos0"])
    bp_t = {k: v[0] for k, v in tp["stack"]["pos0"].items()}
    return cfg, bp_j, bp_t


@pytest.mark.parametrize("mode,L", [("train", 16), ("prefill", 16),
                                    ("prefill", 2), ("odd_length", 13),
                                    ("decode", 1)])
def test_mamba_block_matches_reference(mamba_params, mode, L):
    """Every branch of mamba_block: the chunked scan (chunk 8), a prompt
    shorter than the conv window (the cache tail padded), a length the
    chunk does not divide (chunk 1), and one decode step from a nonzero
    cache."""
    cfg, bp_j, bp_t = mamba_params
    rng = np.random.default_rng(L)
    x = rng.normal(size=(2, L, cfg.d_model)).astype(np.float32)
    jc = _jcfg(cfg)
    if mode == "decode":
        cache = {"conv": rng.normal(size=(2, cfg.ssm_conv - 1,
                                          cfg.ssm_conv_dim)),
                 "state": rng.normal(size=(2, cfg.ssm_heads,
                                           cfg.ssm_head_dim,
                                           cfg.ssm_state)) * 0.3}
        cache = {k: v.astype(np.float32) for k, v in cache.items()}
        want, wcache = jssm.mamba_block(
            jnp.asarray(x), bp_j, jc,
            decode_cache={k: jnp.asarray(v) for k, v in cache.items()})
        tcache = {k: _t(v) for k, v in cache.items()}
        got = ssm.mamba_block(_t(x), bp_t, cfg, decode_cache=tcache)
    else:
        want, wcache = jssm.mamba_block(jnp.asarray(x), bp_j, jc,
                                        return_cache=mode != "train")
        tcache = ssm.init_mamba_cache(cfg, 2, torch.float32, "cpu")
        got = ssm.mamba_block(_t(x), bp_t, cfg,
                              prefill_cache=None if mode == "train"
                              else tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    if wcache is not None:
        _assert_trees_close(tcache, wcache, 2e-4)


def test_mamba_block_hands_the_kernel_unit_last_strides(mamba_params,
                                                        monkeypatch):
    """The operands mamba_block passes to the SSD scan in prefill (the
    route that reaches the kernel) have the unit last stride the CUDA
    kernel requires (x dt, B and C; B and C may be stride-0 expansions
    over the heads)."""
    import types

    cfg, _, bp_t = mamba_params
    seen = []
    scan = ssm.ssd_ops.ssd_chunked

    def spy(xdt, dA, B_, C_, chunk, initial_state=None):
        seen.append([t.stride(-1) for t in (xdt, B_, C_)])
        return scan(xdt, dA, B_, C_, chunk)

    monkeypatch.setattr(ssm, "ssd_ops", types.SimpleNamespace(
        ssd_chunked=spy))
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    for dtype in (torch.float32, torch.bfloat16):
        bp = {k: (v.to(dtype) if k in ("in_proj", "out_proj") else v)
              for k, v in bp_t.items()}
        ssm.mamba_block(x.to(dtype), bp, cfg, mode="prefill")
    assert seen == [[1, 1, 1], [1, 1, 1]]


@pytest.mark.parametrize("arch", ["zamba2-7b", "zamba2-7b-tail",
                                  "mamba2-130m"])
def test_prefill_matches_reference(arch):
    """Reduced zamba2-7b (two units of five Mamba2 blocks and the shared
    attention block, flash backend at L = 128; with 9 layers, one unit and
    a tail of three Mamba2 blocks, as the full model's 81 layers end) and
    mamba2-130m: logits and every cache leaf (k, v, pos; conv, state)
    within 2e-4."""
    cfg = reduced(get_config(arch.replace("-tail", "")),
                  **({"n_layers": 9} if arch.endswith("-tail") else {}))
    cfg = cfg.replace(attn_backend="flash")
    jp, tp = _params(cfg, seed=1)
    B, L = 2, 128
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, L))
    jc = _jcfg(cfg)
    want, jcache = jm.prefill(jp, jc, jm.init_cache(jc, B, L + 4),
                              jnp.asarray(toks, jnp.int32))
    tcache = tm.init_cache(cfg, B, L + 4, device="cpu")
    got, tcache2 = tm.prefill(tp, cfg, tcache, _t(toks))
    assert tcache2 is tcache
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    _assert_trees_close(tcache, jcache, 2e-4)


def test_forward_hidden_matches_reference():
    cfg = reduced(get_config("zamba2-7b"))
    jp, tp = _params(cfg, seed=4)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 24))
    jh, _ = jm.forward_hidden(jp, _jcfg(cfg), jnp.asarray(toks, jnp.int32))
    th, _ = tm.forward_hidden(tp, cfg, _t(toks))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_then_decode_matches_full_forward(family):
    """tests/test_decode_parity.py's mamba and hybrid_shared families in
    the port: prefill of 8 tokens then 8 decode steps against the full
    forward over 16, within 1e-3."""
    cfg = FAMILIES[family]
    _, tp = _params(cfg, seed=1)
    B, L = 2, 16
    tt = _t(np.random.default_rng(6).integers(0, cfg.vocab, (B, L)))
    h, _ = tm.forward_hidden(tp, cfg, tt)
    full = tm.lm_logits(h, tp, cfg)
    cache = tm.init_cache(cfg, B, L, dtype=torch.float32, device="cpu")
    Lp = L // 2
    lg, cache = tm.prefill(tp, cfg, cache, tt[:, :Lp])
    errs = [(lg - full[:, Lp - 1]).abs().max().item()]
    for i in range(Lp, L):
        lg, cache = tm.serve_step(tp, cfg, cache, tt[:, i:i + 1],
                                  torch.full((B,), i))
        errs.append((lg - full[:, i]).abs().max().item())
    assert max(errs) < 1e-3, errs


def test_shared_block_reads_one_weight_set():
    """zamba's shared_attn positions hold no weights; every invocation
    reads params['shared'] and keeps its own cache."""
    cfg = reduced(get_config("zamba2-7b"))
    tp = tm.init_params(torch.Generator().manual_seed(0), cfg)
    j = [b.kind for b in cfg.pattern].index("shared_attn")
    assert tp["stack"][f"pos{j}"] == {}
    assert set(tp["shared"]) >= {"wq", "wk", "wv", "wo", "wi", "wd"}
    cache = tm.init_cache(cfg, 1, 8, device="cpu")
    assert cache["stack"][f"pos{j}"]["k"].shape[0] == cfg.n_units
    toks = torch.randint(0, cfg.vocab, (1, 8),
                         generator=torch.Generator().manual_seed(1))
    tm.prefill(tp, cfg, cache, toks)
    k = cache["stack"][f"pos{j}"]["k"]
    assert not torch.equal(k[0], k[1])  # two invocations, two caches
