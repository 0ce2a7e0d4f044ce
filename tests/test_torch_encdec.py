"""The port's encoder-decoder and modality-frontend serving path
(``models.model.encode``, the cross-attention sub-block,
``layers.attn_qkvo(kv_override=, causal=)``, ``forward_hidden`` /
``prefill`` / ``serve_step`` with ``embeds`` and ``enc_embeds``, the
seamless-m4t-large-v2 and internvl2-2b configs) against the JAX package
on the CPU.  Inputs are drawn with numpy from a seed; weights are made by
the reference's ``init_params`` and carried across by
``params_from_numpy``:

  * trees, shapes, dtypes and counts equal; ``reduced`` equal;
  * ``encode``, ``attn_qkvo(kv_override=)`` and the cross sub-block
    within 1e-5;
  * ``forward_hidden`` within 2e-4; ``prefill`` on the xla and flash
    backends (flash is K4's plain version here, the Pallas kernel in
    interpret mode on the reference's side): logits within 2e-4, every
    cache leaf (``enc_out`` included) within 1e-5;
  * prefill then decode against the full forward within 1e-3, on the
    reference's own ``encdec`` and ``vlm_frontend`` families
    (tests/test_decode_parity.py) and the two reduced configs;
  * the serve CLI on both reduced archs."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.config import reduced as jax_reduced  # noqa: E402
from repro_torch.checkpointing import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import BlockCfg, ModelConfig, reduced  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from test_decode_parity import FAMILIES  # noqa: E402
from test_torch_lm_serve import (_assert_trees_close, _jcfg,  # noqa: E402
                                 _leaves, _params)

ARCHS = ["seamless-m4t-large-v2", "internvl2-2b"]
#: the published parameter counts (seamless: 12 encoder and 12 decoder
#: layers, vocab 256 206 tied; internvl2: 24 layers, vocab 92 553 untied)
COUNTS = {"seamless-m4t-large-v2": 1_017_393_152,
          "internvl2-2b": 1_889_146_880}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_cfg(jcfg):
    """The port's ModelConfig with a reference config's fields."""
    fields = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    fields["pattern"] = tuple(BlockCfg(b.kind, b.window)
                              for b in jcfg.pattern)
    return ModelConfig(**fields)


def _extras(cfg, B, seed):
    """numpy ``embeds`` [B, F, d] and ``enc_embeds`` [B, enc_len, d] in
    float32 where the config takes them."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.enc_dec:
        out["enc_embeds"] = rng.standard_normal(
            (B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend != "none":
        out["embeds"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return out


def _both(extras):
    return ({k: jnp.asarray(v) for k, v in extras.items()},
            {k: _t(v) for k, v in extras.items()})


@pytest.fixture(scope="module", params=ARCHS)
def small(request):
    cfg = reduced(get_config(request.param))
    return (cfg,) + _params(cfg, seed=3)


@pytest.fixture(scope="module")
def seamless_small():
    cfg = reduced(get_config("seamless-m4t-large-v2"))
    return (cfg,) + _params(cfg, seed=5)


# ---------------------------------------------------------------------------
# configs, trees, counts, conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_matches_reference(arch):
    got, want = reduced(get_config(arch)), jax_reduced(jax_get_config(arch))
    for f in want.__dataclass_fields__:
        if f == "pattern":
            assert [(b.kind, b.window) for b in got.pattern] \
                == [(b.kind, b.window) for b in want.pattern]
        else:
            assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    cfg = get_config(arch)
    assert cfg.param_count() == jax_get_config(arch).param_count() \
        == COUNTS[arch]
    assert cfg.source == jax_get_config(arch).source
    small_cfg = reduced(cfg)
    tree = tm.init_params(torch.Generator().manual_seed(0), small_cfg)
    assert sum(v.numel() for _, v in _leaves(tree)) == \
        small_cfg.param_count()


def test_bf16_encdec_tree_converts_bit_for_bit():
    """The encoder's stacked blocks, its empty ``tail`` dict and the
    decoder's cross leaves arrive bit for bit and keep their dtypes."""
    cfg = jax_reduced(jax_get_config("seamless-m4t-large-v2")) \
        .replace(dtype="bfloat16")
    jp = jm.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jp, "cpu")
    assert tp["enc"]["tail"] == {} and set(tp["enc"]) == {"stack", "tail",
                                                          "ln_f"}
    assert tp["enc"]["stack"]["pos0"]["wq"].shape[0] == cfg.n_enc_layers
    assert {"ln_x", "wq_x", "wk_x", "wv_x", "wo_x"} <= \
        set(tp["stack"]["pos0"])
    want = dict(_leaves(jp))
    got = dict(_leaves(tp))
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        a, t = np.asarray(leaf), got[key]
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16), err_msg=key)
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), a, err_msg=key)


# ---------------------------------------------------------------------------
# the encoder, the cross-attention, attn_qkvo's new arguments
# ---------------------------------------------------------------------------

def _encode_cfg(which):
    base = reduced(get_config("seamless-m4t-large-v2"))
    return {"seamless": base,
            # grouped heads and a query chunk smaller than the frames
            "gqa_chunked": base.replace(n_kv_heads=base.n_heads // 2,
                                        attn_chunk=8, attn_softcap=30.0),
            "family": _port_cfg(FAMILIES["encdec"])}[which]


@pytest.mark.parametrize("which", ["seamless", "gqa_chunked", "family"])
def test_encode_matches(which):
    cfg = _encode_cfg(which)
    jp, tp = _params(cfg, seed=7)
    x = _extras(cfg, 2, seed=8)["enc_embeds"]
    want = jm.encode(jp, _jcfg(cfg), jnp.asarray(x))
    got = tm.encode(tp, cfg, _t(x))
    assert got.shape == (2, cfg.enc_len, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _kv_override_inputs(cfg, L, Le, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, L, cfg.d_model)).astype(np.float32)
    k = rng.standard_normal((2, Le, cfg.n_kv_heads, cfg.head_dim)) \
        .astype(np.float32)
    v = rng.standard_normal((2, Le, cfg.n_kv_heads, cfg.head_dim)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(L) + 3, (2, L)).astype(np.int32)
    kpos = np.broadcast_to(np.arange(Le), (2, Le)).astype(np.int32)
    return x, k, v, pos, kpos


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_attn_qkvo_kv_override_matches(seamless_small, backend,
                                       monkeypatch):
    """q projected and roped, k and v as given, the plain bidirectional
    attention q-chunked: on the flash backend too (the override never
    reaches the kernel), at a query length the kernel would take."""
    cfg, jp, tp = seamless_small
    cfg = cfg.replace(attn_backend=backend, attn_chunk=32)

    def boom(*a, **k):
        raise AssertionError("the cross-attention reached flash_mha")

    monkeypatch.setattr(tl, "flash_mha", boom)
    x, k, v, pos, kpos = _kv_override_inputs(cfg, 128, 16, seed=9)
    bp_j = jax.tree.map(lambda a: a[0], jp["stack"]["pos0"])
    bp_t = {n: a[0] for n, a in tp["stack"]["pos0"].items()}
    want, cache = jl.attn_qkvo(
        jnp.asarray(x), bp_j, _jcfg(cfg), jnp.asarray(pos),
        kv_override=(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos)))
    assert cache is None
    got = tl.attn_qkvo(_t(x), bp_t, cfg, _t(pos),
                       kv_override=(_t(k), _t(v), _t(kpos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_attn_qkvo_bidirectional_prefill_matches(seamless_small, backend):
    """``causal=False`` on the prefill path, both branches (the flash
    branch takes ``flash_mha(causal=False)``): output and cache within
    1e-5."""
    cfg, jp, tp = seamless_small
    cfg = cfg.replace(attn_backend=backend)
    x, _, _, pos, _ = _kv_override_inputs(cfg, 128, 1, seed=10)
    bp_j = jax.tree.map(lambda a: a[0], jp["stack"]["pos0"])
    bp_t = {n: a[0] for n, a in tp["stack"]["pos0"].items()}
    jcache = jm.init_block_cache(BlockCfg("attn"), _jcfg(cfg), 2, 130,
                                 jnp.float32)
    tcache = tm.init_block_cache(BlockCfg("attn"), cfg, 2, 130,
                                 torch.float32, "cpu")
    want, jnew = jl.attn_qkvo(jnp.asarray(x), bp_j, _jcfg(cfg),
                              jnp.asarray(pos), prefill_cache=jcache,
                              causal=False)
    got = tl.attn_qkvo(_t(x), bp_t, cfg, _t(pos), prefill_cache=tcache,
                       causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    _assert_trees_close(tcache, jnew, 1e-5)


def test_cross_sub_block_matches(seamless_small):
    """``_cross_attn`` alone and a whole decoder block with the encoder's
    output (self-attention, ``ln_x`` + cross-attention, MLP) within
    1e-5."""
    cfg, jp, tp = seamless_small
    rng = np.random.default_rng(11)
    h = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.enc_len, cfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    kpos = np.broadcast_to(np.arange(cfg.enc_len), (2, cfg.enc_len)) \
        .astype(np.int32)
    bp_j = jax.tree.map(lambda a: a[1], jp["stack"]["pos0"])
    bp_t = {n: a[1] for n, a in tp["stack"]["pos0"].items()}
    jkv = ("enc_out", jnp.asarray(enc), jnp.asarray(kpos))
    tkv = (_t(enc), _t(kpos))
    xp_j = {n: bp_j[f"{n}_x"] for n in ("wq", "wk", "wv", "wo")}
    xp_t = {n: bp_t[f"{n}_x"] for n in ("wq", "wk", "wv", "wo")}
    want, _ = jm._cross_attn(jnp.asarray(h), xp_j, _jcfg(cfg),
                             jnp.asarray(pos), jkv)
    got = tm._cross_attn(_t(h), xp_t, cfg, _t(pos), tkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want, _, _ = jm.apply_block(BlockCfg("attn"), bp_j, jnp.asarray(h),
                                _jcfg(cfg), jnp.asarray(pos), enc_kv=jkv)
    got, aux = tm.apply_block(BlockCfg("attn"), bp_t, _t(h), cfg, _t(pos),
                              enc_kv=tkv)
    assert aux is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_forward_hidden_matches(small):
    cfg, jp, tp = small
    toks = np.random.default_rng(12).integers(0, cfg.vocab, (2, 24))
    jx, tx = _both(_extras(cfg, 2, seed=13))
    jh, jaux = jm.forward_hidden(jp, _jcfg(cfg), jnp.asarray(toks, jnp.int32),
                                 **jx)
    th, taux = tm.forward_hidden(tp, cfg, _t(toks), **tx)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-4,
                               atol=2e-4)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_prefill_matches_reference(small, backend):
    base, jp, tp = small
    cfg = base.replace(attn_backend=backend)
    B, L = 2, 128  # L % 128 == 0: the flash backend takes the kernel path
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, L))
    jx, tx = _both(_extras(cfg, B, seed=14))
    jcfg = _jcfg(cfg)
    want, jcache = jm.prefill(jp, jcfg, jm.init_cache(jcfg, B, L + 4),
                              jnp.asarray(toks, jnp.int32), **jx)
    tcache = tm.init_cache(cfg, B, L + 4, device="cpu")
    got, tcache2 = tm.prefill(tp, cfg, tcache, _t(toks), **tx)
    assert tcache2 is tcache  # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    assert ("enc_out" in tcache) == cfg.enc_dec
    _assert_trees_close(tcache, jcache, 1e-5)


def _decode_parity(cfg, tp, extras, B=2, L=16):
    """Prefill of L/2 tokens then decode to L against the full forward;
    returns the largest logit difference."""
    toks = _t(np.random.default_rng(6).integers(0, cfg.vocab, (B, L)))
    h, _ = tm.forward_hidden(tp, cfg, toks, **extras)
    full = tm.lm_logits(h, tp, cfg)
    cache = tm.init_cache(cfg, B, L, dtype=torch.float32, device="cpu")
    Lp = L // 2
    lg, cache = tm.prefill(tp, cfg, cache, toks[:, :Lp], **extras)
    errs = [(lg - full[:, Lp - 1]).abs().max().item()]
    for i in range(Lp, L):
        lg, cache = tm.serve_step(tp, cfg, cache, toks[:, i:i + 1],
                                  torch.full((B,), i))
        errs.append((lg - full[:, i]).abs().max().item())
    return max(errs)


@pytest.mark.parametrize("family", ["encdec", "vlm_frontend"] + ARCHS)
def test_prefill_then_decode_matches_full_forward(family):
    """tests/test_decode_parity.py's ``encdec`` and ``vlm_frontend``
    families in the port, and the reduced configs; the port's full
    forward held against the reference's too."""
    cfg = _port_cfg(FAMILIES[family]) if family in FAMILIES \
        else reduced(get_config(family))
    jp, tp = _params(cfg, seed=1)
    jx, tx = _both(_extras(cfg, 2, seed=15))
    assert _decode_parity(cfg, tp, tx) < 1e-3
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 16))
    jh, _ = jm.forward_hidden(jp, _jcfg(cfg), jnp.asarray(toks, jnp.int32),
                              **jx)
    th, _ = tm.forward_hidden(tp, cfg, _t(toks), **tx)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-4,
                               atol=2e-4)


def test_prefill_writes_enc_out_in_place(seamless_small):
    """``enc_out`` is written into the cache's own tensor, cast to its
    dtype; an encoder input of another length is refused."""
    cfg, _, tp = seamless_small
    toks = _t(np.random.default_rng(2).integers(0, cfg.vocab, (2, 8)))
    x = _t(_extras(cfg, 2, seed=16)["enc_embeds"])
    cache = tm.init_cache(cfg, 2, 12, dtype=torch.bfloat16, device="cpu")
    buf = cache["enc_out"]
    assert buf.shape == (2, cfg.enc_len, cfg.d_model) and not buf.any()
    tm.prefill(tp, cfg, cache, toks, enc_embeds=x)
    assert cache["enc_out"] is buf and buf.dtype == torch.bfloat16
    torch.testing.assert_close(buf, tm.encode(tp, cfg, x).to(torch.bfloat16))
    with pytest.raises(ValueError, match="encoder output"):
        tm.prefill(tp, cfg, tm.init_cache(cfg, 2, 12, device="cpu"), toks,
                   enc_embeds=x[:, :-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    """The serve CLI through its existing flags on the reduced configs
    (an enc-dec server decodes against the cache's zero encoder output,
    as the reference's does): every request finishes."""
    stats = serve.main(["--arch", arch, "--device", "cpu", "--requests",
                        "3", "--slots", "2", "--max-new", "4"])
    assert stats["decode_steps"] > 0
    out = capsys.readouterr().out
    assert all(f"req{i}:" in out for i in range(3))
