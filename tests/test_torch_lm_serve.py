"""The port's LM serving path (``repro_torch.models``, ``launch.serve``)
against the JAX package on the CPU, with weights made by the reference's
``init_params`` and carried across by ``params_from_numpy``:

  * layer functions within 1e-5;
  * ``prefill`` logits and caches, xla and flash backends, within 2e-4
    (tests/test_flash_backend.py's bound) at reduced gemma2-2b;
  * prefill-then-decode against the full forward within 1e-3
    (tests/test_decode_parity.py's dense_windowed family), the rolling
    cache's wraparound, and slot isolation (tests/test_launchers.py);
  * the bf16 checkpoint conversion bit for bit, the parameter tree and
    count (the MoE, Mamba2, encoder-decoder and frontend models too), the
    serve CLI on the CPU (the reduced Mamba2 models too; the MoE models'
    in tests/test_torch_moe.py, the enc-dec and frontend models' in
    tests/test_torch_encdec.py);
  * the sampled ``Server.run`` against the reference ``Server`` on the
    same weights: the same tokens.

Logits are compared, never greedy tokens: near ties flip."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.config import BlockCfg as JBlockCfg  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.config import reduced as jax_reduced  # noqa: E402
from repro_torch.checkpointing import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import BlockCfg, ModelConfig, reduced  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402

DENSE_ARCHS = ["gemma2-2b", "internlm2-20b", "llama3-8b", "tiny"]


def _jcfg(cfg):
    """The reference's ModelConfig with the port config's fields."""
    fields = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    fields["pattern"] = tuple(JBlockCfg(b.kind, b.window)
                              for b in cfg.pattern)
    return JModelConfig(**fields)


def _params(cfg, seed=0):
    """(jax params, port params): the reference's init carried across."""
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


@pytest.fixture(scope="module")
def gemma_small():
    cfg = reduced(get_config("gemma2-2b"))
    return (cfg,) + _params(cfg)


# ---------------------------------------------------------------------------
# layer functions
# ---------------------------------------------------------------------------

def _layer_cases():
    rng = np.random.default_rng(3)
    B, L, H, K, D = 2, 24, 4, 2, 16
    x = rng.normal(size=(B, L, 32)).astype(np.float32)
    gamma = (0.1 * rng.normal(size=(32,))).astype(np.float32)
    q = rng.normal(size=(B, L, H, D)).astype(np.float32)
    k = rng.normal(size=(B, L, K, D)).astype(np.float32)
    v = rng.normal(size=(B, L, K, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(L), (B, L)).astype(np.int32) + 5
    wi = (rng.normal(size=(32, 2 * 48)) / 6).astype(np.float32)
    wd = (rng.normal(size=(48, 32)) / 7).astype(np.float32)
    cache_pos = np.where(rng.random((B, L)) < 0.8, np.arange(L), -1)
    cache_pos = cache_pos.astype(np.int32)
    qpos = np.full((B, 1), L - 3, np.int32)
    return {
        "rms_norm": lambda m, a: m.rms_norm(a(x), a(gamma)),
        "softcap": lambda m, a: m.softcap(a(x) * 40, 30.0),
        "swiglu": lambda m, a: m.swiglu(a(x), a(wi), a(wd)),
        "apply_rope": lambda m, a: m.apply_rope(a(q), a(pos), 10000.0),
        "attention": lambda m, a: m.attention(
            a(q), a(k), a(v), a(pos), a(pos), window=7, attn_softcap=50.0),
        "attention_q_chunk": lambda m, a: m.attention(
            a(q), a(k), a(v), a(pos), a(pos), q_chunk=8),
        "attention_bidirectional": lambda m, a: m.attention(
            a(q), a(k), a(v), a(pos), a(pos), causal=False),
        "attention_decode": lambda m, a: m.attention_decode(
            a(q[:, :1]), a(k), a(v), a(qpos), a(cache_pos), window=9,
            attn_softcap=50.0),
        "causal_window_mask": lambda m, a: m.causal_window_mask(
            a(pos), a(pos), window=4),
    }


@pytest.mark.parametrize("name", list(_layer_cases()))
def test_layer_functions_match(name):
    fn = _layer_cases()[name]
    got = fn(tl, lambda a: torch.from_numpy(np.ascontiguousarray(a)))
    want = np.asarray(fn(jl, jnp.asarray))
    if got.dtype == torch.bool:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_attn_qkvo_matches(gemma_small):
    cfg, jp, tp = gemma_small
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16)).astype(np.int32)
    bp_j = jax.tree.map(lambda a: a[0], jp["stack"]["pos0"])
    bp_t = {k: v[0] for k, v in tp["stack"]["pos0"].items()}
    want, _ = jl.attn_qkvo(jnp.asarray(x), bp_j, _jcfg(cfg), jnp.asarray(pos),
                           window=8)
    got = tl.attn_qkvo(torch.from_numpy(x), bp_t, cfg, torch.from_numpy(pos),
                       window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# prefill, both backends
# ---------------------------------------------------------------------------

def _tail_cfg():
    """One unit of gemma's (local, global) pattern plus a one-block tail."""
    return reduced(get_config("gemma2-2b"), n_layers=3)


@pytest.mark.parametrize("backend", ["xla", "flash"])
@pytest.mark.parametrize("which", ["gemma2-2b", "tail"])
def test_prefill_matches_reference(gemma_small, backend, which):
    if which == "tail":
        base = _tail_cfg()
        jp, tp = _params(base, seed=2)
    else:
        base, jp, tp = gemma_small
    cfg = base.replace(attn_backend=backend)
    B, L = 2, 128  # L % 128 == 0: the flash backend takes the kernel path
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, L))
    jcfg = _jcfg(cfg)
    want, jcache = jm.prefill(jp, jcfg, jm.init_cache(jcfg, B, L + 4),
                              jnp.asarray(toks, jnp.int32))
    tcache = tm.init_cache(cfg, B, L + 4, device="cpu")
    got, tcache2 = tm.prefill(tp, cfg, tcache, torch.from_numpy(toks))
    assert tcache2 is tcache  # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    _assert_trees_close(tcache, jcache, 2e-4)


def test_flash_backend_matches_xla_backend(gemma_small):
    """tests/test_flash_backend.py inside the port."""
    base, _, tp = gemma_small
    B, L = 2, 128
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, base.vocab, (B, L)))
    outs = {}
    for backend in ("xla", "flash"):
        cfg = base.replace(attn_backend=backend)
        outs[backend] = tm.prefill(tp, cfg,
                                   tm.init_cache(cfg, B, L, device="cpu"),
                                   toks)
    torch.testing.assert_close(outs["flash"][0], outs["xla"][0], rtol=2e-4,
                               atol=2e-4)
    for (ka, a), (kb, b) in zip(_leaves(outs["flash"][1]),
                                _leaves(outs["xla"][1])):
        assert ka == kb
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


def test_odd_length_takes_the_xla_branch(monkeypatch):
    """L % 128 != 0 under attn_backend="flash" runs the q-chunked jnp path
    of the reference (its semantics, not a fallback): flash_mha is never
    called."""
    cfg = ModelConfig("fb2", 2, 64, 4, 2, 16, 128, 97,
                      pattern=(BlockCfg("attn"),), dtype="float32",
                      remat=False, attn_backend="flash")
    _, tp = _params(cfg, seed=1)

    def boom(*a, **k):
        raise AssertionError("flash_mha called for L % 128 != 0")

    monkeypatch.setattr(tl, "flash_mha", boom)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 97, (1, 20)))
    logits, _ = tm.prefill(tp, cfg, tm.init_cache(cfg, 1, 20, device="cpu"),
                           toks)
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

DENSE_WINDOWED = ModelConfig(
    "d", 4, 64, 4, 2, 16, 128, 97,
    pattern=(BlockCfg("attn", window=6), BlockCfg("attn")),
    dtype="float32", remat=False, logit_softcap=30.0, attn_softcap=50.0)


def test_prefill_then_decode_matches_full_forward():
    """tests/test_decode_parity.py, dense_windowed family, in the port; the
    port's full forward is also held against the reference's."""
    cfg = DENSE_WINDOWED
    jp, tp = _params(cfg, seed=1)
    B, L = 2, 16
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (B, L))
    tt = torch.from_numpy(toks)
    h, _ = tm.forward_hidden(tp, cfg, tt)
    full = tm.lm_logits(h, tp, cfg)
    jh, _ = jm.forward_hidden(jp, _jcfg(cfg), jnp.asarray(toks, jnp.int32))
    np.testing.assert_allclose(full.numpy(),
                               np.asarray(jm.lm_logits(jh, jp, _jcfg(cfg))),
                               rtol=1e-4, atol=1e-4)
    cache = tm.init_cache(cfg, B, L, device="cpu")
    Lp = L // 2
    lg, cache = tm.prefill(tp, cfg, cache, tt[:, :Lp])
    errs = [(lg - full[:, Lp - 1]).abs().max().item()]
    for i in range(Lp, L):
        lg, cache = tm.serve_step(tp, cfg, cache, tt[:, i:i + 1],
                                  torch.full((B,), i))
        errs.append((lg - full[:, i]).abs().max().item())
    assert max(errs) < 1e-3, errs


def test_rolling_cache_window_decode():
    """Decode far beyond the window allocation (alloc == window == 4)."""
    cfg = ModelConfig("w", 2, 64, 4, 2, 16, 128, 97,
                      pattern=(BlockCfg("attn", window=4),),
                      dtype="float32", remat=False)
    _, tp = _params(cfg, seed=5)
    B, L = 1, 24
    tt = torch.from_numpy(np.random.default_rng(7).integers(0, 97, (B, L)))
    h, _ = tm.forward_hidden(tp, cfg, tt)
    full = tm.lm_logits(h, tp, cfg)
    cache = tm.init_cache(cfg, B, L, device="cpu")
    assert cache["stack"]["pos0"]["k"].shape[2] == 4
    for i in range(L):
        lg, cache = tm.serve_step(tp, cfg, cache, tt[:, i:i + 1],
                                  torch.full((B,), i))
        err = (lg - full[:, i]).abs().max().item()
        assert err < 1e-3, (i, err)


def test_batched_decode_isolated_vs_solo(gemma_small):
    """tests/test_launchers.py::test_batched_decode_isolated_vs_solo."""
    cfg, _, tp = gemma_small
    S = 24
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)))
    cache = tm.init_cache(cfg, 2, S, dtype=torch.float32, device="cpu")
    lg_b, cache = tm.prefill(tp, cfg, cache, toks)
    nxt = torch.argmax(lg_b, -1)[:, None]
    lg_b2, _ = tm.serve_step(tp, cfg, cache, nxt, torch.full((2,), 8))
    for i in range(2):
        c1 = tm.init_cache(cfg, 1, S, dtype=torch.float32, device="cpu")
        lg_s, c1 = tm.prefill(tp, cfg, c1, toks[i:i + 1])
        torch.testing.assert_close(lg_s[0], lg_b[i], rtol=1e-4, atol=1e-4)
        lg_s2, _ = tm.serve_step(tp, cfg, c1, nxt[i:i + 1],
                                 torch.full((1,), 8))
        torch.testing.assert_close(lg_s2[0], lg_b2[i], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# parameters, conversion, registry, CLI
# ---------------------------------------------------------------------------

def test_bf16_tree_converts_bit_for_bit():
    cfg = jax_reduced(jax_get_config("gemma2-2b")).replace(dtype="bfloat16")
    jp = jm.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jp, "cpu")
    jl_ = dict(_leaves(jp))
    tl_ = dict(_leaves(tp))
    assert sorted(jl_) == sorted(tl_)
    assert tl_["embed"].dtype == torch.bfloat16
    for key, leaf in jl_.items():
        a = np.asarray(leaf)
        t = tl_[key]
        assert tuple(t.shape) == a.shape, key
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16), err_msg=key)
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), a, err_msg=key)


@pytest.mark.parametrize("arch,mode", [(a, "full") for a in DENSE_ARCHS + [
    "zamba2-7b", "mamba2-130m", "olmoe-1b-7b", "moonshot-v1-16b-a3b",
    "mixtral-8x22b", "seamless-m4t-large-v2", "internvl2-2b"]]
    + [("gemma3-27b", "lora"), ("mixtral-8x22b", "lora")])
def test_param_tree_and_count_match(arch, mode):
    """Trees and counts in ``fl_mode`` ``mode``: every config in "full"
    (mixtral-8x22b's replaced), and gemma3-27b and mixtral-8x22b in their
    own "lora" (the adapters under ``lora`` beside the base)."""
    cfg = reduced(get_config(arch)).replace(fl_mode=mode)
    gen = torch.Generator().manual_seed(0)
    tp = tm.init_params(gen, cfg)
    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0),
                                                   _jcfg(cfg)))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(shapes)}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _leaves(tp)}
    assert got == want
    assert ("lora" in tp) == (mode == "lora")
    full = get_config(arch).replace(fl_mode=mode)
    assert full.param_count() == \
        jax_get_config(arch).replace(fl_mode=mode).param_count()


def test_serve_cli_on_cpu(capsys):
    stats = serve.main(["--arch", "tiny", "--device", "cpu", "--requests",
                        "3", "--slots", "2", "--max-new", "4"])
    assert stats["decode_steps"] > 0 and stats["tok_per_s"] > 0
    out = capsys.readouterr().out
    assert all(f"req{i}:" in out for i in range(3))


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-130m"])
def test_serve_cli_ssm_archs_on_cpu(arch, capsys):
    """The serve CLI through its existing flags on the reduced Mamba2
    models: every request finishes."""
    stats = serve.main(["--arch", arch, "--device", "cpu", "--requests",
                        "3", "--slots", "2", "--max-new", "4"])
    assert stats["decode_steps"] > 0
    out = capsys.readouterr().out
    assert all(f"req{i}:" in out for i in range(3))


def test_server_finishes_requests_with_sampling():
    cfg = reduced(get_config("tiny"))
    srv = serve.Server(cfg, batch_slots=2, max_seq=32, device="cpu")
    rng = np.random.default_rng(1)
    reqs = [serve.Request(i, rng.integers(0, cfg.vocab, 5), 3)
            for i in range(3)]
    done, _ = srv.run(reqs, greedy=False)
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out) == 3 and (r.out < cfg.vocab).all() for r in done)


@pytest.mark.parametrize("arch", ["tiny", "seamless-m4t-large-v2",
                                  "internvl2-2b"])
def test_sampled_server_matches_reference(arch):
    """``Server.run(greedy=False)`` against the reference ``Server`` with
    its weights carried across: the same requests give the same tokens
    (decode step n draws categorical(PRNGKey(n), logits) on both)."""
    from repro.launch import serve as jserve

    cfg = reduced(get_config(arch))
    jsrv = jserve.Server(_jcfg(cfg), batch_slots=2, max_seq=32, seed=4)
    # the reference hands jnp.asarray(self.pos), which on the CPU may
    # alias the numpy buffer, to an asynchronously dispatched step and
    # then increments self.pos: unless the step is waited for, it may
    # read the next position (seen here in a process's first run)
    step = jsrv._step
    jsrv._step = lambda *a: jax.block_until_ready(step(*a))
    srv = serve.Server(cfg, batch_slots=2, max_seq=32, device="cpu")
    srv.params = params_from_numpy(jsrv.params, "cpu")
    rng = np.random.default_rng(8)
    spec = [(rng.integers(0, cfg.vocab, int(rng.integers(4, 9))), 6)
            for _ in range(3)]
    want, _ = jsrv.run([jserve.Request(i, p, n)
                        for i, (p, n) in enumerate(spec)], greedy=False)
    got, _ = srv.run([serve.Request(i, p, n)
                      for i, (p, n) in enumerate(spec)], greedy=False)
    want = {r.rid: r.out.tolist() for r in want}
    assert {r.rid: r.out.tolist() for r in got} == want
    # the draws are samples, not the greedy tokens
    srv = serve.Server(cfg, batch_slots=2, max_seq=32, device="cpu")
    srv.params = params_from_numpy(jsrv.params, "cpu")
    greedy, _ = srv.run([serve.Request(i, p, n)
                         for i, (p, n) in enumerate(spec)])
    assert {r.rid: r.out.tolist() for r in greedy} != want


def test_serve_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "tiny", "--requests", "1"])
