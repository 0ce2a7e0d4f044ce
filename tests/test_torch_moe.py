"""The port's MoE serving path (``repro_torch.models.moe``, the MoE block
of ``models.model``, the MoE configs) against the JAX package on the CPU,
each case driven from the same numpy inputs:

  * ``router_topk``: indices bit-equal, weights within 1e-6, aux 1e-5;
  * ``moe_ffn`` in float32 at tight capacity (cf 1.0 and 1.25), one and
    three sequences, with and without shared experts: the kept slots
    bit-equal to the reference's (its stable argsort), outputs within
    1e-5, aux 1e-6; in bfloat16 within 4x the reference's own
    bf16-vs-f32 spread; against ``moe_ffn_dense_ref`` at cf = E within
    2e-4 (tests/test_moe.py's bound);
  * ``init_moe_block``, the parameter trees and counts of the three
    configs, ``reduced``, and the checkpoint converter on an MoE tree;
  * reduced olmoe-1b-7b, moonshot-v1-16b-a3b and mixtral-8x22b (its
    ``fl_mode="full"``): prefill logits and caches on carried weights
    within 2e-4 on the xla and flash backends, ``forward_hidden``'s aux
    within 1e-5, prefill then decode against the full forward within 1e-3
    (at cf = E, as tests/test_decode_parity.py's moe family: dropped
    slots depend on the sequence length), batched decode against solo;
  * the serve CLI on the reduced MoE models."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import reduced as jax_reduced  # noqa: E402
from repro_torch.checkpointing import params_from_numpy  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import BlockCfg, ModelConfig, reduced  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from test_torch_lm_serve import (_assert_trees_close, _jcfg,  # noqa: E402
                                 _leaves, _params)

MOE_ARCHS = ["olmoe-1b-7b", "moonshot-v1-16b-a3b", "mixtral-8x22b"]
D = 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _small(E, k, shared=0, cf=1.25, dtype="float32"):
    return ModelConfig("m", 1, D, 2, 2, 16, 0, 64,
                       pattern=(BlockCfg("moe"),), n_experts=E, top_k=k,
                       expert_ff=16, capacity_factor=cf,
                       n_shared_experts=shared, dtype=dtype, remat=False)


def _block(cfg, seed):
    """One MoE block's FFN leaves drawn with numpy in float32: router
    N(0, 1/d) (logits O(1), so the top-k are well apart), experts at
    the reference's scales."""
    rng = np.random.default_rng(seed)
    E, eff = cfg.n_experts, cfg.expert_ff

    def n(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    bp = {"router": n(D, E, scale=D ** -0.5),
          "wi_e": n(E, D, 2 * eff, scale=D ** -0.5),
          "wd_e": n(E, eff, D, scale=eff ** -0.5)}
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * eff
        bp["wi_s"] = n(D, 2 * sff, scale=D ** -0.5)
        bp["wd_s"] = n(sff, D, scale=sff ** -0.5)
    return bp


def _both(bp, dtype):
    """(jax leaves, port leaves) in ``dtype``, the router in float32."""
    def cast(name, a):
        return a if name == "router" else a.astype(dtype)

    jbp = {k: jnp.asarray(cast(k, v)) for k, v in bp.items()}
    return jbp, params_from_numpy(
        {k: np.asarray(v) for k, v in jbp.items()}, "cpu")


def _ref_keep(x, jbp, cfg):
    """The reference's kept slots in flat order (b, t, j), replaying
    ``_moe_seq``'s dispatch (``repro/models/moe.py:88-101``) with its own
    router and jnp's stable argsort, one sequence at a time."""
    E, k = cfg.n_experts, cfg.top_k
    out = []
    for xb in jnp.asarray(x):
        _, topi, _ = jmoe.router_topk(xb, jbp["router"], k)
        S = xb.shape[0] * k
        flat_e = topi.reshape(S)
        order = jnp.argsort(flat_e)
        se = flat_e[order]
        rank = jnp.arange(S) - jnp.searchsorted(se, jnp.arange(E))[se]
        cap = int(max(1, round(cfg.capacity_factor * S / E)))
        keep = np.empty(S, bool)
        keep[np.asarray(order)] = np.asarray(rank < cap)
        out.append(keep)
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# router, dispatch, the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,k", [(4, 1), (8, 2), (64, 6), (64, 8)])
def test_router_topk_matches(E, k):
    rng = np.random.default_rng(E + k)
    x = rng.standard_normal((96, D)).astype(np.float32)
    w = (rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32)
    jw, ji, ja = jmoe.router_topk(jnp.asarray(x), jnp.asarray(w), k)
    tw, ti, ta = tmoe.router_topk(_t(x), _t(w), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    assert abs(float(ta) - float(ja)) <= 1e-5
    assert tw.dtype == ta.dtype == torch.float32


FFN_CASES = [(E, k, shared, cf, B)
             for E, k, shared in [(4, 2, 0), (8, 2, 2), (64, 8, 0),
                                  (64, 6, 2)]
             for cf in (1.0, 1.25) for B in (1, 3)]


@pytest.mark.parametrize("E,k,shared,cf,B", FFN_CASES)
def test_moe_ffn_matches_reference(E, k, shared, cf, B):
    cfg = _small(E, k, shared, cf)
    jbp, tbp = _both(_block(cfg, seed=E * 10 + k), np.float32)
    x = np.random.default_rng(B).standard_normal((B, 40, D)) \
        .astype(np.float32)
    jy, ja = jmoe.moe_ffn(jnp.asarray(x), jbp, _jcfg(cfg))
    ty, ta = tmoe.moe_ffn(_t(x), tbp, cfg)
    _, topi, _ = tmoe._route(_t(x), tbp["router"], k)
    _, _, keep = tmoe.dispatch(topi, E, tmoe.capacity(cfg, 40))
    want_keep = _ref_keep(x, jbp, cfg)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if cf == 1.0:
        assert not want_keep.all()  # tight: some slots are dropped
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(ta) - float(ja)) <= 1e-6


def test_tight_capacity_keeps_the_lowest_flat_slots():
    """Many equal keys (E 4, L 256, cf 0.5): each overfull expert keeps
    its first cap slots in flat order, as the reference's stable sort;
    the buffer rows read those slots' tokens, the rest the zero row."""
    cfg = _small(4, 2, cf=0.5)
    jbp, tbp = _both(_block(cfg, seed=9), np.float32)
    x = np.random.default_rng(4).standard_normal((2, 256, D)) \
        .astype(np.float32)
    _, topi, _ = tmoe._route(_t(x), tbp["router"], 2)
    cap = tmoe.capacity(cfg, 256)
    src, dest, keep = tmoe.dispatch(topi, 4, cap)
    np.testing.assert_array_equal(keep.numpy(), _ref_keep(x, jbp, cfg))
    flat_e = topi.reshape(2, -1)
    for b in range(2):
        for e in range(4):
            slots = torch.nonzero(flat_e[b] == e)[:, 0] + b * 256 * 2
            n = min(cap, len(slots))
            assert keep[slots[:n]].all() and not keep[slots[n:]].any()
            rows = (e * 2 + b) * cap + torch.arange(cap)
            np.testing.assert_array_equal(dest[slots[:n]].numpy(),
                                          rows[:n].numpy())
            np.testing.assert_array_equal(src[rows[:n]].numpy(),
                                          (slots[:n] // 2).numpy())
            assert (src[rows[n:]] == 2 * 256).all()
    assert (dest[~keep] == 4 * 2 * cap).all()


@pytest.mark.parametrize("E,k,shared", [(8, 2, 0), (64, 8, 0), (64, 6, 2)])
def test_moe_ffn_bf16_within_reference_spread(E, k, shared):
    """bfloat16 activations and experts (router float32): the port's
    distance from the reference's float32 output on the same bf16-valued
    inputs within 4x the reference's own bf16 distance from it."""
    cfg = _small(E, k, shared, 1.25, "bfloat16")
    bp = _block(cfg, seed=E + 2 * k)
    x = np.random.default_rng(5).standard_normal((2, 48, D)) \
        .astype(np.float32)
    jbf, tbf = _both(bp, jnp.bfloat16)
    x16 = jnp.asarray(x, jnp.bfloat16)
    j32 = {n: a.astype(jnp.float32) for n, a in jbf.items()}
    truth, _ = jmoe.moe_ffn(x16.astype(jnp.float32), j32,
                            _jcfg(cfg.replace(dtype="float32")))
    ref16, _ = jmoe.moe_ffn(x16, jbf, _jcfg(cfg))
    port16, _ = tmoe.moe_ffn(_t(np.asarray(x16.astype(jnp.float32)))
                             .to(torch.bfloat16), tbf, cfg)
    assert port16.dtype == torch.bfloat16
    truth = np.asarray(truth)
    spread = np.abs(np.asarray(ref16.astype(jnp.float32)) - truth).max()
    err = np.abs(port16.float().numpy() - truth).max()
    assert 0 < spread and err <= 4 * spread, (err, spread)


@pytest.mark.parametrize("E,k,shared", [(4, 1, 0), (4, 2, 0), (8, 2, 1),
                                        (64, 6, 2)])
def test_moe_ffn_matches_dense_ref_without_drops(E, k, shared):
    cfg = _small(E, k, shared, cf=float(E))
    _, tbp = _both(_block(cfg, seed=3), np.float32)
    x = _t(np.random.default_rng(6).standard_normal((2, 8, D))
           .astype(np.float32))
    y1, a1 = tmoe.moe_ffn(x, tbp, cfg)
    y2, a2 = tmoe.moe_ffn_dense_ref(x, tbp, cfg)
    torch.testing.assert_close(y1, y2, rtol=2e-4, atol=2e-4)
    assert float(a1) == pytest.approx(float(a2), rel=1e-5)
    # and the dense plain version is the reference's
    jbp = {n: jnp.asarray(v.numpy()) for n, v in tbp.items()}
    jy, ja = jmoe.moe_ffn_dense_ref(jnp.asarray(x.numpy()), jbp,
                                    _jcfg(cfg))
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(a2) - float(ja)) <= 1e-6


def test_decode_rows_route_alone():
    """One token per row (cap 1): a row's output does not depend on what
    the other rows route, even when every row picks the same experts (a
    slot dropped or shared would move it by tenths; other batch shapes
    only reorder the products' sums)."""
    cfg = _small(8, 2, 1)
    _, tbp = _both(_block(cfg, seed=7), np.float32)
    x = _t(np.random.default_rng(8).standard_normal((1, 1, D))
           .astype(np.float32))
    solo, _ = tmoe.moe_ffn(x, tbp, cfg)
    assert tmoe.capacity(cfg, 1) == 1
    others = torch.cat([x, x, torch.randn(2, 1, D)])
    batched, _ = tmoe.moe_ffn(others, tbp, cfg)
    for row in (0, 1):
        torch.testing.assert_close(batched[row], solo[0], rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# parameters, configs, conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [0, 2])
def test_init_moe_block_tree_matches(shared):
    cfg = _small(8, 2, shared).replace(dtype="bfloat16")
    for lead in ((), (3,)):
        got = tm.init_moe_block(torch.Generator().manual_seed(0), cfg, lead)
        shapes = jax.eval_shape(lambda: jm.init_moe_block(
            jax.random.PRNGKey(0), _jcfg(cfg)))
        want = {n: (tuple(lead) + tuple(v.shape), str(v.dtype))
                for n, v in shapes.items()}
        assert {n: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for n, v in got.items()} == want


def test_expert_draws_have_the_reference_scales():
    """Each stacked unit of an expert leaf is its own draw at d^-0.5
    (wi_e) and eff^-0.5 (wd_e); the router float32 at d^-0.5."""
    cfg = _small(8, 2).replace(d_model=256, expert_ff=64)
    bp = tm.init_moe_block(torch.Generator().manual_seed(1), cfg, (2,))
    for name, scale in (("wi_e", 256 ** -0.5), ("wd_e", 64 ** -0.5),
                        ("router", 256 ** -0.5)):
        for u in range(2):
            assert bp[name][u].std().item() == pytest.approx(scale, rel=0.05)
    assert not torch.equal(bp["wi_e"][0], bp["wi_e"][1])
    assert bp["router"].dtype == torch.float32


def _full(arch, which):
    """The port's or the reference's full config; mixtral with
    fl_mode="full" (its LoRA mode belongs to LM training)."""
    cfg = (get_config if which == "port" else jax_get_config)(arch)
    return cfg.replace(fl_mode="full") if arch == "mixtral-8x22b" else cfg


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_count_matches_reference(arch):
    assert _full(arch, "port").param_count() == \
        _full(arch, "jax").param_count()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reduced_matches_reference(arch):
    got, want = reduced(get_config(arch)), jax_reduced(jax_get_config(arch))
    for f in want.__dataclass_fields__:
        if f == "pattern":
            assert [(b.kind, b.window) for b in got.pattern] \
                == [(b.kind, b.window) for b in want.pattern]
        else:
            assert getattr(got, f) == getattr(want, f), f
    assert got.n_experts == 4 and got.top_k == 2


def test_registry_lists_the_reference_archs_it_runs():
    """Every architecture of the reference's registry, in its order."""
    from repro.configs import ARCHS as JAX_ARCHS

    assert ARCHS == JAX_ARCHS
    for arch in MOE_ARCHS:
        want = jax_get_config(arch)
        assert get_config(arch).source == want.source


def test_bf16_moe_tree_converts_bit_for_bit():
    """params_from_numpy is generic: the MoE block's router (float32),
    wi_e, wd_e, wi_s and wd_s arrive stacked on [n_units], bit for bit."""
    cfg = jax_reduced(jax_get_config("moonshot-v1-16b-a3b")) \
        .replace(dtype="bfloat16")
    jp = jm.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jp, "cpu")
    blk = tp["stack"]["pos0"]
    assert {"router", "wi_e", "wd_e", "wi_s", "wd_s"} <= set(blk)
    assert blk["router"].dtype == torch.float32
    assert blk["wi_e"].shape == (cfg.n_units, 4, cfg.d_model,
                                 2 * cfg.expert_ff)
    for key, leaf in _leaves(jp):
        a, t = np.asarray(leaf), dict(_leaves(tp))[key]
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16), err_msg=key)
        else:
            np.testing.assert_array_equal(t.numpy(), a, err_msg=key)


# ---------------------------------------------------------------------------
# the model: prefill, aux, decode
# ---------------------------------------------------------------------------

def _small_arch(arch, **kw):
    cfg = reduced(get_config(arch))
    if arch == "mixtral-8x22b":
        cfg = cfg.replace(fl_mode="full")
    return cfg.replace(**kw)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def small_moe(request):
    cfg = _small_arch(request.param)
    return (cfg,) + _params(cfg, seed=3)


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_prefill_matches_reference(small_moe, backend):
    base, jp, tp = small_moe
    cfg = base.replace(attn_backend=backend)
    B, L = 2, 128  # L % 128 == 0: the flash backend takes the kernel path
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, L))
    jcfg = _jcfg(cfg)
    want, jcache = jm.prefill(jp, jcfg, jm.init_cache(jcfg, B, L + 4),
                              jnp.asarray(toks, jnp.int32))
    tcache = tm.init_cache(cfg, B, L + 4, device="cpu")
    got, _ = tm.prefill(tp, cfg, tcache, _t(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    _assert_trees_close(tcache, jcache, 2e-4)


def test_forward_hidden_aux_matches(small_moe):
    cfg, jp, tp = small_moe
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (3, 24))
    jh, jaux = jm.forward_hidden(jp, _jcfg(cfg), jnp.asarray(toks, jnp.int32))
    th, taux = tm.forward_hidden(tp, cfg, _t(toks))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)
    assert taux.dtype == torch.float32 and taux.shape == ()
    assert abs(float(taux) - float(jaux)) <= 1e-5


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_then_decode_matches_full_forward(arch):
    """tests/test_decode_parity.py's moe family on the reduced configs,
    at cf = E (no slot dropped), the port's full forward also held
    against the reference's."""
    cfg = _small_arch(arch, capacity_factor=4.0)
    jp, tp = _params(cfg, seed=1)
    B, L = 2, 16
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (B, L))
    tt = _t(toks)
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


def test_batched_decode_isolated_vs_solo(small_moe):
    """tests/test_launchers.py::test_batched_decode_isolated_vs_solo at
    the config's own capacity: capacity is per sequence, so a row's
    prefill and decode are its solo run's."""
    cfg, _, tp = small_moe
    S = 24
    toks = _t(np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)))
    cache = tm.init_cache(cfg, 2, S, device="cpu")
    lg_b, cache = tm.prefill(tp, cfg, cache, toks)
    nxt = torch.argmax(lg_b, -1)[:, None]
    lg_b2, _ = tm.serve_step(tp, cfg, cache, nxt, torch.full((2,), 8))
    for i in range(2):
        c1 = tm.init_cache(cfg, 1, S, device="cpu")
        lg_s, c1 = tm.prefill(tp, cfg, c1, toks[i:i + 1])
        torch.testing.assert_close(lg_s[0], lg_b[i], rtol=1e-5, atol=1e-5)
        lg_s2, _ = tm.serve_step(tp, cfg, c1, nxt[i:i + 1],
                                 torch.full((1,), 8))
        torch.testing.assert_close(lg_s2[0], lg_b2[i], rtol=1e-5, atol=1e-5)


def test_prefill_is_deterministic(small_moe):
    """No atomics in the combine: two prefills give the same bits."""
    cfg, _, tp = small_moe
    toks = _t(np.random.default_rng(9).integers(0, cfg.vocab, (2, 32)))
    outs = []
    for _ in range(2):
        cache = tm.init_cache(cfg, 2, 32, device="cpu")
        outs.append(tm.prefill(tp, cfg, cache, toks))
    assert torch.equal(outs[0][0], outs[1][0])
    for (_, a), (_, b) in zip(_leaves(outs[0][1]), _leaves(outs[1][1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "moonshot-v1-16b-a3b"])
def test_serve_cli_moe_archs_on_cpu(arch, capsys):
    stats = serve.main(["--arch", arch, "--device", "cpu", "--requests",
                        "3", "--slots", "2", "--max-new", "4"])
    assert stats["decode_steps"] > 0
    out = capsys.readouterr().out
    assert all(f"req{i}:" in out for i in range(3))
