"""The bfloat16 drift witness.

In bfloat16 the flash kernel and the xla branch round the softmax
probabilities at different points (the kernel before normalising,
``repro/kernels/flash_attention/kernel.py:79``, the xla branch after),
so the two backends' prefills differ by bf16 ulps that compound through
the layers.  chip_smoke.py holds the port's CUDA kernel to that drift on
the card, on the witness inputs (``chip_smoke.witness_arrays``: reduced
gemma2-2b at head dim 256, numpy weights and tokens) and against the
reference's own numbers, ``chip_smoke.REF_DRIFT``.  Here, on the CPU:

  * the JAX package's flash (Pallas, interpret mode) and xla prefills of
    the witness differ by what REF_DRIFT records, layer by layer and end
    to end;
  * the port's xla prefill of the witness in bfloat16 agrees with the
    reference's as closely as the port's kernel must agree with the
    port's xla branch: within WITNESS_RATIO times that drift."""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.config import reduced as jax_reduced  # noqa: E402
from repro_torch.checkpointing import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import reduced  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke",
    pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(scope="module")
def witness():
    cfg = chip_smoke.witness_config(get_config, reduced)
    jcfg = jax_reduced(jax_get_config("gemma2-2b"), head_dim=256,
                       dtype="bfloat16")
    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    arrays, toks = chip_smoke.witness_arrays(np, shapes, cfg.vocab)
    jp = chip_smoke.tree_map(
        lambda k, a: jnp.asarray(a) if k.startswith("ln")
        else jnp.asarray(a).astype(jnp.bfloat16), arrays)
    tp = chip_smoke.tree_map(
        lambda k, t: t if k.startswith("ln") else t.to(torch.bfloat16),
        params_from_numpy(arrays, "cpu"))
    return cfg, jcfg, jp, tp, toks


def _jax_prefill(jcfg, jp, toks, backend, record=None):
    """The reference's prefill; with ``record``, every attention sub-block
    runs both backends on the xla run's input (as chip_smoke's
    ``both_backends`` does in the port) and appends max |flash - xla|."""
    c = jcfg.replace(attn_backend=backend)
    cache = jm.init_cache(c, toks.shape[0], toks.shape[1])
    if record is None:
        return jm.prefill(jp, c, cache, jnp.asarray(toks))
    orig = jm._orig_attn_qkvo

    def both(x, wp, cfg, positions, **kw):
        yf, _ = orig(x, wp, cfg.replace(attn_backend="flash"), positions,
                     **kw)
        yx, nx = orig(x, wp, cfg.replace(attn_backend="xla"), positions,
                      **kw)
        err = jnp.max(jnp.abs(yf.astype(jnp.float32)
                              - yx.astype(jnp.float32)))
        jax.debug.callback(lambda e: record.append(float(e)), err)
        return yx, nx

    jm._orig_attn_qkvo = both
    try:
        out = jm.prefill(jp, c, cache, jnp.asarray(toks))
        jax.effects_barrier()
    finally:
        jm._orig_attn_qkvo = orig
    return out


def _kv(cache):
    return [np.asarray(leaf[name], np.float32)
            for _, leaf in sorted(cache["stack"].items())
            for name in ("k", "v")]


def test_reference_drift_matches_record(witness):
    cfg, jcfg, jp, tp, toks = witness
    lf, cf = _jax_prefill(jcfg, jp, toks, "flash")
    layers = []
    lx, cx = _jax_prefill(jcfg, jp, toks, "xla", record=layers)
    got = dict(layers=layers,
               logits=float(jnp.max(jnp.abs(lf - lx))),
               cache=max(float(np.abs(a - b).max())
                         for a, b in zip(_kv(cf), _kv(cx))))
    ref = chip_smoke.REF_DRIFT
    assert len(got["layers"]) == cfg.n_layers == len(ref["layers"])
    np.testing.assert_allclose(got["layers"], ref["layers"], rtol=1e-6)
    assert got["logits"] == pytest.approx(ref["logits"], rel=1e-6)
    assert got["cache"] == pytest.approx(ref["cache"], rel=1e-6)


def test_port_xla_prefill_bf16_matches_reference(witness):
    """Both run the xla branch in bfloat16; they differ by where bf16
    roundings fall in the projections (torch and XLA order the sums
    differently), held to the bound the port's kernel is held to."""
    cfg, jcfg, jp, tp, toks = witness
    lj, cj = _jax_prefill(jcfg, jp, toks, "xla")
    c = cfg.replace(attn_backend="xla")
    cache = tm.init_cache(c, toks.shape[0], toks.shape[1], device="cpu")
    lt, ct = tm.prefill(tp, c, cache, torch.from_numpy(toks))
    ref = chip_smoke.REF_DRIFT
    logits = float(np.abs(lt.numpy() - np.asarray(lj)).max())
    cache_err = max(float(np.abs(a.float().numpy() - b).max())
                    for a, b in zip(chip_smoke.cache_kv(ct), _kv(cj)))
    ratio = chip_smoke.WITNESS_RATIO
    assert logits <= ratio * ref["logits"], logits
    assert cache_err <= ratio * ref["cache"], cache_err
