"""Counter-based PRNG: the ``jax.random`` functions the FedAWE slice draws
from, ported to torch bit for bit.

The JAX package draws every availability mask, sampler column and local
key through ``jax.random`` under its defaults: the ``threefry2x32``
implementation with ``jax_threefry_partitionable=True``.  This module
computes the same bits from the same keys, so a port run and a reference
run started from one seed see identical masks, batches and τ.

Representation: a key is an int64 tensor of shape ``[..., 2]`` holding two
uint32 words (JAX's legacy ``uint32[2]`` key).  All uint32 arithmetic runs
in int64 and is masked back to 32 bits: additions and rotations stay far
below 2**63, and the products of ``randint``'s modulus step go through
``_mul32``, which splits a factor into 16-bit halves so no partial product
can overflow int64 and the result wraps as uint32 does.

Every function runs on the device of its key tensor and never copies
from the host inside a round (scalars become device tensors through
``torch.full``, a fill kernel, not a synchronous host copy); leading key
dimensions batch (``split`` of ``[m, 2]`` keys gives ``[m, num, 2]``, the
counterpart of ``jax.vmap(jax.random.split)``).

``split``, ``fold_in``, ``uniform`` and ``randint`` are bit-exact against
jax 0.9.0; ``gumbel`` and ``categorical`` (the serving loop's sampled
draw) evaluate jax's formulas on those uniforms through torch's ``log``
and ``log1p``, so the Gumbel noise agrees within an ulp and the sampled
indices are the reference's unless two classes tie within it.  ``normal`` evaluates the same Giles polynomial as XLA's
``erf_inv`` but through torch's ``log1p``/``sqrt``, so it agrees within a
tolerance, not bitwise.  ``gamma``, ``loggamma`` and ``dirichlet`` run
jax's Marsaglia–Tsang rejection sampler with its key splits; they agree
within a tolerance, and an accept test that an ulp of ``normal`` or
``log`` tips the other way draws a different value (counted by the
tests).
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
#: nextafter(-1, 0) in float32: the open lower end of ``normal``'s uniform
_NORMAL_LO = -1.0 + 2.0 ** -24


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def _mul32(a, b):
    """``(a * b) mod 2**32`` for uint32 values held in int64: ``b`` is
    split into 16-bit halves so each partial product stays below 2**48."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher, 20 rounds (jax ``prng.py``,
    ``_threefry2x32_lowering``).  All operands broadcast; returns the two
    output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def _scalar(v, dtype, device):
    """A 0-d device tensor from a Python number (filled on the device) or
    an existing tensor (cast)."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=device)


def _shape(shape):
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(d) for d in shape)


def _iota_2x32(shape, device):
    """Row-major uint64 iota over ``shape`` as (high, low) uint32 words."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & MASK32


def _hash_counts(key, shape):
    """threefry of every counter of ``shape`` under ``key [..., 2]``:
    returns two ``[..., *shape]`` words."""
    hi, lo = _iota_2x32(shape, key.device)
    lead = key.shape[:-1]
    pad = (1,) * len(shape)
    k1 = key[..., 0].reshape(lead + pad)
    k2 = key[..., 1].reshape(lead + pad)
    return threefry2x32(k1, k2, hi, lo)


def PRNGKey(seed: int, device):
    """``jax.random.PRNGKey(seed)`` for a 32-bit integer seed: the key
    ``[0, seed mod 2**32]`` on ``device``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside the int32 range that "
                         "jax.random.PRNGKey accepts by default")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64,
                        device=device)


def split(key, num=2):
    """``jax.random.split(key, num)``: ``[..., 2] -> [..., *num, 2]``."""
    b1, b2 = _hash_counts(key, _shape(num))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``; ``data`` is a Python int or a
    0-d integer tensor (e.g. the device-resident round counter)."""
    d = _scalar(data, torch.int64, key.device) & MASK32
    zero = torch.zeros_like(d)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], zero, d)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key, shape):
    """32 random bits per element (uint32 values in int64):
    ``jax.random.bits(key, shape, uint32)``."""
    b1, b2 = _hash_counts(key, _shape(shape))
    return b1 ^ b2


def _unit_floats(key, shape):
    """Floats in [0, 1): the top 23 bits as a mantissa under exponent 0,
    minus 1.  That is ``mantissa * 2**-23`` exactly (the mantissa fits
    float32's 24 bits, the product is a power-of-two scaling, and the
    reference's subtraction is exact), computed without a dtype view,
    which ``torch.func.vmap`` cannot batch in every supported torch."""
    return (random_bits(key, shape) >> 9).to(torch.float32) * 2.0 ** -23


def uniform(key, shape=(), minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape)`` in float32 on [minval, maxval)."""
    floats = _unit_floats(key, shape)
    lo = _scalar(minval, torch.float32, key.device)
    hi = _scalar(maxval, torch.float32, key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def randint(key, shape, minval, maxval):
    """``jax.random.randint(key, shape, minval, maxval)`` for int32
    bounds; ``minval``/``maxval`` broadcast against ``shape`` (e.g. a
    per-row ``counts[:, None]``).  Returns int64 (torch's index dtype)
    holding the reference's int32 values."""
    shape = _shape(shape)
    dev = key.device
    lo = _scalar(minval, torch.int64, dev)
    hi = _scalar(maxval, torch.int64, dev)
    k = split(key)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = (hi - lo) & MASK32
    span = torch.where(hi <= lo, torch.ones_like(span), span)
    mult = (65536 % span)
    # uint32 product: for span > 2**16 it is 2**32, which wraps to 0
    mult = _mul32(mult, mult) % span
    off = (_mul32(higher % span, mult) + lower % span) & MASK32
    return lo + off % span


def _erf_inv(x):
    """float32 inverse error function by Giles' polynomial, the one XLA
    lowers ``erf_inv`` to (valid on the open interval (-1, 1))."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    c_small = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
    c_large = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, torch.full_like(x, c_small[0]),
                    torch.full_like(x, c_large[0]))
    for a, b in zip(c_small[1:], c_large[1:]):
        p = torch.where(small, torch.full_like(x, a),
                        torch.full_like(x, b)) + p * w
    return p * x


def normal(key, shape=()):
    """``jax.random.normal(key, shape)`` in float32 (within a tolerance:
    see the module docstring)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return math.sqrt(2) * _erf_inv(u)


def _marsaglia_tsang(keys, alpha, log_space):
    """jax's ``_gamma_one`` (``jax/_src/random.py``) for every element of
    ``alpha`` at once, element i under ``keys[i]``.  Each rejection loop
    runs over a mask of the elements still in it, and an element's key
    splits, normal and uniform draws are those jax makes for it, so
    every element follows its own sequential loop.  It reads the masks on
    the host (a setup-time draw, never inside a round)."""
    f32 = dict(dtype=torch.float32, device=alpha.device)
    one = torch.ones((), **f32)
    third = torch.full((), 1.0 / 3.0, **f32)
    # alpha < 1 is boosted to alpha + 1: Gamma(a) ~ Gamma(a + 1) U^(1/a)
    boost = alpha >= one
    a = torch.where(boost, alpha, alpha + one)
    d = a - third
    c = third / torch.sqrt(d)
    ks = split(keys)
    key, subkey = ks[..., 0, :], ks[..., 1, :]

    def rejecting(X, V, U):
        return ((U >= one - torch.full((), 0.0331, **f32) * (X * X))
                & (torch.log(U) >= X * torch.full((), 0.5, **f32)
                   + d * ((one - V) + torch.log(V))))

    X, V = torch.zeros_like(alpha), torch.ones_like(alpha)
    U = torch.full_like(alpha, 2.0)
    todo = rejecting(X, V, U)
    while bool(todo.any()):
        k3 = split(key, 3)
        nkey, xkey, ukey = k3[..., 0, :], k3[..., 1, :], k3[..., 2, :]
        x, v = torch.zeros_like(alpha), -torch.ones_like(alpha)
        inner = v <= 0
        while bool(inner.any()):
            k2 = split(xkey)
            xn = normal(k2[..., 1, :], ())
            vn = one + xn * c
            xkey = torch.where(inner[..., None], k2[..., 0, :], xkey)
            x, v = torch.where(inner, xn, x), torch.where(inner, vn, v)
            inner = inner & (v <= 0)
        Un = uniform(ukey, ())
        key = torch.where(todo[..., None], nkey, key)
        X = torch.where(todo, x * x, X)
        V = torch.where(todo, v * v * v, V)
        U = torch.where(todo, Un, U)
        todo = todo & rejecting(X, V, U)
    if log_space:
        # -exponential(subkey) = log1p(-u)
        log_u = torch.log1p(-uniform(subkey, ()))
        log_boost = torch.where(boost | (log_u == 0), 0.0,
                                log_u * (one / alpha))
        return (torch.log(d) + torch.log(V)) + log_boost
    u = one - uniform(subkey, ())
    return d * V * torch.where(boost, one, torch.pow(u, one / alpha))


def _gamma_draw(key, a, shape, log_space):
    """``jax.random.gamma``'s body: ``a`` broadcast to ``shape``, one key
    of ``split(key, prod(shape))`` per element, row-major."""
    a = torch.as_tensor(a, dtype=torch.float32, device=key.device)
    shape = tuple(a.shape) if shape is None else _shape(shape)
    a = torch.broadcast_to(a, shape)
    keys = split(key, math.prod(shape)).reshape(shape + (2,))
    return _marsaglia_tsang(keys, a, log_space)


def gamma(key, a, shape=None):
    """``jax.random.gamma(key, a, shape)`` in float32 (within a tolerance:
    see the module docstring)."""
    return _gamma_draw(key, a, shape, log_space=False)


def loggamma(key, a, shape=None):
    """``jax.random.loggamma(key, a, shape)``: the log of a gamma draw,
    computed in log space (exact for small ``a``)."""
    return _gamma_draw(key, a, shape, log_space=True)


def dirichlet(key, alpha, shape=None):
    """``jax.random.dirichlet(key, alpha, shape)``: ``shape + alpha.shape
    [-1:]`` float32 draws (``shape`` defaults to ``alpha.shape[:-1]``),
    the softmax of log-gamma draws."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=key.device)
    shape = tuple(alpha.shape[:-1]) if shape is None else _shape(shape)
    logs = loggamma(key, alpha, shape + tuple(alpha.shape[-1:]))
    un = torch.exp(logs - torch.amax(logs, dim=-1, keepdim=True))
    return un / torch.sum(un, dim=-1, keepdim=True)


_F32_TINY = torch.finfo(torch.float32).tiny


def gumbel(key, shape=()):
    """``jax.random.gumbel(key, shape)`` in float32 (``jax/_src/random.py``'s
    ``_gumbel``) in the mode jax's default resolves to, "low" (the
    ``jax_high_dynamic_range_gumbel`` flag defaults to False):
    -log(-log(u)) of one uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key, logits, axis=-1):
    """``jax.random.categorical(key, logits, axis)`` on float32 logits
    (with replacement, jax's default mode): the Gumbel-max trick, argmax
    over ``axis`` of logits + gumbel(key, logits.shape), ties to the
    first index as ``jnp.argmax``.  Returns int64 indices of shape
    logits.shape without ``axis``."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical draws on float32 logits (the "
                        f"reference's uniform bits depend on the dtype); "
                        f"got {logits.dtype}")
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=axis)
