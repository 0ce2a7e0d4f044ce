"""Client availability processes (Section 7 / Appendix J.3 of the paper).

p_i^t = p_i * f_i(t) with
  stationary:        f(t) = 1
  staircase:         f(t) = 1 on the first half-period, 0.4 on the second
  sine:              f(t) = gamma*sin(2*pi*t/P) + (1-gamma)
  interleaved_sine:  f(t) = g(t) * 1{p_i*g(t) >= cutoff}   (zeros allowed!)
  markov:            2-state Gilbert-Elliott chain per client

Every float expression keeps the reference's float32 operation order, and
the draws come from ``core/prng.py``, so masks equal the reference's.  The
one source of difference is the float compare ``u < p``: ``f_t``'s sine
and ``base_probs_from_data``'s ``nu @ phi`` may round differently by an
ulp in another library, which flips a mask entry only when ``u`` falls
inside that ulp.
"""
from __future__ import annotations

import dataclasses
import math
import struct

import torch

from repro_torch.core import prng
from repro_torch.sharding.placement import rows_of

KINDS = ("stationary", "staircase", "sine", "interleaved_sine", "markov")


@dataclasses.dataclass(frozen=True)
class AvailabilityCfg:
    """Static config of one availability process (fields and meaning as
    in the reference's ``AvailabilityCfg``)."""
    kind: str = "stationary"
    gamma: float = 0.3
    period: int = 20
    staircase_low: float = 0.4
    cutoff: float = 0.1
    delta_floor: float = 0.0      # optional clamp to keep Assumption 1
    markov_up: float = 0.2        # P(off -> on)
    markov_down: float = 0.2      # P(on -> off)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown availability kind {self.kind!r}; "
                             f"expected one of {KINDS}")


def base_probs_from_data(rng, nu):
    """nu: [m, C] float32 per-client label distributions (on the device
    of ``rng``). Returns p [m] in (0, 1]."""
    m, C = nu.shape
    half = C // 2
    scales = torch.cat([torch.ones(half, device=nu.device),
                        0.5 * torch.ones(C - half, device=nu.device)])
    phi = prng.uniform(rng, (C,)) * scales
    p = nu @ phi
    return torch.clamp(p, 1e-3, 1.0)


def base_probs(rng, m, alpha=0.1, n_classes=10):
    """The paper's construction from scratch: ν_i ~ Dirichlet(alpha) per
    client (``prng.dirichlet``, under the first half of ``split(rng)``),
    then ``base_probs_from_data`` under the second.  Returns ``(p [m],
    nu [m, n_classes])`` on the device of ``rng``."""
    k1, k2 = prng.split(rng)
    nu = prng.dirichlet(k1, torch.full((n_classes,), alpha,
                                       dtype=torch.float32,
                                       device=rng.device), (m,))
    return base_probs_from_data(k2, nu), nu


def _f32(x: float) -> float:
    """Round a Python float to the nearest float32 value (a product of
    two float32 values is exact in double, so this is a float32 multiply
    when applied to one)."""
    return struct.unpack("f", struct.pack("f", x))[0]


def f_t(cfg: AvailabilityCfg, t):
    """Time modulation f(t) in float32 (``t``: an integer tensor)."""
    t = t.float()
    P = cfg.period
    if cfg.kind in ("stationary", "markov"):
        return torch.ones_like(t)
    if cfg.kind == "staircase":
        phase = torch.remainder(t, P)
        return torch.where(phase < P / 2, 1.0, cfg.staircase_low)
    # sine family.  The reference's jitted round evaluates 2*pi*t/P as
    # t * (f32(2*pi) * f32(1/P)): XLA turns the division by the constant
    # P into a product with its reciprocal and folds the two constants.
    # The same float32 product here keeps the phase, and the masks,
    # bit-equal.
    w = _f32(_f32(2 * math.pi) * _f32(1.0 / P))
    return cfg.gamma * torch.sin(t * w) + (1 - cfg.gamma)


def markov_turn_on(cfg: AvailabilityCfg, base_p):
    """Per-client P(off -> on) of the Gilbert-Elliott chain, clamped to
    [0, 1], with ``delta_floor`` applied in the dynamics (reference
    ``markov_turn_on``)."""
    up = torch.clamp(cfg.markov_up * base_p
                     / torch.clamp(base_p.mean(), min=1e-6), 0.0, 1.0)
    if cfg.delta_floor:
        floor_up = (cfg.delta_floor * cfg.markov_down
                    / max(1.0 - cfg.delta_floor, 1e-6))
        up = torch.clamp(torch.clamp(up, min=floor_up), 0.0, 1.0)
    return up


def probs_at(cfg: AvailabilityCfg, base_p, t):
    """p_i^t for every client. base_p: [m]; for ``kind="markov"`` the
    chain's stationary marginal ``up_i / (up_i + down)``."""
    if cfg.kind == "markov":
        up = markov_turn_on(cfg, base_p)
        return up / torch.clamp(up + cfg.markov_down, min=1e-6)
    p = base_p * f_t(cfg, t)
    if cfg.kind == "interleaved_sine":
        p = torch.where(p >= cfg.cutoff, p, 0.0)
    if cfg.delta_floor:
        p = torch.clamp(p, cfg.delta_floor, 1.0)
    return torch.clamp(p, 0.0, 1.0)


def sample_active(rng, cfg: AvailabilityCfg, base_p, t, markov_state=None,
                  place=None):
    """Returns (mask [m] float32, new_markov_state).  Under a client
    placement (``sharding.placement``) ``base_p`` is the whole ``[m]``,
    the draw is made over all m clients and the rank's rows of it are
    taken: the mask and ``markov_state`` are the rank's rows."""
    if cfg.kind == "markov":
        if markov_state is None:
            raise ValueError("kind='markov' needs the carried markov state")
        u = rows_of(prng.uniform(rng, base_p.shape), place)
        on = markov_state > 0.5
        stay_on = u > cfg.markov_down
        turn_on = u < rows_of(markov_turn_on(cfg, base_p), place)
        new = torch.where(on, stay_on, turn_on).float()
        return new, new
    p = probs_at(cfg, base_p, t)
    mask = (rows_of(prng.uniform(rng, p.shape), place)
            < rows_of(p, place)).float()
    return mask, markov_state


def availability_trace(rng, cfg: AvailabilityCfg, base_p, T):
    """Simulate T rounds; returns the masks ``[T, m]`` (float32).

    For ``kind="markov"`` the chain starts from a stationary-marginal
    draw keyed off ``k0`` of ``split(rng)``; the other kinds are
    memoryless and do not split ``rng`` first.  Each round then splits
    the carried key and draws ``sample_active`` from the subkey, as the
    reference's scan does."""
    m = base_p.shape[0]
    dev = base_p.device
    if cfg.kind == "markov":
        rng, k0 = prng.split(rng)
        pi = probs_at(cfg, base_p, 0)   # the chain's stationary marginal
        state = (prng.uniform(k0, (m,)) < pi).float()
    else:
        state = torch.ones((m,), dtype=torch.float32, device=dev)
    ts = torch.arange(T, dtype=torch.int32, device=dev)
    key, masks = rng, []
    for t in range(T):
        key, sub = prng.split(key)
        mask, state = sample_active(sub, cfg, base_p, ts[t], state)
        masks.append(mask)
    return torch.stack(masks)
