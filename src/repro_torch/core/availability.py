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


def sample_active(rng, cfg: AvailabilityCfg, base_p, t, markov_state=None):
    """Returns (mask [m] float32, new_markov_state)."""
    if cfg.kind == "markov":
        if markov_state is None:
            raise ValueError("kind='markov' needs the carried markov state")
        u = prng.uniform(rng, markov_state.shape)
        on = markov_state > 0.5
        stay_on = u > cfg.markov_down
        turn_on = u < markov_turn_on(cfg, base_p)
        new = torch.where(on, stay_on, turn_on).float()
        return new, new
    p = probs_at(cfg, base_p, t)
    mask = (prng.uniform(rng, p.shape) < p).float()
    return mask, markov_state
