"""Semi-asynchronous rounds: straggler/staleness as an executor dimension.

The port of the reference's ``core/staleness.py``.  A straggler computes
on the model it was handed at round ``t``, but its update reaches the
server at ``t + d``, with ``d <= tau_max`` drawn from the configured
delay dynamics:

  * **bounded-delay ring buffer** — pending innovations live in a
    ``{"buf": [tau_max, m, N], "ages": [tau_max, m]}`` carry
    (``FLState.stale``) indexed by DUE round modulo ``tau_max``: round
    ``t`` drains slot ``t % tau_max``, and a client computing now with
    drawn delay ``d >= 1`` inserts at slot ``(t + d) % tau_max`` after
    the drain, so ``d = tau_max`` reuses the just-freed slot.  ``ages``
    holds the original delay ``d`` (0 = empty slot), both the occupancy
    mask and the staleness weight at delivery.
  * **busy gating** — a client with an in-flight update does not compute
    again until it delivers, so each client holds at most one pending
    update, delivered after exactly its drawn delay.
  * **delay dynamics** — ``kind="det"`` (every straggler takes ``delay``
    rounds), ``"geom"`` (geometric with per-round arrival probability
    ``p_next``), ``"trace"`` (a ``[T, m]`` delay trace replayed by row
    ``t % T``), all clipped to ``[0, tau_max]``.
  * **staleness-discounted delivery** — an arrival aged ``d`` aggregates
    with weight ``gamma ** d`` (the engine applies it).

The buffer is updated functionally: ``step_buffer`` returns a fresh
``torch.where`` selection over the whole ring (43.8 MB at m = 100 on the
full-width CNN with ``tau_max = 4``, one pass a round), and ``drain``
returns copies, so the slot it read can be refilled in the same round
without aliasing.  No function reads a device value on the host.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng

_KINDS = ("det", "geom", "trace")


@dataclasses.dataclass(frozen=True)
class StalenessCfg:
    """Static semi-async config (fields and meaning as in the reference's
    ``StalenessCfg``).

    ``tau_max`` bounds every delay (the ring's depth; 0 disables the
    substrate).  ``kind`` picks the delay dynamics: ``"det"`` draws
    ``delay`` for every computing client, ``"geom"`` a geometric delay
    with per-round arrival probability ``p_next``, ``"trace"`` replays
    ``FLState.stale["dtrace"]`` row ``t % T``.  ``gamma`` is the discount
    base: a delivery aged ``d`` aggregates with weight ``gamma ** d``."""
    tau_max: int = 0
    kind: str = "det"
    delay: int = 1
    p_next: float = 0.5
    gamma: float = 1.0

    def __post_init__(self):
        if self.tau_max < 0:
            raise ValueError(f"tau_max must be >= 0; got {self.tau_max}")
        if self.kind not in _KINDS:
            raise ValueError(f"unknown delay kind {self.kind!r}; expected "
                             f"one of {_KINDS}")
        if self.delay < 0:
            raise ValueError(f"delay must be >= 0; got {self.delay}")
        if not 0.0 < self.p_next <= 1.0:
            raise ValueError(f"p_next must lie in (0, 1]; got {self.p_next}")
        if not 0.0 < self.gamma <= 1.0:
            raise ValueError(f"gamma must lie in (0, 1]; got {self.gamma}")

    @property
    def needs_state(self) -> bool:
        """The ring buffer is required whenever the substrate is on."""
        return self.tau_max > 0


def init_staleness_state(cfg: StalenessCfg | None, n: int, m: int, *,
                         dtrace=None, device=None):
    """Build the ``FLState.stale`` dict (or None when the substrate is
    off) on ``device``: ``buf`` ``[tau_max, m, n]`` pending innovations
    and ``ages`` ``[tau_max, m]``, both zero (float32); ``dtrace``
    (``[T, m]``, required for ``kind="trace"``) is the replayed per-client
    delay trace (see ``staircase_delay_trace``)."""
    if cfg is None or not cfg.needs_state:
        return None
    st = {
        "buf": torch.zeros((cfg.tau_max, m, n), dtype=torch.float32,
                           device=device),
        "ages": torch.zeros((cfg.tau_max, m), dtype=torch.float32,
                            device=device),
    }
    if cfg.kind == "trace":
        if dtrace is None:
            raise ValueError('kind="trace" needs a [T, m] per-client delay '
                             "trace")
        tr = torch.as_tensor(dtrace, dtype=torch.float32, device=device)
        if tr.dim() != 2:
            raise ValueError(f"dtrace must be [T, m]; got {tuple(tr.shape)}")
        st["dtrace"] = tr
    return st


def _slot(table, k):
    """``table[k]`` for a 0-d device index ``k``, as a copy."""
    return table.index_select(0, k.reshape(1))[0]


def draw_delay(cfg: StalenessCfg, stale_state, rng, t, m):
    """Per-client upload delay for updates computed at round ``t``:
    ``[m]`` int32 in ``[0, tau_max]``.  The engine splits one key for
    every kind, keeping the other streams aligned across dynamics."""
    dev = rng.device
    if cfg.kind == "det":
        d = torch.full((m,), cfg.delay, dtype=torch.int32, device=dev)
    elif cfg.kind == "geom":
        # failures-before-first-success with P(arrive next round) = p_next:
        # d = 1 + floor(log1p(-u) / log1p(-p_next)), all in float32
        u = prng.uniform(rng, (m,))
        if cfg.p_next >= 1.0:
            d = torch.ones((m,), dtype=torch.int32, device=dev)
        else:
            q = torch.log1p(-torch.full((), cfg.p_next, dtype=torch.float32,
                                        device=dev))
            d = 1 + torch.floor(torch.log1p(-u) / q).to(torch.int32)
    else:  # trace
        tr = stale_state["dtrace"]
        row = torch.remainder(t.long(), tr.shape[0])
        d = _slot(tr, row).to(torch.int32)
    return torch.clamp(d, 0, cfg.tau_max)


def busy_mask(stale_state):
    """``[m]`` float32: 1 where the client has an in-flight update (any
    occupied ring slot) — unavailable to compute until it delivers."""
    return (torch.amax(stale_state["ages"], dim=0) > 0).float()


def drain(stale_state, t):
    """Arrivals due at round ``t``: slot ``t % tau_max``.

    Returns ``(arrived [m] f32, arr_age [m] f32, arr_buf [m, N])``, copies
    of the slot (``arr_age`` holds each arrival's original delay, 0 where
    none)."""
    tau_max = stale_state["ages"].shape[0]
    k0 = torch.remainder(t.long(), tau_max)
    arr_age = _slot(stale_state["ages"], k0)
    arr_buf = _slot(stale_state["buf"], k0)
    arrived = (arr_age > 0).float()
    return arrived, arr_age, arr_buf


def step_buffer(stale_state, t, defer, d, G):
    """One round of ring bookkeeping: clear the drained slot
    ``t % tau_max``, then insert the deferred innovations (``defer`` [m]
    0/1, drawn delay ``d`` [m] int32 >= 1 where deferred) at their due
    slots ``(t + d) % tau_max``.

    Every update is a ``torch.where`` selection, never a multiply: a
    non-finite deferred row stays confined to its own slot and is only
    ever selected at its delivery round, where sanitization can still
    demote it."""
    ages, buf = stale_state["ages"], stale_state["buf"]
    tau_max = ages.shape[0]
    slots = torch.arange(tau_max, dtype=torch.int32,
                         device=ages.device)[:, None]          # [tau_max, 1]
    k0 = torch.remainder(t, tau_max)
    ages = torch.where(slots == k0, 0.0, ages)
    due = torch.remainder(t + d, tau_max)                      # [m]
    put = (slots == due[None, :]) & (defer[None, :] > 0)       # [tau_max, m]
    ages = torch.where(put, d[None, :].float(), ages)
    buf = torch.where(put[..., None], G[None], buf)
    return dict(stale_state, ages=ages, buf=buf)


def pending_count(stale_state):
    """Number of in-flight updates (occupied ring slots): over a run,
    sum(n_active) == sum(n_stale) + pending_count(final state) when every
    computed update passes through the ring."""
    return torch.sum((stale_state["ages"] > 0).float())


def staircase_delay_trace(rng, m, T, *, levels=(1, 2, 4), period=8):
    """A recorded-style per-client delay trace: ``[T, m]`` float32 delays
    cycling through ``levels`` every ``period`` rounds, with a per-client
    phase offset drawn from ``rng``; replayed via
    ``StalenessCfg(kind="trace")``."""
    phase = prng.randint(rng, (m,), 0, period)
    tt = torch.arange(T, dtype=torch.int64, device=rng.device)[:, None] \
        + phase[None, :]
    idx = torch.remainder(tt // period, len(levels))
    lv = torch.tensor(levels, dtype=torch.int32, device=rng.device)
    return lv[idx].float()
