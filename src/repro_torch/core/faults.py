"""Fault injection: client failure as a first-class executor dimension.

The port of the reference's ``core/faults.py``.  Each fault is a config
knob that composes with any ``AvailabilityCfg`` through the mask the
round engine already threads:

  * **mid-round dropout** — the availability mask splits in two:
    ``mask`` (drawn at round start, decides who runs local SGD) and
    ``mask_upload`` (a post-compute survival draw; only survivors
    contribute to aggregation, update their client state or advance τ).
    ``upload_survival`` is the per-client per-round P(computed update
    reaches the server).
  * **trace replay** — a ``[T, m]`` 0/1 trace riding in ``FLState.fault``
    overrides the sampled mask with row ``t mod T``.
  * **adversarial dynamics** — ``adversarial_probs_from_nu`` couples
    availability to the client label distributions ν, and ``blackout_*``
    zeroes a whole data cluster (``clusters`` labels in
    ``FLState.fault``) for B consecutive rounds.
  * **update sanitization** — non-finite or norm-exploded updates are
    detected in-round and the client is demoted to "dropped" (the engine
    scrubs its rows, so a 0-weighted NaN can never poison a ``w·G``
    reduction), with ``n_dropped`` / ``n_rejected`` counted per round.

Draws come from ``core/prng.py`` with the reference's keys, and the
survival threshold is compared as a float32 value, as JAX rounds the
Python float: ``mask_upload`` equals the reference's bit for bit.  No
function reads a device value on the host.  ``upload_mask_cohort`` is
the cohort round's variant (core/cohort.py): the same fates at O(c).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.availability import AvailabilityCfg, availability_trace
from repro_torch.core import prng
from repro_torch.core.tree_util import tree_leaves


@dataclasses.dataclass(frozen=True)
class FaultCfg:
    """Static fault-injection config (fields and meaning as in the
    reference's ``FaultCfg``).

    ``upload_survival`` < 1 enables the mid-round dropout draw; ``trace``
    replays ``FLState.fault["trace"]`` instead of the sampled compute
    mask; ``blackout_len`` > 0 zeroes clients whose
    ``FLState.fault["clusters"]`` label equals ``blackout_cluster`` for
    ``blackout_len`` rounds from ``blackout_start`` (recurring every
    ``blackout_every`` rounds when > 0); ``sanitize`` demotes clients with
    non-finite — or, with ``norm_cap`` > 0, norm-exploded — innovations
    to dropped for that round."""
    upload_survival: float = 1.0
    trace: bool = False
    blackout_start: int = 0
    blackout_len: int = 0
    blackout_every: int = 0
    blackout_cluster: int = 0
    sanitize: bool = False
    norm_cap: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.upload_survival <= 1.0:
            raise ValueError(f"upload_survival must lie in [0, 1]; got "
                             f"{self.upload_survival}")
        if self.norm_cap < 0.0:
            raise ValueError(f"norm_cap must be >= 0; got {self.norm_cap}")

    @property
    def mid_round(self) -> bool:
        return self.upload_survival < 1.0

    @property
    def needs_state(self) -> bool:
        """Does this config require arrays in ``FLState.fault``?"""
        return self.trace or self.blackout_len > 0


def init_fault_state(cfg: FaultCfg | None, *, trace=None, clusters=None):
    """Build the ``FLState.fault`` dict (or None when the config needs no
    carried arrays).

    ``trace``: ``[T, m]`` 0/1 availability replay (required when
    ``cfg.trace``); ``clusters``: ``[m]`` data-cluster labels (required
    when ``cfg.blackout_len > 0``; see ``clusters_from_nu``).  Tensors
    stay on their device; numpy arrays land on the CPU."""
    if cfg is None or not cfg.needs_state:
        return None
    st = {}
    if cfg.trace:
        if trace is None:
            raise ValueError("cfg.trace needs a [T, m] trace array")
        tr = torch.as_tensor(trace, dtype=torch.float32)
        if tr.dim() != 2:
            raise ValueError(f"trace must be [T, m]; got {tuple(tr.shape)}")
        st["trace"] = tr
    if cfg.blackout_len > 0:
        if clusters is None:
            raise ValueError("blackout_len > 0 needs [m] cluster labels "
                             "(clusters_from_nu)")
        st["clusters"] = torch.as_tensor(clusters, dtype=torch.int32)
    return st


def _row(table, t):
    """Row ``t mod T`` of a ``[T, m]`` table, ``t`` a 0-d device tensor
    (an index_select, so the host never reads ``t``)."""
    row = torch.remainder(t.long(), table.shape[0]).reshape(1)
    return table.index_select(0, row)[0]


def compute_mask(cfg: FaultCfg, fault_state, mask, t):
    """Round-start availability under faults.

    Trace replay OVERRIDES the sampled draw with row ``t mod T``;
    blackouts then zero the targeted cluster.  The availability draw is
    still consumed by the caller either way, keeping the other streams
    aligned across fault configs."""
    if cfg.trace:
        mask = _row(fault_state["trace"], t)
    if cfg.blackout_len > 0:
        tt = t - cfg.blackout_start
        if cfg.blackout_every:
            tt = torch.remainder(tt, cfg.blackout_every)
        hit = (t >= cfg.blackout_start) & (tt < cfg.blackout_len)
        target = fault_state["clusters"] == cfg.blackout_cluster
        mask = torch.where(hit & target, 0.0, mask)
    return mask


def update_norms_sq(G):
    """Per-client squared innovation norm over a client-stacked update:
    one ``[m]`` float32 vector whether ``G`` is the flat ``[m, N]`` buffer
    or a tree of ``[m, ...]`` leaves."""
    tot = None
    for leaf in tree_leaves(G):
        x = leaf.float().reshape(leaf.shape[0], -1)
        s = torch.sum(x * x, dim=1)
        tot = s if tot is None else tot + s
    return tot


def _fates(cfg: FaultCfg, survive_u, mask, G):
    """``upload_mask``'s body on given survival uniforms ``survive_u``
    (None without mid-round dropout)."""
    keep = mask
    dropped = torch.zeros((), dtype=torch.float32, device=mask.device)
    rejected = torch.zeros((), dtype=torch.float32, device=mask.device)
    if cfg.mid_round:
        # float32 threshold: JAX rounds the Python float to float32 before
        # the compare, so the mask agrees bit for bit
        thr = torch.full((), cfg.upload_survival, dtype=torch.float32,
                         device=mask.device)
        survive = (survive_u < thr).float()
        dropped = torch.sum(keep * (1.0 - survive))
        keep = keep * survive
    if cfg.sanitize:
        n2 = update_norms_sq(G)
        bad = ~torch.isfinite(n2)
        if cfg.norm_cap > 0.0:
            cap = torch.full((), cfg.norm_cap, dtype=torch.float32,
                             device=n2.device)
            bad = bad | (n2 > cap ** 2)
        badf = bad.float()
        rejected = torch.sum(keep * badf)
        keep = keep * (1.0 - badf)
    return keep, dropped, rejected


def upload_mask(cfg: FaultCfg, rng, mask, G):
    """Post-compute fate of each active client's update.

    Returns ``(mask_upload, n_dropped, n_rejected)``: the survival draw
    marks mid-round dropouts, then sanitization demotes non-finite /
    norm-exploded innovations.  ``mask_upload`` is the effective
    aggregation mask (``<= mask`` elementwise); a client dropped or
    rejected here behaves exactly as if it had never been sampled."""
    u = prng.uniform(rng, mask.shape) if cfg.mid_round else None
    return _fates(cfg, u, mask, G)


def upload_mask_cohort(cfg: FaultCfg, rng, m: int, idx, mask, G):
    """``upload_mask`` on the cohort: ``mask`` and ``G`` are the cohort's
    ``[c]`` and ``[c, N]``.  The survival draw is still taken over the
    full ``[m]`` population and gathered at ``idx``, so a client's fate
    depends on ``(rng, client index)`` alone, as in a dense round;
    sanitization runs on the ``[c, N]`` working set."""
    u = None
    if cfg.mid_round:
        u = torch.gather(prng.uniform(rng, (m,)), -1, idx)
    return _fates(cfg, u, mask, G)


def adversarial_probs_from_nu(nu, *, hot=0.9, cold=0.05):
    """Availability adversarially correlated with the client label
    distributions ν ``[m, C]``: clients whose dominant label falls in the
    first half of the classes participate at ``hot``, the rest at
    ``cold``.  Returns a ``[m]`` float32 base_p replacement."""
    nu = torch.as_tensor(nu, dtype=torch.float32)
    C = nu.shape[1]
    dom = torch.argmax(nu, dim=1)
    return torch.where(dom < C // 2, hot, cold).float()


def clusters_from_nu(nu):
    """``[m]`` int32 data-cluster labels — each client's dominant label
    under its Dirichlet ν draw (the first on ties, as ``jnp.argmax``)."""
    nu = torch.as_tensor(nu, dtype=torch.float32)
    return torch.argmax(nu, dim=1).to(torch.int32)


def diurnal_trace(rng, base_p, T, *, period=24, gamma=0.45):
    """A recorded-style diurnal availability trace: ``[T, m]`` 0/1 mask
    rows simulated from a sine-modulated process with a day-length
    ``period``, replayed via ``FaultCfg(trace=True)``."""
    cfg = AvailabilityCfg(kind="sine", gamma=gamma, period=period)
    return availability_trace(rng, cfg, base_p, T)
