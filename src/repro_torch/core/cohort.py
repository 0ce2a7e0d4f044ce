"""Sparse cohort substrate: O(cohort) rounds over an O(m) resident stack.

The port of the reference's ``core/cohort.py``.  The dense flat round
touches all ``[m, N]`` client rows every round although only the
available cohort computes; the cohort round (``FLConfig.sparse_cohort``)
works on the cohort's rows alone:

  * ``cohort_select`` — availability mask -> the round's cohort indices
    under a static cap ``c_max``, lowest client index first, with the
    actives beyond the cap counted in ``n_deferred`` (a deferred client
    does not compute this round: nothing it computed is ever dropped);
  * ``cohort_gather`` — resident rows -> a float32 ``[c, N]`` working
    set (the promote of the reduced-precision residency);
  * ``cohort_scatter`` — working rows -> the resident stack (the
    demote), by selection: unwritten slots write back the bytes they
    held and, on a stack below float32, a non-finite value keeps the old
    row instead of parking a NaN in the carry for good.

A resident stack may be stored in bfloat16 (``FLConfig.resident_dtype``,
``flatten.resident_dtype``): gather promotes, all round math runs in
float32, scatter demotes.  Promote-then-demote is the identity for
bfloat16, so rows a round does not write stay bit-stable.

In place: ``cohort_scatter`` writes into the resident stack it is given
(``index_copy_`` over the c distinct rows, deterministic, no atomics) and
returns it, as the reference's donated ``.at[idx].set`` aliases its
buffer.  A functional copy would move O(m·N) bytes a round, 5.47 GB at
m = 10⁵ in bfloat16: the cost the cohort exists to avoid.  The call
therefore CONSUMES the stack's old contents — and a cohort round
(``engine.make_round_fn``) consumes the state it is given: read the
state it returns, never the one passed in.

Every function also takes a leading seed axis: ``[S, m, N]`` stacks with
``[S, c]`` indices are gathered and written on the ``[S·m, N]`` view at
rows ``idx + j·m``, one gather and one ``index_copy_`` for all seeds.
"""
from __future__ import annotations

import torch


def cohort_select(mask, c_max: int):
    """Availability mask ``[m]`` -> ``(idx [c_max] int64, n_deferred)``.

    ``idx`` holds the ``c_max`` lowest-index active clients, then — when
    fewer are active — the lowest-index inactive clients as padding
    (their mask gathers to 0, so they carry zero weight downstream):
    always ``c_max`` distinct rows.  ``n_deferred`` (a 0-d float32)
    counts the actives beyond the cap, the highest indices."""
    m = mask.shape[-1]
    arange = torch.arange(m, device=mask.device)
    # actives sort by index, inactives by index + m: unique keys, so any
    # correct sort gives the reference's order
    order = torch.where(mask > 0, arange, arange + m)
    idx = torch.argsort(order, dim=-1)[..., :c_max]
    n_active = torch.sum((mask > 0).float(), dim=-1)
    n_deferred = torch.clamp(n_active - c_max, min=0.0)
    return idx, n_deferred


def _flat_rows(stack, idx):
    """``stack`` ``[..., m, N]`` as ``[rows, N]`` and ``idx`` ``[..., c]``
    as rows of that view (``idx + j·m`` for seed j)."""
    m = stack.shape[-2]
    if idx.dim() == 1:
        return stack, idx
    lead = torch.arange(idx.shape[0], device=idx.device)[:, None] * m
    return stack.view(-1, stack.shape[-1]), (idx + lead).reshape(-1)


def cohort_rows(resident, idx):
    """Resident rows at ``idx``, in the resident dtype: ``[..., c, N]``."""
    flat, rows = _flat_rows(resident, idx)
    return flat.index_select(0, rows).view(idx.shape + resident.shape[-1:])


def cohort_gather(resident, idx):
    """Gather-promote: resident rows at ``idx`` -> float32 ``[..., c,
    N]`` working rows."""
    return cohort_rows(resident, idx).float()


def cohort_payload(old, rows, write):
    """What ``cohort_scatter`` stores at the cohort's slots: ``rows``
    demoted to ``old``'s dtype where ``write`` > 0 (on a stack below
    float32 a non-finite value keeps ``old``), ``old``'s own bytes
    elsewhere.  ``old`` is the resident rows (``cohort_rows``)."""
    if old.dtype == torch.float32:
        new = rows
    else:
        new = torch.where(torch.isfinite(rows), rows,
                          old.float()).to(old.dtype)
    return torch.where(write[..., None] > 0, new, old)


def cohort_write(resident, idx, payload):
    """Write ``payload`` rows into ``resident`` at ``idx`` in place (one
    ``index_copy_`` over distinct rows); returns ``resident``."""
    flat, rows = _flat_rows(resident, idx)
    flat.index_copy_(0, rows, payload.reshape(-1, resident.shape[-1]))
    return resident


def cohort_scatter(resident, idx, rows, write):
    """Accumulate-demote: write float32 working ``rows`` back into the
    resident stack at ``idx`` where ``write`` > 0.  Writes in place and
    returns ``resident`` (see the module note): the old contents are
    consumed.  On a float32 stack the write is exact and unfiltered (NaN
    included); below float32 a non-finite value keeps the old row."""
    old = cohort_rows(resident, idx)
    return cohort_write(resident, idx, cohort_payload(old, rows, write))
