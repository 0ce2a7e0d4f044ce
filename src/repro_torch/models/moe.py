"""Mixture-of-Experts layer: sort-based capacity dispatch; a port of
``repro/models/moe.py``.

Routing and capacity are the reference's.  The router runs in float32:
softmax, top-k, the top-k weights renormalised, and the Switch
load-balance loss.  Each sequence routes on its own, as the reference's
``vmap`` of ``_moe_seq`` over the batch does, with
``cap = int(max(1, round(cf * L * k / E)))`` slots per expert.  An
overfull expert keeps the slots with the lowest flat index ``t * k + j``,
the order of the reference's stable argsort.

The port dispatches the whole batch at once instead of looping over the
sequences.  One stable sort on the key ``e * B + b`` ranks the slots of
each (expert, sequence) group in flat order, so a rank never crosses
sequences, and the dispatch buffer comes out expert-major,
``[E, B * cap, d]``, ready for one batched SwiGLU in cuBLAS (``torch.bmm``:
the reference leaves its einsum to XLA, outside any Pallas kernel).
Everything else is indexing.  Each buffer row gathers its token, or a
zero row past the group's count.  Each slot gathers its expert output, or
a zero row when it was dropped.  The k weighted contributions of a token
are then laid out as ``[T, k, d]`` and summed over k.  There is no
scatter-add, so no atomics, and two prefills give the same bits.  The
reference's ``.at[st].add`` sums the same k terms in its sorted order, so
the two differ by the rounding of a k-term sum.  Nothing is written in
place or through ``out=``, so the layer also runs under the client
``torch.func.vmap`` of local SGD, and the router's loss carries its
gradient through the mean router probabilities, as the reference's does
(the top-1 fractions, counts, carry none).

Over DTensors (a step placed over a device mesh, ``launch/dryrun.py``)
the dispatch plan is one ``local_map`` region: the routing is
replicated and every rank computes the whole plan, replicated
(``models/placed.py``).  ``_constrain_expert_buffer`` is the reference's
sharding hint on the ``[E, B * cap, d]`` expert buffer, read from
``REPRO_MOE_CONSTRAIN``: "1" redistributes it to ``Shard(0)`` over
'model' (experts sharded: the tokens travel to the experts' ranks), "D"
to ``Shard(2)`` over 'data' (the feature dim, to meet 'data'-sharded
expert weights); on a plain tensor it does nothing.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch.models.layers import swiglu
from repro_torch.models.placed import batch_rows, is_placed, placed_like


def _route(x, router_w, top_k):
    """x: [B, L, d] -> (weights [B, L, k] f32, idx [B, L, k] int64, aux
    [B] f32), each sequence's load-balance loss on its own."""
    B, L, _ = x.shape
    E = router_w.shape[-1]
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)  # [B, L, E]
    topw, topi = torch.topk(probs, top_k, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True)
    me = probs.mean(1)  # mean router prob per expert
    # fraction of tokens whose top-1 is e: counts of 0/1 terms, exact in
    # float32 whatever the order of the adds (and without a gradient, as
    # the reference's one-hot has none)
    top1 = topi[..., 0, None] == placed_like(
        torch.arange(E, device=x.device), topi, replicate=True)
    fe = top1.float().sum(1) / L
    return topw, topi, E * (me * fe).sum(-1)


def router_topk(x, router_w, top_k):
    """x: [T, d] -> (weights [T, k] f32, idx [T, k] int64, aux scalar)."""
    topw, topi, aux = _route(x[None], router_w, top_k)
    return topw[0], topi[0], aux[0]


def capacity(cfg, L):
    """Slots per expert and sequence of L tokens: the reference's
    expression, Python's round (half to even) on host numbers."""
    S = L * cfg.top_k
    return int(max(1, round(cfg.capacity_factor * S / cfg.n_experts)))


def dispatch(topi, n_experts, cap):
    """The dispatch plan of the routing ``topi`` [B, L, k].

    Returns ``src`` [E * B * cap]: the token row (of the [B * L] tokens)
    each buffer row reads, B * L (a zero row) past its group's count;
    ``dest`` [B * L * k]: the expert-output row of each slot ``(b, t, j)``,
    E * B * cap (a zero row) when the slot was dropped; ``keep``
    [B * L * k], whether it was kept.  Buffer row ``(e * B + b) * cap + r``
    holds rank r of expert e in sequence b."""
    B, L, k = topi.shape
    n, G, dev = B * L * k, n_experts * B, topi.device
    seq = torch.arange(B, device=dev).repeat_interleave(L * k)
    group = topi.reshape(n) * B + seq
    sgroup, order = torch.sort(group, stable=True)
    groups = torch.arange(G, device=dev)
    starts = torch.searchsorted(sgroup, groups)
    count = torch.searchsorted(sgroup, groups, right=True) - starts
    rank = torch.arange(n, device=dev) - starts[sgroup]
    dest_sorted = torch.where(rank < cap, sgroup * cap + rank, G * cap)
    # order is a permutation: the scatter overwrites every element
    dest = dest_sorted.scatter(0, order, dest_sorted)
    r = torch.arange(cap, device=dev)
    pos = (starts[:, None] + r).clamp(max=n - 1)
    src = torch.where(r < count[:, None], order[pos] // k, B * L)
    return src.reshape(-1), dest, dest < G * cap


def _dispatch_plan(topi, n_experts, cap):
    """``dispatch``; over DTensors one ``local_map`` region: ``topi``
    replicated, the plan computed on every rank and replicated."""
    if not is_placed(topi):
        return dispatch(topi, n_experts, cap)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    R = (Replicate(),) * topi.device_mesh.ndim
    return local_map(lambda t: dispatch(t, n_experts, cap),
                     out_placements=(R, R, R), in_placements=(R,),
                     device_mesh=topi.device_mesh,
                     redistribute_inputs=True)(topi)


def _constrain_expert_buffer(eb, E):
    """The sharding hint on the ``[E, B * cap, d]`` expert buffer
    (``REPRO_MOE_CONSTRAIN``, module note): "1" -> ``Shard(0)`` over
    'model', "D" -> ``Shard(2)`` over 'data', every other mesh dim
    replicated; unset or "0", a plain tensor, or a mesh without that
    axis: ``eb`` as it is."""
    mode = os.environ.get("REPRO_MOE_CONSTRAIN", "0")
    if mode == "0" or not is_placed(eb):
        return eb
    from torch.distributed.tensor import Replicate, Shard

    axis, dim = ("data", 2) if mode == "D" else ("model", 0)
    names = eb.device_mesh.mesh_dim_names or ()
    if axis not in names:
        return eb
    return eb.redistribute(placements=[
        Shard(dim) if n == axis else Replicate() for n in names])


def moe_ffn(x, bp, cfg):
    """x: [B, L, d] -> (y, aux_loss).

    bp: router [d, E] (float32), wi_e [E, d, 2 * eff], wd_e [E, eff, d],
    optional wi_s / wd_s: the shared experts' SwiGLU, added on every
    token.  aux is the mean over the sequences of their router losses."""
    B, L, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    topw, topi, aux = _route(x, bp["router"], k)
    cap = capacity(cfg, L)
    src, dest, keep = _dispatch_plan(topi, E, cap)
    xt = x.reshape(B * L, d)
    eb = torch.cat([xt, xt.new_zeros(1, d)]).index_select(0, src)
    eb = _constrain_expert_buffer(eb.view(E, B * cap, d), E)
    g, u = torch.bmm(eb, bp["wi_e"]).chunk(2, dim=-1)
    # the expert outputs and a zero row for the dropped slots
    out = F.pad(torch.bmm(F.silu(g) * u, bp["wd_e"]).view(E * B * cap, d),
                (0, 0, 0, 1))
    w = topw.reshape(-1).to(x.dtype) * keep
    y = (out.index_select(0, dest) * w[:, None]).view(B * L, k, d).sum(1)
    if cfg.n_shared_experts and "wi_s" in bp:
        y = y + swiglu(xt, bp["wi_s"], bp["wd_s"])
    # over DTensors the tokens' rows go back to the input's batch shards
    # first: torch 2.13's view mis-sizes a dim sharded on two mesh dims
    return batch_rows(y, xt).view(B, L, d), aux.mean()


def moe_ffn_dense_ref(x, bp, cfg):
    """Plain version: every expert evaluated on every token and combined
    (O(E) compute).  Tests and ``chip_smoke.py`` hold ``moe_ffn`` against
    it; equal to it when no slot is dropped (capacity_factor >= E).  The
    aux loss is averaged over the sequences, as ``moe_ffn`` routes them."""
    B, L, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(B * L, d)
    aux = _route(x, bp["router"], k)[2].mean()
    topw, topi, _ = router_topk(xt, bp["router"], k)
    g, u = torch.einsum("td,edf->tef", xt, bp["wi_e"]).chunk(2, dim=-1)
    all_out = torch.einsum("tef,efd->ted", F.silu(g) * u, bp["wd_e"])
    comb = torch.zeros(B * L, E, dtype=x.dtype, device=x.device)
    for j in range(k):
        comb = comb + F.one_hot(topi[:, j], E).to(x.dtype) \
            * topw[:, j:j + 1].to(x.dtype)
    y = torch.einsum("te,ted->td", comb, all_out)
    if cfg.n_shared_experts and "wi_s" in bp:
        y = y + swiglu(xt, bp["wi_s"], bp["wd_s"])
    return y.view(B, L, d), aux
