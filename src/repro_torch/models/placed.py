"""The model's steps over DTensors: the regions that run on each rank's
block (``local_map``) and the constants a step makes, placed.

A serving step placed over a device mesh (``launch/dryrun.py``) takes
DTensor parameters, caches and inputs, and DTensor's sharding
propagation decides where its collectives go, as XLA's SPMD partitioner
does for the reference.  Six regions run on local blocks instead,
each with its placements fixed here (``local_map``, inputs redistributed
to them):

  * ``local_attention``, the attention core (self-attention plain or
    K4, the encoder's and the cross-attention's plain): per mesh
    dim, the batch keeps a shard of its dim 0; the heads keep a shard of
    dim 2 where the kv heads divide over that mesh dim (q, k and v
    alike, so each rank's query heads read its own kv heads); the plain
    attention's queries keep a shard of their sequence (dim 1) with the
    keys, values and key positions replicated (``seq_shard``); every
    other dim is replicated.  The output takes the queries' placements.
    DTensor's own propagation of the grouped-head einsum makes a strided
    shard of the merged (batch, head) dim, which torch 2.13 cannot place
    under ``FakeTensorMode``, and K4 has no sharding strategy.
  * ``decode_attention``, decode's attention over a cache whose slots are
    sharded: each rank scores its block of slots (q and its positions
    keep the cache's batch shard and are otherwise replicated), keeps its
    block's running max, softmax sum and unnormalised output, and the
    blocks combine as flash decoding does: the maxima are returned
    ``Partial("max")`` and reduced, each block's sum and output rescaled
    by ``exp(m_block - m)`` and returned ``Partial("sum")``.
  * ``local_mixer``, a Mamba2 block's mixer in prefill and decode (the
    depthwise conv and the SSD scan through K5, written with ``out=``
    and in-place cache writes): the input and the cache keep their batch
    shard (dim 0; the cache keeps its own placements, so the writes land
    in it), every weight is replicated; the output takes the input's
    placements.
  * ``embed``, the token lookup in a vocab-sharded table: the table
    keeps its vocab shard (dim 0) and is otherwise replicated, the tokens
    keep their batch shard on the other mesh dims; each rank looks up
    the tokens in its rows (zeros for the others'), and the blocks' sum
    is reduced once, to the tokens' batch shards (a reduce-scatter where
    the tokens were split over a vocab-sharded mesh dim, as a training
    batch over 'model' is).  DTensor's own strategy
    for ``embedding`` (``MaskPartial``) loses its mask at the second
    reduction of the residual stream.
  * ``write_cache``, the prefill's and decode's write of K/V/positions at
    their cache slots: the cache keeps its placements (batch over
    'data', slots over 'model' by ``cache_pspecs``); the values and slots
    keep the cache's batch shard and are otherwise replicated; each rank
    writes the slots that fall in its block.
  * ``local_dispatch`` (``models/moe.py``), the MoE dispatch plan (stable
    sort, ``searchsorted``, gathers over the whole batch): the routing is
    replicated and the plan computed on every rank, replicated.

Between blocks the residual stream is brought back to the embedding's
placements (``keep_placements``): left to propagation it would gather
partial sums and new shardings layer after layer, and each new layout is
a new (slow) search for DTensor's redistribution planner.  The MoE
layer's output rows go back to its input's batch shards
(``batch_rows``) before their view.

``placed_like`` makes a tensor built inside a step (positions, rope
frequencies) a DTensor beside the step's own, with no communication.  On
plain tensors every function here calls the plain code as it is.
"""
from __future__ import annotations

import sys

import torch


def is_placed(t) -> bool:
    """Whether ``t`` is a DTensor (a step placed over a device mesh).  No
    DTensor exists before ``torch.distributed.tensor`` is imported, so a
    plain step pays one dictionary lookup, not the import."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def placed_like(t, ref, *, replicate=False):
    """``t``, a tensor made inside a step (positions, rope frequencies, a
    row index), held as ``ref`` holds its tensors: where ``ref`` is a
    DTensor, a DTensor on its mesh with ``ref``'s placements (``t`` of
    ``ref``'s shape) or, with ``replicate``, replicated; else ``t``
    itself.  Each rank keeps its own block of ``t``: nothing is
    communicated."""
    if not is_placed(ref):
        return t
    from torch.distributed.tensor import Replicate, distribute_tensor

    mesh = ref.device_mesh
    pl = [Replicate()] * mesh.ndim if replicate else ref.placements
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def split_heads(y, n_heads, head_dim):
    """``y [B, L, n_heads * head_dim]`` viewed ``[B, L, n_heads,
    head_dim]``.  On a DTensor whose last dim is sharded over more ranks
    than the heads divide into, that dim is first replicated (DTensor
    cannot split a head across ranks)."""
    B, L = y.shape[:2]
    if is_placed(y):
        from torch.distributed.tensor import Replicate

        mesh, pl = y.device_mesh, list(y.placements)
        last = [i for i, p in enumerate(pl) if _shard_dim(p) == y.dim() - 1]
        k = 1
        for i in last:
            k *= mesh.size(i)
        if n_heads % k:
            for i in last:
                pl[i] = Replicate()
            y = y.redistribute(placements=pl)
    return y.reshape(B, L, n_heads, head_dim)


def keep_placements(h, ref):
    """``h`` with ``ref``'s placements where both are DTensors (one
    redistribution, a sum of partials or a gather where they differ);
    else ``h``."""
    if not is_placed(h) or h.placements == ref.placements:
        return h
    return h.redistribute(placements=ref.placements)


def batch_rows(y, ref):
    """``y`` with ``ref``'s shards of dim 0 (its batch rows) and
    replicated on every other mesh dim, where both are DTensors; else
    ``y``."""
    if not is_placed(y):
        return y
    from torch.distributed.tensor import Replicate, Shard

    return y.redistribute(placements=[
        Shard(0) if _shard_dim(p) == 0 else Replicate()
        for p in ref.placements])


def _shard_dim(p):
    from torch.distributed.tensor import Shard

    return p.dim if isinstance(p, Shard) else None


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(x):
    """``x``, with its gradient made contiguous on the way back where a
    gradient is recorded: a region's input gradients come back from its
    local backward in whatever strides it left, and DTensor's ``view``
    rule (the projections' backward views ``[B, L, n] -> [B·L, n]``)
    does not reshape a non-contiguous local block."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ContiguousGrad.apply(x)
    return x


class _GradLikeForward(torch.autograd.Function):
    """The identity on a DTensor, whose backward redistributes the
    gradient to the forward's placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g.placements != ctx.placements:
            g = g.redistribute(placements=ctx.placements)
        return g


def reduce_partial(x):
    """``x`` with every partial sum of its placements reduced (the
    residual stream after a tensor-parallel projection: one all-reduce
    a sub-block, the "g" operator); plain tensors as they are."""
    if not is_placed(x):
        return x
    from torch.distributed.tensor import Partial, Replicate

    pl = tuple(Replicate() if isinstance(p, Partial) else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(placements=pl)


def grad_like_forward(x):
    """``x``; on a DTensor through which a gradient is recorded, its
    gradient comes back with ``x``'s placements (one reduction of a
    partial sum, or a local slice of a replicated gradient).  Placed on
    a block's normed input (the tensor-parallel "f" operator): without
    it DTensor keeps the residual stream's gradient a partial sum, and
    every weight gradient after it is computed whole on every rank and
    reduced at the end."""
    if is_placed(x) and torch.is_grad_enabled() and x.requires_grad:
        return _GradLikeForward.apply(x)
    return x


def local_attention(body, q, k, v, q_pos, k_pos, *, keep_seq):
    """``body(q, k, v, q_pos, k_pos)`` (q ``[B, L, H, D]``, k and v ``[B,
    S, K, D]``, positions ``[B, L]`` / ``[B, S]``) on each rank's block
    when ``q`` is a DTensor, with the placements of the module note
    (``keep_seq``: the queries may keep a sequence shard, the plain
    attention's end-aligned-free masks allow it; K4's do not); else
    ``body`` on the tensors as they are."""
    if not is_placed(q):
        return body(q, k, v, q_pos, k_pos)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    B, K = q.shape[0], k.shape[2]
    R = Replicate()
    pq, pkv, pqp, pkp = [], [], [], []
    for i, p in enumerate(q.placements):
        n, d = mesh.size(i), _shard_dim(p)
        if d == 0 and B % n == 0:
            row = (Shard(0), Shard(0), Shard(0), Shard(0))
        elif d == 2 and K % n == 0:
            row = (Shard(2), Shard(2), R, R)
        elif d == 1 and keep_seq:
            row = (Shard(1), R, Shard(1), R)
        else:
            row = (R, R, R, R)
        for out, pl in zip((pq, pkv, pqp, pkp), row):
            out.append(pl)
    pq, pkv, pqp, pkp = map(tuple, (pq, pkv, pqp, pkp))
    q, k, v = (contiguous_grad(t) for t in (q, k, v))
    return local_map(body, out_placements=(pq,),
                     in_placements=(pq, pkv, pkv, pqp, pkp),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, q_pos, k_pos)


def _block_start(mesh, placements, shape, dim):
    """The index along ``dim`` of this rank's first element of a tensor
    of global ``shape`` held on ``mesh`` with ``placements`` (sharded
    evenly, at most once per mesh dim).  Shapes only: nothing is moved."""
    coord = mesh.get_coordinate()
    start, size = 0, shape[dim]
    for i, p in enumerate(placements):
        if _shard_dim(p) == dim:
            size //= mesh.size(i)
            start += coord[i] * size
    return start


def write_cache(dst, slots, val):
    """``dst[b, slots[b, j]] = val[b, j]`` in place: dst ``[B, A, ...]``
    (a cache), slots ``[B, T]`` (distinct per row), val ``[B, T, ...]``.
    On a DTensor cache each rank writes the slots of its block (the
    module note's placements)."""
    if not is_placed(dst):
        bidx = torch.arange(dst.shape[0], device=dst.device)[:, None]
        dst[bidx, slots] = val.to(dst.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    R = Replicate()
    pdst = tuple(dst.placements)
    prow = tuple(Shard(0) if _shard_dim(p) == 0 else R for p in pdst)
    lo = _block_start(dst.device_mesh, pdst, dst.shape, 1)

    def body(d, s, x):
        a = d.shape[1]
        bidx = torch.arange(d.shape[0], device=d.device)[:, None]
        idx = s - lo
        # the slots of other ranks' blocks land on a scratch row
        idx = torch.where((idx >= 0) & (idx < a), idx, a)
        ext = torch.cat([d, d[:, :1]], dim=1)
        ext[bidx, idx] = x.to(d.dtype)
        return d.copy_(ext[:, :a])

    local_map(body, out_placements=(pdst,), in_placements=(pdst, prow, prow),
              device_mesh=dst.device_mesh, redistribute_inputs=True)(
        dst, slots, val)


def decode_attention(scores, q, k_cache, v_cache, q_pos, cache_pos):
    """Decode attention over a DTensor cache, combined over the mesh dims
    that shard its slots (the module note).  ``scores(q, k_cache, q_pos,
    cache_pos)`` gives a block's masked float32 scores ``[B, K, G, 1,
    S]``; returns ``[B, 1, H, D]`` in the cache's dtype."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = k_cache.device_mesh
    R = Replicate()
    pc = tuple(k_cache.placements)
    dims = [_shard_dim(p) for p in pc]
    prow = tuple(Shard(0) if d == 0 else R for d in dims)
    pmax = tuple(Shard(0) if d == 0 else Partial("max") if d == 1 else R
                 for d in dims)
    psum = tuple(Partial("sum") if p == Partial("max") else p for p in pmax)

    def block(q, kc, vc, qp, cp):
        s = scores(q, kc, qp, cp)                           # [B,K,G,1,S]
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        o = torch.einsum("bkgls,bskd->blkgd", p.to(vc.dtype), vc)
        # statistics in the output's layout [B, 1, K, G, 1]
        return (m.permute(0, 3, 1, 2, 4), p.sum(-1, keepdim=True)
                .permute(0, 3, 1, 2, 4), o.float())

    m, l, o = local_map(block, out_placements=(pmax, psum, psum),
                        in_placements=(prow, pc, pc, prow, pc),
                        device_mesh=mesh, redistribute_inputs=True)(
        q, k_cache, v_cache, q_pos, cache_pos)
    top = m.redistribute(placements=prow)

    def rescale(m, top, l, o):
        w = torch.exp(m - top)
        return l * w, o * w

    l, o = local_map(rescale, out_placements=(psum, psum),
                     in_placements=(pmax, prow, psum, psum),
                     device_mesh=mesh)(m, top, l, o)
    o = o.redistribute(placements=prow) / l.redistribute(placements=prow)
    B, _, K, G, D = o.shape
    return o.reshape(B, 1, K * G, D).to(v_cache.dtype)


def embed(table, tokens):
    """``table[tokens]`` (table ``[V, d]``, tokens ``[B, L]``) over
    DTensors: the module note's region, the result ``[B, L, d]`` with the
    tokens' batch placements and replicated elsewhere."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    R = Replicate()
    vocab = [_shard_dim(p) == 0 for p in table.placements]
    ptab = tuple(Shard(0) if v else R for v in vocab)
    ptok = tuple(R if v else (Shard(0) if _shard_dim(p) == 0 else R)
                 for v, p in zip(vocab, tokens.placements))
    pout = tuple(Partial("sum") if v else p for v, p in zip(vocab, ptok))
    lo = _block_start(mesh, ptab, table.shape, 0)

    def lookup(t, tok):
        idx = tok - lo
        inside = (idx >= 0) & (idx < t.shape[0])
        rows = t[torch.where(inside, idx, 0)]
        return rows * inside[..., None].to(rows.dtype)

    # the table's gradient: its vocab blocks, and a partial sum over the
    # mesh dims the tokens keep a batch shard on
    gtab = tuple(Shard(0) if v else (Partial() if _shard_dim(p) == 0 else R)
                 for v, p in zip(vocab, ptok))
    out = local_map(lookup, out_placements=(pout,), in_placements=(ptab,
                                                                   ptok),
                    in_grad_placements=(gtab, ptok), device_mesh=mesh,
                    redistribute_inputs=True)(table, tokens)
    # the blocks' sum lands on the tokens' own batch shards: where the
    # tokens were gathered for a vocab-sharded table (a batch over 'model'
    # in training), a reduce-scatter keeps their batch split
    return out.redistribute(placements=tuple(
        Shard(0) if _shard_dim(p) == 0 else R for p in tokens.placements))


def local_mixer(body, x, params, cache):
    """``body(x, params, cache)`` (a Mamba2 mixer; ``cache`` a dict or
    None, written in place) on each rank's batch block when ``x`` is a
    DTensor, with the module note's placements; else as it is."""
    if not is_placed(x):
        return body(x, params, cache)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    R = Replicate()
    pb = tuple(Shard(0) if _shard_dim(p) == 0 else R for p in x.placements)
    names = sorted(params)
    held = sorted(cache or {})
    pw = tuple(R for _ in x.placements)

    def block(x, *leaves):
        w = dict(zip(names, leaves[:len(names)]))
        c = dict(zip(held, leaves[len(names):])) if cache is not None \
            else None
        return body(x, w, c)

    # each rank's weight gradient covers its batch block only: a partial
    # sum over the mesh dims the batch is sharded on
    gw = tuple(Partial() if _shard_dim(p) == 0 else R for p in x.placements)
    in_pl = ((pb,) + (pw,) * len(names)
             + tuple(tuple(cache[k].placements) for k in held))
    return local_map(
        block, out_placements=(pb,), in_placements=in_pl,
        in_grad_placements=(pb,) + (gw,) * len(names) + in_pl[1 + len(names):],
        device_mesh=x.device_mesh, redistribute_inputs=True)(
        x, *(params[k] for k in names), *(cache[k] for k in held))


def token_nll_sum(logits, labels, mask):
    """``sum((logsumexp(logits) - logits[labels]) * mask)`` over every
    token (logits ``[..., V]`` float32, labels and mask ``[...]``).  On a
    DTensor whose vocab (last dim) is sharded, the vocab-parallel
    cross-entropy of the module note: each rank takes its block's maximum
    (``Partial("max")``, reduced), its block's sum of exponentials and
    the logit of each label that falls in its block (both
    ``Partial("sum")``); the token rows keep their batch shard (dim 0),
    every other dim is replicated.  DTensor's own ``gather`` on sharded
    logits goes through ``MaskPartial``, which fails on the gathered
    rows' shape."""
    if not is_placed(logits):
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return torch.sum((logz - ll) * mask)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    last = logits.dim() - 1
    R = Replicate()
    dims = [_shard_dim(p) for p in logits.placements]
    plog = tuple(Shard(last) if d == last else Shard(0) if d == 0 else R
                 for d in dims)
    prow = tuple(Shard(0) if d == 0 else R for d in dims)
    pmax = tuple(Partial("max") if d == last else p
                 for d, p in zip(dims, prow))
    psum = tuple(Partial("sum") if d == last else p
                 for d, p in zip(dims, prow))
    lo = _block_start(mesh, plog, logits.shape, last)

    def block_stats(lg, lab):
        idx = lab.long() - lo
        inside = (idx >= 0) & (idx < lg.shape[-1])
        ll = torch.gather(lg, -1, torch.where(inside, idx, 0)[..., None])
        return lg.detach().amax(-1), ll[..., 0] * inside.to(lg.dtype)

    def block_sumexp(lg, top):
        return torch.exp(lg - top[..., None]).sum(-1)

    top, ll = local_map(block_stats, out_placements=(pmax, psum),
                        in_placements=(plog, prow), device_mesh=mesh,
                        redistribute_inputs=True)(logits, labels)
    top = top.redistribute(placements=prow)
    s = local_map(block_sumexp, out_placements=(psum,),
                  in_placements=(plog, prow), device_mesh=mesh,
                  redistribute_inputs=True)(logits, top)
    logz = top + torch.log(s.redistribute(placements=prow))
    return torch.sum((logz - ll.redistribute(placements=prow)) * mask)
