"""Helpers over parameter trees: nested dicts of tensors, leaves in jax's
flatten order (dict keys sorted at every level).  Client-stacked trees
carry a leading client axis ``[m, ...]`` on every leaf (two, ``[S, m,
...]``, in the seed-batched round).  A bare tensor is a one-leaf tree.

The reference's helpers (``src/repro/core/tree_util.py``) with its
casts: arithmetic in float32, results cast back to the leaf dtype.
``tree_broadcast`` returns stride-0 ``expand`` views, not copies, so
nothing may write into its result in place."""
from __future__ import annotations

import torch


def tree_paths(tree, prefix=()):
    """``[(path, leaf)]`` in jax's flatten order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_paths(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_leaves(tree):
    return [leaf for _, leaf in tree_paths(tree)]


def tree_from_paths(paths, leaves):
    """Inverse of ``tree_paths``: nested dicts from paths and leaves."""
    out = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(f, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest))
                for k in tree}
    return f(tree, *rest)


def tree_stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_unstack(tree, m):
    return [tree_map(lambda x: x[i], tree) for i in range(m)]


def tree_broadcast(tree, m):
    """Replicate a tree along a new leading client axis (views)."""
    return tree_map(lambda x: x[None].expand((m,) + tuple(x.shape)), tree)


def tree_axpy(a, x, y):
    """a*x + y elementwise over matching trees."""
    return tree_map(lambda xx, yy: (a * xx.float() + yy.float())
                    .to(yy.dtype), x, y)


def tree_sub(x, y):
    return tree_map(lambda a, b: a - b, x, y)


def tree_add(x, y):
    return tree_map(lambda a, b: a + b, x, y)


def tree_scale(s, x):
    return tree_map(lambda a: (s * a.float()).to(a.dtype), x)


def tree_zeros_like(x):
    return tree_map(torch.zeros_like, x)


def _bshape(v, leaf):
    """Reshape per-client values v [m] (or [S, m]) to broadcast against
    leaf [m, ...] (or [S, m, ...])."""
    return v.reshape(tuple(v.shape) + (1,) * (leaf.dim() - v.dim()))


def tree_client_scale(v, tree):
    """Multiply each client's slice by v[i] (float32, cast back)."""
    return tree_map(lambda x: (x.float() * _bshape(v, x)).to(x.dtype), tree)


def tree_client_norm(tree, lead=1):
    """Per-client global L2 norm ``[m]`` (``[S, m]`` with ``lead=2``) of a
    client-stacked tree: each leaf's sum of squares, summed over leaves in
    flatten order."""
    return sum((x.float() * x.float()).reshape(x.shape[:lead] + (-1,))
               .sum(-1) for x in tree_leaves(tree)) ** 0.5


def tree_masked_mean(tree, mask):
    """Mean over the client axis restricted to mask == 1: zeros when no
    client is active (callers guard with the empty-round rule).  Returns
    a tree without the client axis."""
    w = mask.float()
    denom = torch.clamp(torch.sum(w), min=1.0)
    return tree_map(lambda x: (torch.sum(x.float() * _bshape(w, x), dim=0)
                               / denom).to(x.dtype), tree)


def tree_mean(tree):
    return tree_map(lambda x: torch.mean(x.float(), dim=0).to(x.dtype),
                    tree)


def tree_select(mask, a, b):
    """Per-client select: mask[i] ? a[i] : b[i] (leaves [m, ...])."""
    return tree_map(lambda x, y: torch.where(_bshape(mask, x) != 0, x, y),
                    a, b)


def tree_select_broadcast(mask, new_global, old_stack):
    """Active clients receive the (broadcast) new global; the others keep
    their state."""
    return tree_map(lambda g, o: torch.where(_bshape(mask, o) != 0,
                                             g[None].to(o.dtype), o),
                    new_global, old_stack)


def tree_dot(a, b):
    return sum(torch.vdot(x.float().reshape(-1), y.float().reshape(-1))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_norm(a):
    return torch.sqrt(tree_dot(a, a))


def global_norm_finite(tree):
    return torch.stack([torch.all(torch.isfinite(x))
                        for x in tree_leaves(tree)]).all()
