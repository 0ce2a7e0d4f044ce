"""Helpers over parameter trees: nested dicts of tensors, leaves in jax's
flatten order (dict keys sorted at every level).  Client-stacked trees
carry a leading client axis ``[m, ...]`` on every leaf (two, ``[S, m,
...]``, in the seed-batched round)."""
from __future__ import annotations


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
