"""Flat parameter substrate: one contiguous buffer per model copy.

A ``FlatSpec`` ravels a trainable tree once (at ``init_fl_state``) into a
single contiguous ``[N]`` float32 vector — or ``[m, N]`` for the client
stack — recording per-leaf offsets, shapes and dtypes.  The leaf order is
jax's flatten order (dict keys sorted, so ``conv0/b`` precedes
``conv0/w``), which makes a row of the port's ``[m, N]`` stack equal,
element by element, to the JAX package's.

``unflatten``/``unflatten_stacked`` return ``narrow().view()`` views of
the buffer: for float32 leaves nothing is copied.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.core.tree_util import tree_from_paths, tree_paths

#: dtypes a resident [m, N] stack may be stored in
RESIDENT_DTYPES = ("float32", "bfloat16")


def resident_dtype(name: str) -> torch.dtype:
    """Validate a residency dtype name -> ``torch.dtype`` (int8 is
    reserved in the reference, and rejected here the same way)."""
    if name == "int8":
        raise NotImplementedError(
            "resident_dtype='int8' is reserved: integer residency needs "
            "per-row quantization scales alongside the stack; use "
            "'bfloat16' for compressed residency today")
    if name not in RESIDENT_DTYPES:
        raise ValueError(
            f"unknown resident_dtype {name!r}; expected one of "
            f"{RESIDENT_DTYPES}")
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    paths: Tuple[Tuple[str, ...], ...]   # leaf paths, flatten order
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    size: int                            # N = sum(sizes)

    @classmethod
    def from_tree(cls, tree) -> "FlatSpec":
        """Build the spec from a template tree (no leading client axis)."""
        pl = tree_paths(tree)
        if not pl:
            raise ValueError("FlatSpec needs at least one leaf")
        shapes = tuple(tuple(int(d) for d in leaf.shape) for _, leaf in pl)
        sizes = tuple(math.prod(s) for s in shapes)
        offsets, off = [], 0
        for s in sizes:
            offsets.append(off)
            off += s
        return cls(tuple(p for p, _ in pl), shapes,
                   tuple(leaf.dtype for _, leaf in pl), tuple(offsets),
                   sizes, off)

    @property
    def n_leaves(self) -> int:
        return len(self.sizes)

    def _leaves(self, tree):
        pl = tree_paths(tree)
        if tuple(p for p, _ in pl) != self.paths:
            raise ValueError("tree structure does not match the FlatSpec")
        return [leaf for _, leaf in pl]

    def flatten(self, tree) -> torch.Tensor:
        """Ravel one model tree into an [N] float32 vector."""
        return torch.cat([leaf.reshape(-1).float()
                          for leaf in self._leaves(tree)])

    def flatten_stacked(self, tree) -> torch.Tensor:
        """Ravel a client-stacked tree (leaves [m, ...], or [S, m, ...])
        into [m, N] (or [S, m, N])."""
        leaves = self._leaves(tree)
        lead = leaves[0].shape[:leaves[0].dim() - len(self.shapes[0])]
        return torch.cat([leaf.reshape(lead + (-1,)).float()
                          for leaf in leaves], dim=-1)

    def unflatten(self, flat) -> dict:
        """[N] vector -> tree of views with the recorded shapes/dtypes."""
        leaves = [flat.narrow(0, o, s).view(shp).to(dt)
                  for o, s, shp, dt in zip(self.offsets, self.sizes,
                                           self.shapes, self.dtypes)]
        return tree_from_paths(self.paths, leaves)

    def unflatten_stacked(self, flat) -> dict:
        """[m, N] client stack -> tree of [m, ...] views ([S, m, N] ->
        [S, m, ...] views)."""
        lead = tuple(flat.shape[:-1])
        leaves = [flat.narrow(-1, o, s).view(lead + shp).to(dt)
                  for o, s, shp, dt in zip(self.offsets, self.sizes,
                                           self.shapes, self.dtypes)]
        return tree_from_paths(self.paths, leaves)

    def leaf_views(self, flat):
        """Per-leaf views of an [N] or [m, N] (or [S, m, N]) buffer, in
        the buffer's dtype (no cast: ``unflatten`` gives the leaf
        dtypes)."""
        lead = tuple(flat.shape[:-1])
        return [flat.narrow(-1, o, s).view(lead + shp)
                for o, s, shp in zip(self.offsets, self.sizes, self.shapes)]
