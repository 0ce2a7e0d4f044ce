"""A rank's block of the client axis under a process group: explicit SPMD,
the counterpart of the reference's GSPMD client sharding.

One process per device.  Each rank holds plain local tensors, its own
rows of every client-stacked buffer (``flat_pspecs``: the ``[m, N]``
stacks, the ``[m]`` vectors, the fault carry's ``[T, m]`` columns, the
stale ring's ``[tau_max, m, N]`` rows, the sampler's ``[m, cap]`` rows),
and every reduction over the client axis is an explicit all-reduce over
the ranks that share the rank's seed shard (``client_sum``).  The
``[N]`` global, the keys and the scalars are replicated, and every draw
over ``[m]`` is made whole on each rank from the replicated key, then
sliced (``rows_of``): masks, delays and keys are the unplaced run's bits.

``client_sum`` and ``rows_of`` take ``place=None`` and then do nothing,
so the unplaced round runs exactly as before.  The all-reduce is the
custom operator ``repro_torch::client_all_reduce``, whose vmap rule
reduces a seed-batched tensor in one collective (the seed-batched round
runs its aggregation under ``torch.func.vmap``).
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ClientPlacement:
    """Rows ``[lo, hi)`` of ``m`` clients, and the process group (by name)
    of the ranks that hold the other blocks of the same clients."""
    m: int
    lo: int
    hi: int
    group: str

    @property
    def rows(self) -> int:
        return self.hi - self.lo

    def take(self, x, dim=0):
        """The rank's rows (a view) of a whole ``[..., m, ...]`` tensor
        or array, client axis ``dim``."""
        if x.shape[dim] != self.m:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} is not the "
                             f"{self.m} clients")
        lead = (slice(None),) * (dim % x.ndim)
        return x[lead + (slice(self.lo, self.hi),)]


def rows_of(x, place, dim=0):
    """``x``'s client rows under ``place``; ``x`` itself without one."""
    return x if place is None else place.take(x, dim)


def client_sum(x, place):
    """Sum of ``x`` over the ranks of ``place``'s group (each rank's
    partial over its rows); ``x`` itself without a placement."""
    return x if place is None else _client_all_reduce(x, place.group)


def n_clients(x, place, dim=0):
    """The population ``m`` a mean over clients divides by: the global
    count under a placement, not the rank's row count."""
    return x.shape[dim] if place is None else place.m


def _group(name):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name)


@torch.library.custom_op("repro_torch::client_all_reduce", mutates_args=())
def _client_all_reduce(x: torch.Tensor, group: str) -> torch.Tensor:
    import torch.distributed as dist

    out = x.contiguous().clone()
    dist.all_reduce(out, group=_group(group))
    return out


@_client_all_reduce.register_fake
def _(x, group):
    return torch.empty_like(x)


def _all_reduce_seeds(info, in_dims, x, group):
    # a sum over ranks is elementwise: the batched tensor reduces whole
    return _client_all_reduce(x, group), in_dims[0]


torch.library.register_vmap(_client_all_reduce, _all_reduce_seeds)


def client_axes(mesh):
    """The client axes of ``mesh``: ('pod', 'data') where it has a pod
    axis, else ('data',) (``flat_pspecs(multi_pod=True)``'s)."""
    from repro_torch.sharding.rules import _axis_sizes, _client_axes

    return _client_axes(_axis_sizes(mesh), multi_pod=True)


def client_placement(mesh, m, *, axes=None):
    """This rank's ``ClientPlacement`` of ``m`` clients on a
    ``DeviceMesh``: the block of its coordinates on the client ``axes``
    (default ``client_axes(mesh)``), row-major over them, as
    ``P(('pod', 'data'))`` places rows; its group holds the ranks that
    differ from it on those axes only.  Every rank of the mesh must call
    it (it makes the groups).  Raises where ``m`` does not divide."""
    import torch.distributed as dist

    names = list(mesh.mesh_dim_names)
    axes = client_axes(mesh) if axes is None else tuple(axes)
    dims = [names.index(a) for a in axes]
    extent = math.prod(mesh.shape[d] for d in dims)
    if m % extent:
        raise ValueError(f"{m} clients do not divide over {axes} "
                         f"({extent} blocks)")
    coord = mesh.get_coordinate()
    block = 0
    for d in dims:
        block = block * mesh.shape[d] + coord[d]
    # the groups: the mesh's rank grid with the client dims last, one row
    # of it per group; every rank creates every group, in the same order
    others = [d for d in range(len(names)) if d not in dims]
    grid = mesh.mesh.permute(others + dims).reshape(-1, extent)
    me = dist.get_rank()
    group = None
    for row in grid.tolist():
        g = dist.new_group(ranks=row)
        if me in row:
            group = g
    per = m // extent
    return ClientPlacement(m=m, lo=block * per, hi=(block + 1) * per,
                           group=group.group_name)
