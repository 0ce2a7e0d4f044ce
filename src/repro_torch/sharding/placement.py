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

On tree state the placement is a ``TreePlacement``: it also carries the
mesh, and each of the rank's client leaves is a DTensor on the mesh's
'model' sub-mesh, ``[rows, ...]``, placed as ``client_stack_pspecs``
places the leaf's model dims (the client entry is the explicit rows);
the global is placed by ``param_pspecs`` there, the round's batch by
``batch_pspecs``.  ``mode`` and ``batch_mode`` are the reference's dry
run knobs: ``"tp"`` weights sharded over 'model' and the within-client
batch replicated there (the baseline), ``"dp"`` weights replicated and
the batch over 'model' (``dp_client``); ``zero_client`` keeps ``"tp"``
storage with the ``"dp"`` batch.  ``row_of`` / ``stack_rows`` move
between a rank's ``[rows, ...]`` leaf and one client's, on local blocks
(nothing is communicated), and ``mesh_sum`` reduces a local partial over
a sub-mesh.

``client_sum`` and ``rows_of`` take ``place=None`` and then do nothing,
so the unplaced round runs exactly as before.  The all-reduce is the
custom operator ``repro_torch::client_all_reduce``, whose vmap rule
reduces a seed-batched tensor in one collective (the seed-batched round
runs its aggregation under ``torch.func.vmap``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

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


@dataclasses.dataclass(frozen=True)
class TreePlacement(ClientPlacement):
    """A ``ClientPlacement`` for tree state: the rank's rows, the whole
    ``mesh`` and its 'model' sub-mesh ``sub`` that the leaves' DTensors
    live on, and the storage and batch modes (module note)."""
    mesh: Any = None
    sub: Any = None
    mode: str = "tp"
    batch_mode: str = "tp"

    def global_specs(self, template):
        """``param_pspecs`` of a trainable (or frozen) tree."""
        from repro_torch.sharding.rules import param_pspecs

        return param_pspecs(None, self.mesh, template, mode=self.mode)

    def client_specs(self, template):
        """``client_stack_pspecs`` of a trainable tree, the client entry
        left to the explicit rows (None)."""
        from repro_torch.sharding.rules import client_stack_pspecs

        return _rows_local(client_stack_pspecs(
            None, self.mesh, template, multi_pod=True, mode=self.mode))

    def batch_specs(self, batch):
        """``batch_pspecs`` of a ``[rows, s, b, ...]`` batch, the client
        entry left to the explicit rows."""
        from repro_torch.sharding.rules import batch_pspecs

        return _rows_local(batch_pspecs(self.mesh, batch, multi_pod=True,
                                        mode=self.batch_mode))

    def distribute(self, tree, specs):
        """Each tensor of ``tree`` (whole in its placed dims, the rows
        already the rank's) as a DTensor on ``sub`` placed by its spec:
        the rank keeps its block, nothing is communicated; a DTensor
        passes as it is."""
        import torch.utils._pytree as pytree
        from torch.distributed.tensor import DTensor, distribute_tensor

        from repro_torch.sharding.rules import _is_spec, placements

        leaves, treedef = pytree.tree_flatten(tree)
        sp = pytree.tree_flatten(specs, is_leaf=_is_spec)[0]
        return pytree.tree_unflatten(
            [v if not torch.is_tensor(v) or isinstance(v, DTensor)
             else distribute_tensor(v, self.sub, placements(p, self.sub),
                                    src_data_rank=None)
             for v, p in zip(leaves, sp)], treedef)

    def place_params(self, tree):
        return self.distribute(tree, self.global_specs(tree))

    def place_batch(self, batch):
        return self.distribute(batch, self.batch_specs(batch))


def _rows_local(specs):
    """Specs whose leading (client) entry is left to the explicit rows."""
    from repro_torch.sharding.rules import P, _map_specs

    return _map_specs(lambda s: P(None, *s[1:]), specs)


def tree_placement(mesh, m, *, mode="tp", batch_mode="tp"):
    """This rank's ``TreePlacement`` of ``m`` clients on ``mesh``: the
    rows of ``client_placement`` (every rank must call it), the leaves on
    ``mesh['model']``."""
    for name, v in (("mode", mode), ("batch_mode", batch_mode)):
        if v not in ("tp", "dp"):
            raise ValueError(f"{name} must be 'tp' or 'dp'; got {v!r}")
    rows = client_placement(mesh, m)
    return TreePlacement(**dataclasses.asdict(rows), mesh=mesh,
                         sub=mesh["model"], mode=mode,
                         batch_mode=batch_mode)


def _shift(placements, by):
    from torch.distributed.tensor import Shard

    return tuple(Shard(p.dim + by) if isinstance(p, Shard) else p
                 for p in placements)


def row_of(x, r):
    """Row ``r`` of a rank's ``[rows, ...]`` DTensor (its client dim
    local), as a DTensor of one client: the local block's row."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x.to_local()[r], x.device_mesh,
                              _shift(x.placements, -1), run_check=False)


def stack_rows(xs):
    """The DTensors of one client each (equal placements) stacked into a
    rank's ``[rows, ...]`` leaf, on local blocks."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(torch.stack([x.to_local() for x in xs]),
                              xs[0].device_mesh, _shift(xs[0].placements, 1),
                              run_check=False)


def wrap_like(local, ref):
    """``local`` (a tensor of ``ref``'s local block shape) as a DTensor
    beside ``ref``: its mesh and placements."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False)


def owns_block(x):
    """Whether this rank counts ``x``'s local block in a sum over the
    mesh: always where ``x`` is sharded, only at coordinate 0 of each
    mesh dim it is replicated on (the others hold the same values)."""
    from torch.distributed.tensor import Replicate

    coord = x.device_mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, x.placements)
               if isinstance(p, Replicate))


def mesh_sum(x, mesh):
    """Sum of a local tensor over every rank of ``mesh`` (one all-reduce
    a mesh dim)."""
    for d in range(mesh.ndim):
        x = _client_all_reduce(x, mesh.get_group(d).group_name)
    return x


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
