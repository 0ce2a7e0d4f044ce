"""Logical-axis sharding rules -> partition specs (the port of the
reference's ``repro/sharding/rules.py``), and their DTensor placements.

Mesh axes (``launch/mesh.py``):
  single pod: ('data', 'model') = (16, 16)
  multi-pod:  ('pod', 'data', 'model') = (2, 16, 16)
  seed grid:  ('seed', 'pod', 'data')

Logical mapping:
  clients            -> ('pod', 'data')        client-stacked FL state
  model-parallel dim -> 'model'                heads / d_ff / experts / vocab
  FSDP dim           -> 'data'                 lora-mode frozen base weights
  serve batch        -> 'data'                 (falls back to sequence
  KV-cache sequence  -> 'model' (+'data')       sharding when batch is tiny)

Every function takes the reference's arguments and returns the
reference's specs, leaf for leaf, as the port's ``P`` (a tuple whose
entries are None, an axis name or a tuple of names).  A tree is any
``torch.utils._pytree`` tree whose leaves have a ``.shape`` (tensors,
fake tensors, shape records); a spec's path names are the leaves' dict
keys.  A mesh is a ``DeviceMesh`` (its ``mesh_dim_names`` and ``shape``),
the port's ``SeedMesh``, or anything with ``axis_names`` and
``devices.shape``: the rules read the axis sizes and nothing else.

``placements(spec, mesh)`` turns a spec into DTensor's per-mesh-dimension
``Shard(d)`` / ``Replicate()`` list.  A tuple entry shards the dim over
its axes in mesh order, so under ``P(('pod', 'data'))`` the rank at
``(p, d)`` holds block ``p·D + d`` of ``P·D``: the reference's order.
"""
from __future__ import annotations

import math

import torch.utils._pytree as pytree


def _entry(e):
    """A spec entry as the reference's ``PartitionSpec`` keeps it: a list
    is a tuple, a tuple of one name is the name, an empty one None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


class P(tuple):
    """A partition spec: one entry per tensor dim, each None (replicated),
    a mesh axis name, or a tuple of names (normalised as ``_entry``).
    Compares equal to the tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self):
        return "P" + tuple.__repr__(tuple(self))


def _is_spec(x):
    return isinstance(x, P)


def _axis_sizes(mesh):
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                 # a DeviceMesh
        return dict(zip(names, mesh.shape))
    devices = getattr(mesh, "devices", None)
    shape = devices.shape if hasattr(devices, "shape") else mesh.shape
    return dict(zip(mesh.axis_names, shape))


def _div(n, size):
    return size > 0 and n % size == 0


def _leaf_name(path):
    for p in reversed(path):
        if hasattr(p, "key"):
            return str(p.key)
    return ""


def _in_stack(path):
    return any(getattr(p, "key", None) == "stack" for p in path)


def _map_with_path(f, tree):
    return pytree.tree_map_with_path(f, tree)


def _map_specs(f, spec_tree):
    """``f`` on every spec of ``spec_tree``; other leaves (an
    ``FLState``'s ``FlatSpec``) pass through."""
    return pytree.tree_map(lambda p: f(p) if _is_spec(p) else p, spec_tree,
                           is_leaf=_is_spec)


def _base_spec(name, shape, ax):
    """Spec of a bare (unstacked) parameter leaf.  On a mesh without a
    'model' axis (the ('seed','pod','data') grid mesh) every would-be
    model-parallel dim stays replicated (``_div(n, 0)`` is False)."""
    md = ax.get("model", 0)

    def m(dim):
        return "model" if _div(shape[dim], md) else None

    if name in ("embed",):
        # vocab-parallel when divisible; else shard the embedding dim
        return P(m(0), None) if _div(shape[0], md) else P(None, m(1))
    if name in ("unembed",):
        return P(None, m(1)) if _div(shape[1], md) else P(m(0), None)
    if name in ("wq", "wk", "wv", "wi", "wi_s", "in_proj", "wq_x", "wk_x",
                "wv_x"):
        return P(None, m(1))
    if name in ("wo", "wd", "wd_s", "out_proj", "wo_x"):
        return P(m(0), None)
    if name in ("wi_e",):  # [E, d, 2*eff]
        if _div(shape[0], md):
            return P("model", None, None)
        return P(None, None, m(2))
    if name in ("wd_e",):  # [E, eff, d]
        if _div(shape[0], md):
            return P("model", None, None)
        return P(None, m(1), None)
    if name.startswith("b_"):  # lora B: [r, out]
        return P(None, m(1))
    # router, norms, lora A, conv, ssm scalars, biases -> replicated
    return P(*([None] * len(shape)))


def _fsdp_augment(spec, shape, ax, min_size=1 << 20):
    """Add 'data' sharding on the largest still-unsharded dim (frozen base
    weights in lora mode, ZeRO-3 style)."""
    if math.prod(shape) < min_size:
        return spec
    dd = ax.get("data", 1)
    best, best_dim = 0, None
    padded = tuple(spec) + (None,) * len(shape)
    for i, (s, sp) in enumerate(zip(shape, padded)):
        if sp is None and _div(s, dd) and s > best:
            best, best_dim = s, i
    if best_dim is None:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    parts[best_dim] = "data"
    return P(*parts)


def param_pspecs(cfg, mesh, params_shape, *, fsdp=False, mode="tp"):
    """Specs for a bare params tree (as from ``init_params``).

    fsdp: additionally shard big leaves over 'data' (lora frozen base).
    mode: 'tp' (tensor-parallel blocks) or 'dp' (block weights replicated
    over 'model'; embeddings stay model-sharded)."""
    ax = _axis_sizes(mesh)

    def f(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        core = shape[1:] if _in_stack(path) else shape
        if mode == "dp" and name not in ("embed", "unembed"):
            spec = P(*([None] * len(core))) if core else P()
        else:
            spec = _base_spec(name, core, ax) if core else P()
        if fsdp:
            spec = _fsdp_augment(spec, core, ax)
        if _in_stack(path):
            spec = P(None, *spec)
        return spec

    return _map_with_path(f, params_shape)


def _client_axes(ax, multi_pod):
    return ("pod", "data") if (multi_pod and "pod" in ax) else ("data",)


def client_stack_pspecs(cfg, mesh, trainable_shape, *, multi_pod=False,
                        mode="tp"):
    """Client-stacked trainables: leading client axis over ('pod','data')."""
    client_axes = _client_axes(_axis_sizes(mesh), multi_pod)
    base = param_pspecs(cfg, mesh, trainable_shape, mode=mode)
    return _map_specs(lambda s: P(client_axes, *s), base)


def _fault_leaf(x, m, ca):
    """The fault carry (core/faults.py): the [T, m] replay trace shards
    its client (trailing) axis, [m] cluster labels follow tau."""
    shape = tuple(int(d) for d in x.shape)
    if shape == (m,):
        return P(ca)
    if len(shape) == 2 and shape[1] == m:
        return P(None, ca)
    return P(*([None] * len(shape)))


def _stale_leaf(x, m, ca):
    """The semi-async carry (core/staleness.py): the [tau_max, m, N]
    ring, the [tau_max, m] ages and the [T, m] delay trace shard their
    client (middle / trailing) axis."""
    shape = tuple(int(d) for d in x.shape)
    if len(shape) == 3 and shape[1] == m:
        return P(None, ca, None)
    if len(shape) == 2 and shape[1] == m:
        return P(None, ca)
    if shape == (m,):
        return P(ca)
    return P(*([None] * len(shape)))


def flat_pspecs(mesh, state_sds, *, multi_pod=False):
    """FLState-shaped spec tree for the flat substrate: the [m, N] buffers
    (the client stack, a memory strategy's memory) and the [m] vectors
    shard their client axis over ('pod','data'); the [N] global, scalars
    and the key stay replicated; the fault and stale carries shard their
    client axis.  ``state_sds``: an ``FLState`` (``flat_state``) of
    shaped leaves; the ``spec`` field rides along unchanged."""
    ca = _client_axes(_axis_sizes(mesh), multi_pod)
    m = int(state_sds.tau.shape[0])

    def leaf(x):
        shape = tuple(int(d) for d in x.shape)
        if len(shape) == 2 and shape[0] == m:
            return P(ca, None)           # [m, N] client-stacked
        if shape == (m,):
            return P(ca)                 # per-client vector
        return P(*([None] * len(shape)))  # global [N] / scalars / rng

    fault = getattr(state_sds, "fault", None)
    stale = getattr(state_sds, "stale", None)
    return type(state_sds)(
        global_tr=P(None),
        clients_tr=(None if state_sds.clients_tr is None
                    else P(ca, None)),
        tau=P(ca),
        t=P(),
        extra=pytree.tree_map(leaf, state_sds.extra),
        markov=P(ca),
        rng=P(None),
        spec=state_sds.spec,
        fault=None if fault is None else pytree.tree_map(
            lambda x: _fault_leaf(x, m, ca), fault),
        stale=None if stale is None else pytree.tree_map(
            lambda x: _stale_leaf(x, m, ca), stale),
    )


def cohort_pspecs(mesh, c_max, *, multi_pod=False):
    """Specs of the sparse cohort's working set (core/cohort.py):
    ``dict(rows=P(ca, None), idx=P(ca), mask=P(ca))`` when ``c_max``
    divides the client mesh extent, else replicated."""
    ax = _axis_sizes(mesh)
    ca = _client_axes(ax, multi_pod)
    extent = math.prod(ax.get(a, 1) for a in ca)
    if not _div(int(c_max), extent):
        return dict(rows=P(None, None), idx=P(None), mask=P(None))
    return dict(rows=P(ca, None), idx=P(ca), mask=P(ca))


def sampler_pspecs(mesh, sampler_sds, m, *, multi_pod=False):
    """Sampler-carry spec tree (data/federated.make_device_sampler): the
    ``[m, cap]`` permutations and ``[m]`` cursors follow the client axes;
    the carried ``key`` (even at m = 2, where its shape would pass for a
    client vector) and scalars stay replicated."""
    ca = _client_axes(_axis_sizes(mesh), multi_pod)

    def leaf(path, x):
        shape = tuple(int(d) for d in x.shape)
        if _leaf_name(path) == "key":
            return P(*([None] * len(shape)))
        if len(shape) >= 1 and shape[0] == m:
            return P(ca, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return _map_with_path(leaf, sampler_sds)


def seed_axes_for(mesh, *, multi_pod=None):
    """The mesh axes a leading seed dimension rides: 'seed' when the mesh
    has one, else the client axes."""
    ax = _axis_sizes(mesh)
    if "seed" in ax:
        return "seed"
    mp = ("pod" in ax) if multi_pod is None else multi_pod
    return _client_axes(ax, mp)


def seed_pspecs(spec_tree, *, seed_axes=None):
    """Prepend a leading seed axis to every spec of ``spec_tree``, sharded
    over ``seed_axes`` (None: replicated); an inner dim using one of those
    axes gives it up (a mesh axis appears at most once per spec)."""
    used = set()
    if seed_axes is not None:
        used = set(seed_axes if isinstance(seed_axes, (tuple, list))
                   else (seed_axes,))

    def strip(dim):
        if isinstance(dim, (tuple, list)):
            kept = tuple(a for a in dim if a not in used)
            return kept if kept else None
        return None if dim in used else dim

    lead = (tuple(seed_axes) if isinstance(seed_axes, (tuple, list))
            else seed_axes)
    return _map_specs(lambda p: P(lead, *[strip(d) for d in p]), spec_tree)


def batch_pspecs(mesh, batches_shape, *, multi_pod=False, mode="tp"):
    """FL round batches [m, s, b, ...]: the client axis sharded; in 'dp'
    mode the within-client batch dim also takes the 'model' axis."""
    ax = _axis_sizes(mesh)
    client_axes = _client_axes(ax, multi_pod)
    md = ax.get("model", 0)

    def f(leaf):
        rest = [None] * (len(leaf.shape) - 1)
        if mode == "dp" and len(leaf.shape) >= 3 and _div(leaf.shape[2], md):
            rest[1] = "model"  # [m, s, b, ...] -> b over 'model'
        return P(client_axes, *rest)

    return pytree.tree_map(f, batches_shape)


def serve_batch_pspecs(mesh, batch_size):
    """Serving inputs tokens [B, 1] / pos [B]."""
    ax = _axis_sizes(mesh)
    b_ax = "data" if _div(batch_size, ax.get("data", 1)) else None
    return P(b_ax, None), P(b_ax)


def cache_pspecs(cfg, mesh, cache_shape, batch_size):
    """Decode caches: batch over 'data' when divisible, the cache's
    sequence dim over 'model' (context-parallel decode); for tiny batches
    the sequence dim takes both axes."""
    ax = _axis_sizes(mesh)
    dd, md = ax.get("data", 1), ax.get("model", 1)
    b_data = _div(batch_size, dd)

    def seq(alloc):
        if _div(alloc, dd * md):
            return ("data", "model")
        return "model" if _div(alloc, md) else None

    def f(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        stacked = _in_stack(path)
        core = shape[1:] if stacked else shape  # drop unit axis
        if name in ("k", "v"):  # [B, alloc, K, hd]
            alloc = core[1]
            if b_data:
                spec = ("data", "model" if _div(alloc, md) else None,
                        None, None)
            else:
                spec = (None, seq(alloc), None, None)
        elif name == "pos":  # [B, alloc]
            alloc = core[1]
            if b_data:
                spec = ("data", "model" if _div(alloc, md) else None)
            else:
                spec = (None, seq(alloc))
        elif name == "state":  # [B, h, p, n]
            spec = ("data" if b_data else None, None, None, None)
        elif name in ("conv", "enc_out"):  # [B, W-1, convdim] / [B, Le, d]
            spec = ("data" if b_data else None, None, None)
        else:
            spec = tuple([None] * len(core))
        if stacked:
            spec = (None,) + tuple(spec)
        return P(*spec)

    return _map_with_path(f, cache_shape)


# ---------------------------------------------------------------------------
# DTensor placements of a spec
# ---------------------------------------------------------------------------

def spec_axes(entry):
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh):
    """DTensor's placements of ``spec`` on ``mesh`` (a ``DeviceMesh``, or
    anything the rules read): for each mesh dim, ``Shard(d)`` when tensor
    dim ``d``'s entry names it, else ``Replicate()``.  A tuple entry must
    name its axes in mesh order (DTensor shards a dim over several mesh
    dims in their order); an axis named twice raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(_axis_sizes(mesh))
    where = {a: k for k, a in enumerate(names)}
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        pos = [where[a] for a in spec_axes(entry)]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{tuple(names)}")
        for k in pos:
            if not isinstance(out[k], Replicate):
                raise ValueError(f"axis {names[k]!r} used twice in {spec!r}")
            out[k] = Shard(d)
    return out


def local_shape(shape, spec, mesh):
    """The shape of one rank's block of a ``shape`` tensor placed by
    ``spec``: each sharded dim divided by the product of its axes' sizes;
    raises where a sharded dim does not divide."""
    ax = _axis_sizes(mesh)
    out = []
    for d, n in enumerate(shape):
        k = math.prod(ax[a] for a in spec_axes(spec[d])) if d < len(spec) \
            else 1
        if n % k:
            raise ValueError(f"dim {d} of {tuple(shape)} ({n}) does not "
                             f"divide over {spec[d]!r} ({k})")
        out.append(n // k)
    return tuple(out)
