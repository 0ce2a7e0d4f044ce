"""Checkpointing: trees of tensors <-> ``.npz`` with a JSON manifest, in
the JAX package's on-disk format, so a checkpoint written by either
package restores in the other.

``save_pytree(PATH, tree)`` writes ``PATH.npz`` (arrays ``leaf_0``,
``leaf_1``, ... in flatten order) and ``PATH.json`` (``{"leaves": [{key,
path, shape, dtype}], "meta": {...}}``).  A leaf's path is the string
``jax.tree_util.tree_flatten_with_path`` gives it there: dict keys
(sorted, as JAX sorts them), NamedTuple field names and sequence indices
joined by ``/`` — ``global_tr``, ``extra/mem``, ``fl/tau``,
``sampler/perm``.  ``None`` and a ``FlatSpec`` hold no leaf.

Dtypes follow the reference's leaves: PRNG keys, which the port holds as
uint32 words in int64 (``core/prng.py``), are written as uint32 and read
back into int64; bfloat16 is stored as float32 under its own dtype name.
A restore is checked against a template (every leaf present, every shape
equal) and lands on the template's device and dtype.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.core.flatten import FlatSpec
from repro_torch.core.prng import MASK32


def _rebuild(read, tree, prefix=()):
    """``tree`` with every tensor leaf replaced by ``read(path, leaf)``,
    visited in JAX's flatten order (dict keys sorted)."""
    if tree is None or isinstance(tree, FlatSpec):
        return tree
    if torch.is_tensor(tree):
        return read("/".join(prefix), tree)
    if isinstance(tree, dict):
        return {k: _rebuild(read, tree[k], prefix + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(read, v, prefix + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(read, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                    f"{'/'.join(prefix)!r}: leaves must be tensors")


def _to_numpy(path, leaf):
    """``(array to store, dtype name)`` of one leaf."""
    x = leaf.detach().cpu()
    if x.dtype == torch.int64:
        # uint32 PRNG words held in int64: the reference's key dtype
        if bool(((x < 0) | (x > MASK32)).any()):
            raise ValueError(f"int64 leaf {path!r} holds values outside "
                             "uint32: only PRNG key words are int64")
        return x.numpy().astype(np.uint32), "uint32"
    if x.dtype == torch.bfloat16:
        return x.float().numpy(), "bfloat16"
    arr = x.numpy()
    return arr, str(arr.dtype)


def save_pytree(path: str, tree, extra_meta: dict | None = None):
    arrays, manifest = {}, {"leaves": [], "meta": extra_meta or {}}
    leaves = []
    _rebuild(lambda ps, leaf: leaves.append((ps, leaf)), tree)
    for i, (ps, leaf) in enumerate(leaves):
        key = f"leaf_{i}"
        arr, dtype = _to_numpy(ps, leaf)
        arrays[key] = arr
        manifest["leaves"].append({"key": key, "path": ps,
                                   "shape": list(leaf.shape),
                                   "dtype": dtype})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def load_pytree(path: str, template):
    """The tree of ``template`` with every leaf read from ``PATH``, on the
    template leaf's device and dtype."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    with np.load(path + ".npz") as data:
        def read(ps, leaf):
            if ps not in by_path:
                raise KeyError(f"checkpoint missing leaf {ps!r}")
            arr = data[by_path[ps]["key"]]
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(
                    f"shape mismatch at {ps}: ckpt {arr.shape} vs "
                    f"template {tuple(leaf.shape)}")
            if arr.dtype == np.uint32:
                arr = arr.astype(np.int64)
            # np.array keeps 0-d leaves 0-d (ascontiguousarray would not)
            return torch.from_numpy(np.array(arr)).to(device=leaf.device,
                                                     dtype=leaf.dtype)

        return _rebuild(read, template)


def save_fl_state(path: str, state, round_t: int | None = None):
    meta = {"t": int(state.t) if round_t is None else round_t}
    save_pytree(path, state._asdict(), extra_meta=meta)


def restore_fl_state(path: str, template):
    return type(template)(**load_pytree(path, template._asdict()))


def save_run_state(path: str, state, sampler_state, round_t=None):
    """Checkpoint a RESUMABLE run: the ``FLState`` and the carried sampler
    state in one artifact (``{"fl": ..., "sampler": ...}``).  Under epoch
    sampling the permutations, cursors and epoch counters are part of the
    stream, so a resume needs them; written at a chunk boundary,
    ``state.t`` counts the finished rounds and the stream continues from
    ``fold_in(data_key, t)``."""
    if round_t is None:
        round_t = int(state.t)
    save_pytree(path, {"fl": state._asdict(), "sampler": sampler_state},
                extra_meta={"t": round_t})


def restore_run_state(path: str, state_template, sampler_template):
    """Inverse of ``save_run_state``, checked against templates (a fresh
    ``init_fl_state`` and ``init_sampler_state``): ``(state,
    sampler_state)``, bit for bit the saved carry."""
    d = load_pytree(path, {"fl": state_template._asdict(),
                           "sampler": sampler_template})
    return type(state_template)(**d["fl"]), d["sampler"]
