"""Seed aggregation for the multi-seed experiment grid (per-seed metric
histories to mean±std curves, per-seed finals to one table cell, the
paper-style results table), the model-flops helpers (the roofline
terms, active parameters, 6·N·D / 2·N·D), the per-rank argument bytes
of placed inputs (``argument_bytes``) and the per-rank counters of one
step: ports of the reference's ``repro/launch/analysis.py``.

The reference reads its counts from XLA's artifacts: the HLO's
collectives (``collective_bytes``, ``collective_top``, with a parser for
the trip counts of while loops), ``cost_analysis()`` and
``memory_analysis()``.  Here a step is run, not compiled, and
``CollectiveCounter``, a ``TorchDispatchMode``, sees every operation it
executes on local tensors: DTensor operations are passed on to DTensor
(the counter returns ``NotImplemented``), which runs their local
operations and collectives through the counter in turn, so every count
is one rank's.  A loop of K rounds is K rounds of operations: there is
no trip count to parse.  ``cost_numbers`` and ``memory_numbers`` read
the same counter.  The shape propagation DTensor runs on global shapes
(``ShardingPropagator``, under its ``_fake_mode_lock``) is not counted.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import weakref
from typing import Dict, List

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import conv_flop_count, flop_registry

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> Dict[str, float]:
    """Seconds of compute, memory and collectives per device at the H100
    SXM's constants (``launch/mesh.py``), the dominant term, and the
    compute term's share of the largest."""
    compute_s = flops_per_dev / PEAK_FLOPS_BF16
    memory_s = bytes_per_dev / HBM_BW
    collective_s = coll_bytes_per_dev / ICI_BW
    terms = dict(compute_s=compute_s, memory_s=memory_s,
                 collective_s=collective_s)
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    total = max(compute_s, memory_s, collective_s)
    terms["bound_fraction"] = compute_s / total if total else 0.0
    return terms


def argument_bytes(tree, spec_tree, mesh) -> float:
    """Bytes one rank holds of the tensors of ``tree`` placed on ``mesh``
    by ``spec_tree`` (a ``sharding`` spec beside each leaf): each leaf's
    bytes over the product of the mesh axes its spec shards it on, summed
    (``sharding.local_shape`` raises where a sharded dim does not
    divide).  Leaves need only ``.shape`` and ``.dtype``."""
    import torch
    import torch.utils._pytree as pytree

    from repro_torch.sharding.rules import _is_spec, local_shape

    leaves = pytree.tree_flatten(tree)[0]
    specs = pytree.tree_flatten(spec_tree, is_leaf=_is_spec)[0]
    if len(leaves) != len(specs):
        raise ValueError("a tree and its spec tree differ in structure")
    total = 0.0
    for leaf, spec in zip(leaves, specs):
        if not hasattr(leaf, "shape"):
            continue
        size = torch.empty((), dtype=leaf.dtype).element_size()
        total += float(np.prod(local_shape(tuple(leaf.shape), spec, mesh),
                               dtype=np.float64)) * size
    return total


# ---------------------------------------------------------------------------
# the per-rank counters of one step
# ---------------------------------------------------------------------------

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

#: dispatcher operators (schema names) -> the reference's HLO kind: the
#: functional collectives DTensor issues, the in-place c10d ones
#: ``torch.distributed``'s calls reach, the port's own client all-reduce
#: (``sharding/placement.py``) and the point-to-point operations
_KIND = {
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "c10d::allreduce_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::send": "collective-permute",
    "c10d::recv_": "collective-permute",
    "repro_torch::client_all_reduce": "all-reduce",
}

#: HLO's short dtype names, for ``collective_top``'s signatures
_SHORT = {torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
          torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
          torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
          torch.bool: "pred", torch.complex64: "c64",
          torch.complex128: "c128"}


def _tensors(tree):
    import torch.utils._pytree as pytree

    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _is_dtensor(t) -> bool:
    """Whether the type ``t`` is DTensor's (none exists before its module
    is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and issubclass(t, mod.DTensor)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _aliases(func) -> bool:
    """Whether every result of ``func`` is a view of (or is) an argument
    it does not write: a view, ``wait_tensor``, ``detach``.  Such an
    operation moves no bytes and allocates nothing."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _writes(func) -> bool:
    """Whether a result of ``func`` is an argument it writes (in place)."""
    return any(r.alias_info is not None and r.alias_info.is_write
               for r in func._schema.returns)


class _Propagating:
    """Stands in for DTensor's ``ShardingPropagator._fake_mode_lock``
    while a counter is on: DTensor holds it while it runs an operation on
    global fake shapes to learn its output's metadata, work no rank
    does."""
    depth = 0

    def __enter__(self):
        _Propagating.depth += 1

    def __exit__(self, *exc):
        _Propagating.depth -= 1


@contextlib.contextmanager
def _propagation_marked():
    try:
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
    except ImportError:            # a torch without DTensor
        yield
        return
    held = getattr(ShardingPropagator, "_fake_mode_lock", None)
    ShardingPropagator._fake_mode_lock = _Propagating()
    try:
        yield
    finally:
        ShardingPropagator._fake_mode_lock = held


def conv_backward_flops(grad_out, x, w, *args, out_val=None, **kwargs):
    """``aten.convolution_backward``'s flops: each gradient it is asked
    for (``output_mask``'s first two entries) costs the forward
    convolution's products, ``conv_flop_count`` on the input, weight and
    output shapes; the weight's shape carries the groups, so a depthwise
    convolution counts ``1/groups`` of a dense one's."""
    names = ("bias_sizes", "stride", "padding", "dilation", "transposed",
             "output_padding", "groups", "output_mask")
    a = dict(zip(names, args), **kwargs)
    fwd = conv_flop_count(list(x.shape), list(w.shape),
                          list(grad_out.shape), a["transposed"])
    return fwd * (int(a["output_mask"][0]) + int(a["output_mask"][1]))


#: formulas that take the place of the registry's
_FORMULAS = {torch.ops.aten.convolution_backward: conv_backward_flops}


def _signature(tensors):
    """``"bf16[65536,2304],bf16[2304,1152]"``: dtypes and shapes."""
    return ",".join(f"{_SHORT.get(t.dtype, str(t.dtype))}"
                    f"[{','.join(map(str, t.shape))}]" for t in tensors)


class CollectiveCounter(TorchDispatchMode):
    """Counts what one rank executes while it is on, real or fake tensors
    alike:

      * collectives: operand bytes per kind under the reference's keys
        (``_KIND``; ``collective_bytes()``), and each (kind, shapes) with
        its executions for ``collective_top``;
      * ``flops``: each operation's count by ``FlopCounterMode``'s
        formulas (``torch.utils.flop_counter.flop_registry``, which the
        port's kernels register themselves in), on local shapes; a
        convolution's backward by ``conv_backward_flops`` (the
        registry's counts a grouped convolution's weight gradient as a
        dense one's);
      * ``bytes_accessed``: the bytes of every tensor argument and result
        of each operation that is not a view;
      * memory: the bytes of every storage an operation allocates (a
        result that aliases no argument), live until it is freed; the
        peak of their sum (``peak_bytes``).  Arguments and the storages of
        tensors made before the counter was on are not counted.

    Used as ``with CollectiveCounter() as c: out = step(*args)``."""

    def __init__(self):
        super().__init__()
        #: executions and operand bytes per collective operator (schema
        #: name, e.g. ``"repro_torch::client_all_reduce"``), and per
        #: (kind, operand shapes) for ``collective_top``
        self.calls_by_op = collections.Counter()
        self.bytes_by_op = collections.Counter()
        self._top = collections.Counter()
        self._top_bytes = collections.Counter()
        #: flops and executions per (operator, operand shapes), for
        #: ``flops_top``
        self._flops_by = collections.Counter()
        self._flops_calls = collections.Counter()
        self.flops = 0
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live = {}
        self._marked = None
        self._in_dtensor = False

    def __enter__(self):
        self._marked = _propagation_marked()
        self._marked.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._marked.__exit__(*exc)

    # -- the dispatch -----------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor(t) for t in types):
            if self._in_dtensor:
                return NotImplemented
            # DTensor runs its bookkeeping (sharding propagation, shard
            # offsets) on the host, as it does on real tensors, and its
            # local operations and collectives come back here; fake local
            # tensors take them to their own mode
            self._in_dtensor = True
            try:
                with unset_fake_temporarily(), self:
                    return func(*args, **kwargs)
            finally:
                self._in_dtensor = False
        if any(t is not torch.Tensor and not issubclass(t, FakeTensor)
               for t in types):
            # a collective's async wrapper: it waits, then runs the
            # operation on the plain tensor, which comes back here
            return NotImplemented
        out = func(*args, **kwargs)
        if _Propagating.depth == 0:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        outs = _tensors(out)
        if not outs or _aliases(func):
            return
        ins = _tensors((args, kwargs))
        kind = _KIND.get(func._schema.name)
        if kind is not None:
            self._collective(func._schema.name, kind, ins)
        formula = _FORMULAS.get(func._overloadpacket) \
            or flop_registry.get(func._overloadpacket)
        if formula is not None:
            f = int(formula(*args, **kwargs, out_val=out))
            self.flops += f
            key = (func._overloadpacket.__name__, _signature(ins[:2]))
            self._flops_by[key] += f
            self._flops_calls[key] += 1
        self.bytes_accessed += sum(map(_nbytes, ins)) \
            + sum(map(_nbytes, outs))
        if not _writes(func):
            for t in outs:
                self._allocated(t)

    def _collective(self, op, kind, operands):
        b = sum(map(_nbytes, operands))
        self.calls_by_op[op] += 1
        self.bytes_by_op[op] += b
        sig = _signature(operands[:2])
        self._top[(kind, sig)] += 1
        self._top_bytes[(kind, sig)] += b

    def _allocated(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._freed, key)

    def _freed(self, key):
        self.live_bytes -= self._live.pop(key, 0)

    # -- what it counted --------------------------------------------------

    @property
    def calls(self) -> int:
        """Collectives executed."""
        return sum(self.calls_by_op.values())

    def collective_bytes(self) -> Dict[str, int]:
        """Operand bytes per kind, ``count`` and ``total``: the keys of
        the reference's ``collective_bytes``."""
        out = {k: 0 for k in _COLLECTIVES}
        for op, b in self.bytes_by_op.items():
            out[_KIND[op]] += b
        out["count"] = self.calls
        out["total"] = sum(self.bytes_by_op.values())
        return out

    def flops_top(self, k: int = 12) -> List[str]:
        """The ``k`` (operator, first two operand shapes) with the most
        flops: operator, shapes, executions, flops."""
        items = sorted(((f, key) for key, f in self._flops_by.items()),
                       reverse=True)[:k]
        return [f"{op} {sig} x{self._flops_calls[(op, sig)]}: {f:.4g}"
                for f, (op, sig) in items]

    def collective_top(self, k: int = 12) -> List[str]:
        """The ``k`` (kind, shapes) with the most bytes, as the
        reference's strings: kind, the first two operand shapes, the
        number of executions, GB."""
        items = sorted(((b, key) for key, b in self._top_bytes.items()),
                       reverse=True)[:k]
        return [f"{kind} {sig} x{self._top[(kind, sig)]}: {b / 1e9:.2f}GB"
                for b, (kind, sig) in items]


def cost_numbers(counter: CollectiveCounter) -> Dict[str, float]:
    """The counterpart of the reference's ``cost_analysis_numbers``:
    ``flops`` (``FlopCounterMode``'s formulas on the local operations)
    and ``bytes accessed`` (every argument and result of each operation
    that is not a view).  XLA sums the bytes of its *fused* operations,
    whose intermediates never reach memory, so the two "bytes accessed"
    are not the same quantity: this one is the unfused sum, an upper
    bound on what an eager step moves."""
    return {"flops": float(counter.flops),
            "bytes accessed": float(counter.bytes_accessed)}


def memory_numbers(counter: CollectiveCounter, args,
                   outputs) -> Dict[str, float]:
    """The counterpart of the reference's ``memory_analysis_numbers``
    (bytes, per rank): ``argument_size_in_bytes`` (the bytes of
    ``args``' local tensors), ``output_size_in_bytes`` (the
    outputs' local tensors), ``temp_size_in_bytes`` (the counter's peak
    of live allocations made during the step) and
    ``alias_size_in_bytes`` (outputs that share storage with an argument:
    state updated in place, the counterpart of donation)."""
    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    held = {local(t).untyped_storage()._cdata for t in _tensors(args)}
    outs = [local(t) for t in _tensors(outputs)]
    return dict(
        argument_size_in_bytes=float(sum(_nbytes(local(t))
                                         for t in _tensors(args))),
        output_size_in_bytes=float(sum(map(_nbytes, outs))),
        temp_size_in_bytes=float(counter.peak_bytes),
        alias_size_in_bytes=float(sum(
            _nbytes(t) for t in outs
            if t.untyped_storage()._cdata in held)))


def active_param_count(cfg) -> int:
    """Parameters touched per token: total minus the skipped expert FFNs
    (MODEL_FLOPS uses 6·N_active·D for MoE)."""
    from repro_torch.models.model import count_params

    total = count_params(cfg)
    if not cfg.is_moe:
        return total
    n_moe = sum(1 for b in cfg.layer_blocks() if b.kind == "moe")
    per_expert = 3 * cfg.d_model * cfg.expert_ff  # wi(2x) + wd
    inactive = n_moe * per_expert * (cfg.n_experts - cfg.top_k)
    return total - inactive


def model_flops(cfg, n_tokens: int, kind: str) -> float:
    """6·N·D (train) / 2·N·D (inference) with N = active params."""
    n = active_param_count(cfg)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * n_tokens


def aggregate_seed_histories(histories: List[List[dict]]) -> dict:
    """Per-seed metric histories -> mean±std curves.

    ``histories`` is one history per seed, each a list of per-round dicts
    (``{"t": int, "loss": ...}``; eval keys may appear only at eval
    rounds).  Returns::

        {"seeds": S, "t": [T],
         "metrics": {key: {"mean": [T], "std": [T], "n": [T]}}}

    where ``n[t]`` counts the seeds that recorded ``key`` at round ``t``;
    rounds where no seed recorded it hold ``None`` (strict JSON).  ``std``
    is the population std across seeds (S = 1 gives 0, never NaN).
    Ragged per-seed lengths raise: every executor records exactly T
    rounds per seed."""
    if not histories or not all(histories):
        raise ValueError("need at least one non-empty history")
    lengths = sorted({len(h) for h in histories})
    if len(lengths) > 1:
        raise ValueError(
            f"ragged per-seed histories (lengths {lengths}): every seed "
            "must record the same number of rounds — a shorter history "
            "means a truncated or mismatched run, not a valid replicate")
    T = lengths[0]
    keys = sorted({k for h in histories for r in h for k in r if k != "t"})
    out = {"seeds": len(histories), "t": list(range(T)), "metrics": {}}
    for k in keys:
        mean, std, n = [], [], []
        for t in range(T):
            vals = np.asarray([h[t][k] for h in histories
                               if t < len(h) and k in h[t]], np.float64)
            n.append(int(vals.size))
            mean.append(float(vals.mean()) if vals.size else None)
            std.append(float(vals.std()) if vals.size else None)
        out["metrics"][k] = {"mean": mean, "std": std, "n": n}
    return out


def seed_summary(per_seed_finals: List[dict]) -> dict:
    """Per-seed final scalars -> ``{key: {"mean", "std", "seeds"}}``, one
    cell of the results table."""
    if not per_seed_finals:
        raise ValueError("need at least one seed")
    keys = sorted({k for d in per_seed_finals for k in d})
    out = {}
    for k in keys:
        vals = np.asarray([float(d[k]) for d in per_seed_finals if k in d],
                          np.float64)
        out[k] = {"mean": float(vals.mean()), "std": float(vals.std()),
                  "seeds": int(vals.size)}
    return out


def write_results_table(rows: List[dict], path: str,
                        title: str = "Experiment grid results") -> str:
    """Write a paper-style results table (markdown, and the raw rows as a
    sibling ``.json``); every key across the rows becomes a column.
    Returns the markdown path."""
    if not rows:
        raise ValueError("no rows to tabulate")
    lead = ["scenario", "strategy", "dynamics", "sampling", "seeds",
            "rounds"]
    keys = [k for k in lead if any(k in r for r in rows)]
    keys += sorted({k for r in rows for k in r} - set(keys))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"# {title}\n\n")
        f.write("| " + " | ".join(keys) + " |\n")
        f.write("|" + "|".join("---" for _ in keys) + "|\n")
        for r in rows:
            f.write("| " + " | ".join(str(r.get(k, "")) for k in keys)
                    + " |\n")
    with open(os.path.splitext(path)[0] + ".json", "w") as f:
        json.dump(rows, f, indent=1, default=str)
        f.write("\n")
    return path
