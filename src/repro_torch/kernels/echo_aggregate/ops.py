"""Checked wrappers: flat client stacks -> the echo-aggregate kernel.

``echo_aggregate_flat`` is the single-launch FedAWE server update over the
flat ``[m, N]`` substrate (core/flatten.py), guard included;
``echo_aggregate_tree`` is the same update on tree state, its leaves
raveled into one ``echo_aggregate_flat`` call (one launch a round
whatever the leaf count); ``echo_aggregate`` is the masked echo mean
without the guard.

``echo_aggregate_flat`` goes through the custom operator
``repro_torch::echo_aggregate_flat``, whose ``torch.func.vmap`` rule is
the kernel's seed axis: under the seed-batched round
(``core.engine.seed_vmap``) S seeds' ``[S, m, N]`` stacks, ``[S, m]``
vectors and ``[S, N]`` globals go to ONE launch (grid ``(tiles, slices,
S)``), each seed's arithmetic that of a launch on that seed alone, as
vmapping the Pallas call adds a grid axis on the TPU.

Device dispatch is by the tensors' device and nothing else: CPU tensors
take the plain version (``ref.py``); CUDA tensors launch the CUDA C++
kernel (``kernel.py``, ``csrc/echo_aggregate.cu``) once a call, the upload
weights read by the kernel itself, or raise.  There is no fallback from
the kernel to the plain version or to anything else.  Each wrapper counts
its kernel launches in plain integer attributes
(``echo_aggregate_flat.launches`` for the fault-free update,
``echo_aggregate_flat.upload_launches`` for the ``upload=`` variant,
``echo_aggregate.launches``), so a run can show that it went through the
kernel; a launch over a seed axis counts once.  A caller resets them by
assigning 0.

``launch_geometry`` chooses the kernel's grid from the shapes and the
card's SM count alone.  ``_echo_aggregate_cuda`` launches the kernel at a
given number of row slices, and ``_echo_aggregate_triton`` the earlier
Triton kernel (``kernel_triton.py``) after the earlier wrapper's weight
multiply: both are for ``chip_smoke.py``'s checks and timings, count no
launch, and no path calls them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.flatten import FlatSpec
from repro_torch.kernels.echo_aggregate import kernel, kernel_triton
from repro_torch.kernels.echo_aggregate.ref import (echo_aggregate_fused_ref,
                                                    echo_aggregate_ref)

STACK_DTYPES = (torch.float32, torch.bfloat16)

#: the kernel's geometry (csrc/echo_aggregate.cu): a column tile is 1 KB of
#: a row (256 float32 or 512 bfloat16 columns, a multiple of the 16-byte
#: chunks its windows are cut in); a ring of 2 stages of 16 rows of x and
#: y; the S row slices of a tile form one cluster, at most the portable 8
TILE_ROW_BYTES = 1024
VEC_BYTES = 16
STAGES = 2
STAGE_ROWS = 16
MAX_SLICES = 8
#: a slice streams at least this many rows: at the FL path's m = 100,
#: slices cost more (combine, shorter streams) than they gain
MIN_SLICE_ROWS = 512
#: shared memory of one SM of the H100 and what each block reserves of it
SM_SHARED_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024


def block_smem_bytes(esize, slices):
    """Dynamic shared memory of one block: the ring of windows (a tile row
    plus one 16-byte chunk), its barriers, and with ``slices`` > 1 the
    other ranks' partials (the tile's column sums and the weight sum,
    padded to 16 bytes, per rank)."""
    ring = STAGES * 2 * STAGE_ROWS * (TILE_ROW_BYTES + VEC_BYTES)
    return (ring + 16 * STAGES + 16
            + (slices - 1) * (TILE_ROW_BYTES // esize + 4) * 4)


def blocks_per_sm(esize, slices):
    """Blocks resident on one SM: bounded by shared memory alone (a block
    of 160 threads and 48 registers a thread)."""
    return SM_SHARED_BYTES // (block_smem_bytes(esize, slices)
                               + BLOCK_RESERVED_BYTES)


def launch_geometry(m, n, esize, n_sm, seeds=1):
    """(block_cols, slices) of the kernel's grid, ``ceil(n / block_cols)``
    column tiles by ``slices`` row slices by ``seeds``, for ``seeds``
    [m, n] stacks of ``esize``-byte elements on a card of ``n_sm`` SMs.

    The most slices (at most ``MAX_SLICES``, each of at least
    ``MIN_SLICE_ROWS`` rows) whose grid is one wave of resident blocks, so
    that no block waits for a free SM; one slice where m is short."""
    block_cols = TILE_ROW_BYTES // esize
    tiles = -(-n // block_cols)
    for s in range(min(MAX_SLICES, m // MIN_SLICE_ROWS), 1, -1):
        if tiles * s * seeds <= blocks_per_sm(esize, s) * n_sm:
            return block_cols, s
    return block_cols, 1


#: the kernel's seed axis is its grid's z, at most 65 535 blocks
MAX_SEEDS = 65535


def _check(x, y, vecs, g=None):
    """Validate the operands the kernel takes, [m, N] stacks with [m]
    vectors and an [N] global, or [S, m, N] stacks with [S, m] vectors
    and an [S, N] global; raise on anything else."""
    if x.dim() not in (2, 3) or x.shape != y.shape:
        raise ValueError(f"x, y must be [m, N] (or [S, m, N]) of one shape; "
                         f"got {tuple(x.shape)} and {tuple(y.shape)}")
    lead, (m, n) = tuple(x.shape[:-2]), x.shape[-2:]
    if m < 1 or n < 1 or x.numel() == 0:
        raise ValueError(f"empty client stack {tuple(x.shape)}")
    if lead and lead[0] > MAX_SEEDS:
        raise ValueError(f"at most {MAX_SEEDS} seeds; got {lead[0]}")
    if x.dtype not in STACK_DTYPES or y.dtype != x.dtype:
        raise TypeError(f"x, y must share a dtype in {STACK_DTYPES}; got "
                        f"{x.dtype} and {y.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("x, y must be contiguous")
    for name, v in vecs.items():
        if v is not None and tuple(v.shape) != lead + (m,):
            raise ValueError(f"{name} must be {list(lead + (m,))}; got "
                             f"{tuple(v.shape)}")
    if g is not None and tuple(g.shape) != lead + (n,):
        raise ValueError(f"global must be {list(lead + (n,))}; got "
                         f"{tuple(g.shape)}")
    operands = [x, y, g] + list(vecs.values())
    if any(t is not None and t.device != x.device for t in operands):
        raise ValueError("all operands must lie on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _check_eta(eta_g):
    """η_g is static config, a Python number; the kernel takes it as a
    scalar argument (a tensor would be taken for a pointer)."""
    if isinstance(eta_g, bool) or not isinstance(eta_g, (int, float)):
        raise TypeError(f"eta_g must be a Python number; got "
                        f"{type(eta_g).__name__}")


def _f32(t):
    """``t`` as the kernel takes it: contiguous float32, cast or copied
    only where it is not."""
    if t is None or (t.dtype == torch.float32 and t.is_contiguous()):
        return t
    return t.float().contiguous()


_N_SM = {}


def _sm_count(device):
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _N_SM:
        _N_SM[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _N_SM[idx]


def _launch(x, y, g, mask, echo, eta_g, upload, *, guard, slices=None):
    """One launch of the CUDA kernel on checked operands (with a seed
    axis, one launch for every seed); ``slices`` None takes
    ``launch_geometry``'s."""
    seeds = x.shape[0] if x.dim() == 3 else 1
    m, n = x.shape[-2:]
    block_cols, s = launch_geometry(m, n, x.element_size(),
                                    _sm_count(x.device), seeds)
    out = torch.empty(x.shape[:-2] + (n,), dtype=torch.float32,
                      device=x.device)
    kernel.launch(x, y, _f32(g) if guard else None, _f32(mask),
                  _f32(upload), _f32(echo), out, eta_g, guard=guard,
                  block_cols=block_cols,
                  slices=s if slices is None else slices, seeds=seeds)
    return out


def _on_card(x):
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA and Triton kernels run on the card; got "
                         f"{x.device}")


def echo_aggregate_flat(clients_flat, x_end_flat, global_flat, mask, echo,
                        eta_g, *, upload=None):
    """Fused FedAWE update on the flat substrate: one launch, guard included.

    clients_flat, x_end_flat: [m, N] start / post-local-SGD stacks;
    global_flat: [N] previous global (returned verbatim on empty rounds).
    ``upload`` ([m], optional) is the mid-round delivery weight fused into
    the kernel weights.  Returns the new [N] float32 global.  Under
    ``torch.func.vmap`` over seeds the S calls are one launch (see the
    module note); ``[S, m, N]`` stacks may also be passed directly."""
    _check_eta(eta_g)
    return _fused_op(clients_flat, x_end_flat, global_flat, mask, echo,
                     eta_g, upload)


echo_aggregate_flat.launches = 0
echo_aggregate_flat.upload_launches = 0


@torch.library.custom_op("repro_torch::echo_aggregate_flat", mutates_args=())
def _fused_op(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
              mask: torch.Tensor, echo: torch.Tensor, eta_g: float,
              upload: Optional[torch.Tensor]) -> torch.Tensor:
    """``echo_aggregate_flat`` on real tensors: the plain version on the
    CPU, one counted launch of the kernel on the card."""
    _check(x, y, dict(mask=mask, echo=echo, upload=upload), g=g)
    if x.device.type == "cpu":
        return echo_aggregate_fused_ref(x, y, g, mask, echo, eta_g,
                                        upload=upload)
    out = _launch(x, y, g, mask, echo, eta_g, upload, guard=True)
    if upload is None:
        echo_aggregate_flat.launches += 1
    else:
        echo_aggregate_flat.upload_launches += 1
    return out


@_fused_op.register_fake
def _(x, y, g, mask, echo, eta_g, upload):
    return x.new_empty(x.shape[:-2] + x.shape[-1:], dtype=torch.float32)


def _fused_seeds(info, in_dims, x, y, g, mask, echo, eta_g, upload):
    """The operator's vmap rule: every operand brought to a leading seed
    axis (an unbatched one broadcast, the stacks made contiguous where
    they are not), then the operator once on the ``[S, ...]`` tensors."""
    S = info.batch_size

    def seeds_first(t, d):
        if t is None:
            return None
        return t.movedim(d, 0) if d is not None \
            else t.expand((S,) + tuple(t.shape))

    x, y, g, mask, echo = (seeds_first(t, d) for t, d in zip(
        (x, y, g, mask, echo), in_dims[:5]))
    upload = seeds_first(upload, in_dims[6])
    return _fused_op(x.contiguous(), y.contiguous(), g, mask, echo, eta_g,
                     upload), 0


torch.library.register_vmap(_fused_op, _fused_seeds)


def echo_aggregate_tree(clients_tr, x_end, mask, echo, eta_g, global_tr, *,
                        upload=None):
    """The tree-state FedAWE update in one launch: the leaves of the
    client-stacked start models ``clients_tr`` and post-local-SGD models
    ``x_end`` ([m, ...], or [S, m, ...] under the seed axis) are raveled
    into two float32 ``[m, N]`` buffers by ``FlatSpec.from_tree(
    global_tr)``, the previous global into ``[N]``, for one
    ``echo_aggregate_flat`` call whatever the leaf count (under
    ``torch.func.vmap`` the operator's rule makes it one launch for all
    seeds); the new global comes back as a tree of views in the leaf
    dtypes."""
    spec = FlatSpec.from_tree(global_tr)
    out = echo_aggregate_flat(
        spec.flatten_stacked(clients_tr), spec.flatten_stacked(x_end),
        spec.flatten(global_tr), mask, echo, eta_g, upload=upload)
    return spec.unflatten(out)


def echo_aggregate(x, y, mask, echo, eta_g):
    """x, y: [m, ...]; returns the aggregated [...] (float32).  No
    empty-round guard — callers apply the W = I rule themselves."""
    m = x.shape[0]
    flat_x = x.reshape(m, -1)
    flat_y = y.reshape(m, -1)
    _check(flat_x, flat_y, dict(mask=mask, echo=echo))
    _check_eta(eta_g)
    if flat_x.device.type == "cpu":
        out = echo_aggregate_ref(flat_x, flat_y, mask, echo, eta_g)
    else:
        out = _launch(flat_x, flat_y, None, mask, echo, eta_g, None,
                      guard=False)
        echo_aggregate.launches += 1
    return out.reshape(x.shape[1:])


echo_aggregate.launches = 0


def _echo_aggregate_cuda(x, y, g, mask, echo, eta_g, *, upload=None,
                         slices=None):
    """The CUDA kernel on [m, N] (or [S, m, N]) CUDA stacks at ``slices``
    row slices (``launch_geometry``'s where None), guarded unless ``g`` is
    None; counts no launch.  ``chip_smoke.py`` checks the kernel with it
    at more slices than rows, and a seed stack's launch against one
    launch per seed."""
    _check(x, y, dict(mask=mask, echo=echo, upload=upload), g=g)
    _check_eta(eta_g)
    _on_card(x)
    if g is None and upload is not None:
        raise ValueError("upload weights need the guard (a global g)")
    if slices is not None and not 1 <= slices <= MAX_SLICES:
        raise ValueError(f"slices must be in 1..{MAX_SLICES}; got {slices}")
    return _launch(x, y, g, mask, echo, eta_g, upload, guard=g is not None,
                   slices=slices)


def _echo_aggregate_triton(x, y, g, mask, echo, eta_g, *, upload=None):
    """The earlier Triton kernel, as the earlier wrapper launched it: the
    weights ``mask * upload`` multiplied by a launch of their own, then
    the kernel (guarded unless ``g`` is None).  ``chip_smoke.py``'s
    yardstick; counts no launch."""
    _check(x, y, dict(mask=mask, echo=echo, upload=upload), g=g)
    _check_eta(eta_g)
    _on_card(x)
    w = mask.float()
    if upload is not None:
        w = w * upload.float()
    guard = g is not None
    return kernel_triton.echo_aggregate_triton(
        x, y, g.float().contiguous() if guard else x, w.contiguous(),
        echo.float().contiguous(), eta_g, has_guard=guard)
