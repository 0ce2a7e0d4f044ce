"""Meshes and the card's constants (the port of the reference's
``repro/launch/mesh.py``).

The reference sizes its meshes over TPU chips and keeps the v5e constants
its roofline divides by.  Here the constants are the H100 SXM's.  Two
kinds of mesh:

  * inside a ``torch.distributed`` process group (one process per device:
    ``torchrun``, or a fake group for the dryrun), the production and test
    meshes and the seed mesh are ``DeviceMesh``es over the group's ranks,
    with the reference's shapes and axis names; clients are placed over
    ``('pod', 'data')`` (``sharding/placement.py``);
  * without one, the seed mesh is a ``SeedMesh``, a small record of the
    devices the seed axis is split over: each seed shard runs whole on
    the first device of its sub-mesh (``launch/experiments.py``'s
    ``seed_shards``), so a mesh over ``[cuda:0, cuda:0]`` splits the
    seeds into two shards on one card.

Nothing here touches a device or a process group at import.
"""
from __future__ import annotations

import dataclasses
import math
import re
import subprocess
from typing import Tuple

# H100 SXM constants used by the roofline analysis (NVIDIA's data sheet,
# dense, per card)
PEAK_FLOPS_BF16 = 989e12       # bf16 on the tensor cores
HBM_BW = 3.35e12               # bytes/s of HBM3
#: NVLink 4, bytes/s each way per card: the counterpart of the
#: reference's ICI link rate, under its name
ICI_BW = 450e9


def in_process_group() -> bool:
    """Whether a ``torch.distributed`` process group is initialised."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _rank_mesh(shape, axes, device_type):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks of the process group; raises, as the reference
    does, when the group is short (or absent)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    have = dist.get_world_size() if in_process_group() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for {axes}={shape}, have {have}: run inside a "
            "process group of that size (torchrun, or launch/dryrun.py's "
            "fake group)")
    # the rank grid stays on the host under a default device
    grid = torch.arange(n, device="cpu").reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """('data', 'model') = (16, 16), or ('pod', 'data', 'model') = (2, 16,
    16), over the process group's ranks (device type "cuda" unless the
    caller asks for "cpu")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _rank_mesh(shape, axes, device_type)


def make_test_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The miniature mesh: (2, 2) or (2, 2, 1), with the production axis
    names."""
    shape = (2, 2, 1) if multi_pod else (2, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _rank_mesh(shape, axes, device_type)


def seed_mesh_shape(n_seeds: int, n_devices: int, *, multi_pod: bool = False):
    """Auto-size a ('seed', 'pod', 'data') mesh, or None when it cannot fit.

    The seed axis is a divisor of ``n_seeds`` (so an ``[S, ...]`` state
    splits evenly; size 1 keeps every seed in one shard).  Among the
    divisors that fit beside the pod axis, pick the one that uses the most
    devices — ``seed * pods * (devices // (seed * pods))`` — the larger
    seed axis breaking ties: S=4 on 6 single-pod devices gives (2, 1, 3),
    all six, not (4, 1, 1).  Returns ``None`` exactly when the pod axis
    alone exceeds the device count (the caller then has no seed axis)."""
    assert n_seeds >= 1 and n_devices >= 0
    pods = 2 if multi_pod else 1
    if pods > n_devices:
        return None
    s_ax = max((d for d in range(1, n_seeds + 1)
                if n_seeds % d == 0 and d * pods <= n_devices),
               key=lambda d: (d * pods * (n_devices // (d * pods)), d))
    return (s_ax, pods, n_devices // (s_ax * pods))


@dataclasses.dataclass(frozen=True)
class SeedMesh:
    """Devices laid out over named axes, row-major: ``devices[i]`` is the
    device at the ``i``-th index of ``shape``.  The same device may stand
    at several places (a mesh over ``[cuda:0, cuda:0]``)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    devices: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} and shape "
                             f"{self.shape} differ in rank")
        if math.prod(self.shape) != len(self.devices):
            raise ValueError(f"shape {self.shape} needs "
                             f"{math.prod(self.shape)} devices; got "
                             f"{len(self.devices)}")


def _devices(devices):
    import torch

    if devices is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def make_seed_mesh(n_seeds: int, *, multi_pod: bool = False,
                   test: bool = False, devices=None, device_type="cuda"):
    """('seed', 'pod', 'data') mesh for the seed-batched grid executor.

    Inside a process group (and without ``devices``): a ``DeviceMesh``
    over the group's ranks, sized by ``seed_mesh_shape`` from the world
    size (``test`` caps it at 8); it must use every rank.  When even the
    pod axis does not fit, it degrades to ``make_test_mesh`` /
    ``make_production_mesh``, as the reference does.

    Otherwise a ``SeedMesh`` over ``devices`` (default: every visible
    card), sized the same way; when the pod axis does not fit it has no
    'seed' axis: ``('data',)`` (or ``('pod', 'data')``) over the devices
    there are, and every seed stays in one shard (callers check ``'seed'
    in mesh.axis_names``)."""
    if devices is None and in_process_group():
        import torch.distributed as dist

        world = dist.get_world_size()
        budget = min(world, 8) if test else world
        shape = seed_mesh_shape(n_seeds, budget, multi_pod=multi_pod)
        if shape is None:
            return (make_test_mesh(multi_pod=multi_pod,
                                   device_type=device_type) if test
                    else make_production_mesh(multi_pod=multi_pod,
                                              device_type=device_type))
        if math.prod(shape) != world:
            raise ValueError(f"the seed mesh {shape} uses {math.prod(shape)}"
                             f" of {world} ranks: launch that many")
        return _rank_mesh(shape, ("seed", "pod", "data"), device_type)
    devs = _devices(devices)
    budget = min(len(devs), 8) if test else len(devs)
    if budget == 0:
        raise RuntimeError("a seed mesh needs at least one device; none is "
                           "visible (pass devices=[...], e.g. the CPU's)")
    shape = seed_mesh_shape(n_seeds, budget, multi_pod=multi_pod)
    if shape is None:
        if multi_pod and budget >= 2:
            return SeedMesh(("pod", "data"), (2, budget // 2),
                            tuple(devs[:2 * (budget // 2)]))
        return SeedMesh(("data",), (budget,), tuple(devs[:budget]))
    return SeedMesh(("seed", "pod", "data"), shape,
                    tuple(devs[:math.prod(shape)]))


def mesh_axis_sizes(mesh):
    """``{axis: size}`` of a ``SeedMesh`` or a ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, mesh.shape))


def n_chips(mesh):
    return math.prod(mesh.shape)


def nvcc_release():
    """nvcc's release (``"12.8"``), or None when no nvcc is found
    (``kernels.nvcc.nvcc_path``)."""
    from repro_torch.kernels.nvcc import nvcc_path

    nvcc = nvcc_path()
    if nvcc is None:
        return None
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    m = re.search(r"release (\d+(?:\.\d+)*)", out)
    return m.group(1) if m else None


def backend_cache_tag() -> str:
    """Key of the kernel-library cache directory
    (``launch/compilecache``): ``torch<version>-cuda<version>-<device
    name>`` on the card and ``torch<version>-cpu-cpu`` without one, with
    ``-nvcc<release>`` appended where nvcc is found.  A library's file
    name hashes its source and flags (``kernels/nvcc.py``), not the
    compiler or the card, so those key the directory.  Path-safe."""
    import torch

    if torch.cuda.is_available():
        backend = f"cuda{torch.version.cuda}"
        kind = torch.cuda.get_device_name(0)
    else:
        backend, kind = "cpu", "cpu"
    tag = f"torch{torch.__version__}-{backend}-{kind}"
    release = nvcc_release()
    if release is not None:
        tag += f"-nvcc{release}"
    return re.sub(r"[^A-Za-z0-9_.-]+", "-", tag)
