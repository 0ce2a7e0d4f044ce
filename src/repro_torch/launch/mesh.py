"""The seed mesh and the card's constants (the single-process half of the
reference's ``repro/launch/mesh.py``).

The reference sizes a ``('seed', 'pod', 'data')`` mesh over TPU chips and
keeps the v5e constants its roofline divides by.  Here the constants are
the H100 SXM's, and the seed mesh is a small record of the devices the
seed axis is split over: each seed shard runs whole on the first device of
its sub-mesh (``launch/experiments.py``'s ``seed_shards``), so a mesh over
``[cuda:0, cuda:0]`` splits the seeds into two shards on one card.  The
production and test meshes, which place clients over ``('pod', 'data')``,
come with ``sharding/``.

Nothing here touches a device at import.
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
                   test: bool = False, devices=None) -> SeedMesh:
    """('seed', 'pod', 'data') mesh for the seed-batched grid executor,
    over ``devices`` (default: every visible card).  Sized by
    ``seed_mesh_shape``; ``test`` caps it at 8 devices.  When even the pod
    axis does not fit, the mesh has no 'seed' axis: ``('data',)`` (or
    ``('pod', 'data')``) over the devices there are, and every seed stays
    in one shard (callers check ``'seed' in mesh.axis_names``)."""
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
    return dict(zip(mesh.axis_names, mesh.shape))


def n_chips(mesh):
    return len(mesh.devices)


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
