"""A keyed, persistent directory for the port's compiled kernels (the
counterpart of the reference's ``repro/launch/compilecache.py``).

The reference points jax's persistent compilation cache at a directory so
that re-runs skip XLA.  The port compiles nothing but its hand-written CUDA
kernels: nvcc builds each at its first launch into a shared library
(``kernels/nvcc.py``), by default under ``<repo>/build/kernels``, and a
later process loads the library it finds there without nvcc.  This module
points that build directory at a KEYED one —
``~/.cache/repro-torch/<launch.mesh.backend_cache_tag()>`` by default, so
libraries never mix across torch and CUDA versions, cards or nvcc
releases — and reports the process's hits (libraries found and loaded
without nvcc) and misses (nvcc runs).

CLI entry points: ``--compile-cache DIR|auto`` on
``repro_torch.launch.experiments`` and ``repro_torch.launch.train``.
"""
from __future__ import annotations

import os

from repro_torch.kernels import nvcc

_DIR: str | None = None


def default_cache_dir() -> str:
    """The keyed default: ``~/.cache/repro-torch/<backend_cache_tag()>``
    (base overridable via ``REPRO_COMPILE_CACHE_BASE``)."""
    from repro_torch.launch.mesh import backend_cache_tag
    base = os.environ.get(
        "REPRO_COMPILE_CACHE_BASE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro-torch"))
    return os.path.join(base, backend_cache_tag())


def enable(cache_dir: str = "") -> str:
    """Build and load the kernel libraries in ``cache_dir`` (created if
    missing; ``''``/``'auto'`` resolve to ``default_cache_dir()``).
    Idempotent: a repeated call re-points the directory; a library already
    loaded in this process stays loaded.  Returns the resolved absolute
    path."""
    global _DIR
    path = cache_dir if cache_dir not in ("", "auto") else \
        default_cache_dir()
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(path, exist_ok=True)
    nvcc.set_build_dir(path)
    _DIR = path
    return path


def cache_dir():
    """The directory ``enable`` resolved to, or None before ``enable``."""
    return _DIR


def counters() -> dict:
    """This process's library counts since import: ``hits`` (libraries
    found built and loaded without nvcc) and ``misses`` (nvcc runs)."""
    return dict(nvcc.COUNTS)
