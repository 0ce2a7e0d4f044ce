"""Architecture registry: ``--arch <id>`` resolution, input shapes and
long-context support flags; a copy of ``repro/configs`` holding every
architecture of the reference's registry, in its order: the dense
attention models (gemma2-2b, internlm2-20b, llama3-8b, tiny), the
encoder-decoder seamless-m4t-large-v2 (audio frames from a stub
frontend) and internvl2-2b (vision patch embeddings from a stub
frontend), the MoE models olmoe-1b-7b and moonshot-v1-16b-a3b,
gemma3-27b and mixtral-8x22b (``fl_mode="lora"``: adapters over a frozen
base), and the Mamba2 models mamba2-130m (pure SSM) and
zamba2-7b (Mamba2 with a weight-shared attention block)."""
from __future__ import annotations

import importlib

from repro_torch.configs.shapes import SHAPES, InputShape  # noqa: F401

_MODULES = {
    "gemma2-2b": "gemma2_2b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "internlm2-20b": "internlm2_20b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mamba2-130m": "mamba2_130m",
    "gemma3-27b": "gemma3_27b",
    "mixtral-8x22b": "mixtral_8x22b",
    "zamba2-7b": "zamba2_7b",
    "internvl2-2b": "internvl2_2b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    # extras beyond the assigned pool (selectable but not in the 10x4 sweep)
    "llama3-8b": "llama3_8b",
    "tiny": "tiny",
}

_EXTRAS = ("llama3-8b", "tiny")
ARCHS = [k for k in _MODULES if k not in _EXTRAS]


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _mod(name).CONFIG


def supports_long_context(name: str) -> bool:
    return bool(getattr(_mod(name), "LONG_CONTEXT", False))


def supported_shapes(name: str):
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not supports_long_context(name):
            continue
        out.append(s.name)
    return out
