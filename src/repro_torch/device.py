"""Device resolution for the port's entry points.

``resolve_device`` returns exactly the device asked for: ``"cuda"`` raises
when no card is visible (no silent CPU fallback), ``"cpu"`` is what the
tests pass.  It also turns TF32 off for matmuls and cuDNN convolutions:
torch's cuDNN default computes float32 convolutions in TF32 (about three
decimal digits), while the reference CNN is float32 end to end.
"""
from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type not in DEVICES:
        raise ValueError(f"unsupported device {device!r}; expected one of "
                         f"{DEVICES}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was asked for but no CUDA device is "
            "visible (torch.cuda.is_available() is False); pass "
            "device='cpu' (--device cpu) to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
