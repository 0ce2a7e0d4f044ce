"""Device resolution and the port's float32 policy.

``resolve_device`` returns exactly the device asked for: ``"cuda"`` raises
when no card is visible (no silent CPU fallback), ``"cpu"`` is what the
tests pass.  ``float32_policy`` turns TF32 off for matmuls and cuDNN
convolutions: torch's cuDNN default computes float32 convolutions in TF32
(about three decimal digits), while the reference CNN is float32 end to
end.  The entry points apply it through ``resolve_device``, and the
engine applies it wherever it builds a state or a round
(``core.engine.init_fl_state``, ``make_round_fn``), so a run built
straight from the engine keeps it too.
"""
from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def float32_policy():
    """Full float32 in cuBLAS matmuls and cuDNN convolutions (TF32 off).
    The flags are process-wide and touch only CUDA, so setting them on a
    CPU run changes nothing there."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
    float32_policy()
    return dev
