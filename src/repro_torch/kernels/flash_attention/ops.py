"""Checked wrapper: the model's attention layout -> the flash kernel.

``flash_mha`` takes the model layout (q ``[B, L, H, D]``, k and v
``[B, S, K, D]``), as ``repro/kernels/flash_attention/ops.py:17`` does.
The kernel reads that layout through strides, so nothing is transposed or
copied on the card.

Device dispatch is by the tensors' device and nothing else: CPU tensors
take the plain version (``ref.py``); CUDA tensors launch the CUDA kernel
(``kernel.py``) or raise.  There is no fallback from the kernel to the
plain version.  Launches are counted in the plain integer attribute
``flash_mha.launches``; a caller resets it by assigning 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_mha_ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
#: the bf16 kernel's query tile, the largest grid axis and the largest
#: tensor-map stride
QUERY_TILE = 128
MAX_GRID = 65535
MAX_STRIDE_BYTES = 2 ** 40


def _check(q, k, v, causal, window, softcap):
    """Validate the operands and options; raise on anything the kernel and
    its plain version do not both take."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B, L, H, D] and k, v [B, S, K, D] of "
                         f"one shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, L, H, D = q.shape
    Bk, S, K, Dk = k.shape
    if Bk != B or Dk != D or min(B, L, S, K) < 1 or H % K != 0:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}: "
                         "need one batch and head dim, and H % K == 0")
    if L > S:
        raise ValueError(f"queries are end-aligned to keys: need L <= S, "
                         f"got L={L}, S={S}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype in {DTYPES}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if window is not None and (isinstance(window, bool)
                               or not isinstance(window, int) or window < 1):
        raise ValueError(f"window must be None or an int >= 1; got "
                         f"{window!r}")
    if isinstance(softcap, bool) or not isinstance(softcap, (int, float)) \
            or softcap < 0:
        raise ValueError(f"softcap must be a number >= 0; got {softcap!r}")
    if not isinstance(causal, bool):
        raise TypeError(f"causal must be a bool; got {causal!r}")


def _check_kernel_operands(q, k, v):
    """What the CUDA kernels need beyond ``_check``: head dims that are a
    multiple of 8 up to 256, a unit last stride, and rows that start on
    16-byte boundaries (vector loads; TMA's base and stride alignment).
    The bf16 kernel's tensor maps take strides below 2^40 bytes and dims
    that fit 32 bits, and its grid (heads, batch, 128-query tiles) at most
    65 535 blocks along each axis."""
    B, L, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if D % 8 != 0 or D > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head dims that are a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}; got {D}")
    if max(B, H, -(-L // QUERY_TILE)) > MAX_GRID or max(L, S) >= 2 ** 31:
        raise ValueError(f"the kernel's grid takes at most {MAX_GRID} "
                         f"heads, batch rows and {QUERY_TILE}-query tiles, "
                         f"and lengths below 2^31; got B={B}, H={H}, "
                         f"L={L}, S={S}")
    per_16_bytes = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % per_16_bytes for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel needs a unit last stride, "
                             f"the other strides a multiple of "
                             f"{per_16_bytes} elements and a 16-byte aligned "
                             f"start; got strides {t.stride()}")
        if any(s * t.element_size() >= MAX_STRIDE_BYTES for s in t.stride()):
            raise ValueError(f"{name}: a tensor map takes strides below "
                             f"2^40 bytes; got strides {t.stride()}")


def flash_mha(q, k, v, *, causal=True, window=None, softcap=0.0):
    """q: [B, L, H, D]; k, v: [B, S, K, D] (model layout) -> [B, L, H, D].

    Queries are end-aligned with keys (query i sits at key position
    i + S - L); query head h reads kv head h // (H / K); scores are
    soft-capped by ``softcap`` when it is nonzero and masked causally
    and by ``window``."""
    _check(q, k, v, causal, window, softcap)
    if q.device.type == "cpu":
        return flash_mha_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    _check_kernel_operands(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kernel.launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  out.transpose(1, 2), causal=causal, window=window,
                  softcap=softcap)
    flash_mha.launches += 1
    return out


flash_mha.launches = 0
