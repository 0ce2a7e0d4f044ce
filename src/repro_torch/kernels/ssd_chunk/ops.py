"""The SSD scan assembled from the intra-chunk kernel (K5) and a plain
inter-chunk recurrence; a port of ``repro/kernels/ssd_chunk/ops.py``
``ssd_chunked_pallas``, the JAX package's drop-in equivalent of
``models.ssm.ssd_chunked`` (layout ``[b, l, h, p]`` in and out).

``ssd_chunk`` is the checked wrapper of the kernel.  Device dispatch is by
the tensors' device and nothing else: CPU tensors take the plain version
(``ref.py``); CUDA tensors launch the CUDA kernel (``kernel.py``) or
raise.  There is no fallback from the kernel to the plain version.
Launches are counted in the plain integer attribute
``ssd_chunk.launches``; a caller resets it by assigning 0.

``ssd_chunked`` (what ``models.ssm.mamba_block`` calls) regroups its
operands to ``[b, h, c, K, .]`` by views only: the kernel reads the model
layout through strides, and B and C may be stride-0 expansions of their
groups.  The inter-chunk recurrence and ``y_off`` stay plain torch, as
they are jnp outside Pallas in the reference: a loop of one launch per
chunk, then one batched matrix product.  ``ssd_chunked_plain`` is the same
scan with the plain intra-chunk block on any device, for comparisons on
the card; the model never calls it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_chunk import kernel
from repro_torch.kernels.ssd_chunk.ref import cumsum_f32, ssd_chunk_ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_DIM = 128


def _check(xdt, dA, B_, C_):
    """Validate the [b, h, c, K, .] operands; raise on anything the kernel
    and its plain version do not both take."""
    if xdt.dim() != 5 or dA.dim() != 4 or B_.dim() != 5 \
            or C_.shape != B_.shape:
        raise ValueError(f"need xdt [b,h,c,K,P], dA [b,h,c,K] and B_, C_ "
                         f"[b,h,c,K,N] of one shape; got {tuple(xdt.shape)}, "
                         f"{tuple(dA.shape)}, {tuple(B_.shape)}, "
                         f"{tuple(C_.shape)}")
    if tuple(dA.shape) != tuple(xdt.shape[:4]) \
            or tuple(B_.shape[:4]) != tuple(xdt.shape[:4]):
        raise ValueError(f"leading dims differ: {tuple(xdt.shape)}, "
                         f"{tuple(dA.shape)}, {tuple(B_.shape)}")
    K, P, N = xdt.shape[3], xdt.shape[4], B_.shape[4]
    if min(xdt.shape[:3]) < 1 or not (1 <= K <= MAX_DIM and 1 <= P <= MAX_DIM
                                      and 1 <= N <= MAX_DIM):
        raise ValueError(f"the kernel takes 1 <= K, P, N <= {MAX_DIM} and a "
                         f"nonempty grid; got {tuple(xdt.shape)}, N={N}")
    if xdt.dtype not in DTYPES or B_.dtype != xdt.dtype \
            or C_.dtype != xdt.dtype:
        raise TypeError(f"xdt, B_, C_ must share a dtype in {DTYPES}; got "
                        f"{xdt.dtype}, {B_.dtype}, {C_.dtype}")
    if dA.dtype != torch.float32:
        raise TypeError(f"dA must be float32; got {dA.dtype}")
    if any(t.device != xdt.device for t in (dA, B_, C_)):
        raise ValueError("xdt, dA, B_, C_ must lie on one device")
    if xdt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xdt.device}")


def ssd_chunk(xdt, dA, B_, C_):
    """xdt: [b,h,c,K,P]; dA: [b,h,c,K] float32; B_, C_: [b,h,c,K,N].

    Returns (y_diag [b,h,c,K,P] in xdt's dtype, states float32
    [b,h,c,N,P], decay float32 [b,h,c]).  On the card y_diag is a view of
    ``[b, c, K, h, P]`` memory, the model layout of the scan's output."""
    _check(xdt, dA, B_, C_)
    if xdt.device.type == "cpu":
        return ssd_chunk_ref(xdt, dA, B_, C_)
    for name, t in (("xdt", xdt), ("B_", B_), ("C_", C_)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the kernel needs a unit last stride; "
                             f"got strides {t.stride()}")
    b, h, c, K, P = xdt.shape
    N = B_.shape[-1]
    dev = xdt.device
    y = torch.empty((b, c, K, h, P), dtype=xdt.dtype,
                    device=dev).permute(0, 3, 1, 2, 4)
    states = torch.empty((b, h, c, N, P), dtype=torch.float32, device=dev)
    decay = torch.empty((b, h, c), dtype=torch.float32, device=dev)
    kernel.launch(xdt, dA, B_, C_, y, states, decay)
    ssd_chunk.launches += 1
    return y, states, decay


ssd_chunk.launches = 0


def _plain_chunk(xdt, dA, B_, C_):
    _check(xdt, dA, B_, C_)
    return ssd_chunk_ref(xdt, dA, B_, C_)


def regroup(v, chunk):
    """[b, l, h, *f] -> [b, h, c, chunk, *f], a view (the reference's
    ``grp``, ``ops.py:111-113``)."""
    b, l, h = v.shape[:3]
    v = v.reshape((b, l // chunk, chunk, h) + tuple(v.shape[3:]))
    return v.permute((0, 3, 1, 2) + tuple(range(4, v.dim())))


def _scan(xdt, dA, B_, C_, chunk, initial_state, chunk_fn):
    b, l, h, p = xdt.shape
    n = B_.shape[-1]
    if chunk < 1 or l % chunk:
        raise ValueError(f"chunk {chunk} must divide the length {l}")
    c = l // chunk
    X, A, Bm, Cm = (regroup(v, chunk) for v in (xdt, dA, B_, C_))
    y_diag, states, decay = chunk_fn(X, A, Bm, Cm)

    # inter-chunk recurrence (linear scan over c): prev[i] is the state
    # entering chunk i, prev[c] the final one
    f32 = torch.float32
    prev = torch.empty((c + 1, b, h, n, p), dtype=f32, device=xdt.device)
    if initial_state is None:
        prev[0].zero_()
    else:
        prev[0].copy_(initial_state.transpose(-1, -2))
    for i in range(c):
        torch.addcmul(states[:, :, i], prev[i], decay[:, :, i, None, None],
                      out=prev[i + 1])

    # chunk-input contribution: y_off[k] = (C_k * exp(A_cs_k)) @ prev_state
    A_cs = cumsum_f32(A)
    y_off = torch.matmul(Cm.to(f32) * torch.exp(A_cs)[..., None],
                         prev[:c].permute(1, 2, 0, 3, 4))      # [b,h,c,K,p]
    y = (y_diag.to(f32) + y_off).permute(0, 2, 3, 1, 4)        # [b,c,K,h,p]
    return y.reshape(b, l, h, p).to(xdt.dtype), prev[c].transpose(-1, -2)


def ssd_chunked(xdt, dA, B_, C_, chunk, initial_state=None):
    """xdt: [b,l,h,p]; dA: [b,l,h] float32; B_, C_: [b,l,h,n].
    Returns (y [b,l,h,p], final_state float32 [b,h,p,n]) — matches
    ``models.ssm.ssd_chunked``.  y_diag is rounded to xdt's dtype before
    y_off is added, as in the reference's drop-in (``ops.py:143``)."""
    return _scan(xdt, dA, B_, C_, chunk, initial_state, ssd_chunk)


def ssd_chunked_plain(xdt, dA, B_, C_, chunk, initial_state=None):
    """``ssd_chunked`` with the plain intra-chunk block on any device: the
    oracle of the kernel route on the card."""
    return _scan(xdt, dA, B_, C_, chunk, initial_state, _plain_chunk)
