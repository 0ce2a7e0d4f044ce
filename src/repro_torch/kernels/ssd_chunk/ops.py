"""The SSD scan assembled from the intra-chunk kernel (K5) and a plain
inter-chunk recurrence; a port of ``repro/kernels/ssd_chunk/ops.py``
``ssd_chunked_pallas``, the JAX package's drop-in equivalent of
``models.ssm.ssd_chunked`` (layout ``[b, l, h, p]`` in and out).

``ssd_chunk`` is the checked wrapper of the kernel.  Device dispatch is by
the tensors' device and nothing else: CPU tensors take the plain version
(``ref.py``); CUDA tensors launch a CUDA kernel (``kernel.py``) or raise.
Of the two CUDA kernels, ``wgmma_route`` chooses before the launch, from
dtype, shapes, strides and alignment alone: bfloat16 operands that the
tensor maps can describe take the tensor-core kernel, everything else the
FP32-pipe kernel.  There is no fallback from one kernel to the other or to
the plain version.  Launches are counted in the plain integer attributes
``ssd_chunk.launches`` (every launch of either kernel) and
``ssd_chunk.wgmma_launches`` (the tensor-core kernel's); a caller resets
them by assigning 0.

``ssd_chunked`` (what ``models.ssm.mamba_block`` calls) regroups its
operands to ``[b, h, c, K, .]`` by views only: the kernels read the model
layout through strides, and B and C may be stride-0 expansions of their
groups.  The inter-chunk recurrence and ``y_off`` stay plain torch, as
they are jnp outside Pallas in the reference: a loop of one launch per
chunk, then one batched matrix product.  ``ssd_chunked_plain`` is the same
scan with the plain intra-chunk block on any device, for comparisons on
the card; the model never calls it, nor ``_ssd_chunk_simt``, which runs
the FP32-pipe kernel on any operands it takes.
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


#: the tensor-core kernel's tiles: P up to 64 (one 128-byte panel) in
#: whole 16-byte rows; tensor maps take 16-byte aligned bases and strides
#: below 2^40 bytes; its grid at most 2^31 - 1 blocks
WGMMA_MAX_P = 64
TMA_ALIGN = 16
MAX_STRIDE_BYTES = 2 ** 40
MAX_BLOCKS = 2 ** 31 - 1


def _tma_ok(t, strides):
    """A 16-byte aligned base, a unit last stride, and the given strides
    multiples of 16 bytes below 2^40 bytes."""
    es = t.element_size()
    return (t.data_ptr() % TMA_ALIGN == 0 and t.stride(-1) == 1
            and all(s >= 0 and s * es % TMA_ALIGN == 0
                    and s * es < MAX_STRIDE_BYTES for s in strides))


def wgmma_route(xdt, dA, B_, C_):
    """Whether ``ssd_chunk`` on the card launches the tensor-core kernel
    (else the FP32-pipe kernel), for operands ``_check`` has accepted.

    A pure function of dtype, shapes, strides and alignment: bfloat16
    operands with P <= 64 and P % 8 == 0 (x and y rows of whole 16-byte
    chunks) whose tensor maps exist, i.e. x, B and C with 16-byte aligned
    bases and every stride a multiple of 16 bytes; B and C either both of
    head stride 0 (one tile per (batch, chunk) for every head: every
    config of the registry, through ``models.ssm._expand_groups``) or both
    of nonzero head strides.  dA is read with plain loads, so its strides
    do not matter."""
    if xdt.dtype != torch.bfloat16:
        return False
    b, h, c, _, P = xdt.shape
    if P > WGMMA_MAX_P or P % 8 or b * c * h > MAX_BLOCKS:
        return False
    bs, cs = B_.stride(), C_.stride()
    shared = bs[1] == 0 and cs[1] == 0
    if not shared and (bs[1] == 0 or cs[1] == 0):
        return False
    keep = (0, 2, 3) if shared else (0, 1, 2, 3)
    return (_tma_ok(xdt, xdt.stride()[:4])
            and _tma_ok(B_, [bs[i] for i in keep])
            and _tma_ok(C_, [cs[i] for i in keep]))


def head_run(b, h, c, shared, n_sm):
    """Heads one block of the tensor-core kernel takes: 1 unless B and C
    are shared by the heads; else the heads split into as few runs as
    keep ``n_sm`` SMs busy with one block each (all h when the b * c
    (batch, chunk) pairs alone fill them: zamba2-7b's and mamba2-130m's
    prefills, b * c = 128), so that every C.B^T serves as many heads as
    it can."""
    if not shared:
        return 1
    splits = max(1, min(h, n_sm // (b * c)))
    return -(-h // splits)


_N_SM = {}


def _sm_count(device):
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _N_SM:
        _N_SM[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _N_SM[idx]


def ssd_chunk(xdt, dA, B_, C_):
    """xdt: [b,h,c,K,P]; dA: [b,h,c,K] float32; B_, C_: [b,h,c,K,N].

    Returns (y_diag [b,h,c,K,P] in xdt's dtype, states float32
    [b,h,c,N,P], decay float32 [b,h,c]).  On the card y_diag is a view of
    ``[b, c, K, h, P]`` memory, the model layout of the scan's output."""
    _check(xdt, dA, B_, C_)
    if xdt.device.type == "cpu":
        return ssd_chunk_ref(xdt, dA, B_, C_)
    return _launch(xdt, dA, B_, C_, wgmma_route(xdt, dA, B_, C_))


def _ssd_chunk_simt(xdt, dA, B_, C_):
    """The FP32-pipe kernel on CUDA operands, whatever ``wgmma_route``
    says: a yardstick for the tensor-core kernel on the card (chip_smoke's
    ``time_ssd``).  The model never calls it."""
    _check(xdt, dA, B_, C_)
    if xdt.device.type != "cuda":
        raise ValueError(f"the FP32-pipe kernel runs on the card; got "
                         f"{xdt.device}")
    return _launch(xdt, dA, B_, C_, False)


def _launch(xdt, dA, B_, C_, wgmma):
    if not wgmma:
        for name, t in (("xdt", xdt), ("B_", B_), ("C_", C_)):
            if t.stride(-1) != 1:
                raise ValueError(f"{name}: the kernel needs a unit last "
                                 f"stride; got strides {t.stride()}")
    b, h, c, K, P = xdt.shape
    N = B_.shape[-1]
    dev = xdt.device
    y = torch.empty((b, c, K, h, P), dtype=xdt.dtype,
                    device=dev).permute(0, 3, 1, 2, 4)
    states = torch.empty((b, h, c, N, P), dtype=torch.float32, device=dev)
    decay = torch.empty((b, h, c), dtype=torch.float32, device=dev)
    if wgmma:
        shared = B_.stride(1) == 0 and C_.stride(1) == 0
        kernel.launch_wgmma(xdt, dA, B_, C_, y, states, decay,
                            head_run(b, h, c, shared, _sm_count(dev)))
        ssd_chunk.wgmma_launches += 1
    else:
        kernel.launch(xdt, dA, B_, C_, y, states, decay)
    ssd_chunk.launches += 1
    return y, states, decay


ssd_chunk.launches = 0
ssd_chunk.wgmma_launches = 0


def _plain_chunk(xdt, dA, B_, C_):
    _check(xdt, dA, B_, C_)
    return ssd_chunk_ref(xdt, dA, B_, C_)


def regroup(v, chunk):
    """[b, l, h, *f] -> [b, h, c, chunk, *f], a view (the reference's
    ``grp``, ``ops.py:25-27``)."""
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
    y_off is added, as in the reference's drop-in (``ops.py:57``)."""
    return _scan(xdt, dA, B_, C_, chunk, initial_state, ssd_chunk)


def ssd_chunked_plain(xdt, dA, B_, C_, chunk, initial_state=None):
    """``ssd_chunked`` with the plain intra-chunk block on any device: the
    oracle of the kernel route on the card."""
    return _scan(xdt, dA, B_, C_, chunk, initial_state, _plain_chunk)
