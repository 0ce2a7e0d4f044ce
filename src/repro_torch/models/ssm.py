"""Mamba2 / SSD (state-space duality) blocks; a port of
``repro/models/ssm.py`` with the same names and layouts.

The chunked SSD algorithm runs intra-chunk quadratic blocks plus an
inter-chunk state recurrence.  ``ssd_chunked`` is the plain port of the
reference's jnp function and, with the naive sequential recurrence
``ssd_recurrence_ref``, the correctness oracle; ``ssd_decode_step`` serves
O(1)-per-token decode.

``mamba_block`` takes its route from the mode the model's ``apply_block``
carries.  In training (``mode="train"``) it runs the SSD scan through
``ssd_chunked``, the plain port of the reference's jnp function, which is
what the reference's ``mamba_block`` trains through (``ssm.py:200``):
differentiable, and written without ``out=`` or in-place writes so that
it also runs under the client ``torch.func.vmap`` of local SGD.  K5 has
no backward (nor has the reference's Pallas kernel), so training never
reaches it.  In prefill the port calls
``kernels/ssd_chunk/ops.ssd_chunked``: the port of the JAX package's own
drop-in equivalent ``ssd_chunked_pallas`` (``kernels/ssd_chunk/ops.py:16``),
which carries the SSD chunk kernel (K5).  In float32 the two differ only
in summation order; in bfloat16 the drop-in rounds the diagonal-block
output to the input dtype before adding the inter-chunk part, as the
reference's drop-in does.  Caches are written in place (the reference
returns new ones).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk.ref import cumsum_f32, segsum
from repro_torch.models.layers import rms_norm


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(xdt, dA, B_, C_, chunk, initial_state=None):
    """Chunked SSD scan (plain torch).

    xdt: [b, l, h, p]   (inputs already multiplied by dt)
    dA:  [b, l, h]      (dt * A, negative)
    B_, C_: [b, l, h, n]
    Returns (y [b, l, h, p], final_state [b, h, p, n])."""
    b, l, h, p = xdt.shape
    n = B_.shape[-1]
    if l % chunk:
        raise ValueError(f"chunk {chunk} must divide the length {l}")
    c = l // chunk

    f32 = torch.float32
    X = xdt.reshape(b, c, chunk, h, p).to(f32)
    A = dA.reshape(b, c, chunk, h).permute(0, 3, 1, 2).to(f32)  # [b,h,c,k]
    Bm = B_.reshape(b, c, chunk, h, n).to(f32)
    Cm = C_.reshape(b, c, chunk, h, n).to(f32)

    A_cs = cumsum_f32(A)              # [b,h,c,k]
    L = torch.exp(segsum(A))          # [b,h,c,k,k]

    # 1. intra-chunk (diagonal blocks)
    Y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Cm, Bm, L, X)

    # 2. per-chunk end states
    decay_states = torch.exp(A_cs[:, :, :, -1:] - A_cs)  # [b,h,c,k]
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bm, decay_states, X)

    # 3. inter-chunk recurrence (linear scan over chunks)
    chunk_decay = torch.exp(A_cs[:, :, :, -1])  # [b,h,c]
    carry = (torch.zeros((b, h, p, n), dtype=f32, device=xdt.device)
             if initial_state is None else initial_state.to(f32))
    prev = []
    for i in range(c):
        prev.append(carry)  # the state *entering* chunk i
        carry = carry * chunk_decay[:, :, i, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)  # [b,c,h,p,n]

    # 4. chunk-input contribution to outputs
    state_decay_out = torch.exp(A_cs)  # [b,h,c,k]
    Y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cm, prev_states,
                         state_decay_out)

    y = (Y_diag + Y_off).reshape(b, l, h, p)
    return y.to(xdt.dtype), carry


def ssd_recurrence_ref(xdt, dA, B_, C_, initial_state=None):
    """Sequential oracle: h_t = exp(dA_t) h_{t-1} + B_t xdt_t^T ; y_t = C_t h_t."""
    b, l, h, p = xdt.shape
    n = B_.shape[-1]
    f32 = torch.float32
    hs = (torch.zeros((b, h, p, n), dtype=f32, device=xdt.device)
          if initial_state is None else initial_state.to(f32))
    ys = []
    for t in range(l):
        hs = hs * torch.exp(dA[:, t].to(f32))[..., None, None] + \
            xdt[:, t, :, :, None].to(f32) * B_[:, t, :, None, :].to(f32)
        ys.append(torch.einsum("bhpn,bhn->bhp", hs, C_[:, t].to(f32)))
    return torch.stack(ys, dim=1).to(xdt.dtype), hs


def ssd_decode_step(state, xdt, dA, B_, C_):
    """One-token recurrence. state: [b,h,p,n]; xdt: [b,h,p]; dA: [b,h];
    B_, C_: [b,h,n]. Returns (y [b,h,p], new_state in state's dtype)."""
    f32 = torch.float32
    new = state.to(f32) * torch.exp(dA.to(f32))[..., None, None] + \
        xdt[..., :, None].to(f32) * B_[..., None, :].to(f32)
    y = torch.einsum("bhpn,bhn->bhp", new, C_.to(f32))
    return y.to(xdt.dtype), new.to(state.dtype)


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------

def conv1d_causal(x, w, b, *, train=False):
    """x: [B, L, C]; w: [C, W]; depthwise causal conv in float32 (the
    reference's ``conv_general_dilated`` with ``feature_group_count=C``:
    a cross-correlation over the left-padded sequence).  The result is a
    contiguous [B, L, C]: the SSD kernel reads the channels split from it
    (x, B, C) with unit stride.  ``train`` returns the same values without
    ``out=`` (autograd and ``torch.func.vmap`` take none), in the conv's
    layout: the plain scan needs no unit stride."""
    W = w.shape[-1]
    xp = F.pad(x.to(torch.float32).transpose(1, 2), (W - 1, 0))  # [B, C, L+W-1]
    out = F.conv1d(xp, w.to(torch.float32)[:, None, :], groups=w.shape[0])
    if train:
        return (out.transpose(1, 2) + b.to(torch.float32)).to(x.dtype)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    torch.add(out.transpose(1, 2), b.to(torch.float32), out=y)
    return y.to(x.dtype)


def conv1d_step(cache, x_t, w, b):
    """cache: [B, W-1, C] previous inputs; x_t: [B, C]. Returns (y_t, cache)."""
    window = torch.cat([cache, x_t[:, None, :]], dim=1)  # [B, W, C]
    y = torch.einsum("bwc,cw->bc", window.to(torch.float32),
                     w.to(torch.float32)) + b.to(torch.float32)
    return y.to(x_t.dtype), window[:, 1:]


# ---------------------------------------------------------------------------
# full Mamba2 block
# ---------------------------------------------------------------------------

def _split_proj(proj, cfg):
    di, gn, h = cfg.ssm_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads
    z = proj[..., :di]
    xBC = proj[..., di:di + di + 2 * gn]
    dt_raw = proj[..., di + di + 2 * gn:]
    if dt_raw.shape[-1] != h:
        raise ValueError(f"projection width {proj.shape[-1]} does not fit "
                         f"the config ({h} heads)")
    return z, xBC, dt_raw


def _expand_groups(v, cfg):
    """[..., G, N] -> [..., H, N], each group repeated over its heads: a
    stride-0 view when there is one group (every config of the registry),
    a copy otherwise."""
    reps = cfg.ssm_heads // cfg.ssm_groups
    if cfg.ssm_groups == 1:
        return v.expand(v.shape[:-2] + (cfg.ssm_heads, v.shape[-1]))
    return torch.repeat_interleave(v, reps, dim=-2)


def softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0), with no
    linear branch above a threshold (``F.softplus`` has one at 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_block(x, bp, cfg, *, mode=None, decode_cache=None,
                prefill_cache=None):
    """Mamba2 block. x: [B, L, d]. Returns y [B, L, d].

    ``mode`` "train": the full-sequence pass through the plain,
    differentiable ``ssd_chunked`` (vmap-safe; no kernel).  "prefill":
    the full-sequence pass through ``ssd_ops.ssd_chunked`` (K5 on the
    card), filling ``prefill_cache`` when one is given: dict(conv, state)
    written in place with the last W-1 raw conv inputs and the final SSM
    state, in the cache's dtype.  "decode": one token against
    ``decode_cache`` (dict(conv, state)), updated in place.  Left None,
    the mode is the cache's ("decode" or "prefill"), else "train"."""
    if mode is None:
        mode = ("decode" if decode_cache is not None else
                "prefill" if prefill_cache is not None else "train")
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: 'train', 'prefill' or 'decode'")
    if (mode == "decode") != (decode_cache is not None) \
            or (prefill_cache is not None and mode != "prefill"):
        raise ValueError(f"mode {mode!r} does not take the caches given")
    y, z = _mixer(x, bp, cfg, mode == "train", decode_cache, prefill_cache)
    y = rms_norm(y * F.silu(z), bp["ln_out"], cfg.norm_eps)
    return y @ bp["out_proj"]


def _mixer(x, bp, cfg, train, decode_cache=None, prefill_cache=None):
    """``mamba_block`` up to its gated norm: the SSD output with its skip
    ``y`` [B, L, di] and the gate ``z``."""
    B, L, d = x.shape
    di, G, N, H, P = (cfg.ssm_inner, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_head_dim)
    proj = x @ bp["in_proj"]
    z, xBC, dt_raw = _split_proj(proj, cfg)

    xBC_raw = xBC
    if decode_cache is None:
        xBC = conv1d_causal(xBC, bp["conv_w"], bp["conv_b"], train=train)
    else:
        if L != 1:
            raise ValueError(f"decode takes one token per row; got L={L}")
        y1, window = conv1d_step(decode_cache["conv"], xBC[:, 0],
                                 bp["conv_w"], bp["conv_b"])
        decode_cache["conv"].copy_(window)
        xBC = y1[:, None, :]
    xBC = F.silu(xBC)

    xs = xBC[..., :di].reshape(B, L, H, P)
    Bv = xBC[..., di:di + G * N].reshape(B, L, G, N)
    Cv = xBC[..., di + G * N:].reshape(B, L, G, N)
    Bv = _expand_groups(Bv, cfg)  # [B,L,H,N]
    Cv = _expand_groups(Cv, cfg)

    dt = softplus(dt_raw.to(torch.float32)
                  + bp["dt_bias"].to(torch.float32))  # [B,L,H]
    A = -torch.exp(bp["A_log"].to(torch.float32))  # [H]
    dA = dt * A
    if train:
        xdt = xs * dt[..., None].to(xs.dtype)
    else:
        # written contiguous: an elementwise product may take its layout
        # from the broadcast operand, and the SSD kernel reads p with unit
        # stride
        xdt = torch.empty(xs.shape, dtype=xs.dtype, device=xs.device)
        torch.mul(xs, dt[..., None].to(xs.dtype), out=xdt)

    if decode_cache is None:
        chunk = min(cfg.ssm_chunk, L)
        if L % chunk:
            chunk = 1  # fallback for odd tiny lengths
        scan = ssd_chunked if train else ssd_ops.ssd_chunked
        y, final = scan(xdt, dA, Bv, Cv, chunk)
        if prefill_cache is not None:
            W = cfg.ssm_conv
            tail = xBC_raw[:, max(0, L - (W - 1)):]
            conv = prefill_cache["conv"]
            conv.zero_()
            conv[:, W - 1 - tail.shape[1]:] = tail.to(conv.dtype)
            prefill_cache["state"].copy_(final.to(x.dtype))
    else:
        y, state = ssd_decode_step(decode_cache["state"], xdt[:, 0],
                                   dA[:, 0], Bv[:, 0], Cv[:, 0])
        decode_cache["state"].copy_(state)
        y = y[:, None]

    y = y + xs * bp["D"].to(xs.dtype)[:, None]
    y = y.reshape(B, L, di)
    return y, z


def head_group(bp, cfg, n_h, g):
    """Head group ``g`` of ``n_h`` of a Mamba2 block: the weights of its
    heads (their z, x and dt columns of ``in_proj`` and ``out_proj``'s
    rows, their conv channels, A, D, dt bias and norm scale; the B and C
    columns of their SSM groups, all of them with one group) and its
    config.  The whole block for one group."""
    if n_h == 1:
        return bp, cfg
    di, G, N, H = cfg.ssm_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    dg, hg = di // n_h, H // n_h
    gg = G // n_h if G % n_h == 0 else G
    lo = g * gg if G % n_h == 0 else 0

    def ar(start, n):
        return torch.arange(start, start + n, device=bp["in_proj"].device)

    zx = ar(g * dg, dg)
    bc = torch.cat([ar(di + lo * N, gg * N), ar(di + G * N + lo * N, gg * N)])
    cols = torch.cat([zx, di + zx, di + bc, 2 * di + 2 * G * N + ar(g * hg,
                                                                    hg)])
    conv = torch.cat([zx, bc])
    heads = ar(g * hg, hg)
    part = dict(in_proj=bp["in_proj"].index_select(1, cols),
                out_proj=bp["out_proj"].index_select(0, zx),
                ln_out=bp["ln_out"].index_select(0, zx),
                conv_w=bp["conv_w"].index_select(0, conv),
                conv_b=bp["conv_b"].index_select(0, conv))
    part.update({k: bp[k].index_select(0, heads)
                 for k in ("A_log", "D", "dt_bias")})
    return part, cfg.replace(ssm_heads=hg, ssm_groups=gg)


def mamba_parts(x, bp, cfg, n_h=1, g=0):
    """Head group ``g`` of ``n_h``'s share of a training ``mamba_block``
    (``head_group``): its output with the gated norm's ``1/rms`` left
    out, ``((v · (1 + ln_out)) @ out_proj)`` with ``v = y · silu(z)``,
    and ``v``'s float32 sum of squares over its channels.  Summed over
    the groups, ``mamba_combine`` of the two is the block's output."""
    bp, cfg = head_group(bp, cfg, n_h, g)
    y, z = _mixer(x, bp, cfg, True)
    v = (y * F.silu(z)).float()
    p = (v * (1.0 + bp["ln_out"].float())).to(x.dtype) @ bp["out_proj"]
    return p, (v * v).sum(-1)


def mamba_combine(p, s, cfg):
    """The block's output from ``mamba_parts``' sums over the head
    groups: ``p / rms``, the rms over all ``cfg.ssm_inner`` channels."""
    r = torch.rsqrt(s / cfg.ssm_inner + cfg.norm_eps)
    return (p.float() * r[..., None]).to(p.dtype)


def init_mamba_cache(cfg, batch, dtype, device):
    return dict(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, cfg.ssm_conv_dim),
                         dtype=dtype, device=device),
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), dtype=dtype, device=device),
    )
