"""Small CNN classifier for the paper-faithful simulation tier
(Table 6: C(3,32)-R-M-C(32,32)-R-M-L(...)-R-L(10), cross-entropy).

Parameters keep the JAX package's layout — HWIO conv kernels, ``[din,
dout]`` dense weights — and activations are NHWC at the function
boundary; only the ``F.conv2d``/``F.max_pool2d`` calls see NCHW/OIHW.
At ``channels=(32, 32)``, ``hidden=(128,)`` on 8x8x1 inputs the model has
N = 320 + 9 248 + 16 512 + 1 290 = 27 370 trainable values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import prng


def init_cnn(rng, in_shape=(8, 8, 1), n_classes=10, channels=(32, 32),
             hidden=(128,)):
    """He-style normal init drawn from ``rng`` exactly as the reference
    draws it (``prng.normal`` agrees with ``jax.random.normal`` within
    float32 rounding, not bitwise)."""
    H, W, C = in_shape
    ks = prng.split(rng, len(channels) + len(hidden) + 1)
    dev = rng.device
    params, cin, i = {}, C, 0
    h, w = H, W
    for j, cout in enumerate(channels):
        params[f"conv{j}"] = dict(
            w=prng.normal(ks[i], (3, 3, cin, cout)) * (9 * cin) ** -0.5,
            b=torch.zeros((cout,), device=dev))
        cin = cout
        h, w = h // 2, w // 2
        i += 1
    din = h * w * cin
    for j, dout in enumerate(hidden):
        params[f"fc{j}"] = dict(
            w=prng.normal(ks[i], (din, dout)) * din ** -0.5,
            b=torch.zeros((dout,), device=dev))
        din = dout
        i += 1
    params["head"] = dict(
        w=prng.normal(ks[i], (din, n_classes)) * din ** -0.5,
        b=torch.zeros((n_classes,), device=dev))
    return params


def cnn_apply(params, x):
    """x: [B, H, W, C] -> logits [B, n_classes]."""
    n_conv = sum(1 for k in params if k.startswith("conv"))
    n_fc = sum(1 for k in params if k.startswith("fc"))
    h = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
    for j in range(n_conv):
        p = params[f"conv{j}"]
        h = F.conv2d(h, p["w"].permute(3, 2, 0, 1), p["b"], padding=1)
        h = F.max_pool2d(torch.relu(h), 2, 2)       # 2x2 VALID
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC ravel order
    for j in range(n_fc):
        p = params[f"fc{j}"]
        h = torch.relu(h @ p["w"] + p["b"])
    p = params["head"]
    return h @ p["w"] + p["b"]


def xent_loss(logits, labels):
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return torch.mean(logz - ll)


def make_image_loss_fn(apply_fn):
    """loss_fn(trainable, frozen, batch, rng) for the FL engine."""
    def loss_fn(trainable, frozen, batch, rng):
        logits = apply_fn(trainable, batch["images"])
        return xent_loss(logits, batch["labels"])

    return loss_fn


def accuracy(apply_fn, params, batch):
    logits = apply_fn(params, batch["images"])
    return torch.mean((torch.argmax(logits, -1)
                       == batch["labels"]).float())
