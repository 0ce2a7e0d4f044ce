"""Hand-written optimizers over parameter trees (nested dicts of
tensors); a port of ``repro/optim/optimizers.py``.

Each optimizer is an (init, update) pair:

    state = init(params)
    new_params, new_state = update(params, grads, state, lr)

The arithmetic runs in float32 whatever the parameters' dtype, and the
new parameters are cast back to it; nothing is updated in place.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.tree_util import tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    name: str


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def sgd():
    def init(params):
        return ()

    def update(params, grads, state, lr):
        new = tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                       params, grads)
        return new, state

    return Optimizer(init, update, "sgd")


def momentum(beta=0.9, nesterov=False):
    def init(params):
        return _zeros_f32(params)

    def update(params, grads, state, lr):
        new_m = tree_map(lambda m, g: beta * m + g.float(), state, grads)
        step = (tree_map(lambda m, g: beta * m + g.float(), new_m, grads)
                if nesterov else new_m)
        new = tree_map(lambda p, s: (p.float() - lr * s).to(p.dtype),
                       params, step)
        return new, new_m

    return Optimizer(init, update, "momentum")


def adam(b1=0.9, b2=0.999, eps=1e-8):
    def init(params):
        return dict(m=_zeros_f32(params), v=_zeros_f32(params),
                    t=torch.zeros((), dtype=torch.int32))

    def update(params, grads, state, lr):
        t = state["t"] + 1
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * torch.square(
            g.float()), state["v"], grads)
        bc1 = 1 - b1 ** t.float()
        bc2 = 1 - b2 ** t.float()
        new = tree_map(lambda p, mm, vv: (p.float() - lr * (mm / bc1)
                                          / (torch.sqrt(vv / bc2) + eps))
                       .to(p.dtype), params, m, v)
        return new, dict(m=m, v=v, t=t)

    return Optimizer(init, update, "adam")
