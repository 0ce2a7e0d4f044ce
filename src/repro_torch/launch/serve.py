"""Batched serving loop: continuous-batching style scheduler over the
model substrate (per-request positions, greedy or sampled decode); a
port of ``repro/launch/serve.py`` with the same flags plus ``--device``.

    python -m repro_torch.launch.serve [--arch tiny] [--device cpu]

Runs on the card unless ``--device cpu`` is given; without a card it
raises.  Prompts are prefilled token by token through ``serve_step``, as
in the reference; ``models.model.prefill`` (the flash-attention path) is
the entry point for whole prompts.  An encoder-decoder model decodes
against ``init_cache``'s zero encoder output, as the reference's server
does (it takes no encoder input).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models import init_cache, init_params, reduced, serve_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [Lp]
    max_new: int
    out: Optional[np.ndarray] = None


class Server:
    """Fixed-slot continuous batching: up to B concurrent sequences share
    one KV cache; finished slots are refilled from the queue.  Weights are
    random, drawn from ``torch.Generator(device).manual_seed(seed)``."""

    def __init__(self, cfg, batch_slots=4, max_seq=128, seed=0,
                 device="cuda"):
        self.cfg = cfg
        self.B = batch_slots
        self.max_seq = max_seq
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_params(gen, cfg)
        self.cache = init_cache(cfg, batch_slots, max_seq,
                                device=self.device)
        self.pos = np.zeros(batch_slots, np.int64)
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.remaining = np.zeros(batch_slots, np.int64)

    def _step(self, tok_b, pos_b):
        """serve_step on host arrays [B, 1] and [B]; returns logits [B, V]
        on the device (the cache is updated in place)."""
        logits, self.cache = serve_step(
            self.params, self.cfg, self.cache,
            torch.as_tensor(tok_b, device=self.device),
            torch.as_tensor(pos_b, device=self.device))
        return logits

    def _prefill_one(self, slot, req):
        """Per-slot prefill via serve_step. Other slots' rows receive dummy
        writes at their CURRENT position, which the next real token
        overwrites before any attention reads it (slot isolation)."""
        logits = None
        for tok in req.prompt:
            tok_b = np.zeros((self.B, 1), np.int64)
            tok_b[slot, 0] = tok
            logits = self._step(tok_b, self.pos.copy())
            self.pos[slot] += 1
        # first generated token = greedy continuation of the prompt
        req.out = np.array([int(torch.argmax(logits[slot]))], np.int64)
        return logits

    def run(self, requests: List[Request], greedy=True):
        """Serve every request; returns (finished requests, stats).
        ``greedy=False`` samples decode step n's tokens as the reference
        does, ``categorical(PRNGKey(n), logits)`` on the port's threefry
        (``core.prng``): the same draws from the same logits."""
        queue = list(requests)
        done, t0, steps = [], time.time(), 0
        while queue or any(a is not None for a in self.active):
            # admit
            for slot in range(self.B):
                if self.active[slot] is None and queue:
                    req = queue.pop(0)
                    self.pos[slot] = 0
                    self._prefill_one(slot, req)
                    self.active[slot] = req
                    self.remaining[slot] = req.max_new - 1  # 1 from prefill
            # one decode step for every active slot
            tok_b = np.zeros((self.B, 1), np.int64)
            for slot, req in enumerate(self.active):
                if req is not None and len(req.out):
                    tok_b[slot, 0] = req.out[-1]
                elif req is not None:
                    tok_b[slot, 0] = req.prompt[-1]
            logits = self._step(tok_b, self.pos.copy())
            steps += 1
            nxt = (torch.argmax(logits, -1) if greedy else
                   prng.categorical(prng.PRNGKey(steps, self.device),
                                    logits)).cpu().numpy()
            for slot, req in enumerate(self.active):
                if req is None:
                    continue
                req.out = np.append(req.out, nxt[slot])
                self.pos[slot] += 1
                self.remaining[slot] -= 1
                if self.remaining[slot] <= 0 or \
                        self.pos[slot] >= self.max_seq - 1:
                    done.append(req)
                    self.active[slot] = None
        dt = time.time() - t0
        return done, dict(decode_steps=steps, wall_s=dt,
                          tok_per_s=sum(len(r.out) for r in done) / max(dt, 1e-9))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, rng.integers(4, 10)),
                    args.max_new) for i in range(args.requests)]
    srv = Server(cfg, batch_slots=args.slots, max_seq=64, device=args.device)
    done, stats = srv.run(reqs)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req{r.rid}: prompt={len(r.prompt)}t -> {r.out.tolist()}")
    print(stats)
    if len(done) != args.requests:
        raise RuntimeError(f"{len(done)} of {args.requests} requests "
                           "finished")
    return stats


if __name__ == "__main__":
    main()
