"""Seed aggregation for the multi-seed experiment grid (per-seed metric
histories to mean±std curves, per-seed finals to one table cell, the
paper-style results table) and the model-flops helpers (the roofline
terms, active parameters, 6·N·D / 2·N·D): ports of the reference's
``repro/launch/analysis.py`` functions of those names.  Its HLO parsers
read XLA's artifacts and have no counterpart here."""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> Dict[str, float]:
    """Seconds of compute, memory and collectives per device at the H100
    SXM's constants (``launch/mesh.py``), the dominant term, and the
    compute term's share of the largest."""
    compute_s = flops_per_dev / PEAK_FLOPS_BF16
    memory_s = bytes_per_dev / HBM_BW
    collective_s = coll_bytes_per_dev / ICI_BW
    terms = dict(compute_s=compute_s, memory_s=memory_s,
                 collective_s=collective_s)
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    total = max(compute_s, memory_s, collective_s)
    terms["bound_fraction"] = compute_s / total if total else 0.0
    return terms


def active_param_count(cfg) -> int:
    """Parameters touched per token: total minus the skipped expert FFNs
    (MODEL_FLOPS uses 6·N_active·D for MoE)."""
    from repro_torch.models.model import count_params

    total = count_params(cfg)
    if not cfg.is_moe:
        return total
    n_moe = sum(1 for b in cfg.layer_blocks() if b.kind == "moe")
    per_expert = 3 * cfg.d_model * cfg.expert_ff  # wi(2x) + wd
    inactive = n_moe * per_expert * (cfg.n_experts - cfg.top_k)
    return total - inactive


def model_flops(cfg, n_tokens: int, kind: str) -> float:
    """6·N·D (train) / 2·N·D (inference) with N = active params."""
    n = active_param_count(cfg)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * n_tokens


def aggregate_seed_histories(histories: List[List[dict]]) -> dict:
    """Per-seed metric histories -> mean±std curves.

    ``histories`` is one history per seed, each a list of per-round dicts
    (``{"t": int, "loss": ...}``; eval keys may appear only at eval
    rounds).  Returns::

        {"seeds": S, "t": [T],
         "metrics": {key: {"mean": [T], "std": [T], "n": [T]}}}

    where ``n[t]`` counts the seeds that recorded ``key`` at round ``t``;
    rounds where no seed recorded it hold ``None`` (strict JSON).  ``std``
    is the population std across seeds (S = 1 gives 0, never NaN).
    Ragged per-seed lengths raise: every executor records exactly T
    rounds per seed."""
    if not histories or not all(histories):
        raise ValueError("need at least one non-empty history")
    lengths = sorted({len(h) for h in histories})
    if len(lengths) > 1:
        raise ValueError(
            f"ragged per-seed histories (lengths {lengths}): every seed "
            "must record the same number of rounds — a shorter history "
            "means a truncated or mismatched run, not a valid replicate")
    T = lengths[0]
    keys = sorted({k for h in histories for r in h for k in r if k != "t"})
    out = {"seeds": len(histories), "t": list(range(T)), "metrics": {}}
    for k in keys:
        mean, std, n = [], [], []
        for t in range(T):
            vals = np.asarray([h[t][k] for h in histories
                               if t < len(h) and k in h[t]], np.float64)
            n.append(int(vals.size))
            mean.append(float(vals.mean()) if vals.size else None)
            std.append(float(vals.std()) if vals.size else None)
        out["metrics"][k] = {"mean": mean, "std": std, "n": n}
    return out


def seed_summary(per_seed_finals: List[dict]) -> dict:
    """Per-seed final scalars -> ``{key: {"mean", "std", "seeds"}}``, one
    cell of the results table."""
    if not per_seed_finals:
        raise ValueError("need at least one seed")
    keys = sorted({k for d in per_seed_finals for k in d})
    out = {}
    for k in keys:
        vals = np.asarray([float(d[k]) for d in per_seed_finals if k in d],
                          np.float64)
        out[k] = {"mean": float(vals.mean()), "std": float(vals.std()),
                  "seeds": int(vals.size)}
    return out


def write_results_table(rows: List[dict], path: str,
                        title: str = "Experiment grid results") -> str:
    """Write a paper-style results table (markdown, and the raw rows as a
    sibling ``.json``); every key across the rows becomes a column.
    Returns the markdown path."""
    if not rows:
        raise ValueError("no rows to tabulate")
    lead = ["scenario", "strategy", "dynamics", "sampling", "seeds",
            "rounds"]
    keys = [k for k in lead if any(k in r for r in rows)]
    keys += sorted({k for r in rows for k in r} - set(keys))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"# {title}\n\n")
        f.write("| " + " | ".join(keys) + " |\n")
        f.write("|" + "|".join("---" for _ in keys) + "|\n")
        for r in rows:
            f.write("| " + " | ".join(str(r.get(k, "")) for k in keys)
                    + " |\n")
    with open(os.path.splitext(path)[0] + ".json", "w") as f:
        json.dump(rows, f, indent=1, default=str)
        f.write("\n")
    return path
