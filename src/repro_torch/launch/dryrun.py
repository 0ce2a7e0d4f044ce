"""Multi-pod dry run, the placement half: prove that every (architecture x
input shape x mesh) combination's inputs place on the pod tier's meshes
under the sharding rules, and that one card holds its share.

The port of ``repro/launch/dryrun.py``'s placement.  For each combination
the inputs are built as shapes only (``FakeTensorMode``: no weights are
allocated), on a ``DeviceMesh`` over a fake process group of 256 or 512
ranks (4 or 8 with ``--test-mesh``):

  train_4k     -> the FL round's arguments: the flat FL state at
                  ``fl_clients(mesh)`` clients (``flat_pspecs``), the
                  frozen base (``param_pspecs(fsdp=True)``), the round
                  batch ``[m, s, b, L]`` (``batch_pspecs``)
  prefill_32k  -> params, the cache (``cache_pspecs``), the prompt
  decode_32k / long_500k -> params, the cache, one token per sequence

Every leaf is placed by its spec (``sharding.placements``) and every
sharded dim must divide (``sharding.local_shape``).  The record keeps the
reference's keys where they exist (``arch``, ``shape``, ``mesh``,
``chips``, ``mesh_axes``, ``clients``, ``model_flops``, ``analytic``,
``roofline``, ``ok``, ``error``) beside the per-rank argument bytes
(``memory.argument_size_in_bytes``, ``launch/analysis.argument_bytes``)
against the card's 80 GB: a combination that does not divide or does
not fit is recorded with its ``error``, not skipped.  Lowering the steps
over DTensors (collective and flop counts) is not part of it.

    python -m repro_torch.launch.dryrun --all --mesh multi \\
        --out results/dryrun_torch.json

Results append to ``--out`` so an interrupted sweep resumes
(``--skip-done``).  It runs on the CPU: no card, no real group.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, get_config, supported_shapes
from repro_torch.launch import analysis, roofline
from repro_torch.launch.mesh import (make_production_mesh, make_test_mesh,
                                     mesh_axis_sizes, n_chips)
from repro_torch.sharding import (P, batch_pspecs, cache_pspecs,
                                  flat_pspecs, param_pspecs, placements,
                                  serve_batch_pspecs)
from repro_torch.sharding.rules import _is_spec

#: one H100's device memory
CARD_BYTES = 80e9


def fl_clients(mesh):
    ax = mesh_axis_sizes(mesh)
    return ax.get("pod", 1) * ax.get("data", 1)


def _fake(shape, dtype):
    return torch.empty(shape, dtype=dtype)


# ---------------------------------------------------------------------------
# input specs: shape-only stand-ins for every model input (built under
# FakeTensorMode by the callers below)
# ---------------------------------------------------------------------------

def train_input_specs(cfg, shape, m):
    b = max(1, shape.global_batch // m)
    s, L = cfg.local_steps, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    batch = dict(tokens=_fake((m, s, b, L), torch.int32),
                 labels=_fake((m, s, b, L), torch.int32),
                 mask=_fake((m, s, b, L), torch.float32))
    if cfg.frontend != "none":
        batch["embeds"] = _fake((m, s, b, cfg.frontend_len, cfg.d_model), dt)
    if cfg.enc_dec:
        batch["enc_embeds"] = _fake((m, s, b, cfg.enc_len, cfg.d_model), dt)
    return batch


def prefill_input_specs(cfg, shape):
    B, L = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    out = dict(tokens=_fake((B, L), torch.int32))
    if cfg.frontend != "none":
        out["embeds"] = _fake((B, cfg.frontend_len, cfg.d_model), dt)
    if cfg.enc_dec:
        out["enc_embeds"] = _fake((B, cfg.enc_len, cfg.d_model), dt)
    return out


def decode_input_specs(cfg, shape):
    B = shape.global_batch
    return dict(tokens=_fake((B, 1), torch.int32),
                pos=_fake((B,), torch.int32))


# ---------------------------------------------------------------------------
# the arguments of each shape kind, with their specs
# ---------------------------------------------------------------------------

def train_args(cfg, shape, mesh, multi_pod):
    """The FL round's arguments and specs: the flat state at
    ``fl_clients(mesh)`` clients, the frozen base, the round batch."""
    from repro_torch.core import FLConfig, init_fl_state, prng
    from repro_torch.models.model import init_params, split_trainable

    m = fl_clients(mesh)
    fl = FLConfig(m=m, s=cfg.local_steps, eta_l=0.01, eta_g=1.0,
                  strategy="fedawe", lr_schedule=False, grad_clip=0.0,
                  flat_state=True)
    params = init_params(torch.Generator(), cfg)
    trainable, frozen = split_trainable(params, cfg)
    state = init_fl_state(prng.PRNGKey(0, "cpu"), fl, trainable)
    batch = train_input_specs(cfg, shape, m)
    args = dict(state=state, frozen=frozen, batch=batch)
    specs = dict(state=flat_pspecs(mesh, state, multi_pod=multi_pod),
                 frozen=param_pspecs(cfg, mesh, frozen, fsdp=True),
                 batch=batch_pspecs(mesh, batch, multi_pod=multi_pod))
    return args, specs


def serve_args(cfg, shape, mesh):
    """Prefill's or decode's arguments and specs: params (FSDP-augmented
    for a LoRA base), the cache, the inputs."""
    from repro_torch.models.model import init_cache, init_params

    B = shape.global_batch
    params = init_params(torch.Generator(), cfg)
    cache = init_cache(cfg, B, shape.seq_len, device="cpu")
    tok_spec, pos_spec = serve_batch_pspecs(mesh, B)
    if shape.kind == "prefill":
        inp = prefill_input_specs(cfg, shape)
        inp_spec = {k: P(tok_spec[0], *([None] * (v.dim() - 1)))
                    for k, v in inp.items()}
    else:
        inp = decode_input_specs(cfg, shape)
        inp_spec = dict(tokens=tok_spec, pos=pos_spec)
    args = dict(params=params, cache=cache, inputs=inp)
    specs = dict(params=param_pspecs(cfg, mesh, params,
                                     fsdp=cfg.fl_mode == "lora"),
                 cache=cache_pspecs(cfg, mesh, cache, B), inputs=inp_spec)
    return args, specs


def check_placements(specs, mesh):
    """Every spec of ``specs`` as DTensor placements on ``mesh`` (raises
    on a spec out of mesh order or naming an axis twice); returns how
    many leaves are sharded."""
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import Shard

    n = 0
    for spec in pytree.tree_flatten(specs, is_leaf=_is_spec)[0]:
        if _is_spec(spec):
            n += any(isinstance(p, Shard) for p in placements(spec, mesh))
    return n


# ---------------------------------------------------------------------------
# the fake process group and one combination
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_group(world):
    """A fake process group of ``world`` ranks in this process (rank 0),
    destroyed on exit; an existing group is refused."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; "
                           "one is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_world(mesh_kind, test_mesh):
    if test_mesh:
        return 8 if mesh_kind == "multi" else 4
    return 512 if mesh_kind == "multi" else 256


def run_one(arch, shape_name, mesh_kind, *, test_mesh=False, verbose=True):
    """One combination inside a fake group of ``mesh_world`` ranks: its
    record (``ok`` with its numbers, or its ``error``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    multi_pod = mesh_kind == "multi"
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    with fake_group(mesh_world(mesh_kind, test_mesh)):
        mesh = (make_test_mesh(multi_pod=multi_pod, device_type="cpu")
                if test_mesh else
                make_production_mesh(multi_pod=multi_pod, device_type="cpu"))
        ax = mesh_axis_sizes(mesh)
        rec = dict(arch=arch, shape=shape_name, mesh=mesh_kind,
                   chips=n_chips(mesh), ok=False,
                   mesh_axes={k: int(v) for k, v in ax.items()})
        try:
            with FakeTensorMode():
                if shape.kind == "train":
                    args, specs = train_args(cfg, shape, mesh, multi_pod)
                else:
                    args, specs = serve_args(cfg, shape, mesh)
            if shape.kind == "train":
                m = fl_clients(mesh)
                rec["clients"] = m
                toks = (m * cfg.local_steps
                        * max(1, shape.global_batch // m) * shape.seq_len)
                rec["model_flops"] = analysis.model_flops(cfg, toks, "train")
            elif shape.kind == "prefill":
                rec["model_flops"] = analysis.model_flops(
                    cfg, shape.global_batch * shape.seq_len, "inference")
            else:
                rec["model_flops"] = analysis.model_flops(
                    cfg, shape.global_batch, "inference")
            rec["sharded_leaves"] = check_placements(specs, mesh)
            nbytes = {k: analysis.argument_bytes(args[k], specs[k], mesh)
                      for k in args}
            rec["memory"] = dict(argument_size_in_bytes=sum(nbytes.values()),
                                 by_argument=nbytes, card_bytes=CARD_BYTES)
            ana = roofline.analytic_costs(cfg, shape, dict(ax))
            rec["analytic"] = ana
            rec["roofline"] = analysis.roofline_terms(
                ana["flops_per_dev"], ana["hbm_bytes_per_dev"],
                ana["coll_bytes_per_dev"])
            if rec["model_flops"]:
                rec["useful_flops_ratio"] = rec["model_flops"] / (
                    ana["flops_per_dev"] * n_chips(mesh))
            total = rec["memory"]["argument_size_in_bytes"]
            if total > CARD_BYTES:
                raise MemoryError(
                    f"{total / 1e9:.2f} GB of arguments per rank exceed "
                    f"the card's {CARD_BYTES / 1e9:.0f} GB")
            rec["ok"] = True
        except (ValueError, MemoryError) as e:
            # a dim that does not divide, or a share that does not fit:
            # recorded, and the sweep goes on
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 2)
    if verbose:
        gb = rec.get("memory", {}).get("argument_size_in_bytes", math.nan)
        print(f"{arch} x {shape_name} x {mesh_kind}: "
              f"{'ok' if rec['ok'] else 'FAILED'} ({gb / 1e9:.3f} GB a rank)"
              + (f" {rec['error']}" if "error" in rec else ""), flush=True)
    return rec


def combos(args):
    from repro_torch.configs import ARCHS

    if args.all:
        return [(a, s, args.mesh) for a in ARCHS for s in supported_shapes(a)]
    if not (args.arch and args.shape):
        raise SystemExit("pass --arch and --shape, or --all")
    return [(args.arch, args.shape, args.mesh)]


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true",
                    help="sweep every supported (arch x shape) pair")
    ap.add_argument("--test-mesh", action="store_true",
                    help="the miniature (2, 2) / (2, 2, 1) mesh")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--skip-done", action="store_true")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("ok")}
    for arch, shape_name, mesh_kind in combos(args):
        if args.skip_done and (arch, shape_name, mesh_kind) in done:
            print(f"skip {arch} {shape_name} {mesh_kind} (done)")
            continue
        rec = run_one(arch, shape_name, mesh_kind, test_mesh=args.test_mesh)
        results = [r for r in results
                   if (r["arch"], r["shape"], r["mesh"])
                   != (arch, shape_name, mesh_kind)]
        results.append(rec)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1, default=str)
    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"dry-run complete: {n_ok}/{len(results)} combinations OK")
    return results


if __name__ == "__main__":
    main()
