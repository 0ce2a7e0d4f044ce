#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device; it exits non-zero and prints no result without
one, or when run outside the repository (it imports the port from
``src/``).  It imports neither jax nor the JAX package.  Phases, each
printed as JSON lines:

  1. device   — ``nvidia-smi`` name and power limit of card 0.
  2. kernels  — builds the Triton echo-aggregate kernel from the source in
     ``src/`` (at its first launch, into ``build/triton``), calls the
     checked wrappers on tensors on the card and holds each result
     against the plain torch version on the same inputs: 1e-5 for
     float32 and 5e-2 for bfloat16 (tests/test_kernels.py's bounds); an
     all-zero mask must return the previous global exactly.  Variants:
     K1 the fused FedAWE update, K2 with non-binary upload weights, K3
     without the empty-round guard.
  3. main path — ``repro_torch.launch.train`` in-process with
     ``--strategy fedawe --dynamics sine --flat-state --use-kernel
     --chunk-rounds 16 --rounds 64 --m 100 --s 5 --batch 32`` on the
     full-width CNN (N = 27 370), with every launch count set to 0 just
     before it: K1 must launch once per round and every loss be finite.
     The same flags without ``--use-kernel`` must give identical
     ``n_active`` histories and a final global within 1e-4.
  4. numbers  — kernel, plain-version and two-matvec times at the
     main-path shape (CUDA graphs of calls over rotating operands larger
     than the 50 MB L2), at a 2 GB shape, the HBM bound, ms per round of
     the chunked main path with and without the kernel (CUDA events, in
     turns), the round's pieces timed alone (PRNG draws, sampler, local
     SGD, server update), and a profiler breakdown of one chunk; each
     line carries the card's name and power limit.
  5. the ``{"kernels": [...]}`` line; the last line is
     ``{"ok": true, "device": {...}}``.

No phase catches its own failure: any exception ends the run with a
non-zero exit code and no result line.
"""
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
ETA_G = 1.7
MAIN_FLAGS = ["--strategy", "fedawe", "--dynamics", "sine", "--flat-state",
              "--chunk-rounds", "16", "--rounds", "64", "--m", "100",
              "--s", "5", "--batch", "32", "--device", "cuda"]
M_MAIN, N_MAIN = 100, 27370


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(ok, what):
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def nvidia_smi():
    r = subprocess.run(["nvidia-smi", "-i", "0",
                        "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


# ---------------------------------------------------------------------------
# phase 2: every kernel variant against its plain version
# ---------------------------------------------------------------------------

def make_inputs(torch, m, n, dtype, seed, mask_p=0.7, upload=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x, y, g = rand(m, n).to(dtype), rand(m, n).to(dtype), rand(n)
    mask = (torch.rand(m, generator=gen, device="cuda") < mask_p).float()
    echo = torch.randint(1, 12, (m,), generator=gen, device="cuda").float()
    up = None
    if upload:
        up = 0.8 ** torch.randint(0, 4, (m,), generator=gen,
                                  device="cuda").float()
    return dict(x=x, y=y, g=g, mask=mask, echo=echo, upload=up)


def call_kernel(ops, variant, a):
    if variant == "K3":
        return ops.echo_aggregate(a["x"], a["y"], a["mask"], a["echo"],
                                  ETA_G)
    return ops.echo_aggregate_flat(a["x"], a["y"], a["g"], a["mask"],
                                   a["echo"], ETA_G, upload=a["upload"])


def call_plain(ref, variant, a):
    if variant == "K3":
        return ref.echo_aggregate_ref(a["x"], a["y"], a["mask"], a["echo"],
                                      ETA_G)
    return ref.echo_aggregate_fused_ref(a["x"], a["y"], a["g"], a["mask"],
                                        a["echo"], ETA_G, upload=a["upload"])


def launch_count(ops, variant):
    return {"K1": ops.echo_aggregate_flat.launches,
            "K2": ops.echo_aggregate_flat.upload_launches,
            "K3": ops.echo_aggregate.launches}[variant]


def check_kernels(torch, ops, ref, block_n):
    """Each case: one wrapper call (which must count exactly one launch),
    the plain version on the same inputs, the stated tolerance.  Returns
    the max abs error per variant at the main-path shape in float32."""
    cases = [  # (variant, m, n, dtype, extra)
        ("K1", M_MAIN, N_MAIN, torch.float32, {}),
        ("K2", M_MAIN, N_MAIN, torch.float32, dict(upload=True)),
        ("K3", M_MAIN, N_MAIN, torch.float32, {}),
        ("K1", 8, 1, torch.float32, {}),
        ("K1", 37, 3 * block_n + 5, torch.float32, {}),
        ("K3", 37, 3 * block_n + 5, torch.float32, {}),
        ("K1", M_MAIN, N_MAIN, torch.bfloat16, {}),
        ("K2", M_MAIN, N_MAIN, torch.bfloat16, dict(upload=True)),
        ("K1", 16, 1000, torch.float32, dict(mask_p=0.0)),
        ("K2", 16, 1000, torch.float32, dict(mask_p=0.0, upload=True)),
        ("K1", 1024, 262144, torch.float32, {}),
        ("K3", 1024, 262144, torch.float32, {}),
    ]
    errs = {}
    for i, (variant, m, n, dtype, extra) in enumerate(cases):
        a = make_inputs(torch, m, n, dtype, seed=100 + i, **extra)
        before = launch_count(ops, variant)
        out = call_kernel(ops, variant, a)
        torch.cuda.synchronize()
        launched = launch_count(ops, variant) - before
        plain = call_plain(ref, variant, a)
        torch.cuda.synchronize()
        tol = 1e-5 if dtype == torch.float32 else 5e-2
        err = (out - plain).abs().max().item()
        empty = extra.get("mask_p") == 0.0
        ok = (launched == 1 and out.shape == (n,)
              and out.dtype == torch.float32
              and bool(torch.isfinite(out).all())
              and torch.allclose(out, plain, rtol=tol, atol=tol)
              and (not empty or torch.equal(out, a["g"])))
        emit(dict(phase="kernel_check", kernel=variant, m=m, n=n,
                  dtype=str(dtype).replace("torch.", ""), empty_mask=empty,
                  launches=launched, max_abs_err=err, tol=tol, ok=ok))
        if not ok:
            raise AssertionError(f"kernel {variant} at ({m}, {n}, {dtype}) "
                                 "disagrees with its plain version")
        if (m, n, dtype) == (M_MAIN, N_MAIN, torch.float32):
            errs[variant] = err
        del a, out, plain
    torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

def graph_ms(torch, fn, n_calls, reps=5):
    """Device time per call: ``n_calls`` calls captured in one CUDA graph
    (no host launch overhead between them), replayed ``reps`` times
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * n_calls)
    del graph
    torch.cuda.empty_cache()
    return ms


def bound(m, n, esize, with_g):
    """Least time in ms: each input read once, the output written once
    (x, y at ``esize`` bytes; g, out, w, echo in float32), against about
    5 float32 operations per (client, column) element."""
    nbytes = 2 * m * n * esize + 4 * n * (2 if with_g else 1) + 8 * m
    flops = 5 * m * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def time_kernels(torch, ops, ref, strategies, smi):
    """Kernel, plain version and the two-matvec formulation per variant at
    the main-path shape over 8 rotating operand sets (8 x 21.9 MB, so no
    set is still in the 50 MB L2 when it comes round again), and K1/K3 at
    the 2 GB shape."""
    out = {}
    sets = [make_inputs(torch, M_MAIN, N_MAIN, torch.float32, seed=500 + i,
                        upload=True) for i in range(8)]
    noup = [dict(a, upload=None) for a in sets]
    # the reference's use_kernel=False formulation: G = x - y is an input
    # there (the round computes it anyway)
    Gs = [a["x"] - a["y"] for a in sets]

    def two_matvec(i):
        a, G = sets[i % 8], Gs[i % 8]
        mu = a["mask"]
        denom = torch.clamp(torch.sum(mu), min=1.0)
        acc = (strategies.flat_weighted_sum(mu, a["x"]) - ETA_G
               * strategies.flat_weighted_sum(mu * a["echo"], G)) / denom
        return torch.where(torch.sum(mu) > 0, acc, a["g"])

    two_ms = graph_ms(torch, two_matvec, 64)
    for variant, src in (("K1", noup), ("K2", sets), ("K3", noup)):
        k_ms = graph_ms(torch, lambda i: call_kernel(ops, variant,
                                                      src[i % 8]), 64)
        p_ms = graph_ms(torch, lambda i: call_plain(ref, variant,
                                                     src[i % 8]), 64)
        b_ms, b_by, nbytes = bound(M_MAIN, N_MAIN, 4, variant != "K3")
        out[variant] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                            bound_by=b_by, bytes=nbytes,
                            two_matvec_ms=two_ms if variant == "K1" else None)
    del sets, noup, Gs
    torch.cuda.empty_cache()
    big = make_inputs(torch, 1024, 262144, torch.float32, seed=900)
    for variant in ("K1", "K3"):
        k_ms = graph_ms(torch, lambda i: call_kernel(ops, variant, big), 10)
        b_ms, b_by, nbytes = bound(1024, 262144, 4, variant != "K3")
        out[variant]["large"] = dict(m=1024, n=262144, ms=k_ms,
                                     bound_ms=b_ms, bound_by=b_by,
                                     achieved_gb_per_s=nbytes / k_ms / 1e6)
    del big
    torch.cuda.empty_cache()
    for variant, rec in out.items():
        emit(dict(phase="kernel_time", card=smi, kernel=variant, m=M_MAIN,
                  n=N_MAIN, **rec))
    return out


def time_rounds(torch, train, engine, federated, prng, use_kernel,
                n_chunks=2):
    """ms per round of the chunked main path between CUDA events over
    ``n_chunks`` chunks, after one warm chunk."""
    flags = MAIN_FLAGS + (["--use-kernel"] if use_kernel else [])
    args = train.build_parser().parse_args(flags)
    dev = torch.device("cuda")
    parts = train.setup(args, dev)
    store = parts["ds"].device_store(dev)
    init, sample = federated.make_device_sampler(args.m, args.s, args.batch)
    key = parts["data_key"]
    chunk = engine.make_chunk_fn(None, parts["round_fn"], sample,
                                 args.chunk_rounds)
    state, ss = parts["state"], init(store, key)
    state, ss, _ = chunk(state, ss, store, key)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_chunks):
        state, ss, met = chunk(state, ss, store, key)
    end.record()
    end.synchronize()
    rounds = n_chunks * args.chunk_rounds
    round_ms = start.elapsed_time(end) / rounds
    return dict(state=state, ss=ss, chunk=chunk, store=store, key=key,
                sample=sample, args=args, round_ms=round_ms,
                rounds_per_s=1e3 / round_ms)


def events_ms(torch, fn, reps):
    """Mean ms per call of ``fn`` between CUDA events (after one warm
    call): host launch overhead included, as a round sees it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def round_parts_ms(torch, prng, engine, strategies, cnn, timing, reps=16):
    """Pieces of one main-path round, each run alone on the round's own
    shapes: every PRNG call of a round together (split(rng, 3), the
    mask's uniform, split(k_loc, m), the s per-step splits of the [m, 2]
    keys, the sampler's fold_in + randint), the sampler (fold_in +
    randint + gather), local SGD (s steps, m clients, its key splits
    included) and the FedAWE server update with the kernel.  The PRNG
    piece overlaps the sampler and local SGD, so the pieces do not sum
    to the round."""
    args, state, store = timing["args"], timing["state"], timing["store"]
    rng = prng.PRNGKey(0, "cuda")
    t = state.t
    counts = store["counts"][:, None]

    def draws():
        keys = prng.split(rng, 3)
        prng.uniform(keys[1], (args.m,))
        loc = prng.split(keys[2], args.m)
        for _ in range(args.s):
            loc = prng.split(loc)[:, 0]
        prng.randint(prng.fold_in(timing["key"], t),
                     (args.m, args.s * args.batch), 0, counts)

    def sampler():
        return timing["sample"](store, {}, prng.fold_in(timing["key"], t))

    batches, _ = sampler()
    spec = state.spec
    start = spec.unflatten_stacked(state.clients_tr)
    loc_keys = prng.split(rng, args.m)
    loss_fn = cnn.make_image_loss_fn(cnn.cnn_apply)

    def local():
        return engine.local_sgd(start, {}, batches, loc_keys, s=args.s,
                                eta_l=args.eta_l, loss_fn=loss_fn,
                                grad_clip=0.5)

    x_end = spec.flatten_stacked(local()[0])
    mask = (torch.arange(args.m, device="cuda") % 3 == 0).float()

    def aggregate():
        return strategies.get_strategy("fedawe").aggregate_flat(
            global_flat=state.global_tr, clients_flat=state.clients_tr,
            x_end=x_end, G=state.clients_tr - x_end, mask=mask, t=t,
            tau=state.tau, probs=None, extra=(), eta_g=args.eta_g,
            use_kernel=True)

    return dict(prng_ms=events_ms(torch, draws, reps),
                sampler_ms=events_ms(torch, sampler, reps),
                local_sgd_ms=events_ms(torch, local, reps),
                aggregate_ms=events_ms(torch, aggregate, reps))


def profile_chunk(torch, timing, round_ms):
    """One chunk under torch.profiler: summed device time of all kernels
    per round, its share of the unprofiled ``round_ms`` (the device busy
    share; the profiler slows the host, so its own wall time is reported
    apart), launches per round and the top kernels by device time.
    Device fields are None when the profiler records no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, ss = timing["state"], timing["ss"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, ss, _ = timing["chunk"](state, ss, timing["store"],
                                       timing["key"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rounds = timing["args"].chunk_rounds
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(us for _, us in kernels)
    by_name = {}
    for name, us in kernels:
        by_name[name] = by_name.get(name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(profiled_wall_ms_per_round=wall_ms / rounds,
                device_ms_per_round=(dev_us / 1e3 / rounds
                                     if kernels else None),
                device_busy_share=(dev_us / 1e3 / rounds / round_ms
                                   if kernels else None),
                kernel_launches_per_round=(len(kernels) / rounds
                                           if kernels else None),
                top_kernels_ms_per_round=[
                    [name[:80], us / 1e3 / rounds] for name, us in top])


# ---------------------------------------------------------------------------

def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs the "
              "port on one card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.core import engine, prng, strategies
    from repro_torch.data import federated
    from repro_torch.device import resolve_device
    from repro_torch.kernels.echo_aggregate import kernel, ops, ref
    from repro_torch.launch import train
    from repro_torch.models import cnn

    # phase 1: device
    smi = nvidia_smi()
    print(smi, flush=True)
    resolve_device("cuda")
    import triton
    emit(dict(phase="device", nvidia_smi=smi,
              name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, triton=triton.__version__,
              tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
              tf32_cudnn=torch.backends.cudnn.allow_tf32))

    # phase 2: kernels against their plain versions
    t0 = time.perf_counter()
    errs = check_kernels(torch, ops, ref, kernel.BLOCK_N)
    emit(dict(phase="kernel_checks_done", seconds=time.perf_counter() - t0))

    # phase 3: the main path, counts at 0 just before it
    parser = train.build_parser()
    ops.echo_aggregate_flat.launches = 0
    ops.echo_aggregate_flat.upload_launches = 0
    ops.echo_aggregate.launches = 0
    t0 = time.perf_counter()
    state_k, hist_k, final_k = train.run(
        parser.parse_args(MAIN_FLAGS + ["--use-kernel"]))
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches = {"K1": ops.echo_aggregate_flat.launches,
                "K2": ops.echo_aggregate_flat.upload_launches,
                "K3": ops.echo_aggregate.launches}
    losses = [h["loss"] for h in hist_k]
    n_active_k = [h["n_active"] for h in hist_k]
    require(len(hist_k) == 64, f"{len(hist_k)} rounds")
    require(launches["K1"] == 64, f"K1 launches {launches}")
    require(all(math.isfinite(v) for v in losses), f"losses {losses}")
    require(state_k.global_tr.shape == (N_MAIN,)
            and bool(torch.isfinite(state_k.global_tr).all()),
            "final global not finite of shape [N]")
    require(0 < sum(n_active_k) < 64 * M_MAIN, f"n_active {n_active_k}")

    t0 = time.perf_counter()
    state_p, hist_p, final_p = train.run(parser.parse_args(MAIN_FLAGS))
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    # the run without --use-kernel launched nothing
    require(ops.echo_aggregate_flat.launches == 64, "plain run launched K1")
    n_active_p = [h["n_active"] for h in hist_p]
    require(n_active_k == n_active_p, "n_active histories differ")
    diff = (state_k.global_tr - state_p.global_tr).abs().max().item()
    require(diff <= 1e-4, f"kernel vs plain global differ by {diff}")
    emit(dict(phase="main_path", rounds=64, m=M_MAIN, n=N_MAIN,
              launches=launches, wall_s_kernel=wall_k, wall_s_plain=wall_p,
              first_loss=losses[0], last_loss=losses[-1],
              empty_rounds=n_active_k.count(0.0),
              mean_active=sum(n_active_k) / 64, final_eval_acc=final_k,
              final_eval_acc_plain=final_p, kernel_vs_plain_global=diff))

    # phase 4: numbers
    times = time_kernels(torch, ops, ref, strategies, smi)
    runs = []
    for use_kernel in (True, False, False, True):
        r = time_rounds(torch, train, engine, federated, prng, use_kernel)
        runs.append(r)
        emit(dict(phase="round_time", card=smi, use_kernel=use_kernel,
                  round_ms=r["round_ms"], rounds_per_s=r["rounds_per_s"]))
    round_ms = (runs[0]["round_ms"] + runs[3]["round_ms"]) / 2
    parts = round_parts_ms(torch, prng, engine, strategies, cnn, runs[3])
    emit(dict(phase="round_parts", card=smi, round_ms=round_ms, **parts,
              prng_share=parts["prng_ms"] / round_ms))
    emit(dict(phase="profile", card=smi, use_kernel=True,
              **profile_chunk(torch, runs[3], round_ms)))
    print(smi, flush=True)

    # phase 5
    kernels = []
    replaces = {
        "K1": "src/repro/kernels/echo_aggregate/kernel.py:100",
        "K2": "src/repro/kernels/echo_aggregate/kernel.py:100",
        "K3": "src/repro/kernels/echo_aggregate/kernel.py:48"}
    names = {"K1": "echo_aggregate_fused (K1)",
             "K2": "echo_aggregate_fused_upload (K2)",
             "K3": "echo_aggregate (K3)"}
    for v in ("K1", "K2", "K3"):
        t = times[v]
        kernels.append(dict(
            name=names[v], route="triton",
            source="src/repro_torch/kernels/echo_aggregate/kernel.py",
            replaces=replaces[v], launches=launches[v],
            max_abs_err=errs[v], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=None))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
