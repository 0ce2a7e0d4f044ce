"""Multi-pod dry run: prove that every (architecture x input shape x
mesh) combination's inputs place on the pod tier's meshes under the
sharding rules, that one card holds its share, and run its step once
over those placements on a fake process group, counting per rank its
flops, bytes accessed, peak memory and collectives.

The port of ``repro/launch/dryrun.py``.  Each combination runs inside a
fake process group of 256 or 512 ranks (4 with ``--test-mesh``) as rank
0, under ``FakeTensorMode``: shapes only, no weights are allocated, no
rank communicates.

  train_4k     -> the reference's step, the placed FedAWE round on tree
                  state (``build_train_step``):
                  ``engine.make_round_fn_with_frozen(place=)`` with a
                  ``TreePlacement`` over rank 0's client rows of
                  ``fl_clients(mesh)`` clients and its blocks over
                  'model' (``client_stack_pspecs``), local SGD over
                  DTensors, K1's partial form on the rank's column
                  shards and its all-reduce (``sharding/placement.py``);
                  the record says ``"state": "tree"``
  train_4k, --variant dp_client / zero_client -> the same step with the
                  block weights replicated over 'model' and the
                  within-client batch over it, or the weights stored
                  sharded and the batch over 'model' (``train_modes``)
  train_4k, --variant flat_chunk[K][+epoch][+seeds[S]][+mesh][+faults]
               [+staleness] -> the placed chunk executors
                  (``build_chunk_train_step``): K rounds per call, the
                  device store (``cap`` = 4 samples a client) and
                  sampler, S seeds (all of them on the rank, or its rows
                  of a 'seed' axis under ``+mesh``)
  prefill_32k  -> ``model.prefill`` over DTensors (``build_prefill_step``)
  decode_32k / long_500k -> ``model.serve_step`` over DTensors
                  (``build_decode_step``)

The serving steps take DTensor params (``param_pspecs``, ``fsdp`` for a
LoRA base), caches (``cache_pspecs``) and inputs
(``serve_batch_pspecs``; ``seq_shard`` puts the prompt's sequence on
'model' where it divides by 16); the tree step its client leaves, global,
batch and frozen base over 'model' (the base by ``param_pspecs``
without the reference's FSDP over 'data': that axis holds the explicit
client rows).  DTensor's sharding propagation decides where the
collectives go.  The regions that run on local blocks instead, with the
placements they take (``models/placed.py``, ``models/moe.py``):

  * the attention core (``placed.local_attention``: self-attention plain
    or K4, the encoder's and the cross-attention's plain):
    per mesh dim the batch keeps its shard of dim 0, the heads their
    shard of dim 2 where the kv heads divide (q, k, v alike), the plain
    attention's queries their sequence shard with k, v and the key
    positions replicated; all else replicated; the output takes the
    queries' placements;
  * decode attention over slot-sharded caches (``placed.decode_attention``):
    q and its positions keep the cache's batch shard, each rank scores
    its slots, and the blocks combine flash-decoding style (maxima
    ``Partial("max")``, rescaled sums and outputs ``Partial("sum")``);
  * the cache writes (``placed.write_cache``): the cache keeps its
    placements, the values and slots the cache's batch shard, all else
    replicated; each rank writes its slots;
  * the token lookup (``placed.embed``): the table keeps its vocab shard
    and is otherwise replicated, the tokens their batch shard on the
    other mesh dims; each rank looks up its rows, zeros elsewhere, and
    the sum is reduced once to the tokens' placements;
  * a Mamba2 mixer in prefill and decode (``placed.local_mixer``): the
    input and the cache keep their batch shard (the cache its own
    placements), every weight replicated; the output the input's
    placements;
  * the MoE dispatch plan (``moe.dispatch`` under ``local_map``): the
    routing replicated, the plan computed on every rank, replicated;
  * the training loss's cross-entropy (``placed.token_nll_sum``): the
    logits keep their vocab shard (last dim) and batch shard (dim 0),
    labels and mask the batch shard, all else replicated; each rank's
    block maximum ``Partial("max")``, its sum of exponentials and its
    labels' logits ``Partial("sum")``, reduced to the rows' placements.

In the tree step's training forward and backward every projection's
and region's placements are written down (``models/placed.py``'s note),
so that DTensor chooses no strategy by a cost that depends on the mesh's
device type (a fake CUDA step counts what the CPU record counts) and
nothing the reference's compiled step splits over 'model' runs whole:

  * every projection (``placed.project``): column-sharded weights take
    the input replicated and give the output's last dim sharded,
    row-sharded ones take that shard and give a partial sum, and an
    input whose rows are sharded (``dp_client``, ``zero_client``) gathers
    the weights;
  * the gated MLP (``placed.local_swiglu``): the gate/up product moves to
    a row shard for its halves and back for the down projection;
  * the attention (``placed.local_attention(train=True)``): the kv heads
    where they divide 'model', else the batch, else rows x kv-head groups
    with each rank's block a ``Partial`` sum;
  * the Mamba2 mixer (``placed.local_mixer(split=)``): the batch where it
    divides, else rows x head groups whose gated norm finishes on the
    summed parts (``ssm.mamba_parts``, ``ssm.mamba_combine``);
  * the loss where the head's vocab does not divide 'model' or the
    tokens are already split (``placed.local_head_nll``): the tokens
    split, the head gathered once, each rank's sum a ``Partial``;
    elsewhere the vocab-parallel cross-entropy above.

The residual stream's partial sums are reduced before each norm
(``placed.reduce_partial``) and each normed input's gradient is brought
back to its forward placements (``placed.grad_like_forward``), the
tensor-parallel "g" and "f" operators, in the encoder's blocks too; the
attention region's inputs get contiguous gradients
(``placed.contiguous_grad``).  Every weight gradient is redistributed to
its leaf's placements before the step (``engine._placed_as``).

Between blocks the residual stream is brought back to the embedding's
placements (``placed.keep_placements``), and the MoE layer's output rows
to its input's batch shards before their view (``placed.batch_rows``:
torch 2.13's view mis-sizes a dim sharded on two mesh dims).  Each
combination starts from empty DTensor dispatch caches.  Nothing runs under
``implicit_replication``: the constants a step makes (positions, rope
frequencies) are placed beside it (``placed.placed_like``).

The record keeps the reference's keys where they mean the same
(``arch``, ``shape``, ``mesh``, ``chips``, ``mesh_axes``, ``variant``,
``clients``, ``model_flops``, ``analytic``, ``roofline``, ``cost``,
``memory``, ``collectives``, ``collective_top``, ``chunk_rounds``,
``sampling``, ``seeds``, ``faults``, ``staleness``,
``useful_flops_ratio``, ``ok``, ``error``, ``traceback``), ``flops_top``
(the counted flops by operator and operand shapes, the most first);
``run_s`` (the step's wall time on the CPU, fake tensors) takes the place of
``lower_s`` and ``compile_s``, and ``roofline_counted`` (the counted
flops, bytes and collective bytes) that of ``roofline_hlo``.  The counts
are ``launch/analysis.CollectiveCounter``'s, per rank.  ``roofline``
takes the analytic flops and bytes (times K·S for a chunk); its
collective term is the larger of the analytic and counted bytes on the
baseline and the counted bytes for a variant.  A combination whose
arguments do not divide or exceed the card's 80 GB a rank keeps that
error and runs no step; a step that raises keeps its error and
traceback; the sweep goes on.

    python -m repro_torch.launch.dryrun --arch tiny --shape train_4k \\
        --test-mesh --variant flat_chunk4
    python -m repro_torch.launch.dryrun --all --mesh multi \\
        --out results/dryrun_torch.json

A variant is checked before anything runs (``check_variant``): any
unknown token raises, and so do ``dp_client`` and ``zero_client`` beside
``flat_chunk[K]`` (the flat chunk places nothing over 'model'; the
reference ignores them there).

Results append to ``--out`` so an interrupted sweep resumes
(``--skip-done``, keyed by the variant too).  It runs on the CPU: no
card, no real group.
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

from torch._subclasses.fake_tensor import unset_fake_temporarily

from repro_torch.configs import SHAPES, get_config, supported_shapes
from repro_torch.launch import analysis, roofline
from repro_torch.launch.mesh import (make_production_mesh, make_seed_mesh,
                                     make_test_mesh, mesh_axis_sizes,
                                     n_chips)
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

def train_modes(variant):
    """The weights' storage and the within-client batch's modes of the
    tree step, as the reference's knobs set them: ``dp_client`` ("dp",
    "dp"), ``zero_client`` ("tp", "dp"), else ("tp", "tp")."""
    toks = variant.split("+")
    mode = "dp" if "dp_client" in toks else "tp"
    batch_mode = "dp" if "dp_client" in toks or "zero_client" in toks \
        else "tp"
    return mode, batch_mode


def train_args(cfg, shape, mesh, multi_pod, variant="baseline"):
    """The FL round's arguments and specs at ``fl_clients(mesh)``
    clients: the state, the frozen base, the round batch.  The baseline
    and its knobs: tree state as the reference places it (the global by
    ``param_pspecs``, the client stack by ``client_stack_pspecs``, the
    [m] vectors over the client axes as ``flat_pspecs`` places them, the
    batch by ``batch_pspecs``; ``train_modes``); a chunk variant: the
    flat state by ``flat_pspecs``."""
    from repro_torch.core import FLConfig, FLState, init_fl_state, prng
    from repro_torch.models.model import init_params, split_trainable
    from repro_torch.sharding import client_stack_pspecs
    from repro_torch.sharding.rules import _axis_sizes, _client_axes

    m = fl_clients(mesh)
    flat = bool(_chunk_k(variant))
    mode, batch_mode = train_modes(variant)
    fl = FLConfig(m=m, s=cfg.local_steps, eta_l=0.01, eta_g=1.0,
                  strategy="fedawe", lr_schedule=False, grad_clip=0.0,
                  flat_state=flat)
    params = init_params(_generator(), cfg)
    trainable, frozen = split_trainable(params, cfg)
    state = init_fl_state(prng.PRNGKey(0, _device()), fl, trainable)
    batch = train_input_specs(cfg, shape, m)
    args = dict(state=state, frozen=frozen, batch=batch)
    if flat:
        state_spec = flat_pspecs(mesh, state, multi_pod=multi_pod)
    else:
        ca = _client_axes(_axis_sizes(mesh), multi_pod)
        state_spec = FLState(
            global_tr=param_pspecs(cfg, mesh, trainable, mode=mode),
            clients_tr=client_stack_pspecs(cfg, mesh, trainable,
                                           multi_pod=multi_pod, mode=mode),
            tau=P(ca), t=P(), extra=(), markov=P(ca), rng=P(None))
    specs = dict(state=state_spec,
                 frozen=param_pspecs(cfg, mesh, frozen, fsdp=True),
                 batch=batch_pspecs(mesh, batch, multi_pod=multi_pod,
                                    mode=batch_mode))
    return args, specs


def serve_args(cfg, shape, mesh):
    """Prefill's or decode's arguments and specs: params (FSDP-augmented
    for a LoRA base), the cache, the inputs."""
    from repro_torch.models.model import init_cache, init_params

    B = shape.global_batch
    params = init_params(_generator(), cfg)
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
# the fake process group and the meshes
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
        return 4
    return 512 if mesh_kind == "multi" else 256


def make_mesh(mesh_kind, test_mesh, variant="baseline", device_type="cpu"):
    """The combination's ``DeviceMesh`` inside the fake group: the
    production or test mesh, or under ``+mesh`` with ``+seeds[S]`` the
    ('seed', 'pod', 'data') mesh ``make_seed_mesh`` sizes over the
    group's ranks."""
    multi_pod = mesh_kind == "multi"
    if _chunk_mesh(variant) and _chunk_seeds(variant):
        return make_seed_mesh(_chunk_seeds(variant), multi_pod=multi_pod,
                              test=test_mesh, device_type=device_type)
    if test_mesh:
        return make_test_mesh(multi_pod=multi_pod, device_type=device_type)
    return make_production_mesh(multi_pod=multi_pod,
                                device_type=device_type)


def _device():
    """The device the step's tensors are made on: "cpu", or the card's
    under ``run_one(device="cuda")`` (the default device there)."""
    return torch.get_default_device()


def _generator():
    return torch.Generator(device=_device())


# ---------------------------------------------------------------------------
# the variants
# ---------------------------------------------------------------------------

#: the variant's tokens that take no number
KNOBS = ("baseline", "dots_remat", "moe_hint", "moe_dshard", "seq_shard",
         "epoch", "mesh", "faults", "staleness")
#: the variant's tokens that take an optional count: flat_chunk[K], seeds[S]
COUNTED_KNOBS = ("flat_chunk", "seeds")
#: the tree step's knobs (``train_modes``)
TREE_KNOBS = ("dp_client", "zero_client")


def check_variant(variant):
    """``variant`` as it is, where each of its '+'-joined tokens is a knob
    of this dry run; else a ``ValueError`` naming the token.  A tree
    step's knob beside ``flat_chunk[K]`` is refused too: the flat chunk
    places no leaf over 'model', so the knob would change nothing (the
    reference ignores it there), and no record may describe a knob that
    did nothing."""
    toks = variant.split("+")
    for tok in toks:
        counted = any(tok.startswith(k) and tok[len(k):].isdigit()
                      for k in COUNTED_KNOBS)
        if tok not in KNOBS + COUNTED_KNOBS + TREE_KNOBS and not counted:
            raise ValueError(f"variant {variant!r}: unknown knob {tok!r}")
    tree = [t for t in toks if t in TREE_KNOBS]
    if tree and _chunk_k(variant):
        raise ValueError(f"variant {variant!r}: {tree[0]} is a knob of the "
                         "tree-state round; the flat chunk executors place "
                         "no leaf over 'model', so it would change nothing")
    return variant


def _apply_cfg_variant(cfg, variant):
    """Config-level knobs encoded in the variant string: ``dots_remat``
    (``remat_policy="dots"``), ``moe_hint`` / ``moe_dshard`` (the MoE
    layer's ``REPRO_MOE_CONSTRAIN``, ``models/moe.py``: "1" and "D";
    cleared otherwise)."""
    if "dots_remat" in variant:
        cfg = cfg.replace(remat_policy="dots")
    if "moe_dshard" in variant:
        os.environ["REPRO_MOE_CONSTRAIN"] = "D"
    elif "moe_hint" in variant:
        os.environ["REPRO_MOE_CONSTRAIN"] = "1"
    else:
        os.environ.pop("REPRO_MOE_CONSTRAIN", None)
    return cfg


def _chunk_k(variant):
    """'flat_chunk' -> 8 rounds per call; 'flat_chunk<K>' -> K."""
    for tok in variant.split("+"):
        if tok.startswith("flat_chunk"):
            return int(tok[len("flat_chunk"):] or 8)
    return 0


def _chunk_sampling(variant):
    """'+epoch' selects the epoch-permutation device sampler."""
    return "epoch" if "epoch" in variant.split("+") else "uniform"


def _chunk_seeds(variant):
    """'+seeds<S>' selects the S-seed executor; 0 = one seed."""
    for tok in variant.split("+"):
        if tok.startswith("seeds"):
            return int(tok[len("seeds"):] or 4)
    return 0


def _chunk_mesh(variant):
    """'+mesh' (with '+seedsS') runs the S-seed executor on a
    ('seed', 'pod', 'data') mesh: each rank holds its seeds' rows and
    its block of their clients."""
    return "mesh" in variant.split("+")


def _chunk_faults(variant):
    """'+faults': fault injection live in the chunk (mid-round dropout,
    sanitization, a [2K, m] replay trace in the carry)."""
    return "faults" in variant.split("+")


def _chunk_staleness(variant):
    """'+staleness': semi-async rounds live in the chunk (a [tau_max, m,
    N] pending ring in the carry)."""
    return "staleness" in variant.split("+")


# ---------------------------------------------------------------------------
# step builders: (step, args) with step(*args) the combination's step on
# rank 0's share; call them under FakeTensorMode
# ---------------------------------------------------------------------------

def _fl_parts(cfg, mesh, place, *, fault_cfg=None,
              staleness_cfg=None, flat=True):
    """The FedAWE config (flat or tree state), the rank's round (K1's
    partial form over ``place``), the trainable and frozen trees."""
    from repro_torch.core import (AvailabilityCfg, FLConfig,
                                  make_round_fn_with_frozen)
    from repro_torch.models.model import (init_params, lm_loss_fn,
                                          split_trainable)

    m = fl_clients(mesh)
    fl = FLConfig(m=m, s=cfg.local_steps, eta_l=0.01, eta_g=1.0,
                  strategy="fedawe", lr_schedule=False, grad_clip=0.0,
                  flat_state=flat, use_kernel=True)
    trainable, frozen = split_trainable(
        init_params(_generator(), cfg), cfg)
    av = AvailabilityCfg(kind="sine", gamma=0.3, period=20)
    base_p = torch.full((m,), 0.5)
    round_fn = make_round_fn_with_frozen(
        fl, lm_loss_fn(cfg), av, base_p, fault_cfg=fault_cfg,
        staleness_cfg=staleness_cfg, place=place)
    return fl, round_fn, trainable, frozen


def build_train_step(cfg, shape, mesh, variant="baseline"):
    """The reference's train step: one placed FedAWE round on tree state
    (``round_fn(state, frozen, batch)``) over rank 0's client rows and
    its blocks over 'model': its client leaves and global as
    ``client_stack_pspecs`` / ``param_pspecs`` place them, the frozen
    base by ``param_pspecs`` over 'model', the ``[rows, s, b, L]`` batch
    by ``batch_pspecs`` (``train_modes(variant)``), K1's partial form on
    the rank's column shards."""
    from repro_torch.core import init_fl_state, prng
    from repro_torch.sharding.placement import rows_of, tree_placement

    mode, batch_mode = train_modes(variant)
    with unset_fake_temporarily():     # the mesh's rank grid, on the host
        place = tree_placement(mesh, fl_clients(mesh), mode=mode,
                               batch_mode=batch_mode)
    fl, round_fn, trainable, frozen = _fl_parts(cfg, mesh, place,
                                                flat=False)
    state = init_fl_state(prng.PRNGKey(0, _device()), fl, trainable,
                          place=place)
    batch = place.place_batch({k: rows_of(v, place) for k, v in
                               train_input_specs(cfg, shape, fl.m).items()})
    return round_fn, (state, place.place_params(frozen), batch)


#: samples per client in the dry run's store
STORE_CAP = 4


def _store(cfg, shape, m, place):
    """The device store of ``STORE_CAP`` samples a client: the per-sample
    arrays (fake, whole), the rank's rows of the index and the counts
    (real: the epoch sampler reads them on the host)."""
    from repro_torch.sharding.placement import rows_of

    batch = train_input_specs(cfg, shape, m)
    n = m * STORE_CAP
    arrays = {k: torch.empty((n,) + tuple(v.shape[3:]),
                             dtype=torch.int64 if not v.is_floating_point()
                             else v.dtype)
              for k, v in batch.items()}
    with unset_fake_temporarily():
        idx = rows_of(torch.arange(n).view(m, STORE_CAP), place).clone()
        counts = torch.full((idx.shape[0],), STORE_CAP)
    return dict(arrays=arrays, idx=idx, counts=counts)


def build_chunk_train_step(cfg, shape, mesh, variant):
    """The placed chunk executor (``make_chunk_fn`` /
    ``make_seeds_chunk_fn`` with ``with_frozen``): K FedAWE rounds a
    call, batches drawn on the device from the store by the sampler,
    rank 0's client rows of every carry (and its seeds under ``+mesh``),
    fault or stale carries where the variant asks."""
    from repro_torch.core import (init_fl_state, make_chunk_fn,
                                  make_seeds_chunk_fn, prng, stack_seeds)
    from repro_torch.core.faults import FaultCfg, init_fault_state
    from repro_torch.core.flatten import FlatSpec
    from repro_torch.core.staleness import (StalenessCfg,
                                            init_staleness_state)
    from repro_torch.data.federated import (init_seed_sampler_states,
                                            make_device_sampler,
                                            seed_data_keys)
    from repro_torch.launch.experiments import seed_chunk_placement
    from repro_torch.sharding.placement import client_placement

    K, S = _chunk_k(variant), _chunk_seeds(variant)
    m = fl_clients(mesh)
    with unset_fake_temporarily():     # the mesh's rank grid, on the host
        seeds = seed_chunk_placement(mesh, m, S) if S else None
        place = seeds.clients if S else client_placement(mesh, m)
    fault_cfg = staleness_cfg = None
    if _chunk_faults(variant):
        fault_cfg = FaultCfg(upload_survival=0.9, trace=True, sanitize=True)
    if _chunk_staleness(variant):
        staleness_cfg = StalenessCfg(tau_max=2, kind="det", delay=1)
    fl, round_fn, trainable, frozen = _fl_parts(
        cfg, mesh, place, fault_cfg=fault_cfg, staleness_cfg=staleness_cfg)
    # a [2K, m] replay trace (rows read mod T) and the [tau_max, m, N]
    # ring, the rank's client columns of each
    fault = (None if fault_cfg is None else init_fault_state(
        fault_cfg, trace=torch.ones((2 * K, m)), place=place))
    stale = (None if staleness_cfg is None else init_staleness_state(
        staleness_cfg, FlatSpec.from_tree(trainable).size, m, place=place))
    b = max(1, shape.global_batch // m)
    init_sampler, sample_fn = make_device_sampler(
        m, cfg.local_steps, b, mode=_chunk_sampling(variant),
        min_count=STORE_CAP, place=place)
    store = _store(cfg, shape, m, place)
    with unset_fake_temporarily():
        data_key = prng.PRNGKey(1, "cpu")
        keys = seed_data_keys(data_key, S)[seeds.seeds] if S else data_key
        sampler = (init_seed_sampler_states(init_sampler, store, keys) if S
                   else init_sampler(store, keys))

    def state(j):
        return init_fl_state(prng.fold_in(prng.PRNGKey(0, "cpu"), j), fl,
                             trainable, fault=fault, stale=stale,
                             place=place)

    if S:
        states = stack_seeds([state(j) for j in
                              range(S)[seeds.seeds]])
        chunk = make_seeds_chunk_fn(fl, round_fn, sample_fn, K,
                                    seeds.n_seeds, with_frozen=True,
                                    place=place)
        return chunk, (states, frozen, sampler, store, keys)
    chunk = make_chunk_fn(fl, round_fn, sample_fn, K, with_frozen=True,
                          place=place)
    return chunk, (state(0), frozen, sampler, store, keys)


def _place(tree, spec_tree, mesh):
    """Every tensor of ``tree`` as a DTensor placed by its spec (rank 0's
    block of it; nothing is communicated)."""
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import distribute_tensor

    leaves, treedef = pytree.tree_flatten(tree)
    specs = pytree.tree_flatten(spec_tree, is_leaf=_is_spec)[0]
    return pytree.tree_unflatten(
        [distribute_tensor(v, mesh, placements(p, mesh), src_data_rank=None)
         if torch.is_tensor(v) else v for v, p in zip(leaves, specs)],
        treedef)


def build_prefill_step(cfg, shape, mesh, args, specs, variant="baseline"):
    """``model.prefill`` over DTensors: ``args`` / ``specs`` of
    ``serve_args``; ``seq_shard`` puts the prompt's sequence on 'model'
    where it divides by 16."""
    from repro_torch.models.model import prefill

    inp_spec = dict(specs["inputs"])
    if "seq_shard" in variant:
        tok = inp_spec["tokens"]
        if args["inputs"]["tokens"].shape[1] % 16 == 0:
            inp_spec["tokens"] = P(tok[0], "model")
    params = _place(args["params"], specs["params"], mesh)
    cache = _place(args["cache"], specs["cache"], mesh)
    inp = _place(args["inputs"], inp_spec, mesh)

    def step(params, cache, inp):
        return prefill(params, cfg, cache, inp["tokens"],
                       embeds=inp.get("embeds"),
                       enc_embeds=inp.get("enc_embeds"))

    return step, (params, cache, inp)


def build_decode_step(cfg, shape, mesh, args, specs):
    """``model.serve_step`` over DTensors (one new token a sequence)."""
    from repro_torch.models.model import serve_step

    params = _place(args["params"], specs["params"], mesh)
    cache = _place(args["cache"], specs["cache"], mesh)
    inp = _place(args["inputs"], specs["inputs"], mesh)

    def step(params, cache, tokens, pos):
        return serve_step(params, cfg, cache, tokens, pos)

    return step, (params, cache, inp["tokens"], inp["pos"])


def execute(step, args):
    """``step(*args)`` once under ``analysis.CollectiveCounter``: its
    outputs and the counter."""
    with analysis.CollectiveCounter() as counter:
        out = step(*args)
    return out, counter


# ---------------------------------------------------------------------------
# one combination
# ---------------------------------------------------------------------------

def _train_tokens(cfg, shape, m, variant):
    return (m * cfg.local_steps * max(1, shape.global_batch // m)
            * shape.seq_len * max(1, _chunk_k(variant))
            * max(1, _chunk_seeds(variant)))


def _place_and_count(rec, cfg, shape, mesh, mesh_kind, variant, mode):
    """The placement half: the arguments' specs, the per-rank bytes, the
    analytic terms; raises ValueError / MemoryError where they do not
    divide or fit.  Returns the arguments and specs."""
    multi_pod = mesh_kind == "multi"
    ax = mesh_axis_sizes(mesh)
    with mode:
        if shape.kind == "train":
            args, specs = train_args(cfg, shape, mesh, multi_pod, variant)
        else:
            args, specs = serve_args(cfg, shape, mesh)
    if shape.kind == "train":
        m = fl_clients(mesh)
        rec["clients"] = m
        rec["model_flops"] = analysis.model_flops(
            cfg, _train_tokens(cfg, shape, m, variant), "train")
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
    if shape.kind == "train" and _chunk_k(variant):
        # the analytic model is per round; a chunk covers K rounds (x S
        # seeds)
        mul = _chunk_k(variant) * max(1, _chunk_seeds(variant))
        ana = {k: v * mul if isinstance(v, (int, float)) else v
               for k, v in ana.items()}
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
    return args, specs


def _run_step(rec, cfg, shape, mesh, variant, mode, args, specs):
    """Build the step, run it once under the counters, and record what
    they counted."""
    K = _chunk_k(variant)
    with mode:
        if shape.kind == "train":
            rec["state"] = "flat" if K else "tree"
            if K:
                step, step_args = build_chunk_train_step(cfg, shape, mesh,
                                                         variant)
            else:
                step, step_args = build_train_step(cfg, shape, mesh,
                                                   variant)
        elif shape.kind == "prefill":
            step, step_args = build_prefill_step(cfg, shape, mesh, args,
                                                 specs, variant)
        else:
            step, step_args = build_decode_step(cfg, shape, mesh, args,
                                                specs)
        t1 = time.time()
        out, counter = execute(step, step_args)
        rec["run_s"] = round(time.time() - t1, 2)
    rec["cost"] = analysis.cost_numbers(counter)
    mem = analysis.memory_numbers(counter, step_args, out)
    if shape.kind == "train":
        # the round's own arguments: the rank's rows (and blocks over
        # 'model' on tree state), the frozen base over 'model' (whole in
        # a flat chunk), not over 'data' as the reference's FSDP spec
        mem["step_argument_size_in_bytes"] = mem["argument_size_in_bytes"]
    # the record's argument size stays the placed arguments' (placement
    # half)
    mem["argument_size_in_bytes"] = rec["memory"]["argument_size_in_bytes"]
    rec["memory"].update(mem)
    rec["collectives"] = counter.collective_bytes()
    rec["collective_top"] = counter.collective_top()
    # the operators and shapes that count the most flops
    rec["flops_top"] = counter.flops_top()
    # per operator: the client all-reduces (``repro_torch::
    # client_all_reduce``) apart from DTensor's collectives over 'model'
    rec["collective_ops"] = {op: [n, counter.bytes_by_op[op]]
                             for op, n in counter.calls_by_op.items()}
    rec["roofline_counted"] = analysis.roofline_terms(
        rec["cost"]["flops"], rec["cost"]["bytes accessed"],
        rec["collectives"]["total"])
    ana = rec["analytic"]
    counted = float(rec["collectives"]["total"])
    coll = (max(ana["coll_bytes_per_dev"], counted)
            if variant == "baseline" else counted)
    rec["roofline"] = analysis.roofline_terms(
        ana["flops_per_dev"], ana["hbm_bytes_per_dev"], coll)


def run_one(arch, shape_name, mesh_kind, *, test_mesh=False, verbose=True,
            variant="baseline", cfg=None, shape=None, device="cpu"):
    """One combination inside a fake group of ``mesh_world`` ranks: its
    record (``ok`` with its numbers, or its ``error``).  ``cfg`` (a
    ``ModelConfig``, e.g. a reduced one) and ``shape`` (an
    ``InputShape``) take the place of ``arch``'s and ``shape_name``'s.
    ``device="cuda"`` makes the mesh and the fake tensors the card's (a
    CUDA fake tensor allocates nothing); the flat chunk variants keep
    their host-side store and sampler carries on the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    check_variant(variant)
    cfg = _apply_cfg_variant(get_config(arch) if cfg is None else cfg,
                             variant)
    shape = SHAPES[shape_name] if shape is None else shape
    # DTensor's native dispatch cache keys a view to -1 without its input
    # shape, so an entry made for one combination's tensors (olmoe's top-8
    # weights) would serve another's (moonshot's top-6) on an equal mesh:
    # every combination starts from an empty cache
    clear = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                    None)
    if clear is not None:
        clear()
    t0 = time.time()
    with fake_group(mesh_world(mesh_kind, test_mesh)), torch.device(device):
        mesh = make_mesh(mesh_kind, test_mesh, variant,
                         device_type=torch.device(device).type)
        ax = mesh_axis_sizes(mesh)
        rec = dict(arch=arch, shape=shape_name, mesh=mesh_kind,
                   chips=n_chips(mesh), ok=False, variant=variant,
                   mesh_axes={k: int(v) for k, v in ax.items()})
        K = _chunk_k(variant) if shape.kind == "train" else 0
        if K:
            rec["chunk_rounds"] = K
            rec["sampling"] = _chunk_sampling(variant)
            if _chunk_seeds(variant):
                rec["seeds"] = _chunk_seeds(variant)
            if _chunk_faults(variant):
                rec["faults"] = True
            if _chunk_staleness(variant):
                rec["staleness"] = True
        # real tensors (the store's index, the sampler's carry) may enter
        # the fake step as constants
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        try:
            args, specs = _place_and_count(rec, cfg, shape, mesh, mesh_kind,
                                           variant, mode)
        except (ValueError, MemoryError) as e:
            # a dim that does not divide, or a share that does not fit:
            # recorded, no step runs, and the sweep goes on
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-2000:]
        else:
            try:
                _run_step(rec, cfg, shape, mesh, variant, mode, args, specs)
                rec["ok"] = True
            except Exception as e:  # noqa: BLE001 — recorded, sweep goes on
                rec["error"] = f"{type(e).__name__}: {e}"
                rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 2)
    if verbose:
        gb = rec.get("memory", {}).get("argument_size_in_bytes", math.nan)
        extra = ""
        if rec["ok"] and "collectives" in rec:
            extra = (f", {rec['cost']['flops']:.3e} flops, "
                     f"{rec['collectives']['total'] / 1e9:.3f} GB "
                     f"collective, {rec['run_s']} s")
        print(f"{arch} x {shape_name} x {mesh_kind} [{variant}]: "
              f"{'ok' if rec['ok'] else 'FAILED'} ({gb / 1e9:.3f} GB a rank"
              f"{extra})" + (f" {rec['error']}" if "error" in rec else ""),
              flush=True)
    return rec


def combos(args):
    from repro_torch.configs import ARCHS

    if args.all:
        return [(a, s, args.mesh) for a in ARCHS for s in supported_shapes(a)]
    if not (args.arch and args.shape):
        raise SystemExit("pass --arch and --shape, or --all")
    return [(args.arch, args.shape, args.mesh)]


VARIANT_HELP = (
    "'+'-joined knobs: dots_remat (remat_policy='dots'), moe_hint / "
    "moe_dshard (the MoE expert buffer on 'model' / 'data'), seq_shard (the "
    "prompt's sequence on 'model'), flat_chunk[K] (the placed chunk "
    "executor, K rounds a call, default 8), epoch (epoch-permutation device "
    "sampling), seeds[S] (the S-seed executor, default 4), mesh (with "
    "seedsS: the ('seed', 'pod', 'data') mesh of make_seed_mesh), faults "
    "(mid-round dropout, sanitization and a [2K, m] replay trace in the "
    "chunk), staleness (bounded-delay uploads through a [tau_max, m, N] "
    "pending ring in the chunk), dp_client (the tree step's block weights "
    "replicated over 'model', the within-client batch over it), "
    "zero_client (weights stored sharded, the batch over 'model'); the "
    "last two raise beside flat_chunk, as does any unknown knob")


def _variant_arg(text):
    try:
        return check_variant(text)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None


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
    ap.add_argument("--variant", default="baseline", type=_variant_arg,
                    help=VARIANT_HELP)
    return ap


def _key(r):
    return (r["arch"], r["shape"], r["mesh"], r.get("variant", "baseline"))


def main(argv=None):
    args = build_parser().parse_args(argv)
    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {_key(r) for r in results if r.get("ok")}
    for arch, shape_name, mesh_kind in combos(args):
        key = (arch, shape_name, mesh_kind, args.variant)
        if args.skip_done and key in done:
            print(f"skip {arch} {shape_name} {mesh_kind} {args.variant} "
                  "(done)")
            continue
        rec = run_one(arch, shape_name, mesh_kind, test_mesh=args.test_mesh,
                      variant=args.variant)
        results = [r for r in results if _key(r) != key]
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
