"""The reference's compiled train step, read on the CPU: per-rank ``dot``
flops and collective bytes of ``repro.launch.dryrun.build_train_step``
on a forced-host-device mesh, the yardstick the port's dry-run counts
are held against.

The step compiles in a subprocess of its own: the host device count is
fixed by ``XLA_FLAGS`` before JAX is imported (``repro.launch.dryrun``
reads ``REPRO_DRYRUN_DEVICES``), and the test process keeps one device.

  * ``dot_flops``: every ``dot`` of the compiled (SPMD-partitioned, so
    per-rank) module, ``2 · prod(output) · prod(contracted dims)``,
    weighted by how often its computation runs: a while loop's body by
    its trip count (``known_trip_count``, else the largest ``s32``
    constant of its condition), and the computations an instruction calls
    (``calls=``, ``to_apply=``, a conditional's branches) once per
    execution of the caller, summed over every call site;
  * ``dots``: the same flops per (output shape, lhs shape) signature, the
    largest first, to read which split XLA chose;
  * ``collectives``: ``repro.launch.analysis.collective_bytes`` as the
    reference's dry run records it (its parser reads the shapes printed
    inside a collective's parentheses or its tuple result; the compiled
    text prints operands by name, so it sees only the tuple results);
  * ``collective_operand_bytes``: each collective's operands' bytes, the
    shapes looked up by name, trip-weighted as the dots are.

    REPRO_DRYRUN_DEVICES=256 PYTHONPATH=src python tests/_torch_ref_hlo.py \\
        '{"arch": "gemma2-2b", "mesh": "single"}'
    REPRO_DRYRUN_DEVICES=4 PYTHONPATH=src python tests/_torch_ref_hlo.py \\
        '{"arch": "gemma2-2b", "test_mesh": true, "seq_len": 64,
          "global_batch": 4, "reduced": {"n_kv_heads": 1}}'

prints one JSON object a job.  ``ReferenceRun`` runs such a command in
the background (its device count set) and ``reference_counts`` one job.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HEADER = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->\s*.*\{\s*$")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
_CALLS = re.compile(r"\b(?:calls|to_apply|body|condition|true_computation|"
                    r"false_computation)=%?([\w.\-]+)")
_BRANCHES = re.compile(r"branch_computations=\{([^}]*)\}")


def _dims(text):
    return [int(d) for d in text.split(",") if d]


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


def split_module(hlo):
    """``{name: [instruction lines]}`` of an HLO module's computations,
    ``{name: header line}`` and the entry computation's name."""
    comps, headers, entry, cur = {}, {}, None, None
    for line in hlo.splitlines():
        m = _HEADER.match(line.strip())
        if m:
            cur = m.group(2)
            comps[cur], headers[cur] = [], line
            if m.group(1):
                entry = cur
            continue
        if line.strip() == "}":
            cur = None
            continue
        if cur is not None:
            comps[cur].append(line)
    return comps, headers, entry


def _trip(line, comps):
    m = re.search(r'"known_trip_count":\{"n":"(\d+)"', line)
    if m:
        return int(m.group(1))
    cond = re.search(r"condition=%?([\w.\-]+)", line)
    consts = [int(c) for c in re.findall(
        r"s32\[\]\s+constant\((\d+)\)",
        "\n".join(comps.get(cond.group(1), ()) if cond else ()))]
    return max(consts) if consts else 1


def _symbols(header, lines):
    """``{name: (dtype, dims)}`` of a computation's parameters and
    instructions (array shapes only; a tuple's name maps to nothing)."""
    out = {}
    for name, dt, dims in re.findall(
            r"%?([\w.\-]+):\s*(\w+)\[([0-9,]*)\]", header):
        out[name] = (dt, dims)
    for line in lines:
        ins = _INSTR.match(line)
        if ins:
            m = re.match(r"(\w+)\[([0-9,]*)\]", ins.group(2))
            if m:
                out[ins.group(1)] = (m.group(1), m.group(2))
    return out


def _operands(rhs, op):
    """The operand names of ``op(...)`` in an instruction's right-hand
    side."""
    m = re.search(rf"\b{op}\(([^)]*)\)", rhs)
    return [] if not m else [a.strip().split()[-1].lstrip("%")
                             for a in m.group(1).split(",") if a.strip()]


def _dot(rhs, sym):
    """(flops, signature) of a ``dot`` instruction's right-hand side (its
    operands' shapes from ``sym``), or None."""
    m = re.match(r"(\w+)\[([0-9,]*)\]\S*\s+dot\(", rhs)
    if not m:
        return None
    lhs = sym[_operands(rhs, "dot")[0]]
    cdims = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", rhs)
    ldims = _dims(lhs[1])
    k = _prod(ldims[c] for c in _dims(cdims.group(1))) if cdims else 1
    flops = 2 * _prod(_dims(m.group(2))) * k
    return flops, f"{m.group(1)}[{m.group(2)}] <- {lhs[0]}[{lhs[1]}]"


_COLL = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def _collective(rhs, sym):
    """(kind with its operands' shapes, operand bytes) of a collective
    instruction (its ``-start`` form included, its ``-done`` not), or
    None."""
    from repro.launch.analysis import _shape_bytes

    for kind in _COLL:
        if re.search(rf"\s{kind}(-start)?\(", " " + rhs):
            op = kind + ("-start" if f"{kind}-start(" in rhs else "")
            shapes = [sym[a] for a in _operands(rhs, op) if a in sym]
            sig = ",".join(f"{dt}[{dims}]" for dt, dims in shapes)
            return f"{kind} {sig}", sum(_shape_bytes(*s) for s in shapes)
    return None


def module_counts(hlo):
    """``(dot flops, {signature: flops}, {kind and operand shapes:
    collective operand bytes})`` of a compiled module, each trip-weighted
    (module note)."""
    comps, headers, entry = split_module(hlo)
    memo = {}

    def total(name, stack=()):
        if name in memo:
            return memo[name]
        if name in stack or name not in comps:
            return 0, {}, {}
        sym = _symbols(headers[name], comps[name])
        flops, sigs, coll = 0, {}, {}
        for line in comps[name]:
            ins = _INSTR.match(line)
            if not ins:
                continue
            rhs = ins.group(2)
            d = _dot(rhs, sym)
            if d is not None:
                flops += d[0]
                sigs[d[1]] = sigs.get(d[1], 0) + d[0]
            c = _collective(rhs, sym)
            if c is not None:
                coll[c[0]] = coll.get(c[0], 0) + c[1]
            called = _CALLS.findall(rhs)
            br = _BRANCHES.search(rhs)
            if br:
                called += [c.strip().lstrip("%") for c in
                           br.group(1).split(",") if c.strip()]
            if not called:
                continue
            mult = _trip(rhs, comps) if re.search(r"\swhile\(", rhs) else 1
            for child in called:
                cf, cs, cc = total(child, stack + (name,))
                flops += mult * cf
                for k, v in cs.items():
                    sigs[k] = sigs.get(k, 0) + mult * v
                for k, v in cc.items():
                    coll[k] = coll.get(k, 0) + mult * v
        memo[name] = (flops, sigs, coll)
        return memo[name]

    if entry is None:
        raise ValueError("no ENTRY computation in the module")
    return total(entry)


def _config(arch, reduced_kw):
    from repro.configs import get_config
    from repro.models.config import reduced

    cfg = get_config(arch)
    return cfg if reduced_kw is None else reduced(cfg, **reduced_kw)


def _count(job):
    """One job's JSON object: ``job`` holds ``arch``, ``mesh`` ("single"
    or "multi"), ``test_mesh``, and optionally ``reduced`` (overrides of
    ``repro.models.config.reduced``), ``seq_len``, ``global_batch``,
    ``variant``, ``top``."""
    import time

    from repro.configs import SHAPES, InputShape
    from repro.launch import analysis, dryrun
    from repro.launch.mesh import make_production_mesh, make_test_mesh

    cfg = _config(job["arch"], job.get("reduced"))
    base = SHAPES["train_4k"]
    shape = InputShape("train_4k", "train", job.get("seq_len") or
                       base.seq_len, job.get("global_batch") or
                       base.global_batch)
    multi = job.get("mesh", "single") == "multi"
    mesh = (make_test_mesh(multi_pod=multi) if job.get("test_mesh")
            else make_production_mesh(multi_pod=multi))
    top = job.get("top", 12)
    t0 = time.time()
    with mesh:
        fn, step_args = dryrun.build_train_step(
            cfg, shape, mesh, multi, variant=job.get("variant", "baseline"))
        compiled = fn.lower(*step_args).compile()
    hlo = compiled.as_text()
    flops, sigs, coll_sigs = module_counts(hlo)
    coll = {}
    for k, v in coll_sigs.items():
        coll[k.split()[0]] = coll.get(k.split()[0], 0) + v
    return dict(
        job, seq_len=shape.seq_len, global_batch=shape.global_batch,
        dot_flops=flops,
        dots=[[k, v] for k, v in sorted(sigs.items(),
                                        key=lambda kv: -kv[1])[:top]],
        collectives=analysis.collective_bytes(hlo),
        collective_operand_bytes=dict(coll, total=sum(coll.values())),
        collective_operand_top=[[k, v] for k, v in sorted(
            coll_sigs.items(), key=lambda kv: -kv[1])[:top]],
        collective_top=analysis.collective_top(hlo),
        compile_s=round(time.time() - t0, 1))


def main(argv=None):
    """Each argument a job (a JSON object, ``_count``'s); one JSON line
    per job."""
    for text in (sys.argv[1:] if argv is None else argv):
        print(json.dumps(_count(json.loads(text))), flush=True)


class ReferenceRun:
    """The jobs' subprocess, started at construction on 4 (a
    ``test_mesh`` job), 256 or 512 forced host devices (every job of one
    run on the same count); ``result()`` waits for it and returns each
    job's object in order."""

    def __init__(self, *jobs, timeout=600):
        multi = any(j.get("mesh") == "multi" for j in jobs)
        test = all(j.get("test_mesh") for j in jobs)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.join(REPO, "src")
        env["REPRO_DRYRUN_DEVICES"] = ("4" if test else
                                       "512" if multi else "256")
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("XLA_FLAGS", None)
        self.timeout = timeout
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)]
            + [json.dumps(j) for j in jobs], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)

    def result(self):
        try:
            out, err = self.proc.communicate(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            raise
        if self.proc.returncode:
            raise RuntimeError(f"reference step failed "
                               f"({self.proc.returncode}):\n{out[-2000:]}\n"
                               f"{err[-4000:]}")
        return [json.loads(line) for line in out.splitlines()
                if line.startswith("{")]


def reference_counts(arch, *, mesh="single", test_mesh=False, reduced=None,
                     seq_len=None, global_batch=None, timeout=600):
    """One job's object (``ReferenceRun``)."""
    return ReferenceRun(dict(arch=arch, mesh=mesh, test_mesh=test_mesh,
                             reduced=reduced, seq_len=seq_len,
                             global_batch=global_batch),
                        timeout=timeout).result()[0]


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(REPO, "src"))
    main()
