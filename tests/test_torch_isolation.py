"""The port stands alone: importing every repro_torch module (and every
example script of ``examples/torch/``) pulls in neither jax nor the JAX
package, no source line of the port, of its examples or of chip_smoke.py
imports them, and chip_smoke.py refuses to run — printing no result —
without a card or outside the repo."""
import os
import re
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT = os.path.join(SRC, "repro_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")
EXAMPLES = os.path.join(REPO, "examples", "torch")

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|from\s+repro\b"
    r"|import\s+repro\.|from\s+repro\.)", re.M)


def _port_modules():
    mods = []
    for root, _, names in os.walk(PORT):
        for name in sorted(names):
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, name), SRC)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_every_module_imports_without_jax_or_repro():
    mods = _port_modules()
    for name in ("repro_torch.kernels.echo_aggregate.kernel",
                 "repro_torch.launch.train",
                 "repro_torch.kernels.flash_attention.kernel",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.models.model", "repro_torch.models.layers",
                 "repro_torch.configs.gemma2_2b", "repro_torch.launch.serve",
                 "repro_torch.kernels.nvcc", "repro_torch.models.ssm",
                 "repro_torch.kernels.ssd_chunk.kernel",
                 "repro_torch.kernels.ssd_chunk.ops",
                 "repro_torch.kernels.ssd_chunk.ref",
                 "repro_torch.configs.zamba2_7b",
                 "repro_torch.core.faults", "repro_torch.core.staleness",
                 "repro_torch.core.engine", "repro_torch.models.moe",
                 "repro_torch.launch.experiments", "repro_torch.optim",
                 "repro_torch.optim.optimizers",
                 "repro_torch.optim.schedules", "repro_torch.core.mixing",
                 "repro_torch.launch.mesh", "repro_torch.launch.compilecache",
                 "repro_torch.launch.roofline", "repro_torch.sharding",
                 "repro_torch.sharding.rules",
                 "repro_torch.sharding.placement",
                 "repro_torch.launch.dryrun"):
        assert name in mods, name
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


def _examples():
    names = sorted(n for n in os.listdir(EXAMPLES) if n.endswith(".py"))
    assert names == ["federated_image.py", "federated_lm.py",
                     "quickstart.py", "serve_demo.py"], names
    return [os.path.join(EXAMPLES, n) for n in names]


def test_examples_import_without_jax_or_repro():
    code = ("import importlib.util, sys\n"
            f"for i, p in enumerate({_examples()!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f'ex{i}', p)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


def test_no_source_line_imports_jax_or_repro():
    files = [SMOKE] + _examples()
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        hits = _FORBIDDEN.findall(open(path).read())
        assert not hits, f"{path}: {hits}"


def test_chip_smoke_refuses_without_card_and_outside_repo(tmp_path):
    import torch

    runs = [(REPO, SMOKE)]
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, lone)
    runs.append((str(tmp_path), str(lone)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in runs:
        if cwd == REPO and torch.cuda.is_available():
            continue
        r = subprocess.run([sys.executable, script], capture_output=True,
                           text=True, env=env, cwd=cwd, timeout=300)
        assert r.returncode != 0, (cwd, r.stdout)
        assert '"ok": true' not in r.stdout
