"""The port stands alone: importing every repro_torch module pulls in
neither jax nor the JAX package, no source line of the port (or of
chip_smoke.py) imports them, and chip_smoke.py refuses to run — printing
no result — without a card or outside the repo."""
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
    assert "repro_torch.kernels.echo_aggregate.kernel" in mods
    assert "repro_torch.launch.train" in mods
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


def test_no_source_line_imports_jax_or_repro():
    files = [SMOKE]
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
