"""The PyTorch port stands alone: importing every module of
``imagegenerator_tpu_torch`` (and ``chip_smoke.py``) loads no JAX, flax,
optax, orbax or ``imagegenerator_tpu`` module, and no source file of the
port or its scripts imports one, even inside a function."""

import ast
import os
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "imagegenerator_tpu")
SOURCES = sorted((ROOT / "imagegenerator_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_PROBE = f"""
import importlib, pkgutil, sys
import imagegenerator_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
print(len(names), bad)
"""

# each console script's target; the probe imports it alone, as the script does
_SCRIPT_PROBE = f"""
import importlib, sys
target = sys.argv[1]
module, func = target.split(":")
assert callable(getattr(importlib.import_module(module), func))
print(sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}))
"""


PORT_SCRIPTS = {name: target for name, target in
                tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"].items()
                if name.startswith("imagegen-torch-")}


def test_importing_every_module_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.split(" ", 1)
    # v1 sampling, both training steps, the training runtime, v2 generation,
    # data parallelism, profiling, the caption cache, the host ops, eval,
    # tensor parallelism, remat, the legacy LSTM path, the dry run, the
    # bench, the op-class profiler and the weights-day playbook
    assert int(count) >= 70
    assert bad.strip() == "[]"


def test_the_port_has_its_console_scripts():
    assert sorted(PORT_SCRIPTS) == [f"imagegen-torch-{n}" for n in ("bench", "evaluate", "generate", "sample", "train")]


@pytest.mark.parametrize("name", sorted(PORT_SCRIPTS))
def test_console_script_imports_no_jax(name):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT_PROBE, PORT_SCRIPTS[name]], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_the_checkpoint_bridge_is_not_part_of_the_port():
    """``tools/jax_checkpoint_to_port.py`` imports JAX and Orbax to read
    and write the JAX package's checkpoints, so it lives outside the
    port's sources and the port imports it nowhere."""
    assert (ROOT / "tools" / "jax_checkpoint_to_port.py").exists()
    assert not any(p.name == "jax_checkpoint_to_port.py" for p in SOURCES)
    for path in SOURCES:
        assert "jax_checkpoint_to_port" not in path.read_text(), path


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"
