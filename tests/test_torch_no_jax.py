"""The PyTorch port stands alone: importing every module of
``imagegenerator_tpu_torch`` (and ``chip_smoke.py``) loads no JAX, flax,
optax, orbax or ``imagegenerator_tpu`` module, and no source file of the
port or its scripts imports one, even inside a function."""

import ast
import os
import subprocess
import sys
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


def test_importing_every_module_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.split(" ", 1)
    assert int(count) >= 15
    assert bad.strip() == "[]"


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
