"""Fixtures of the benchmark's own tests (CPU; ``python -m pytest
portbench/tests``)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench.common import CHECKOUT
from portbench.tests import tiny


@pytest.fixture(scope="session")
def tiny_spec(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tinybench"))


def run_cell(spec, workload, seed=3_000_000_019, seconds=0.5, trace=0, extra=(), timeout=600):
    """Run the harness as its command does, on the CPU against the tiny
    benchmark; returns ``(returncode, stdout lines, stderr)``."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "portbench.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace), "--spec", str(spec), "--device", "cpu",
           *extra]
    p = subprocess.run(cmd, cwd=str(CHECKOUT), env=env, capture_output=True, text=True, timeout=timeout)
    return p.returncode, [ln for ln in p.stdout.splitlines() if ln.strip()], p.stderr


def result(lines):
    """The result: the last line of standard output."""
    return json.loads(lines[-1])
