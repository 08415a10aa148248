"""On the card (``-m cuda``; skipped without one): a one-chip cell at its
full size for a short window, through the benchmark's own command, and
its control, the reference in fp8 in the program's place, failing a
limit on three seeds.

    python -m pytest -m cuda portbench/tests/test_on_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench.common import CHECKOUT, Bench

ONE_CHIP = [w["name"] for w in Bench().spec["workloads"] if w["chips"] == 1]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _run(*args):
    return subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=str(CHECKOUT),
                          capture_output=True, text=True, timeout=900)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CHIP)
def test_cell_on_the_card(workload):
    _need_card()
    p = _run("--workload", workload, "--seed", str(2**35 + 7), "--seconds", "3", "--trace", "0")
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CHIP)
def test_control_on_the_card(workload):
    _need_card()
    p = subprocess.run([sys.executable, "-m", "portbench.calibrate", "--workload", workload, "--mode", "control",
                        "--seeds", "1,2,3"], cwd=str(CHECKOUT), capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    limits = Bench().limits(workload)
    rows = [json.loads(ln) for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert len(rows) == 3
    for row in rows:
        assert any(row[k] > lim for k, lim in limits.items()), row
