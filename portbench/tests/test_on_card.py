"""On the card (``-m cuda``; skipped without one): a one-chip cell at its
full size for a short window, through the benchmark's own command, and
its control, the reference in fp8 in the program's place, failing a
limit on three seeds; a cell over several cards likewise where the host
has a card for each of its ranks (its control needs one card).

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
RANKED = [w["name"] for w in Bench().spec["workloads"] if w["chips"] > 1]


def _need_card(count=1):
    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        pytest.skip(f"needs {count} NVIDIA card(s)")


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
@pytest.mark.parametrize("workload", RANKED)
def test_ranked_cell_on_the_cards(workload):
    _need_card(Bench().cell(workload)["chips"])
    p = _run("--workload", workload, "--seed", str(2**35 + 9), "--seconds", "3", "--trace", "0")
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    assert len(lines) == 1 and out["correct"] is True and out["device"]["count"] == Bench().cell(workload)["chips"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CHIP + RANKED)
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
