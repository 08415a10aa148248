"""Every cell end to end on the CPU at the port's tiny widths, as the
benchmark's command runs it: a result line of the expected form, ``correct`` true;
each planted fault a training cell can have comes out not correct; the
control (the reference in fp8) fails a limit; nothing of JAX loads."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench.common import CHECKOUT, Bench
from portbench.tests.conftest import result, run_cell
from portbench.tests.tiny import TINY_LIMITS

SPEC = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def _check_line(out, workload, trace, bench):
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(out)[-1] == "checked"
    section = "per_layer" if trace else "end_to_end"
    expected = {m["name"] for m in bench.metrics_of(section, workload)}
    assert set(out["metrics"]) <= expected
    if not trace:
        assert set(out["metrics"]) == expected
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == bench.cell(workload)["chips"]
    if trace:
        assert "busy_s" in dev and "window_s" in dev and set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_end_to_end(tiny_spec, workload, trace):
    rc, lines, err = run_cell(tiny_spec, workload, trace=trace)
    assert rc == 0, err[-3000:]
    out = result(lines)
    _check_line(out, workload, trace, Bench(tiny_spec))
    assert out["correct"], err[-2000:]
    tail = err.strip().splitlines()[-len(TINY_LIMITS):]
    assert [t.split()[1] for t in tail] == list(TINY_LIMITS)


@pytest.mark.parametrize("fault", ["stale", "half_batch"])
@pytest.mark.parametrize("workload", CELLS)
def test_planted_fault_is_not_correct(tiny_spec, workload, fault):
    rc, lines, err = run_cell(tiny_spec, workload, extra=("--fault", fault))
    assert rc == 0, err[-3000:]
    assert result(lines)["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit(tiny_spec, workload):
    """The reference in fp8 put in the program's place, on three seeds:
    each reads over at least one of the tiny cells' limits."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", "portbench.calibrate", "--workload", workload, "--mode", "control",
                        "--seeds", "1,2,3", "--spec", str(tiny_spec), "--device", "cpu"], cwd=str(CHECKOUT),
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    rows = [json.loads(ln) for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert len(rows) == 3
    for row in rows:
        assert any(row[k] > lim for k, lim in TINY_LIMITS.items()), row


def test_no_result_without_a_card():
    """Without ``--device`` the harness looks for CUDA cards: here there
    are none, so it exits non-zero and prints no result."""
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=str(CHECKOUT), capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference.stackgan, portbench.reference.attention_hash; "
            "bad = {m.split('.')[0] for m in sys.modules} & {'imagegenerator_tpu_torch', 'imagegenerator_tpu', "
            "'jax', 'jaxlib', 'flax', 'optax', 'orbax'}; print(sorted(bad))")
    p = subprocess.run([sys.executable, "-c", code], cwd=str(CHECKOUT), capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stderr


def test_forbidden_modules_end_a_run(tiny_spec):
    """A run whose process holds a module of the JAX family when the
    window closes exits non-zero with no result and names it."""
    code = ("import sys, types; sys.modules['jax'] = types.ModuleType('jax'); "
            "from portbench import run; sys.exit(run.main(sys.argv[1:]))")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", code, "--workload", CELLS[0], "--seed", "5", "--seconds", "0.2",
                        "--spec", str(tiny_spec), "--device", "cpu"], cwd=str(CHECKOUT), env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "jax" in p.stderr
