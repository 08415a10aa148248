"""Every cell end to end on the CPU at the port's tiny widths, as the
benchmark's command runs it: a result line of the expected form, ``correct`` true;
each fault its system can plant (``faults`` of ``systems/<kind>.py``)
comes out not correct; its control fails a limit; nothing of JAX loads.
A cell over several cards runs as ranks over gloo: one result line, and a
rank that fails or hangs ends the launch within its deadline with no
rank left."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import pytest

from portbench.common import CHECKOUT, Bench, system_kind
from portbench.systems import stackgan
from portbench.tests.conftest import planted, result, run_cell
from portbench.tests.tiny import TINY_RANKS

SPEC = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
RANKED = [w["name"] for w in SPEC["workloads"] if w["chips"] > 1]


def _kind(workload):
    bench = Bench()
    return system_kind(bench.config(bench.cell(workload)["config"])["system"])


def _limits(workload):
    return _kind(workload).TINY_LIMITS


# every fault the cell's system can plant in it, at the tiny cell's ranks
PLANTED = [(w["name"], fault) for w in SPEC["workloads"]
           for fault in _kind(w["name"]).faults(min(Bench().traffic(w["traffic"])["ranks"], TINY_RANKS))]


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
    if trace:  # a rate reported per layer needs no card to read
        rates = {m["name"] for m in Bench(tiny_spec).metrics_of("per_layer", workload)
                 if m["name"].startswith("images_per_s.")}
        assert rates <= set(out["metrics"])
    assert out["correct"], err[-2000:]
    limits = _limits(workload)
    lines = err.strip().splitlines()
    assert [t.split()[1] for t in lines[-len(limits):]] == list(limits)
    if trace:  # the phase stretch, reduced by the system's own spans
        phases = json.loads(lines[-len(limits) - 1])["phases"]
        spans = _kind(workload).SPANS
        assert set(spans) <= set(phases) and any(phases[n]["count"] for n in spans)


def test_stackgan_names_its_faults():
    assert stackgan.faults(1) == ("stale", "half_batch")
    assert stackgan.faults(4) == ("stale", "half_batch", "no_exchange")


@pytest.mark.parametrize(("workload", "fault"), PLANTED)
def test_planted_fault_is_not_correct(tiny_spec, workload, fault):
    rc, lines, err = run_cell(tiny_spec, workload, extra=("--fault", fault))
    assert rc == 0, err[-3000:]
    assert result(lines)["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit(tiny_spec, workload):
    """The system's control (StackGAN's: the reference in fp8) put in the
    program's place, on three seeds: each reads over at least one of the
    tiny cells' limits."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", "portbench.calibrate", "--workload", workload, "--mode", "control",
                        "--seeds", "1,2,3", "--spec", str(tiny_spec), "--device", "cpu"], cwd=str(CHECKOUT),
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    rows = [json.loads(ln) for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert len(rows) == 3
    for row in rows:
        assert any(row[k] > lim for k, lim in _limits(workload).items()), row


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


def _rank_pids(err: str) -> list:
    return [int(p) for p in re.findall(r"^\[launch\] rank \d+ of \d+: pid (\d+)$", err, re.M)]


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.mark.parametrize("workload", RANKED)
def test_ranks_print_one_result_line(tiny_spec, workload):
    rc, lines, err = run_cell(tiny_spec, workload, seed=2**33 + 17)
    assert rc == 0, err[-3000:]
    assert len(lines) == 1 and result(lines)["correct"] is True
    pids = _rank_pids(err)
    assert len(pids) == Bench(tiny_spec).cell(workload)["chips"] and all(map(_gone, pids))


@pytest.mark.parametrize("workload", RANKED)
def test_no_exchange_is_not_correct(tiny_spec, workload):
    rc, lines, err = run_cell(tiny_spec, workload, extra=("--fault", "no_exchange"))
    assert rc == 0, err[-3000:]
    assert result(lines)["correct"] is False


@pytest.mark.parametrize("fault", ["raises", "hangs"])
@pytest.mark.parametrize("workload", RANKED)
def test_a_failed_rank_ends_the_launch(tiny_spec, workload, fault):
    """The last rank raises, or never returns, once it has joined: the
    launcher exits non-zero within its deadline, prints no result and
    leaves no rank behind."""
    deadline = 20.0
    t = time.monotonic()
    rc, lines, err = run_cell(tiny_spec, workload, env=planted(fault, deadline))
    took = time.monotonic() - t
    assert rc != 0 and lines == [], err[-3000:]
    assert ("planted failure" if fault == "raises" else "deadline") in err
    assert took < deadline + 30.0
    pids = _rank_pids(err)
    assert len(pids) == Bench(tiny_spec).cell(workload)["chips"] and all(map(_gone, pids))


@pytest.mark.parametrize("workload", RANKED)
def test_no_result_without_cards_for_every_rank(workload):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload, "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=str(CHECKOUT), capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("workload", RANKED)
def test_forbidden_modules_end_a_launch(tiny_spec, workload):
    """The launcher, which prints the result of a cell over several cards,
    holds a module of the JAX family: no result."""
    code = ("import sys, types; sys.modules['flax'] = types.ModuleType('flax'); "
            "from portbench import run; sys.exit(run.main(sys.argv[1:]))")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", code, "--workload", workload, "--seed", "5", "--seconds", "0.2",
                        "--spec", str(tiny_spec), "--device", "cpu"], cwd=str(CHECKOUT), env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "flax" in p.stderr.splitlines()[-1]


@pytest.mark.parametrize("workload", RANKED)
def test_forbidden_modules_on_a_rank_end_a_launch(tiny_spec, workload):
    """The last rank alone holds a module of the JAX family when its
    window closes: it leaves with a code other than 0, and the launcher
    prints no result."""
    rc, lines, err = run_cell(tiny_spec, workload, env=planted("module"))
    assert rc != 0 and lines == [], err[-3000:]
    assert "flax" in err and "exited with code 3" in err


@pytest.mark.parametrize("mode", ["program", "no_exchange"])
@pytest.mark.parametrize("workload", RANKED)
def test_calibrate_reads_seeds_over_ranks(tiny_spec, workload, mode):
    """Calibration runs the program's seeds as ranks, one line a seed
    from rank 0: sound runs under every tiny limit, the exchange left out
    over one."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", "portbench.calibrate", "--workload", workload, "--mode", mode,
                        "--seeds", "1,2", "--spec", str(tiny_spec), "--device", "cpu"], cwd=str(CHECKOUT),
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    rows = [json.loads(ln) for ln in p.stdout.splitlines()]
    assert [r["seed"] for r in rows] == [1, 2]
    for row in rows:
        over = any(row[k] > lim for k, lim in _limits(workload).items())
        assert over == (mode == "no_exchange"), row
