"""A new kind of system needs only new files: a copy of the harness takes
a toy kind (``toy_kind/``: a plain MLP with one loss and one phase span,
its reference, control, faults, tiny form, configuration, mix, limits and
reader, and entries appended to ``BENCHMARK.json``) without an edit to any
file it has, and runs it through ``portbench.run`` (``--trace 0`` and
``1``, the phase spans reduced), ``portbench.calibrate`` in every mode
and the tiny benchmark's set-up."""

from __future__ import annotations

import filecmp
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.common import CHECKOUT, ROOT, SPEC_FILE

TOY = ROOT / "tests" / "toy_kind"
SEED = 2**33 + 101


def _files(root):
    return {p.relative_to(root) for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def _python(root, *args, timeout=300):
    """``python *args`` in the copy: its ``portbench`` first on the path,
    the program (which the toy does not use) found in this checkout."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(CHECKOUT))
    return subprocess.run([sys.executable, *args], cwd=str(root), env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """``(root, tiny spec)``: the harness copied, the toy's files and entries
    added, and the copy's tiny benchmark written by its own ``tiny.make``."""
    root = tmp_path_factory.mktemp("newkind")
    shutil.copytree(ROOT, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    for rel in _files(TOY / "portbench"):
        dest = root / "portbench" / rel
        assert not dest.exists(), rel
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(TOY / "portbench" / rel, dest)
    spec = json.loads(SPEC_FILE.read_text())
    for section, entries in json.loads((TOY / "entries.json").read_text()).items():
        spec[section] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))
    p = _python(root, "-c", "import sys; from portbench.tests import tiny; print(tiny.make(sys.argv[1]))",
                str(root / "tiny"))
    assert p.returncode == 0, p.stderr[-3000:]
    return root, p.stdout.strip()


def test_the_copy_differs_by_added_files_only(copy):
    root, _ = copy
    have = _files(ROOT)
    added = _files(root / "portbench") - have
    assert added == _files(TOY / "portbench")
    same, changed, missing = filecmp.cmpfiles(ROOT, root / "portbench", sorted(map(str, have)), shallow=False)
    assert changed == [] and missing == [] and len(same) == len(have)
    old, new = json.loads(SPEC_FILE.read_text()), json.loads((root / "BENCHMARK.json").read_text())
    for section, value in old.items():
        assert new[section][: len(value)] == value if isinstance(value, list) else new[section] == value


def test_the_tiny_form_comes_from_each_kind(copy):
    root, spec = copy
    spec = json.loads(open(spec).read())
    toy = next(c for c in spec["configs"] if c["name"] == "toy_mlp")
    conf = json.loads((root / "tiny" / toy["file"]).read_text())
    assert conf["system"] == "toy" and conf["hidden"] == 16
    limits = json.loads((root / "tiny" / "portbench" / "limits" / "toy_mlp_rows.json").read_text())["limits"]
    assert set(limits) == {"loss_gap", "grad_norm_gap", "change_norm_gap"}


def _run(root, spec, trace=0, fault=None):
    args = ["-m", "portbench.run", "--workload", "toy_mlp_rows", "--seed", str(SEED), "--seconds", "0.3",
            "--trace", str(trace), "--spec", spec, "--device", "cpu"]
    return _python(root, *args, *(("--fault", fault) if fault else ()))


@pytest.mark.parametrize("trace", [0, 1])
def test_toy_cell_runs(copy, trace):
    root, spec = copy
    p = _run(root, spec, trace)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["attempted"] >= 1, p.stderr[-2000:]
    lines = p.stderr.strip().splitlines()
    assert [ln.split()[1] for ln in lines[-3:]] == ["loss_gap", "grad_norm_gap", "change_norm_gap"]
    if trace:
        # the phase stretch, reduced by the toy's own span: on the CPU the
        # host's spans, no device time, so its reader reads nothing
        phases = json.loads(lines[-4])["phases"]
        assert phases["toy_step"]["count"] == 1.0 and phases["toy_step"]["device_ms"] == 0.0
        assert "toy_step_ms.toy" not in out["metrics"]
    else:
        assert set(out["metrics"]) == {"toy_rows_per_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", ["stale", "half_batch"])
def test_toy_faults_are_not_correct(copy, fault):
    root, spec = copy
    p = _run(root, spec, fault=fault)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is False


@pytest.mark.parametrize("mode", ["program", "control", "stale", "half_batch"])
def test_toy_calibrates_in_every_mode(copy, mode):
    """Sound runs read under every tiny limit; the control (the reference
    in bfloat16) and each fault over one."""
    root, spec = copy
    p = _python(root, "-m", "portbench.calibrate", "--workload", "toy_mlp_rows", "--mode", mode,
                "--seeds", "1,2", "--spec", spec, "--device", "cpu")
    assert p.returncode == 0, p.stderr[-3000:]
    rows = [json.loads(ln) for ln in p.stdout.splitlines()]
    limits = json.loads((root / "tiny" / "portbench" / "limits" / "toy_mlp_rows.json").read_text())["limits"]
    assert [r["seed"] for r in rows] == [1, 2]
    for row in rows:
        assert "gen_loss_gap" not in row
        assert any(row[k] > lim for k, lim in limits.items()) == (mode != "program"), row


def test_calibrate_refuses_a_fault_the_system_lacks(copy):
    root, spec = copy
    p = _python(root, "-m", "portbench.calibrate", "--workload", "toy_mlp_rows", "--mode", "no_exchange",
                "--seeds", "1", "--spec", spec, "--device", "cpu")
    assert p.returncode == 2 and "program, control, stale, half_batch" in p.stderr
