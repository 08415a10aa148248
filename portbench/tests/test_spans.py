"""``spans.reduce`` on hand-built trace events: each device event goes to
the innermost program span that held its launch, on any thread; self
times, ``outside`` and ``unmatched`` add up to the device events' sum."""

from __future__ import annotations

import subprocess
import sys

import pytest

from portbench import spans
from portbench.common import CHECKOUT


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _launch(corr, ts, tid=1, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts, "dur": 1, "tid": tid,
            "args": {"correlation": corr}}


def _kernel(corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


def _events():
    return [
        _span("train_step", 0, 1000),
        _span("critic", 10, 300),
        _span("optimizer", 200, 100),  # nested in critic
        _span("generator", 400, 200),
        _span("text_backward", 600, 300),
        _span("Optimizer.step#Adam.step", 210, 50),  # not the program's: ignored
        _launch(1, 20), _kernel(1, 30, 50),  # critic
        _launch(2, 220), _kernel(2, 230, 40),  # optimizer, inside critic
        _launch(3, 250, cat="cuda_driver"), _kernel(3, 280, 20, "gpu_memset"),  # optimizer
        _launch(4, 450), _kernel(4, 460, 100),  # generator
        _launch(5, 650, tid=2), _kernel(5, 660, 200),  # autograd's thread, main thread in text_backward
        _launch(6, 1100), _kernel(6, 1100, 10),  # after the step: outside
        _kernel(7, 1200, 30),  # its launch dropped: unmatched
    ]


def test_launch_decides_the_phase():
    r = spans.reduce(_events())
    ph = r["phases"]
    assert ph["text_backward"]["device_s"] == pytest.approx(200e-6) and ph["text_backward"]["launches"] == 1
    assert ph["critic"]["device_s"] == pytest.approx(50e-6)  # its optimizer's 60 us left out
    assert ph["optimizer"]["device_s"] == pytest.approx(60e-6) and ph["optimizer"]["launches"] == 1  # the fill
    assert ph["generator"]["device_s"] == pytest.approx(100e-6)
    assert ph["train_step"]["device_s"] == 0.0 and ph["text"]["device_s"] == 0.0
    assert r["outside"]["device_s"] == pytest.approx(10e-6) and r["outside"]["launches"] == 1
    assert r["unmatched"]["device_s"] == pytest.approx(30e-6)
    assert {k: v["count"] for k, v in ph.items() if v["count"]} == {
        "train_step": 1, "critic": 1, "optimizer": 1, "generator": 1, "text_backward": 1}


def test_phases_outside_and_unmatched_add_up_to_the_device_sum():
    events = _events()
    r = spans.reduce(events)
    plain = sum(e["dur"] for e in events if e["cat"] in ("kernel", "gpu_memcpy", "gpu_memset")) * 1e-6
    parts = sum(v["device_s"] for v in r["phases"].values()) + r["outside"]["device_s"] + r["unmatched"]["device_s"]
    assert r["device_s"] == pytest.approx(plain) and parts == pytest.approx(plain)


def test_an_idle_gap_goes_to_the_phase_that_launched_the_work_ending_it():
    # busy 30-80, 230-270, 280-300, 460-560, 660-860, 1100-1110, 1200-1230
    r = spans.reduce(_events())
    ph = r["phases"]
    assert ph["optimizer"]["idle_s"] == pytest.approx((150 + 10) * 1e-6)  # 80-230, 270-280
    assert ph["generator"]["idle_s"] == pytest.approx(160e-6)  # 300-460
    assert ph["text_backward"]["idle_s"] == pytest.approx(100e-6)  # 560-660
    assert ph["critic"]["idle_s"] == 0.0 and ph["train_step"]["idle_s"] == 0.0  # the first work ends no gap
    assert r["outside"]["idle_s"] == pytest.approx(240e-6)  # 860-1100
    assert r["unmatched"]["idle_s"] == pytest.approx(90e-6)  # 1110-1200


def test_the_clocks_are_checked():
    """A kernel that starts before its launch is early, by how much; a
    launch outside the host operator that made it is off its op."""
    op = lambda ext, ts, dur: {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": ts, "dur": dur,
                               "args": {"External id": ext}}
    made = lambda launch, ext: dict(launch, args=dict(launch["args"], **{"External id": ext}))
    r = spans.reduce([_span("critic", 0, 100), made(_launch(1, 50), 11), _kernel(1, 40, 5), op(11, 45, 10),
                      made(_launch(2, 70), 12), _kernel(2, 75, 5), op(12, 80, 10)])
    assert r["early"] == 1 and r["early_us"] == pytest.approx(10.0)
    assert r["phases"]["critic"]["device_s"] == pytest.approx(10e-6)
    assert (r["off_op"], r["in_op"]) == (1, 2)
    clean = spans.reduce(_events())
    assert (clean["early"], clean["early_us"], clean["off_op"], clean["in_op"]) == (0, 0.0, 0, 0)


def test_per_step_divides_by_the_steps_traced():
    events = _events() + [_span("train_step", 2000, 100), _launch(8, 2010), _kernel(8, 2020, 40)]
    rows = spans.per_step(spans.reduce(events))
    assert rows["train_step"] == {"device_ms": pytest.approx(0.02), "launches": 0.5,
                                  "idle_ms": pytest.approx(0.395), "count": 1.0}  # 1230-2020
    assert rows["text_backward"]["device_ms"] == pytest.approx(0.1)
    assert spans.per_step(spans.reduce([_launch(1, 0), _kernel(1, 1, 1)])) == {}


def test_no_line_without_a_card():
    p = subprocess.run([sys.executable, "-m", "portbench.spans", "--workload", "stage1_b256_coco", "--seed", "1"],
                       cwd=str(CHECKOUT), capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and not p.stdout.strip()
