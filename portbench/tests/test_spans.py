"""``spans.reduce`` on hand-built trace events: each device event goes to
the innermost program span that held its launch, on any thread; self
times, ``outside`` and ``unmatched`` add up to the device events' sum.
The spans are the cell's system's (``SPANS`` of ``systems/<kind>.py``),
and the reduction reads what it read when it named StackGAN's itself;
the phase readers give the ms a step by hand."""

from __future__ import annotations

import bisect
import gzip
import json
import os
import subprocess
import sys

import pytest

from portbench import spans
from portbench.common import CHECKOUT, ROOT, metric_reader
from portbench.systems.stackgan import SPANS


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
    r = spans.reduce(_events(), SPANS)
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
    r = spans.reduce(events, SPANS)
    plain = sum(e["dur"] for e in events if e["cat"] in ("kernel", "gpu_memcpy", "gpu_memset")) * 1e-6
    parts = sum(v["device_s"] for v in r["phases"].values()) + r["outside"]["device_s"] + r["unmatched"]["device_s"]
    assert r["device_s"] == pytest.approx(plain) and parts == pytest.approx(plain)


def test_an_idle_gap_goes_to_the_phase_that_launched_the_work_ending_it():
    # busy 30-80, 230-270, 280-300, 460-560, 660-860, 1100-1110, 1200-1230
    r = spans.reduce(_events(), SPANS)
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
                      made(_launch(2, 70), 12), _kernel(2, 75, 5), op(12, 80, 10)], SPANS)
    assert r["early"] == 1 and r["early_us"] == pytest.approx(10.0)
    assert r["phases"]["critic"]["device_s"] == pytest.approx(10e-6)
    assert (r["off_op"], r["in_op"]) == (1, 2)
    clean = spans.reduce(_events(), SPANS)
    assert (clean["early"], clean["early_us"], clean["off_op"], clean["in_op"]) == (0, 0.0, 0, 0)


def test_per_step_divides_by_the_steps_traced():
    events = _events() + [_span("train_step", 2000, 100), _launch(8, 2010), _kernel(8, 2020, 40)]
    rows = spans.per_step(spans.reduce(events, SPANS), 2)
    assert rows["train_step"] == {"device_ms": pytest.approx(0.02), "launches": 0.5,
                                  "idle_ms": pytest.approx(0.395), "count": 1.0}  # 1230-2020
    assert rows["text_backward"]["device_ms"] == pytest.approx(0.1)
    assert spans.per_step(spans.reduce([_launch(1, 0), _kernel(1, 1, 1)], SPANS), 0) == {}


def test_no_line_without_a_card():
    p = subprocess.run([sys.executable, "-m", "portbench.spans", "--workload", "stage1_b256_coco", "--seed", "1"],
                       cwd=str(CHECKOUT), capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and not p.stdout.strip()


def _reduce_naming_stackgan(events: list) -> dict:
    """``spans.reduce`` as it was when it named StackGAN's spans itself,
    kept whole to hold the new one to."""
    names = ("data", "train_step", "text", "critic", "generator", "text_backward", "optimizer")
    spans_, launches, device, cats, ops, made = [], {}, [], {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args", {})
        cats[cat] = cats.get(cat, 0) + 1
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation" and e["name"] in names:
            spans_.append((s, s + d, e["name"]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = s
            if "External id" in args:
                made.append((args["External id"], s))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((s, d, cat, args.get("correlation")))
        elif cat == "cpu_op" and "External id" in args:
            ops[args["External id"]] = (s, s + d)
    spans_.sort()
    starts = [s for s, _, _ in spans_]

    def at(t):
        i = bisect.bisect_right(starts, t)
        while i > 0:
            i -= 1
            if spans_[i][1] >= t:
                return spans_[i][2]
        return None

    blank = lambda: {"device_s": 0.0, "launches": 0, "idle_s": 0.0, "count": 0}
    out = {name: blank() for name in names}
    outside, unmatched = blank(), blank()
    for _, _, name in spans_:
        out[name]["count"] += 1
    total, early, early_us, end = 0.0, 0, 0.0, None
    for s, d, cat, corr in sorted(device, key=lambda ev: ev[0]):
        total += d
        launch = launches.get(corr)
        if launch is None:
            slot = unmatched
        else:
            if s < launch:
                early, early_us = early + 1, max(early_us, launch - s)
            name = at(launch)
            slot = out[name] if name else outside
        slot["device_s"] += d * 1e-6
        slot["launches"] += cat == "kernel"
        if end is not None and s - end >= 5.0:
            slot["idle_s"] += (s - end) * 1e-6
        end = s + d if end is None else max(end, s + d)
    checked = [(ops[x], t) for x, t in made if x in ops]
    off_op = sum(not (s <= t <= e) for (s, e), t in checked)
    return {"phases": out, "outside": outside, "unmatched": unmatched, "device_s": total * 1e-6, "cats": cats,
            "early": early, "early_us": early_us, "off_op": off_op, "in_op": len(checked)}


RECORDED = sorted((ROOT / "tests" / "data").glob("*.trace.json.gz"))


@pytest.mark.parametrize("path", RECORDED, ids=lambda p: p.name.split(".")[0])
def test_reduce_reads_as_when_it_named_stackgans_spans(path):
    """A trace recorded on an H100 (one tiny StackGAN step with the host's
    operators, its events cut to the keys the reduction reads) and the
    hand-built events: the same result, bit for bit."""
    with gzip.open(path, "rt") as f:
        events = json.load(f)
    new = spans.reduce(events, SPANS)
    assert new == _reduce_naming_stackgan(events)
    assert new["phases"]["train_step"]["count"] >= 1 and new["phases"]["critic"]["launches"] > 0
    assert spans.reduce(_events(), SPANS) == _reduce_naming_stackgan(_events())


def _step_events(t0, corr, text_us, critic_us, opt_us, gen_us, back_us):
    """One step's spans, each with one kernel launched inside it: the
    critic's nested optimizer and the generator side's own."""
    ev = [_span("train_step", t0, 1000), _span("text", t0 + 10, 90), _span("critic", t0 + 100, 400),
          _span("optimizer", t0 + 400, 80), _span("generator", t0 + 500, 200), _span("optimizer", t0 + 900, 90)]
    if back_us:
        ev.append(_span("text_backward", t0 + 700, 200))
    for i, (at, us) in enumerate([(20, text_us), (150, critic_us), (410, opt_us), (550, gen_us), (750, back_us),
                                  (920, 10)]):
        if us:
            ev += [_launch(corr + i, t0 + at), _kernel(corr + i, t0 + at + 5, us)]
    return ev


def test_phase_readers_by_hand():
    """Two steps: the readers give each set of spans' self device ms over
    the stretch's steps; stage 2's step, with no ``text_backward``, reads
    ``text`` alone in ``encoder_ms``."""
    events = _step_events(0, 10, 50, 200, 30, 80, 120) + _step_events(1000, 20, 60, 210, 30, 90, 130)
    ctx = {"trace": {"phases": dict(spans.reduce(events, SPANS), steps=2)}}
    read = lambda name: metric_reader(name).read(ctx)
    assert read("encoder_ms.stage1") == pytest.approx((50 + 120 + 60 + 130) / 2 * 1e-3)
    assert read("critic_ms.stage1") == pytest.approx((200 + 210) / 2 * 1e-3)  # less the nested optimizer
    assert read("optimizer_ms.stage1") == pytest.approx((30 + 10 + 30 + 10) / 2 * 1e-3)
    assert read("generator_ms.stage1") == pytest.approx((80 + 90) / 2 * 1e-3)
    stage2 = _step_events(0, 10, 50, 200, 30, 80, 0) + _step_events(1000, 20, 60, 210, 30, 90, 0)
    ctx["trace"]["phases"] = dict(spans.reduce(stage2, SPANS), steps=2)
    assert read("encoder_ms.train") == pytest.approx((50 + 60) / 2 * 1e-3)


def test_phase_readers_read_nothing_where_nothing_ran():
    no_spans = [_launch(1, 0), _kernel(1, 1, 5)]
    for reading in ({}, {"phases": dict(spans.reduce(no_spans, SPANS), steps=1)},
                    # spans but no device work: the CPU's trace
                    {"phases": dict(spans.reduce([_span("train_step", 0, 10), _span("critic", 1, 5)], SPANS),
                                    steps=1)}):
        for name in ("encoder_ms", "critic_ms", "generator_ms", "optimizer_ms"):
            assert metric_reader(name).read({"trace": reading}) is None


RANKED = [w["name"] for w in json.loads((CHECKOUT / "BENCHMARK.json").read_text())["workloads"] if w["chips"] > 1]


@pytest.mark.parametrize("workload", RANKED)
def test_spans_over_ranks_print_rank_0s_lines(tiny_spec, workload):
    """A cell over several cards: a process a card, the others stepping
    beside rank 0, which prints both stretches (here on the CPU, over gloo:
    the host's spans, no device time)."""
    p = subprocess.run([sys.executable, "-m", "portbench.spans", "--workload", workload, "--seed", "7",
                        "--spec", str(tiny_spec), "--device", "cpu"], cwd=str(CHECKOUT), capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(ln) for ln in p.stdout.splitlines()]
    assert [ln["stretch"] for ln in lines] == ["card", "card_and_host"]
    assert lines[1]["phases"]["train_step"]["count"] == 1.0 and lines[1]["phases"]["critic"]["count"] == 5.0
