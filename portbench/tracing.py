"""The traced stretches of a run, under ``torch.profiler``, reduced to
plain numbers that the per-layer readers in ``metrics/``
take.

The readers' stretch records the card alone (CUPTI: kernels, copies,
fills), whose cost to the host is small, so that its idle share is the
run's; recording the host's operators too slows a launch-bound step by
most of itself. A second, shorter stretch records both, and only names
the idle gaps by what the host was doing (``breakdown``).

A reading: ``window_s`` (the stretch on the host's clock, between
a synchronise before its first step and one after its last), ``busy_s``
(the union of the intervals in which a kernel, copy or fill ran on the
card), ``overlap_s`` (the time in which more than one ran at once, as
a collective on its own stream beside compute), ``steps``, ``kernels`` (name -> ``[launches, seconds]``), ``gaps``
(idle seconds between device work by the innermost host operator that
was running at each gap's middle, from the second stretch) and ``work``
(what the system says these steps asked of named kernels, for
rooflines).
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MIN_GAP_US = 5.0  # shorter idle spells are launch jitter, not a gap


def capture(run_steps, steps: int, host_ops: bool = False) -> dict:
    """Run ``run_steps()`` (``steps`` steps) under the profiler and reduce
    the trace; ``host_ops`` records the host's operators too."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run_steps()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce_trace(events, steps, window_s)


def _union(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _overlap(intervals):
    """The intervals' summed lengths less their union: time in which
    operations ran at once, once for each beyond the first."""
    return sum(e - s for s, e in intervals) - _union(intervals)


def reduce_trace(events: list, steps: int, window_s: float) -> dict:
    device = []
    kernels: dict = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        device.append((s, s + d))
        if e["cat"] == "kernel":
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += d * 1e-6
    if not device:
        raise RuntimeError("the trace holds no device activity")
    return {"window_s": window_s, "busy_s": min(_union(device) * 1e-6, window_s),
            "overlap_s": _overlap(device) * 1e-6, "steps": steps, "kernels": kernels, "gaps": _gaps(events, device)}


def _gaps(events, device) -> dict:
    """Idle seconds of the card between its first and last work, by the
    host operator running at each gap's middle: the innermost one (the
    latest to start of those that cover it, on any thread), "host: none"
    where none ran. Empty where the trace holds no host operators."""
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                 for e in events
                 if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation"))
    if not ops:
        return {}
    idle, end = [], None
    for s, e in sorted(device):
        if end is not None and s - end >= MIN_GAP_US:
            idle.append(((s + end) / 2, s - end))
        end = e if end is None else max(end, e)
    out: dict = {}
    active, i = [], 0
    for mid, length in idle:  # in time order, so an operator that ends before one mid covers no later one
        while i < len(ops) and ops[i][0] <= mid:
            active.append(ops[i])
            i += 1
        while active and active[-1][1] < mid:
            active.pop()
        name = active[-1][2] if active else "host: none"
        out[name] = out.get(name, 0.0) + length * 1e-6
    return out


def breakdown(reading: dict, n: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time and the longest idle gaps by what the host was doing, in
    seconds."""
    ops = sorted(reading["kernels"].items(), key=lambda kv: -kv[1][1])[:n]
    gaps = sorted(reading["gaps"].items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[name, s] for name, (_, s) in ops],
            "idle_gaps": [[name, s] for name, s in gaps]}


def _classes() -> list:
    from portbench.common import ROOT

    return json.loads((ROOT / "kernel_classes.json").read_text())["classes"]


def kernel_class(name: str, classes=None) -> str:
    n = name.lower()
    for cls, patterns in classes or _classes():
        if any(p in n for p in patterns):
            return cls
    return "other"


def class_ms_per_step(reading: dict, cls: str):
    """Device ms per step of the kernels of class ``cls``; None where no
    kernel of the class ran."""
    classes = _classes()
    seconds = sum(s for name, (_, s) in reading["kernels"].items() if kernel_class(name, classes) == cls)
    if not seconds:
        return None
    return 1e3 * seconds / reading["steps"]
