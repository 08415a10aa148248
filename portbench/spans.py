"""The card's time of a traced stretch by the program's phases: each
device event is joined to the launch that issued it, and the launch's
time on the host decides the phase.

The program names its phases with ``torch.profiler.record_function``
spans (``imagegenerator_tpu_torch/utils/profiling.py::span``), which the
trace holds as ``user_annotation`` events on the profiler's clock beside
the card's CUPTI events. ``reduce(events)`` takes a Chrome trace's
events and the phase spans of the cell's system (``SPANS`` of
``systems/<kind>.py``):

- a device event (``tracing.DEVICE_CATS``) is joined to the
  ``cuda_runtime`` or ``cuda_driver`` event with the same
  ``args["correlation"]``, its launch;
- the launch's ``ts`` lies in the phase of the latest-starting of the
  program's spans (``names``) whose interval holds it, on any thread:
  autograd launches the backward's kernels from its own thread while the
  main thread waits inside the span;
- per span name: ``device_s``, the device seconds of the events it owns
  (self time: ``critic`` leaves out its nested ``optimizer``);
  ``launches``, the kernels among them, as ``launches_per_step`` counts;
  ``idle_s``, the card's idle gaps of at least ``tracing.MIN_GAP_US``
  that end with work it launched: the card waited for that launch;
  ``count``, how many times the span ran;
- ``outside``: device work launched under no program span (the harness's
  own draws between steps); ``unmatched``: device work with no launch in
  the trace (``torch.profiler`` drops the launches at a trace's start);
  each with its idle gaps as above;
- ``device_s``, the plain sum of every device event's duration, which
  the phases, ``outside`` and ``unmatched`` add up to; ``cats``, the
  events by category;
- the clocks: ``early``, the attributed events that start on the card
  before their launch on the host, and ``early_us``, the most by which
  one does (0 where the card's clock and the host's agree); ``off_op``,
  the launches that lie outside the host operator that made them (the
  ``cpu_op`` of the same ``External id``; 0 where the launches and the
  spans share a clock), of ``in_op`` so checked.

Only the host's times place work and idle in a phase: on an H100 the
card's clock drifted from the host's by up to 4.6 ms within a 1.2 s
stretch, while the launches kept to their host operators, so a device
event's own time is compared with nothing of the host's.

The benchmark's traced runs reduce a stretch that records the host's
operators too (``tracing.phases``; the card's activity alone holds the
launches but none of the spans), and the phase readers in ``metrics/``
take the device ms a step of their spans from it (``tracing.phase_ms``).
This module's own entry traces a cell's steps after its set-up and
prints the phases in device ms a step:

    python3 -m portbench.spans --workload <cell> --seed <n> [--steps 3]

once with the card's activity alone, as the benchmark's readers' stretch
records it (no span: every phase reads 0), and once with the host's
operators too, as the phase readers' stretch records it. A cell over
several cards runs a process a card (``ranks.py``), and rank 0 traces and
prints.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys

from portbench.tracing import DEVICE_CATS, MIN_GAP_US

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _blank() -> dict:
    return {"device_s": 0.0, "launches": 0, "idle_s": 0.0, "count": 0}


class _Phases:
    """The program's spans, for the innermost one holding a time."""

    def __init__(self, spans):
        self.spans = sorted(spans)  # (start, end, name)
        self.starts = [s for s, _, _ in self.spans]

    def at(self, t: float) -> str | None:
        i = bisect.bisect_right(self.starts, t)
        while i > 0:
            i -= 1
            s, e, name = self.spans[i]
            if e >= t:
                return name
        return None


def reduce(events: list, names) -> dict:
    spans, launches, device, cats, ops, made = [], {}, [], {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args", {})
        cats[cat] = cats.get(cat, 0) + 1
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation" and e["name"] in names:
            spans.append((s, s + d, e["name"]))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = s
            if "External id" in args:
                made.append((args["External id"], s))
        elif cat in DEVICE_CATS:
            device.append((s, d, cat, args.get("correlation")))
        elif cat == "cpu_op" and "External id" in args:
            ops[args["External id"]] = (s, s + d)
    phases = _Phases(spans)
    out = {name: _blank() for name in names}
    outside, unmatched = _blank(), _blank()
    for _, _, name in spans:
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
            name = phases.at(launch)
            slot = out[name] if name else outside
        slot["device_s"] += d * 1e-6
        slot["launches"] += cat == "kernel"
        if end is not None and s - end >= MIN_GAP_US:
            slot["idle_s"] += (s - end) * 1e-6
        end = s + d if end is None else max(end, s + d)
    checked = [(ops[x], t) for x, t in made if x in ops]
    off_op = sum(not (s <= t <= e) for (s, e), t in checked)
    return {"phases": out, "outside": outside, "unmatched": unmatched, "device_s": total * 1e-6, "cats": cats,
            "early": early, "early_us": early_us, "off_op": off_op, "in_op": len(checked)}


def per_step(r: dict, steps: int) -> dict:
    """Device ms, launches and idle ms a step of each phase, ``outside``
    and ``unmatched``, over the stretch's ``steps``."""
    if not steps:
        return {}
    rows = dict(r["phases"], outside=r["outside"], unmatched=r["unmatched"])
    return {name: {"device_ms": 1e3 * v["device_s"] / steps, "launches": v["launches"] / steps,
                   "idle_ms": 1e3 * v["idle_s"] / steps, "count": v["count"] / steps}
            for name, v in rows.items()}


# ------------------------------------------------------- the entry


def _stretches(args, conf, mix, device, rank) -> None:
    """Set-up as the benchmark's, then the two stretches; over several
    ranks the others step beside rank 0, which traces and prints."""
    from portbench import check, tracing
    from portbench.common import system_kind

    kind = system_kind(conf["system"])
    system = kind.System(conf, mix, args.seed, device, rank=rank)
    system.build()
    for k in range(check.STEPS):  # every shape warmed up, as the benchmark's set-up does
        system.step(k)
    k = check.STEPS
    for label, host_ops in (("card", False), ("card_and_host", True)):
        start, k = k, k + args.steps
        run_steps = lambda: [system.step(start + i) for i in range(args.steps)]
        if rank:
            run_steps()
            continue
        events, window_s = tracing.record(run_steps, host_ops, card=device.type == "cuda")
        r = reduce(events, kind.SPANS)
        line = {"workload": args.workload, "stretch": label, "steps": args.steps,
                "window_ms_per_step": 1e3 * window_s / args.steps,
                "device_ms_per_step": 1e3 * r["device_s"] / args.steps,
                **{key: r[key] for key in ("early", "early_us", "off_op", "in_op", "cats")},
                "phases": per_step(r, args.steps)}
        print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    from portbench import ranks, run

    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=3)
    # the tests: another benchmark file, the CPU; a rank: the launcher's start
    p.add_argument("--spec", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default=None, help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    args.argv = argv
    if args.t0 is not None:

        def part(device, rank, world):
            _, _, conf, mix = run.entries(args)
            _stretches(args, conf, mix, device, rank)
            return 0

        ranks.serve(args.device, part, run._forbidden_loaded)
    built = run.kernels_built()
    opened = run.open_cell(args)
    if opened is None:
        return 2
    _, _, conf, mix, device = opened
    if device is None:
        return run.launch("portbench.spans", args, mix["ranks"], ranks.deadline_s(0.0, built))
    _stretches(args, conf, mix, device, 0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
