"""Run one cell of the port's benchmark once, and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's system (``systems/<kind>.py``) from the run's
seed, takes its first ``check.STEPS`` steps through the timed path's own
call and keeps what the comparison needs; then the window steps back to
back for ``--seconds`` (the rate over all its steps and all its time,
between two synchronisations of the card); ``--trace 1`` then traces a
few more steps (``tracing.py``): the card alone, one step with the
host's operators for the idle gaps, and a stretch with the host's
operators split by the system's phase spans (``SPANS``); and reads the
cell's per-layer metrics (``metrics/``).
Once the window has closed and the peak memory is read, the program's
state is freed and the plain reference replays the first steps;
``check.py`` compares them. The last line of standard output is the
result; the numbers compared, each beside its limit, are the last lines
of standard error.

A cell whose ``chips`` (and its mix's ``ranks``) exceed 1 runs as one
process a card (``ranks.py``): this command is the launcher, and each
rank builds the system on its own card and steps its own rows through
the port's step with ``reduce=dp.all_reduce_mean``. Every rank takes the
same number of steps, fixed from timed warm steps before the window,
which starts and ends with every card idle and every rank at a barrier;
the rate is over rank 0's window, ``setup_s`` from the launcher's start
to that window's start, the peak memory the largest rank's, and rank 0
alone traces (the others step beside it), checks and prints.

Caches stay inside the checkout: the program's kernels in
``build/kernels/`` (its own rule), Triton's in ``build/triton/``, the
CUDA driver's in ``build/cuda_cache/``. PyTorch's CPU operators get one
thread.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CHECKOUT / "build" / "cuda_cache")
# One host thread for PyTorch's CPU operators: the step's host work is
# launching, and idle worker threads spinning beside the launching thread
# only add noise on a shared host.
os.environ["OMP_NUM_THREADS"] = "1"

import torch  # noqa: E402

from portbench import check, ranks, spans, tracing  # noqa: E402
from portbench.common import Bench, metric_reader, system_kind  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "imagegenerator_tpu")
TRACE_STEPS = 3
WARM_STEPS = 3  # timed before a window over several ranks, to fix its step count
GIB = 2.0 ** 30


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the tests: another benchmark file, the CPU, a planted fault
    p.add_argument("--spec", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default=None, help=argparse.SUPPRESS)
    p.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    # a rank process of a cell over several cards: the launcher's start
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _first_steps(system, steps: int) -> dict:
    """The program's first steps through the timed path's own call: each
    step's metrics, the gradient norms after the first, the trained leaves
    after the last (on the host)."""
    snap = {"metrics": []}
    for k in range(steps):
        snap["metrics"].append(check.as_floats(system.step(k)))
        if k == 0:
            snap["grad"] = system.grad_norms()
    snap["params"] = system.trained_params()
    return snap


def _reference_steps(system, ref, theta0, shards_of, steps: int) -> dict:
    state = ref.init_state(theta0)
    snap = {"metrics": []}
    for k in range(steps):
        snap["metrics"].append(check.as_floats(ref.step(state, shards_of(k))))
        if k == 0:
            snap["grad"] = system.reference_grad_norms(state)
    snap["params"] = system.reference_params(state)
    return snap


def _check(system, prog: dict) -> dict:
    """Replay the first steps in the plain reference and compare."""
    theta0 = system.initial_params()
    ref = _reference_steps(system, system.reference(), theta0, system.shards, check.STEPS)
    return check.compare(prog, ref, theta0, system.compared_groups(), system.loss_names())


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def entries(args):
    """The cell's entries: ``(bench, cell, conf, mix)``."""
    bench = Bench(args.spec)
    cell = bench.cell(args.workload)
    conf = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    if cell["chips"] != mix["ranks"]:
        raise SystemExit(f"{args.workload}: {cell['chips']} chip(s), but its mix {cell['traffic']} has "
                         f"{mix['ranks']} rank(s)")
    return bench, cell, conf, mix


def open_cell(args, processes=None):
    """The cell's entries and its device: ``(bench, cell, conf, mix,
    device)``, or None where the cards the cell asks for are not here.
    The cell runs as ``processes`` processes (its mix's ``ranks`` unless
    given), each on a card of its own; over several, this process is the
    launcher, which builds the kernels and holds no card (``device``
    None)."""
    bench, cell, conf, mix = entries(args)
    processes = processes or mix["ranks"]
    if args.device is not None:
        return bench, cell, conf, mix, None if processes > 1 else torch.device(args.device)
    if not torch.cuda.is_available() or torch.cuda.device_count() < processes:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {processes} CUDA card(s); {count} here", file=sys.stderr)
        return None
    from imagegenerator_tpu_torch.ops.kernels import _build

    if processes > 1:
        _build.build_all()
        return bench, cell, conf, mix, None
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    _build.build_all()
    return bench, cell, conf, mix, device


def kernels_built() -> bool:
    """Whether every kernel of the program is built already."""
    from imagegenerator_tpu_torch.ops.kernels import _build

    return all(_build.library_path(n).exists() for n in _build.names())


def launch(module: str, args, world: int, deadline: float) -> int:
    """Run ``module`` with this process's arguments as ``world`` ranks
    (``ranks.launch``) and print rank 0's standard output, the result,
    where every rank ended well and this process holds no forbidden
    module."""
    code, out = ranks.launch(module, args.argv, world, deadline, T_START)
    if code or _forbidden_loaded():
        return code or 3
    sys.stdout.write(out)
    sys.stdout.flush()
    return 0


def run(args) -> int:
    built = kernels_built()
    opened = open_cell(args)
    if opened is None:
        return 2
    if opened[-1] is None:  # over several cards: this process launches the ranks
        return launch("portbench.run", args, opened[3]["ranks"], ranks.deadline_s(args.seconds, built))
    return _report(*_run_cell(args, *opened))


def _forbidden_loaded() -> bool:
    """Whether this process holds a forbidden module, which it names."""
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that the port's benchmark may not load: {bad}", file=sys.stderr)
    return bool(bad)


def _report(out, rows, notes) -> int:
    """Print the notes, each number compared beside its limit, and the
    result, in that order, unless a forbidden module is loaded."""
    if _forbidden_loaded():
        return 3
    print(json.dumps(notes), file=sys.stderr)
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def run_rank(args) -> None:
    """A rank of a cell over several cards (``ranks.serve``); rank 0
    prints the result."""

    def part(device, rank, world):
        result = _run_cell(args, *entries(args), device, rank)
        return _report(*result) if rank == 0 else 0

    ranks.serve(args.device, part, _forbidden_loaded)


def _run_cell(args, bench, cell, conf, mix, device, rank=0):
    """``(result, [(number, value, limit)], notes)``; over several ranks,
    rank 0's, and None on the others."""
    world = mix["ranks"]
    kind = system_kind(conf["system"])
    system = kind.System(conf, mix, args.seed, device, args.fault, rank)
    system.build()
    prog = _first_steps(system, check.STEPS)
    k = check.STEPS
    if world == 1:
        _sync(device)
        setup_s = time.time() - T_START
        t0 = time.perf_counter()
        while True:
            system.step(k)
            k += 1
            if time.perf_counter() - t0 >= args.seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - t0
        steps = k - check.STEPS
    else:
        steps = ranks.steps_for(args.seconds, system.step, k, WARM_STEPS, device)
        k += WARM_STEPS
        ranks.sync_all(device)
        setup_s = time.time() - args.t0
        t0 = time.perf_counter()
        for i in range(steps):
            system.step(k + i)
        ranks.sync_all(device)
        window_s = time.perf_counter() - t0
        k += steps

    reading = None
    if args.trace:
        first = k

        def steps_from(start, n):
            return lambda: [system.step(start + i) for i in range(n)]

        card = device.type == "cuda"
        if card and rank == 0:
            reading = tracing.capture(steps_from(first, TRACE_STEPS), TRACE_STEPS)
            reading["gaps"] = tracing.capture(steps_from(first + TRACE_STEPS, 1), 1, host_ops=True)["gaps"]
        else:  # the other ranks step beside rank 0; the tests: no card to trace, the stretch's shape only
            steps_from(first, TRACE_STEPS + 1)()
            reading = {"window_s": 1.0, "busy_s": 1.0, "steps": TRACE_STEPS, "kernels": {}, "gaps": {}}
        phase_steps = steps_from(first + TRACE_STEPS + 1, TRACE_STEPS)
        if rank == 0:  # on the CPU the host's alone: the spans, no device time
            reading["phases"] = tracing.phases(phase_steps, TRACE_STEPS, kind.SPANS, card)
            reading["work"] = {"attention": [c for i in range(TRACE_STEPS)
                                             for c in system.attention_work(first + i)]}
        else:
            phase_steps()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if world > 1:
        peak = ranks.largest(peak, device)
        if rank:
            return None
    flops = system.flops_per_step() if args.trace else None
    system.free()
    _free(device)

    t_check = time.perf_counter()
    numbers = _check(system, prog)
    check_s = time.perf_counter() - t_check
    correct, rows = check.verdict(numbers, bench.limits(args.workload))
    readings = {"setup_s": setup_s, "peak_mem_gib": peak / GIB}
    readings.update(system.rates(steps * system.images_per_step, window_s))
    out = {"correct": correct, "attempted": steps, "failed": 0}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": world, "memory_peak_bytes": peak}
    if args.trace:
        ctx = {"trace": reading, "flops_per_step": flops, "window": {"steps": steps, "seconds": window_s},
               "peaks": bench.peaks(dev["kind"]), "chips": cell["chips"], "images_per_step": system.images_per_step}
        metrics = {}
        for m in bench.metrics_of("per_layer", args.workload):
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = reading["busy_s"]
        dev["window_s"] = reading["window_s"]
        out["metrics"] = metrics
        out["breakdown"] = tracing.breakdown(reading)
    else:
        out["metrics"] = {m["name"]: {"value": readings[m["name"]], "unit": m["unit"]}
                          for m in bench.metrics_of("end_to_end", args.workload)}
    dev["power_limit"] = _power_limit() if device.type == "cuda" else "not read"
    out["device"] = dev
    out["checked"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    notes = {k: numbers[k] for k in ("leaves", "left_out", "median", "step_loss_gaps", "losses")}
    notes.update(steps=steps, window_s=window_s, check_s=check_s)
    if args.trace:
        notes["trace"] = {k: reading.get(k) for k in ("window_s", "busy_s", "overlap_s", "steps")}
        notes["phases"] = spans.per_step(reading["phases"], TRACE_STEPS)
    return out, rows, notes


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    args.argv = argv
    if args.t0 is not None:
        run_rank(args)  # ends the process
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
