"""Readings for the limits of ``check.py``: each seed's first steps
against the plain reference, with no window, in one process.

    python3 -m portbench.calibrate --workload <cell> --mode <mode> --seeds 1,2,3

Modes: ``program`` (the sound runs: the lower reading), ``half_batch``
and ``no_exchange`` (those faults planted in the program, on every rank;
see ``systems/stackgan.py``; a stale step reads 1 by construction and
needs no run), and ``control``: the reference in float8 e4m3, the
precision below the configuration's bfloat16, put in the program's place
(the upper reading). One JSON line a seed on standard output: every
number of ``check.py``, and for each optimizer's leaves, compared or
not, the worst and the median leaf's gradient gap, and the gaps of the
norms of its whole gradient and of its whole change.

A cell over several cards reads its program's seeds as its runs do, one
process a card (``ranks.py``; rank 0 holds the comparison), with a
deadline of ``ranks.COLD_S`` and ``SEED_S`` a seed; its control, which
runs no program, is the reference over every rank's shard in one
process on one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from portbench import run as harness  # sets the cache directories before torch loads
from portbench import check, ranks
from portbench.common import system_kind
from portbench.reference.stackgan import Reference, fp8_e4m3

MODES = ("program", "half_batch", "no_exchange", "control")
SEED_S = 150.0


def _whole_gap(prog: dict, ref: dict, names) -> float:
    """The gap between the norms of ``names`` taken as one vector,
    relative to the reference's."""
    p = sum(prog[n] ** 2 for n in names) ** 0.5
    r = sum(ref[n] ** 2 for n in names) ** 0.5
    return abs(p - r) / max(r, 1e-30)


def group_readings(prog: dict, ref: dict, theta0: dict, groups: dict) -> dict:
    out = {}
    for opt, names in groups.items():
        gaps = check._gaps(prog["grad"], ref["grad"], {opt: names})
        change = [{n: float((snap["params"][n].to(theta0[n].device).float() - theta0[n].float()).norm())
                   for n in names} for snap in (prog, ref)]
        out[opt] = {"worst": max(gaps.values()), "median": statistics.median(gaps.values()),
                    "whole": _whole_gap(prog["grad"], ref["grad"], names),
                    "change_whole": _whole_gap(change[0], change[1], names)}
    return out


def readings(system, mode: str):
    """The numbers of one seed; None on a rank other than 0."""
    if mode == "control":
        system.plan()
        control = Reference(system.conf, system.stage, system.compute, quant=fp8_e4m3)
        prog = harness._reference_steps(system, control, system.initial_params(), system.shards, check.STEPS)
    else:
        system.build()
        prog = harness._first_steps(system, check.STEPS)
        system.free()
        harness._free(system.device)
        if system.rank:
            return None
    theta0 = system.initial_params()
    truth = harness._reference_steps(system, system.reference(), theta0, system.shards, check.STEPS)
    numbers = check.compare(prog, truth, theta0, system.compared_groups(), system.loss_names())
    numbers["groups"] = group_readings(prog, truth, theta0, system.leaf_groups())
    return numbers


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=MODES, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--spec", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default=None, help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    args.argv = argv
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.t0 is not None:  # a rank

        def part(device, rank, world):
            _, _, conf, mix = harness.entries(args)
            _read(args, conf, mix, seeds, device, rank)
            return 0

        ranks.serve(args.device, part, harness._forbidden_loaded)
    opened = harness.open_cell(args, processes=1 if args.mode == "control" else None)
    if opened is None:
        return 2
    _, _, conf, mix, device = opened
    if device is None:
        return harness.launch("portbench.calibrate", args, mix["ranks"], ranks.COLD_S + SEED_S * len(seeds))
    _read(args, conf, mix, seeds, device, 0)
    return 0


def _read(args, conf, mix, seeds, device, rank) -> None:
    kind = system_kind(conf["system"])
    fault = args.mode if args.mode in ("half_batch", "no_exchange") else None
    for seed in seeds:
        system = kind.System(conf, mix, seed, device, fault, rank)
        numbers = readings(system, args.mode)
        if numbers is not None:
            row = {"calibrate": args.mode, "workload": args.workload, "seed": seed}
            row.update({n: numbers[n] for n in check.NUMBERS if n in numbers})
            row.update({k: numbers[k] for k in ("leaves", "median", "step_loss_gaps", "losses", "groups",
                                                "per_leaf")})
            print(json.dumps(row), flush=True)
        del system
        harness._free(device)


if __name__ == "__main__":
    sys.exit(main())
