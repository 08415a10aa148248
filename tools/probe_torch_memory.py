#!/usr/bin/env python3
"""What sets the peak memory of a training step, with and without remat.
Run on a CUDA card from the repository root:

    python3 tools/probe_torch_memory.py [--stage 1 2] [--out DIR]

For each stage (1: the full-width stage-1 step at batch 128; 2: the
stage-2 step at batch 32; both f32 with TF32 off and cuDNN deterministic,
as ``chip_smoke.py`` phase 11 (c) runs them, from one seeded state) and
for remat off and on, it records the allocator's history
(``torch.cuda.memory._record_memory_history``) over the first step,
replays the history to the moment of the peak and prints the bytes live
there above what was held before the step, grouped two ways: by the line
of ``train_step`` that was running when each block was allocated (which
part of the step keeps it: the text forward, the critic loop, the
generator side's backward) and by the innermost frame in the port's
package (which module made it). ``--out DIR`` also writes the groups as
``DIR/memory_stage{N}.json``.

Prints the card's name and power limit first; every number is of that card.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the step's config, batch and seeds, as phase 11 (c) has them)

PACKAGE = "imagegenerator_tpu_torch"
TOP = 12  # groups printed per grouping


def _where(frames, fn) -> str:
    """``file:line (function)`` of the innermost frame for which ``fn``
    holds. A block the autograd engine allocates for a CUDA backward has
    no Python frame of the step (the engine runs it on its own thread)."""
    for f in frames:
        if fn(f):
            return f"{Path(f['filename']).name}:{f['line']} ({f['name']})"
    return "<backward: no frame of the step>" if frames else "<no Python frame>"


def live_at_peak(trace: list) -> tuple[int, dict]:
    """Replay one device's alloc / free events: the highest sum of live
    bytes reached (relative to the start) and the blocks live then,
    ``addr -> (size, frames)``."""
    current = peak = 0
    peak_at = -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            current += e["size"]
            if current > peak:
                peak, peak_at = current, i
        elif e["action"] == "free_completed":
            current -= e["size"]
    live = {}
    for e in trace[:peak_at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], e.get("frames", []))
        elif e["action"] == "free_completed":
            live.pop(e["addr"], None)
    return peak, live


def grouped(live: dict, key) -> list:
    sums = collections.Counter()
    for size, frames in live.values():
        sums[key(frames)] += size
    return sums.most_common()


def record_step(step) -> tuple[int, dict]:
    import torch

    mem = torch.cuda.memory
    impl = getattr(mem, "_record_memory_history_impl", None)
    kw = {"clear_history": True} if impl and "clear_history" in inspect.signature(impl).parameters else {}
    torch.cuda.synchronize()
    mem._record_memory_history("all", context="alloc", stacks="python", max_entries=4_000_000, **kw)
    try:
        metrics = step()
        torch.cuda.synchronize()
        snapshot = mem._snapshot()
    finally:
        mem._record_memory_history(None)
    trace = snapshot["device_traces"][torch.cuda.current_device()]
    return {k: v.item() for k, v in metrics.items()}, live_at_peak(trace)


def probe(stage: int, card: str, out: Path | None) -> None:
    import torch

    if stage == 1:
        cfg = chip_smoke.train_config(True, True, None)
        from imagegenerator_tpu_torch.train.stage1 import Stage1System as System
        build, batch_of = chip_smoke.train_system, lambda c, g: chip_smoke.train_batch(c, g)
    else:
        cfg = chip_smoke.train2_config(True, None)
        from imagegenerator_tpu_torch.train.stage2 import Stage2System as System
        build = chip_smoke.train2_system
        batch_of = lambda c, g: chip_smoke.train2_batch(c, g, chip_smoke.REMAT_STAGE2_BATCH)
    seed = chip_smoke.TP_SEED
    state = System(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(seed)).state_dict()
    batch = batch_of(cfg, torch.Generator("cuda").manual_seed(seed + 1))
    report = {}
    for remat in (False, True):
        system = build(dataclasses.replace(cfg, remat=remat), state)
        gen, host = torch.Generator("cuda").manual_seed(seed + 2), torch.Generator().manual_seed(seed + 3)
        kw = dict(host_generator=host) if stage == 1 else {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        metrics, (peak, live) = record_step(lambda: system.train_step(batch, generator=gen, **kw))
        allocator_peak = torch.cuda.max_memory_allocated() - base
        by_step = grouped(live, lambda fr: _where(fr, lambda f: f["name"] == "train_step"))
        by_module = grouped(live, lambda fr: _where(fr, lambda f: PACKAGE in f["filename"]))
        print(f"stage {stage}, remat {remat}: first step's peak {peak / 2**30:.3f} GiB over the "
              f"{base / 2**30:.3f} GiB held before it (allocator: {allocator_peak / 2**30:.3f}); "
              f"{len(live)} blocks live at the peak; metrics {metrics} [{card}]")
        for title, groups in (("by the line of train_step", by_step), ("by the innermost frame in the package",
                                                                       by_module)):
            print(f"  live at the peak, {title}:")
            for where, size in groups[:TOP]:
                print(f"    {size / 2**30:8.3f} GiB  {where}")
        report[f"remat_{remat}"] = {"peak_bytes": peak, "base_bytes": base, "metrics": metrics,
                                    "by_step": by_step, "by_module": by_module}
        del system, live
        torch.cuda.empty_cache()
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        (out / f"memory_stage{stage}.json").write_text(json.dumps({"card": card, **report}, indent=1))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--stage", type=int, nargs="+", choices=(1, 2), default=[1, 2])
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_memory: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    chip_smoke.set_tf32(False)
    torch.backends.cudnn.deterministic = True
    for stage in args.stage:
        probe(stage, card, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
