"""Profiling hooks — counterpart of ``imagegenerator_tpu/utils/profiling.py``:
a ``torch.profiler`` trace of a span of the run, and step timing that
waits for the card.

``trace(logdir)`` records the host's activity and, where CUDA is
available, the card's kernels, and writes one Chrome trace per
data-parallel rank, ``<logdir>/trace_rank<R>.json`` (open it in
``chrome://tracing`` or Perfetto). The training CLI wraps ``fit`` in it
and the v2 CLI the optimisation loop, the spans the JAX CLIs trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from imagegenerator_tpu_torch.parallel import dp


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def fence(tree) -> None:
    """Wait until the work that produces the tensors of ``tree`` (a
    tensor, or dicts, lists and tuples of them) has finished on their
    cards."""
    for device in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def step_timer(name: str, result: dict | None = None):
    """Host-clock seconds of the block, into ``result[name]`` or printed.
    Fence the block's outputs inside it: CUDA calls return before the
    card is done."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if result is not None:
        result[name] = dt
    else:
        print(f"[timer] {name}: {dt * 1000:.2f} ms", flush=True)


def trace_path(logdir: str, rank: int | None = None) -> str:
    return os.path.join(logdir, f"trace_rank{dp.rank() if rank is None else rank}.json")


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of the block (host activity, and the
    card's kernels where CUDA is available), written on exit to
    ``trace_path(logdir)``, one file per rank."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = trace_path(logdir)
    prof.export_chrome_trace(path)
    print(f"[profile] trace written to {path}", flush=True)
