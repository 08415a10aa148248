"""Profiling hooks — counterpart of ``imagegenerator_tpu/utils/profiling.py``:
a ``torch.profiler`` trace of a stretch of the run, and the spans that
name its phases.

``trace(logdir)`` records the host's activity and, where CUDA is
available, the card's kernels, and writes one Chrome trace per
data-parallel rank, ``<logdir>/trace_rank<R>.json`` (open it in
``chrome://tracing`` or Perfetto). The training CLI wraps ``fit`` in it
and the v2 CLI the optimisation loop, the stretches the JAX CLIs trace.

``span(name)`` marks a phase of the work as a ``user_annotation`` event
of the trace, on the host's clock, as are the card's kernels' launches. The
training loop shows ``data`` (the wait for the loader's next batch) and
both stages' ``train_step`` with, inside it, ``text`` (the encoder's and
projection's forward), ``critic`` (one critic iteration, ``n_critic`` a
step), ``generator`` (the generator side's forward and gradient),
``text_backward`` (stage 1: the encoder's and projection's gradient) and
``optimizer`` (one optimizer's update). A kernel belongs to the span
whose interval held its launch (the launch event with its
``correlation``), on any thread: autograd launches the backward's
kernels from its own. So an operator reads where the card's time of a
step goes, and what the host was doing where the card sat idle.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

from imagegenerator_tpu_torch.parallel import dp


def span(name: str):
    """A context naming a phase of the work in a running profiler's trace
    (``torch.profiler.record_function``); with no profiler recording, a
    context that does nothing, at the cost of one flag check. It reads no
    clock and synchronises nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


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
