"""A cell over several cards: one process a card, as ``torchrun`` runs
the port's training over ``parallel/dp.py``.

The benchmark's command is then the launcher. ``launch`` starts one rank
process a card (the same module and arguments, with ``--t0``, the
launcher's start), each with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR=127.0.0.1`` and a free
``MASTER_PORT``, and waits for them until a deadline. Rank 0's standard
error is the launcher's; its standard output holds only the result line,
which the launcher prints once every rank has ended with 0. The other
ranks' output goes to the launcher's standard error a line at a time,
tagged with the rank. A rank that fails, or the deadline, ends every rank
and the launcher exits non-zero with no result. Each rank runs in a
session of its own, killed as a group with whatever it started, and is
killed by the kernel should the launcher die first.

Why not ``torchrun`` itself: its console either tags every line of every
rank on one stream (``--tee``) or drops the other ranks' output
(``--local-ranks-filter``), where the result has to be rank 0's raw last
line of standard output and the other ranks' failures readable on
standard error. Its ``--numa-binding`` would bind each rank to cores near
its card, which the cards' machines cannot do: their kernel is a sandbox
in user space that keeps a thread's CPU affinity but reports every
thread on CPU 0, and shows no NUMA node.

A rank runs in ``serve``: it joins through ``dp.init_from_env``, runs its
part, and leaves by ``os._exit``, never through
``destroy_process_group`` (a four-rank run once hung in NCCL's teardown
until it was killed), with a non-zero code where its part raised or
where it holds a module the benchmark may not load.

The deadline (``deadline_s``): the window's seconds plus ``WARM_S`` for
the ranks' start, set-up, the traced steps and the reference, or plus
``COLD_S`` where the launcher found the kernels not yet built, as in a
checkout's first run, which also compiles Triton's kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import os
import signal
import socket
import subprocess
import sys
import threading
import time

WARM_S = 290.0
COLD_S = 1100.0
PR_SET_PDEATHSIG = 1


def deadline_s(seconds: float, built: bool) -> float:
    return seconds + (WARM_S if built else COLD_S)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ launcher


_LIBC = ctypes.CDLL(None, use_errno=True)


def _die_with_parent() -> None:  # runs in the child between fork and exec
    _LIBC.prctl(PR_SET_PDEATHSIG, signal.SIGKILL)


def _tag(stream, prefix: str) -> None:
    for line in iter(stream.readline, ""):
        sys.stderr.write(prefix + line)
        sys.stderr.flush()
    stream.close()


def _collect(stream, into: list) -> None:
    into.extend(iter(stream.readline, ""))
    stream.close()


def _kill(procs) -> None:
    for p in procs:
        with contextlib.suppress(ProcessLookupError, PermissionError):
            os.killpg(p.pid, signal.SIGKILL)
    for p in procs:
        p.wait()


def launch(module: str, argv: list, world: int, deadline: float, t0: float) -> tuple:
    """Run ``python -m module *argv --t0 t0`` as ``world`` ranks on this
    host and wait at most ``deadline`` seconds; returns the launcher's
    exit code and, where every rank ended with 0, rank 0's standard
    output."""
    port = free_port()
    cmd = [sys.executable, "-m", module, *argv, "--t0", repr(t0)]
    procs, threads, out0 = [], [], []

    def stop(signum, frame):
        raise SystemExit(128 + signum)

    previous = {s: signal.signal(s, stop) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                 stderr=None if r == 0 else subprocess.STDOUT, text=True,
                                 start_new_session=True, preexec_fn=_die_with_parent)
            procs.append(p)
            print(f"[launch] rank {r} of {world}: pid {p.pid}", file=sys.stderr, flush=True)
        threads = [threading.Thread(target=_collect, args=(procs[0].stdout, out0), daemon=True)]
        threads += [threading.Thread(target=_tag, args=(p.stdout, f"[rank {r}] "), daemon=True)
                    for r, p in enumerate(procs) if r]
        for t in threads:
            t.start()
        end = time.monotonic() + deadline
        failed = None
        while failed is None:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0][0]} exited with code {bad[0][1]}"
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > end:
                failed = f"the ranks passed the deadline of {deadline:.0f} s"
            else:
                time.sleep(0.1)
    finally:
        _kill(procs)
        for t in threads:
            t.join(timeout=10)
        for s, h in previous.items():
            signal.signal(s, h)
    if failed is not None:
        print(f"[launch] {failed}: every rank ended, no result", file=sys.stderr, flush=True)
        return (124 if "deadline" in failed else 1), ""
    return 0, "".join(out0)


# ------------------------------------------------------------ in a rank


def serve(device, part, held) -> None:
    """A rank's whole life: join the launcher's process group
    (``dp.init_from_env``: NCCL with a card a rank, gloo on the CPU; its
    report goes to standard error, standard output is the result's), run
    ``part(device, rank, world)`` for its exit code, and leave. A part
    that raises, or a rank that ``held()`` finds holding a module the
    benchmark may not load, leaves with a code other than 0."""
    code = 1
    try:
        from imagegenerator_tpu_torch.parallel import dp

        with contextlib.redirect_stdout(sys.stderr):
            device = dp.init_from_env(device)
        code = part(device, dp.rank(), dp.world())
        if code == 0 and held():
            code = 3
    except BaseException:  # a rank's failure ends the run: report it, then leave
        import traceback

        traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def sync_all(device) -> None:
    """Every rank's card idle, then every rank here."""
    import torch
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.barrier()


def _one(value: int, device, collective) -> int:
    import torch

    t = torch.tensor([value], dtype=torch.int64, device=device)
    collective(t)
    return int(t.item())


def broadcast(value: int, device) -> int:
    """Rank 0's ``value`` on every rank."""
    import torch.distributed as dist

    return _one(value, device, lambda t: dist.broadcast(t, 0))


def largest(value: int, device) -> int:
    """The largest of the ranks' ``value``."""
    import torch.distributed as dist

    return _one(value, device, lambda t: dist.all_reduce(t, op=dist.ReduceOp.MAX))


def steps_for(seconds: float, step, k: int, warm: int, device) -> int:
    """The window's step count: ``warm`` steps from step ``k`` timed on
    every rank between two ``sync_all``, rank 0's time a step into
    ``seconds``, broadcast once; the window then needs no host
    synchronisation to end together."""
    sync_all(device)
    t = time.perf_counter()
    for i in range(warm):
        step(k + i)
    sync_all(device)
    per_step = (time.perf_counter() - t) / warm
    return broadcast(max(1, math.ceil(seconds / per_step)), device)
