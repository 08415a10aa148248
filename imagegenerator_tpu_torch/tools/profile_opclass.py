"""Device time of a benched workload by class of kernel: the counterpart
of the JAX package's ``tools/profile_opclass.py``.

A top-kernel table says little when no kernel holds more than a few
percent of a step; the question is how much of the step runs on the
tensor cores (cuBLAS/CUTLASS GEMMs, cuDNN convolutions, the port's hand
kernels) and how much is elementwise work, reductions, normalisation,
copies and layout transforms, RNG and memory traffic, which is not.

The workload is built by the bench's own setup functions
(``imagegenerator_tpu_torch.bench._v2_setup`` / ``_stage1_setup`` /
``_stage2_setup``, under the same ``BENCH_*`` variables), so the profile
traces what the bench times. After a warm-up, 3 steps (3 chains of
``--chain`` iterations for v2) run under ``torch.profiler``; each
kernel's self time on the device is put in the first class of
``KERNEL_CLASSES`` whose pattern its name holds, "other" when none does,
so nothing is dropped. The tool prints per class the ms per step, the
share of device time and the top kernels (the hand kernels each by
name), and ends with one JSON line.

    python -m imagegenerator_tpu_torch.tools.profile_opclass --workload stage2
    python -m imagegenerator_tpu_torch.tools.profile_opclass --workload v2 --keep DIR
    python -m imagegenerator_tpu_torch.tools.profile_opclass --trace DIR

``--trace`` reads a chrome trace written by ``torch.profiler``
(``export_chrome_trace``; ``--keep`` writes one) instead of capturing.
It runs on the card; ``BENCH_DEVICE=cpu`` times the CPU's operators
instead (names of aten operators, not of kernels; for the tests).
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys

# The port's hand-written kernels, by the names they launch under
# (``csrc/*.cu``, ``ops/kernels/*.py``).
HAND_KERNELS = (
    "attention_fwd_mma_kernel",
    "attention_fwd_kernel",
    "attention_bwd_mma_kernel",
    "attention_bwd_dq_kernel",
    "attention_bwd_dkdv_kernel",
    "attention_fwd_tiled_kernel",
    "attention_bwd_dq_tiled_kernel",
    "attention_bwd_dkdv_tiled_kernel",
    "attention_fwd_wgmma_kernel",
    "attention_bwd_dq_wgmma_kernel",
    "attention_bwd_dkdv_wgmma_kernel",
    "layernorm_fwd_warp_kernel",
    "layernorm_fwd_block_kernel",
    "_layernorm_bwd_kernel",
    "_layernorm_bwd_reduce_kernel",
    "vq_argmin_kernel",
    "_scanline_lerp_kernel",
    "batch_norm_reduce_kernel",
    "batch_norm_finalize_kernel",
    "batch_norm_apply_kernel",
)
HAND = "hand kernels"
OTHER = "other"

# (class, patterns): a kernel goes to the first class one of whose
# patterns its lower-cased name holds. The order matters: a convolution's
# mangled template arguments can name a permutation, cuDNN's layout
# transforms name cuDNN, and PyTorch's casts, RNG and fused optimizer run
# in its elementwise templates.
KERNEL_CLASSES = (
    (HAND, tuple(k.lower() for k in HAND_KERNELS)),
    ("memcpy/memset", ("memcpy", "memset")),
    ("rng", ("distribution_", "philox", "curand", "randperm", "normal_kernel", "uniform_kernel",
             "bernoulli", "random_")),
    ("cuDNN convolutions", ("fprop", "dgrad", "wgrad", "convolve", "conv2d", "winograd",
                            "implicitgemmconvolution")),
    ("copies and layout transforms", ("nchwtonhwc", "nhwctonchw", "tensortransform", "addpadding", "converttensor",
                                      "direct_copy", "copy_kernel", "catarraybatchedcopy", "flip_kernel")),
    ("normalization", ("batch_norm", "layer_norm", "group_norm", "softmax", "welford", "bn_fw",
                       "bn_bw", "rowwisemoments", "gammabetabackward", "computeinternalgradients",
                       "fusedparams")),
    ("tensor-core GEMMs", ("gemm", "nvjet", "cutlass", "cublas", "gemv", "splitkreduce", "xmma")),
    ("reductions", ("reduce", "argmin", "argmax", "scan_", "norm_kernel")),
    ("elementwise", ("elementwise", "multi_tensor_apply", "fill", "index", "where", "scatter", "gather",
                     "clamp")),
)
CLASSES = tuple(c for c, _ in KERNEL_CLASSES) + (OTHER,)


def kernel_class(name: str) -> str:
    """The class of a kernel (or operator) name."""
    n = name.lower()
    for cls, patterns in KERNEL_CLASSES:
        if any(p in n for p in patterns):
            return cls
    return OTHER


def _workload_step(workload: str, batch: int | None, chain: int):
    """``(step, executions)``: ``step(i)`` runs one traced unit (a train
    step, or a chain of ``chain`` v2 iterations), built by the bench's
    setup functions; ``executions`` is what 3 units hold (steps or
    iterations)."""
    from imagegenerator_tpu_torch import bench

    if workload == "v2":
        engine, state, prompts = bench._v2_setup(batch or 1)
        return (lambda i: engine.chain(state, chain, 10 + i, *prompts)), 3 * chain
    if workload.startswith("stage1"):
        _, _, step = bench._stage1_setup(
            batch or int(os.environ.get("BENCH_BATCH", "128")),
            fastpath="fast" in workload, reuse="reuse" in workload, golden="golden" in workload,
        )
    else:  # stage2, the precomputed-tem headline
        _, _, step = bench._stage2_setup(batch or int(os.environ.get("BENCH_BATCH", "256")), True)
    return (lambda i: step()), 3


PROFILE_TRIES = 3


def capture(workload: str, batch: int | None = None, chain: int = 20, keep: str | None = None):
    """Trace 3 units of ``workload`` after a warm-up: ``(rows,
    executions)``, rows ``(name, self microseconds, count)`` per kernel
    (per operator on the CPU). ``torch.profiler`` now and then records no
    kernel of a short trace; such a trace is taken again, at most
    ``PROFILE_TRIES`` times, and then this raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from imagegenerator_tpu_torch import bench

    device = bench._device()
    step, executions = _workload_step(workload, batch, chain)
    step(-1)
    bench._fence(device)
    cuda = device.type == "cuda"
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
            for i in range(3):
                step(i)
            bench._fence(device)
        kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
        rows = [
            (e.key, e.self_device_time_total if cuda else e.self_cpu_time_total, e.count)
            for e in prof.key_averages() if e.device_type == kind
        ]
        if sum(us for _, us, _ in rows) > 0:
            break
        print("profile_opclass: the trace recorded no device time; tracing again", file=sys.stderr)
    else:
        raise RuntimeError(f"torch.profiler recorded no device time in {PROFILE_TRIES} traces")
    if keep:
        os.makedirs(keep, exist_ok=True)
        prof.export_chrome_trace(os.path.join(keep, f"{workload}.json"))
    return rows, executions


def parse_trace(trace_dir: str):
    """Rows ``(name, microseconds, count)`` of the device events (kernels,
    memcpys, memsets) in the chrome traces under ``trace_dir``."""
    paths = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True)
        + glob.glob(os.path.join(trace_dir, "**", "*.json.gz"), recursive=True)
    )
    if not paths:
        raise SystemExit(f"no chrome trace (*.json) under {trace_dir}")
    totals: dict = {}
    for path in paths:
        with (gzip.open if path.endswith(".gz") else open)(path, "rt") as f:
            trace = json.load(f)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        for e in events:
            if str(e.get("cat", "")).lower() in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
                t = totals.setdefault(e.get("name", "?"), [0.0, 0])
                t[0] += float(e["dur"])
                t[1] += 1
    return [(name, us, count) for name, (us, count) in totals.items()]


TOP = 4  # names listed per class (every hand kernel)


def classify(rows, executions: int | None) -> list:
    """Group rows by class: per class its ms, ms per execution (where
    known), share of the total and its top names (every hand kernel).
    Every class is listed, empty ones with 0, so the shares sum to 100."""
    total = sum(us for _, us, _ in rows)
    by_class = {c: [] for c in CLASSES}
    for row in rows:
        by_class[kernel_class(row[0])].append(row)
    per = f" ({total / 1e3 / executions:.3f} ms per step)" if executions else ""
    print(f"\ntotal self time: {total / 1e3:.2f} ms over {len(rows)} names{per}")
    print(f"{'class':<30} {'ms/step' if executions else 'ms':>9} {'%':>6}  top kernels (% of total)")
    out = []
    for cls in sorted(CLASSES, key=lambda c: -sum(us for _, us, _ in by_class[c])):
        rs = sorted(by_class[cls], key=lambda r: -r[1])
        t = sum(us for _, us, _ in rs)
        pct = 100 * t / total if total else 0.0
        tops = rs if cls == HAND else rs[:TOP]
        scale = 1e3 * (executions or 1)
        print(f"{cls:<30} {t / scale:>9.3f} {pct:>5.1f}%  "
              + ", ".join(f"{name[:60]} {100 * us / total:.1f}%" for name, us, _ in tops))
        out.append({
            "class": cls,
            "ms": round(t / 1e3, 4),
            **({"ms_per_step": round(t / scale, 4)} if executions else {}),
            "pct": round(pct, 3),
            "names": len(rs),
            "launches": sum(n for _, _, n in rs),
            "top": [{"name": name, "ms": round(us / 1e3, 4), "pct": round(100 * us / total, 3)}
                    for name, us, _ in tops],
        })
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="v2",
                    choices=["v2", "stage1", "stage1_fast", "stage1_fast_reuse", "stage1_golden", "stage2"],
                    help="the benched workload to trace (train workloads report ms per step, a step "
                         "holding n_critic critic updates; v2 ms per iteration)")
    ap.add_argument("--trace", default=None,
                    help="read the chrome traces under this directory instead of capturing")
    ap.add_argument("--chain", type=int, default=20, help="iterations per chain (v2)")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch (default: the target's bench default, 1 v2 / 128 stage1 / 256 stage2)")
    ap.add_argument("--keep", default=None, help="write the captured chrome trace to this directory")
    args = ap.parse_args(argv)

    if args.trace:
        rows, executions, device, limit = parse_trace(args.trace), None, None, None
    else:
        from imagegenerator_tpu_torch import bench

        rows, executions = capture(args.workload, args.batch, args.chain, args.keep)
        device, limit = bench._card()
        print(f"traced 3 {'chains' if args.workload == 'v2' else 'steps'} of {args.workload} on {device} "
              f"({limit} W)")
    classes = classify(rows, executions)
    total = sum(us for _, us, _ in rows)
    print(json.dumps({
        "workload": None if args.trace else args.workload,
        "device": device,
        "power_limit_w": limit,
        "executions": executions,
        "total_ms": round(total / 1e3, 4),
        **({"ms_per_step": round(total / 1e3 / executions, 4)} if executions else {}),
        "classes": classes,
    }))


if __name__ == "__main__":
    main()
