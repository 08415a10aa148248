#!/usr/bin/env python3
"""The BatchNorm kernels (``csrc/batch_norm_nhwc.cu``) timed at the nets'
shapes beside what the port ran before them and a library yardstick. Run
on a CUDA card from the repository root:

    python3 tools/probe_torch_batchnorm.py [--shapes 80x128,640x16,128x16] [--batch 256]

1. Builds the library and prints what ``ptxas`` says of each kernel
   (registers, spills, shared memory).
2. For each ``CxH`` (C channels of an H x H map, batch 256, bf16,
   channels-last): CUDA-event milliseconds a call, median of 20 after
   warm-up, of the forward in training mode, the backward and the double
   backward on the kernels (each pass: the reduction, its finalize and
   the elementwise pass); the same three of the layer's composition of
   PyTorch ops differentiated by autograd (``plain``:
   ``BatchNorm.composition``, what the card ran before the kernels: its
   forward, ``autograd.grad`` of it, and ``autograd.grad`` of that taken
   with ``create_graph``, each timed alone); and
   ``F.batch_norm`` on the channels-last map (cuDNN's or PyTorch's
   kernels, forward and forward with backward; a yardstick the port
   never calls). Beside the kernels' event times, their device time a
   call by ``torch.profiler`` (the kernels named ``batch_norm``, over 5
   calls), which leaves out the host's launch time. The bound is bytes /
   3.35 TB/s at about 6, 10 and 16 bytes an element (bf16: x read twice
   and y written; g and x read twice and dx written; gg, x and g read
   twice and two written).

Prints the card's name and power limit first, and ends with one JSON
line of every reading.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from imagegenerator_tpu_torch.ops import layers  # noqa: E402
from imagegenerator_tpu_torch.ops.kernels import _build  # noqa: E402
from imagegenerator_tpu_torch.ops.kernels import batchnorm as bn  # noqa: E402

HBM = 3.35e12
BYTES = {"fwd": 6, "bwd": 10, "double_bwd": 16}  # bf16, an element


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip() or torch.cuda.get_device_name(0)


def timed(fn, reps=20, warm=3) -> float:
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, calls=5) -> float:
    """Device milliseconds a call of the kernels named ``batch_norm``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time for e in prof.events() if "batch_norm" in e.name) / calls / 1e3


def probe(C: int, H: int, batch: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(C * 1000 + H)
    shape = (batch, C, H, H)
    cl = lambda t: t.contiguous(memory_format=torch.channels_last)
    x = cl(torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)).requires_grad_(True)
    g = cl(torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16))
    gg = cl(torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16))
    w = (1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")).requires_grad_(True)
    b = (0.1 * torch.randn(C, generator=gen, device="cuda")).requires_grad_(True)
    rm, rv = torch.zeros(C, device="cuda"), torch.ones(C, device="cuda")
    kw = dict(training=True, update=True, momentum=0.1, eps=1e-5, out_dtype=torch.bfloat16)
    row = {"shape": f"{batch}x{H}x{H}x{C}", "elements": x.numel()}

    xr, gr, ggr = bn.rows(x.detach()), bn.rows(g), bn.rows(gg)
    n = xr.shape[0]

    def fwd():
        with torch.no_grad():
            return bn.batch_norm(x, w, b, rm, rv, **kw)

    _, stats = bn.batch_norm_fwd(xr, bn.batch_norm_sums(bn.FWD, xr), w, b, rm, rv, count=n, **kw)

    def bwd():
        local = bn.batch_norm_sums(bn.BWD, gr, xr, stats=stats)
        return bn.batch_norm_bwd(gr, xr, stats, w, local, 1.0 / n)

    local = bn.batch_norm_sums(bn.BWD, gr, xr, stats=stats)

    def dbl():
        dl = bn.batch_norm_sums(bn.DBL, ggr, xr, gr, stats)
        return bn.batch_norm_double_bwd(ggr, xr, gr, stats, w, dl, dl, local, local, None, None, 1.0 / n)

    row["kernel_ms"] = {"fwd": timed(fwd), "bwd": timed(bwd), "double_bwd": timed(dbl)}
    row["device_ms"] = {"fwd": device_ms(fwd), "bwd": device_ms(bwd), "double_bwd": device_ms(dbl)}

    layer = layers.BatchNorm(C, dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        layer.weight.copy_(w), layer.bias.copy_(b)

    def plain_fwd():
        with torch.no_grad():
            return layer.composition(x)

    y = layer.composition(x)
    plain_bwd = lambda: torch.autograd.grad(y, [x, layer.weight, layer.bias], g, retain_graph=True)
    (gx,) = torch.autograd.grad(y, x, g, create_graph=True)
    plain_dbl = lambda: torch.autograd.grad(gx, [x, layer.weight, layer.bias], gg, retain_graph=True,
                                            allow_unused=True)
    row["plain_ms"] = {"fwd": timed(plain_fwd), "bwd": timed(plain_bwd), "double_bwd": timed(plain_dbl)}
    del y, gx

    def lib_fwd():
        with torch.no_grad():
            return F.batch_norm(x, rm, rv, w, b, training=True, momentum=0.1, eps=1e-5)

    def lib_fwd_bwd():
        out = F.batch_norm(x, rm, rv, w, b, training=True, momentum=0.1, eps=1e-5)
        return torch.autograd.grad(out, [x, w, b], g)

    row["library_ms"] = {"fwd": timed(lib_fwd), "fwd_bwd": timed(lib_fwd_bwd)}
    row["bound_ms"] = {k: v * x.numel() / HBM * 1e3 for k, v in BYTES.items()}
    return row


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--shapes", default="80x128,160x64,320x32,640x16,512x16,32x64,512x4,24x32")
    parser.add_argument("--batch", type=int, default=256)
    args = parser.parse_args()
    print(card(), flush=True)
    _build.library("batch_norm_nhwc")
    for line in _build.build_log("batch_norm_nhwc").splitlines():
        if re.search(r"Compiling entry|registers|spill", line):
            print("  ptxas:", line.strip())
    rows = []
    for item in args.shapes.split(","):
        C, H = (int(v) for v in item.split("x"))
        row = probe(C, H, args.batch)
        rows.append(row)
        k, p, lib, bound = row["kernel_ms"], row["plain_ms"], row["library_ms"], row["bound_ms"]
        d = row["device_ms"]
        print(f"{row['shape']}: kernel fwd {k['fwd']:.4f} bwd {k['bwd']:.4f} dbl {k['double_bwd']:.4f} ms "
              f"(device {d['fwd']:.4f} / {d['bwd']:.4f} / {d['double_bwd']:.4f}); "
              f"plain {p['fwd']:.4f} / {p['bwd']:.4f} / {p['double_bwd']:.4f}; "
              f"F.batch_norm fwd {lib['fwd']:.4f} fwd+bwd {lib['fwd_bwd']:.4f}; "
              f"bound {bound['fwd']:.4f} / {bound['bwd']:.4f} / {bound['double_bwd']:.4f}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"batch_norm_probe": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
