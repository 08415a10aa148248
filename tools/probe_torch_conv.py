#!/usr/bin/env python3
"""Where the StackGAN nets' convolutions spend the card's time. Run on a
CUDA card from the repository root:

    python3 tools/probe_torch_conv.py --attribute [--batch 256] [--host]

Builds the stage-2 system as the bench's stage-2 target does
(``bench._stage2_setup``: ``Stage2Config()`` in bf16, batch 256), runs a
warm-up step, then traces one ``train_step`` under ``torch.profiler``
(CPU and CUDA, ``record_shapes``). Every ``Conv2d`` and
``ConvTranspose2d`` module of G2 and D2 gets a forward pre-hook and a
forward hook, set from this script, that open and close a
``record_function`` range named by the layer's kind and geometry and its
input and weight shapes; the program's code is not touched. The forward
kernels a range launches are the ones its layer's forward ran, whatever
ran them; backward kernels run under the
autograd engine's ranges, outside every layer's. Prints, for each
geometry group, the calls a step, TFLOP a step (``2 N Ho Wo Cout Cin k
k``), the bound (the sum over calls of ``max(bytes / 3.35 TB/s, FLOPs /
989.4 TFLOP/s)``, bytes those of x, w and y in bf16 read and written
once), the kernels by name with their device ms a step, and the sum; then
the step's device ms of every kernel class of ``profile_opclass``'s
table. ``--host`` times the host's cost a call of ``ops/conv.py``'s
Functions beside ``F.conv2d`` (``host_cost``). The last line is one JSON
object of every reading.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

HBM = 3.35e12
PEAK = 989.4e12


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip() or torch.cuda.get_device_name(0)


def _geometry(module) -> str:
    k, s, p = module.weight.shape[-1], module.stride, module.padding
    kind = "convT" if type(module).__name__ == "ConvTranspose2d" else "conv"
    return f"{kind} k{k} s{s} p{p}"


def hook_layers(nets) -> list:
    """Forward hooks on every conv layer of ``nets`` ({name: module}) that
    wrap its forward in a ``record_function`` range ``conv|<net>.<layer>|
    <geometry>|<x shape>|<w shape>``; returns the handles."""
    from torch.autograd.profiler import record_function

    handles = []
    for net_name, net in nets.items():
        for name, mod in net.named_modules():
            if type(mod).__name__ not in ("Conv2d", "ConvTranspose2d"):
                continue

            def pre(mod, args, net_name=net_name, name=name):
                x = args[0]
                label = "|".join(["conv", f"{net_name}.{name}", _geometry(mod), "x".join(map(str, x.shape)),
                                  "x".join(map(str, mod.weight.shape))])
                rf = record_function(label)
                rf.__enter__()
                mod._probe_range = rf

            def post(mod, args, out):
                mod._probe_range.__exit__(None, None, None)
                del mod._probe_range

            handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    return handles


def conv_cost(geometry: str, x_shape, w_shape):
    """``(flops, bytes)`` of one forward: the product's FLOPs and x, w, y
    in bf16 once each."""
    N, C, H, W = x_shape
    k = int(geometry.split()[1][1:])
    s = int(geometry.split()[2][1:])
    p = int(geometry.split()[3][1:])
    if geometry.startswith("convT"):
        cin, cout = w_shape[0], w_shape[1]
        Ho, Wo = (H - 1) * s - 2 * p + k, (W - 1) * s - 2 * p + k
        flops = 2 * N * H * W * cin * cout * k * k
    else:
        cout, cin = w_shape[0], w_shape[1]
        Ho, Wo = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
        flops = 2 * N * Ho * Wo * cout * cin * k * k
    nbytes = 2 * (N * C * H * W + cout * cin * k * k + N * cout * Ho * Wo)
    return flops, nbytes


def _op_key(e) -> str:
    """``<autograd node> / <aten op with shapes> <its input shapes>`` of a
    kernel-launching event outside the layers' forwards: the outermost
    ``autograd::engine::evaluate_function`` range above it and the
    outermost aten convolution op below that (or the innermost op that
    recorded shapes)."""
    node, op, shapes = "no autograd node", e.name, e.input_shapes
    conv_op = None
    cur = e
    while cur is not None:
        if cur.name.startswith("autograd::engine::evaluate_function"):
            node = cur.name.split(": ", 1)[-1]
        if cur.name.startswith("aten::") and "conv" in cur.name:
            conv_op = cur
        cur = cur.cpu_parent
    if conv_op is not None:
        op, shapes = conv_op.name, conv_op.input_shapes
    shapes = ",".join("x".join(map(str, s)) for s in (shapes or []) if s)
    return f"{node} / {op} {shapes}"


def attribute(batch: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from imagegenerator_tpu_torch import bench
    from imagegenerator_tpu_torch.tools.profile_opclass import kernel_class

    system, _, step = bench._stage2_setup(batch, True)
    step()
    torch.cuda.synchronize()
    nets = {"G2": system.gen_2, "D2": system.critic_2}
    handles = hook_layers(nets)
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
            step()
            torch.cuda.synchronize()
        events = prof.events()
        if any(k.duration > 0 for e in events for k in e.kernels):
            break
        print("probe_torch_conv: the trace recorded no device time; tracing again", file=sys.stderr)
    else:
        raise RuntimeError("torch.profiler recorded no device time in 3 traces")
    for h in handles:
        h.remove()

    groups = collections.OrderedDict()
    classes = collections.Counter()
    outside_layers = collections.Counter()
    outside_ops = collections.Counter()
    for e in events:
        for k in e.kernels:
            classes[kernel_class(k.name)] += k.duration / 1e3
        if not e.kernels:
            continue
        root = e
        while root is not None and not root.name.startswith("conv|"):
            root = root.cpu_parent
        if root is None:
            for k in e.kernels:
                if kernel_class(k.name) == "cuDNN convolutions":
                    outside_layers[k.name] += k.duration / 1e3
                    outside_ops[_op_key(e)] += k.duration / 1e3
            continue
        _, layer, geometry, xs, ws = root.name.split("|")
        x_shape = [int(v) for v in xs.split("x")]
        w_shape = [int(v) for v in ws.split("x")]
        key = (geometry, xs, ws)
        g = groups.setdefault(key, {"geometry": geometry, "x": x_shape, "w": w_shape, "layers": set(),
                                    "ranges": set(), "kernels": collections.Counter()})
        g["layers"].add(layer)
        g["ranges"].add(root.id)
        for k in e.kernels:
            g["kernels"][k.name] += k.duration / 1e3

    rows = []
    for g in groups.values():
        flops, nbytes = conv_cost(g["geometry"], g["x"], g["w"])
        calls = len(g["ranges"])
        ms = sum(g["kernels"].values())
        bound = calls * max(nbytes / HBM, flops / PEAK) * 1e3
        rows.append({"geometry": g["geometry"], "x": g["x"], "w": g["w"], "layers": sorted(g["layers"]),
                     "calls": calls, "tflop": calls * flops / 1e12, "bound_ms": bound, "ms": ms,
                     "kernels": {k: v for k, v in g["kernels"].most_common()}})
    return {"batch": batch, "rows": rows, "classes_ms": dict(classes.most_common()),
            "conv_kernels_outside_layers_ms": dict(outside_layers.most_common()),
            "conv_kernels_outside_layers_by_op_ms": dict(outside_ops.most_common())}


def host_cost(calls: int = 200, rounds: int = 24) -> dict:
    """Host microseconds a call on a launch-bound shape (batch 1: D1's
    head, 640 -> 128 at 4 x 4), each the median over ``rounds`` rounds of
    ``calls`` calls with one synchronisation at the end, the routes in
    turns within a round: ``conv_ops.conv2d`` (the Functions) against
    ``F.conv2d`` on the same operands (which require grad, as in
    training), forward alone and forward with the backward
    (``autograd.grad`` in x, w and b)."""
    import statistics
    import time

    import torch.nn.functional as F

    from imagegenerator_tpu_torch.ops import conv as conv_ops
    from imagegenerator_tpu_torch.ops import layers

    cl, bf = torch.channels_last, torch.bfloat16
    layer = layers.Conv2d(640, 128, 1, 1, 0, dtype=bf).to("cuda")
    x = torch.randn((1, 640, 4, 4), device="cuda").to(bf).contiguous(memory_format=cl)
    ops = [t.detach().clone().requires_grad_(True) for t in layers._conv_operands(layer, x)]
    g = torch.randn((1, 128, 4, 4), device="cuda").to(bf).contiguous(memory_format=cl)
    routes = {
        "functions_us": lambda: conv_ops.conv2d(*ops),
        "aten_us": lambda: F.conv2d(*ops),
        "functions_fwd_bwd_us": lambda: torch.autograd.grad(conv_ops.conv2d(*ops), ops, g),
        "aten_fwd_bwd_us": lambda: torch.autograd.grad(F.conv2d(*ops), ops, g),
    }
    readings = {name: [] for name in routes}
    for _ in range(rounds):
        for name, fn in routes.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            readings[name].append((time.perf_counter() - t0) / calls * 1e6)
    out = {name: statistics.median(v) for name, v in readings.items()}
    quartiles = {name: [round(q, 2) for q in statistics.quantiles(v, n=4)] for name, v in readings.items()}
    print("host cost a call (us), medians:", json.dumps({k: round(v, 2) for k, v in out.items()}), flush=True)
    print("host cost a call (us), quartiles:", json.dumps(quartiles), flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--attribute", action="store_true", help="trace one stage-2 step by conv layer")
    parser.add_argument("--host", action="store_true",
                        help="the host's cost a call of the convolution's Functions beside F.conv2d")
    parser.add_argument("--batch", type=int, default=256)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_conv: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    print(card(), flush=True)
    out = {}
    if args.attribute:
        att = attribute(args.batch)
        out["attribute"] = att
        total = collections.Counter()
        for r in att["rows"]:
            fwd = r["geometry"].startswith("conv ")
            total["fwd" if fwd else "convT"] += r["ms"]
            total["fwd_bound" if fwd else "convT_bound"] += r["bound_ms"]
            total["fwd_tflop" if fwd else "convT_tflop"] += r["tflop"]
            top = "; ".join(f"{k[:70]} {v:.3f}" for k, v in list(r["kernels"].items())[:3])
            print(f"{r['geometry']:<16} x {'x'.join(map(str, r['x'])):<18} w {'x'.join(map(str, r['w'])):<15} "
                  f"{r['calls']:>3} calls {r['tflop']:8.4f} TF bound {r['bound_ms']:8.3f} ms "
                  f"device {r['ms']:8.3f} ms [{','.join(r['layers'])[:60]}] {top}", flush=True)
        print(f"forward convs: {total['fwd']:.3f} ms a step, bound {total['fwd_bound']:.3f} ms, "
              f"{total['fwd_tflop']:.3f} TF; transposed: {total['convT']:.3f} ms, bound "
              f"{total['convT_bound']:.3f} ms, {total['convT_tflop']:.3f} TF")
        print("classes (ms a step):", json.dumps({k: round(v, 3) for k, v in att["classes_ms"].items()}))
        print("conv-class kernels outside the layers' forwards (ms a step):",
              json.dumps({k[:90]: round(v, 3) for k, v in list(att["conv_kernels_outside_layers_ms"].items())[:12]}))
        print("the same by autograd node and aten op (ms a step):")
        for k, v in list(att["conv_kernels_outside_layers_by_op_ms"].items())[:40]:
            print(f"  {v:8.3f}  {k}")
    if args.host:
        out["host"] = host_cost()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("BENCH_DTYPE", "bf16")
    sys.exit(main())
