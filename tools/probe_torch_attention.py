#!/usr/bin/env python3
"""Where the PyTorch port's tensor-core attention kernels spend their time,
as far as a run without a kernel profiler can tell. On a CUDA card, from
the repository root:

    python3 tools/probe_torch_attention.py

1. The same bytes at different sequence lengths: (B, T) from (256, 128)
   to (2048, 16) at hidden 768, 12 heads, bf16, with a mask, at dropout
   rate 0 and 0.1. One block works on one (batch row, head), so the block
   count doubles down the list while the products per block fall by four;
   a time that follows the block count and not the products says the
   kernels are not bound by their products. A plain copy of one tensor
   stands beside them as the card's memory rate that day.
2. The static instruction mix of the two tensor-core kernels, from
   ``cuobjdump -sass`` on the built libraries: HMMA (tensor-core
   products), LDSM (``ldmatrix``), MUFU (``exp``, reciprocal) and the rest.

    python3 tools/probe_torch_attention.py --times [--out FILE]

instead times the forward and backward wrappers at the shapes of
``TIMED`` (bf16, a ragged mask, dropout rate 0.1 and 0): CUDA events
around back-to-back calls, ``torch.profiler`` device time per call, the
plain versions, ``F.scaled_dot_product_attention`` and its autograd
backward at rate 0 (a yardstick; the port never calls it), the bound
(max of bytes over 3.35 TB/s and FLOPs over 989.4 TFLOP/s) and which route
the wrapper took; a shape the wrappers refuse is reported as such. Each
reading is printed and, with ``--out``, written as one JSON object a
line.

Prints the card's name and power limit first, as every number needs them
beside it.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SHAPES = ((256, 128), (512, 64), (1024, 32), (2048, 16), (128, 128), (64, 128))
HIDDEN, HEADS = 768, 12
# (B, T, H, heads) of ``--times``: BERT-base's stage-1 attention at
# seq_len 256 and 512, at 128, and at 128 with head dims 32 and 128
TIMED = ((256, 256, 768, 12), (256, 512, 768, 12), (256, 128, 768, 12),
         (256, 128, 768, 24), (256, 128, 768, 6))
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989.4e12


def cuda_ms(fn, warmup=3, calls=20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def shape_sweep(attention) -> None:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, T in SHAPES:
        q, k, v, do = (torch.randn((B, T, HIDDEN), generator=gen, device="cuda").bfloat16()
                       for _ in range(4))
        mask = torch.ones((B, T), dtype=torch.int32, device="cuda")
        mask[:, T - T // 4:] = 0
        megabytes = q.numel() * 2 / 1e6
        for rate in (0.0, 0.1):
            _, m, l = attention.attention_fwd(q, k, v, mask, HEADS, rate, 7)
            fwd = cuda_ms(lambda: attention.attention_fwd(q, k, v, mask, HEADS, rate, 7))
            bwd = cuda_ms(lambda: attention.attention_bwd(q, k, v, do, mask, m, l, HEADS, rate, 7))
            print(f"({B}, {T}, {HIDDEN}) bf16 rate {rate}: {B * HEADS} heads; forward {fwd:.4f} ms "
                  f"({4 * megabytes / fwd / 1e3:.2f} TB/s of q, k, v, o), backward {bwd:.4f} ms "
                  f"({7 * megabytes / bwd / 1e3:.2f} TB/s of q, k, v, do, dq, dk, dv)", flush=True)
        out = torch.empty_like(q)
        copy = cuda_ms(lambda: out.copy_(q))
        print(f"    a copy of one such tensor: {copy:.4f} ms ({2 * megabytes / copy / 1e3:.2f} TB/s)")


def device_ms(fn, calls) -> float:
    """Device time per call by ``torch.profiler``: each kernel's mean
    time times its launches per call (the trace loses a launch or two at
    its start, so the count is rounded up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.self_device_time_total / e.count * -(-e.count // calls) for e in events if e.count)
        if total > 0:
            return total / 1e3
    return float("nan")  # the profiler recorded nothing three times: printed as such


def bound_ms(B, T, H, heads, backward: bool) -> tuple[float, str]:
    """max(bytes / 3.35 TB/s, FLOPs / 989.4 TFLOP/s): q, k, v, o (and do,
    dq, dk, dv) in bf16, the mask, m and l (and D) in 32 bits; the two
    products of the forward, the backward's four and its recomputed
    scores."""
    tensors, stats = (7, 3) if backward else (4, 2)
    moved = tensors * B * T * H * 2 + B * T * 4 + stats * B * heads * T * 4
    flops = (10 if backward else 4) * B * T * T * H
    by_bytes, by_ops = moved / PEAK_BYTES, flops / PEAK_BF16
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def timed_shapes(attention, out) -> None:
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, T, H, heads in TIMED:
        q, k, v, do = (torch.randn((B, T, H), generator=gen, device="cuda").bfloat16() for _ in range(4))
        lengths = torch.randint(T // 4, T + 1, (B,), generator=gen, device="cuda")
        mask = (torch.arange(T, device="cuda")[None, :] < lengths[:, None]).int()
        d = H // heads
        heads_of = lambda t: t.reshape(B, T, heads, d).transpose(1, 2)
        keep = mask[:, None, None, :].bool()
        for rate in (0.1, 0.0):
            row = {"shape": [B, T, H], "heads": heads, "head_dim": d, "dtype": "bf16", "rate": rate}
            try:
                attention.mma_launches = attention.mma_bwd_launches = 0
                _, m, l = attention.attention_fwd(q, k, v, mask, heads, rate, 7)
                attention.attention_bwd(q, k, v, do, mask, m, l, heads, rate, 7)
                torch.cuda.synchronize()
            except ValueError as e:
                row["refused"] = str(e)
                print(json.dumps(row), flush=True)
                out.append(row)
                continue
            row["route"] = "mma" if attention.mma_launches else "fma"
            row["bwd_route"] = "mma" if attention.mma_bwd_launches else "fma"
            fns = {
                "fwd": lambda: attention.attention_fwd(q, k, v, mask, heads, rate, 7),
                "bwd": lambda: attention.attention_bwd(q, k, v, do, mask, m, l, heads, rate, 7),
                "plain_fwd": lambda: attention.attention_reference(q, k, v, mask, heads, rate, 7),
                "plain_bwd": lambda: attention.attention_bwd_reference(q, k, v, do, mask, m, l, heads, rate, 7),
            }
            if rate == 0.0:
                qh, kh, vh = (heads_of(t).detach().requires_grad_(True) for t in (q, k, v))
                o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep)
                fns["sdpa_fwd"] = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep)
                fns["sdpa_bwd"] = lambda: torch.autograd.grad(o, (qh, kh, vh), heads_of(do), retain_graph=True)
            for name, fn in fns.items():
                first = cuda_ms(fn, warmup=1, calls=1)  # a slow route gets fewer calls
                calls = max(2, min(20, int(200 / max(first, 1e-3))))
                row[f"{name}_ms"] = cuda_ms(fn, warmup=1, calls=calls)
                if name in ("fwd", "bwd"):
                    row[f"{name}_device_ms"] = device_ms(fn, calls)
            for which in ("fwd", "bwd"):
                row[f"{which}_bound_ms"], row[f"{which}_bound_by"] = bound_ms(B, T, H, heads, which == "bwd")
            print(json.dumps(row), flush=True)
            out.append(row)
            del fns
        del q, k, v, do
        torch.cuda.empty_cache()


def instruction_mix(_build) -> None:
    cuobjdump = shutil.which("cuobjdump") or str(Path(_build.find_nvcc()).with_name("cuobjdump"))
    for name in ("attention_fwd", "attention_bwd"):
        sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        counts: dict[str, collections.Counter] = {}
        function = None
        for line in sass.splitlines():
            header = re.search(r"Function : (\S+)", line)
            if header:
                function = header.group(1)
                counts[function] = collections.Counter()
                continue
            op = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_]+)", line)
            if op and function:
                counts[function][op.group(1)] += 1
        for function, mix in counts.items():
            if "mma_kernel" in function:
                top = ", ".join(f"{op} {n}" for op, n in mix.most_common(16))
                print(f"{name}_mma_kernel: {sum(mix.values())} instructions; {top}")


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--times", action="store_true", help="time the wrappers at TIMED instead")
    parser.add_argument("--out", default=None, help="with --times: write the readings here, a line each")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_attention: no CUDA device", file=sys.stderr)
        return 1
    from imagegenerator_tpu_torch.ops.kernels import _build, attention

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.build_all()
    if args.times:
        readings = []
        timed_shapes(attention, readings)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in readings))
        return 0
    shape_sweep(attention)
    instruction_mix(_build)
    return 0


if __name__ == "__main__":
    sys.exit(main())
