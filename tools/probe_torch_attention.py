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

Prints the card's name and power limit first, as every number needs them
beside it.
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SHAPES = ((256, 128), (512, 64), (1024, 32), (2048, 16), (128, 128), (64, 128))
HIDDEN, HEADS = 768, 12


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

    if not torch.cuda.is_available():
        print("probe_torch_attention: no CUDA device", file=sys.stderr)
        return 1
    from imagegenerator_tpu_torch.ops.kernels import _build, attention

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.build_all()
    shape_sweep(attention)
    instruction_mix(_build)
    return 0


if __name__ == "__main__":
    sys.exit(main())
