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
2. The static instruction mix of the tensor-core kernels (the
   ``mma.sync`` whole-head and tiled ones, the Hopper ``wgmma`` ones),
   from ``cuobjdump -sass`` on the built libraries: HGMMA (``wgmma``),
   UTMALDG (TMA tile loads), SYNCS (``mbarrier`` operations), HMMA
   (``mma.sync``), LDSM (``ldmatrix``), MUFU (``exp``, reciprocal), and
   the most frequent of the rest.

    python3 tools/probe_torch_attention.py --times [--out FILE]
    python3 tools/probe_torch_attention.py --mix    # the instruction mix alone
    python3 tools/probe_torch_attention.py --ablate [--out FILE]

``--ablate`` builds the Hopper forward (``attention_fwd_wgmma_kernel``)
again with parts of its work cut out, each variant in a copy of the
package under ``build/probe_ablate/`` (its source edited, then built by
its own ``nvcc``, all at once), and times each against the kernel as it
is at (256, 512, 768) with 12 heads, (256, 128, 768) with 24 and with 6,
rate 0 and 0.1, an all-kept mask: ``loads`` keeps only the copies and
the barriers (no product, no max, no exp, no P V), ``no_pass1`` drops
pass 1's products and max, ``no_exp`` the exp of pass 2, ``no_pv`` the
P V products. A variant's outputs are wrong by design; only its time is
read, to say which part of the work the kernel's time follows.

instead times the forward and backward wrappers at the shapes of
``TIMED`` (bf16, a ragged mask, dropout rate 0.1 and 0): CUDA events
around back-to-back calls, ``torch.profiler`` device time per call, the
plain versions, ``F.scaled_dot_product_attention`` and its autograd
backward at rate 0 (a yardstick; the port never calls it), the bound
(max of bytes over 3.35 TB/s and FLOPs over 989.4 TFLOP/s) and which route
the wrapper took (its counters read); where that is the Hopper route,
also the ``mma.sync`` tiled kernels at the same shape through the C
entry points' route argument (``tiled_*``). A shape the wrappers refuse
is reported as such. Each reading is printed and, with ``--out``,
written as one JSON object a line.

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
                attention.wgmma_launches = attention.wgmma_bwd_launches = 0
                _, m, l = attention.attention_fwd(q, k, v, mask, heads, rate, 7)
                attention.attention_bwd(q, k, v, do, mask, m, l, heads, rate, 7)
                torch.cuda.synchronize()
            except ValueError as e:
                row["refused"] = str(e)
                print(json.dumps(row), flush=True)
                out.append(row)
                continue
            row["route"], row["bwd_route"] = (
                "wgmma" if wgmma else "mma" if mma else "fma"
                for mma, wgmma in ((attention.mma_launches, attention.wgmma_launches),
                                   (attention.mma_bwd_launches, attention.wgmma_bwd_launches)))
            drop = attention._dropout_args(rate, 7)
            fns = {
                "fwd": lambda: attention.attention_fwd(q, k, v, mask, heads, rate, 7),
                "bwd": lambda: attention.attention_bwd(q, k, v, do, mask, m, l, heads, rate, 7),
                "plain_fwd": lambda: attention.attention_reference(q, k, v, mask, heads, rate, 7),
                "plain_bwd": lambda: attention.attention_bwd_reference(q, k, v, do, mask, m, l, heads, rate, 7),
            }
            if row["route"] == "wgmma":
                fns["tiled_fwd"] = lambda: attention._launch_fwd(q, k, v, mask, heads, drop, "mma")
                fns["tiled_bwd"] = lambda: attention._launch_bwd(q, k, v, do, mask, m, l, heads, drop, "mma")
            if rate == 0.0:
                qh, kh, vh = (heads_of(t).detach().requires_grad_(True) for t in (q, k, v))
                o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep)
                fns["sdpa_fwd"] = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep)
                fns["sdpa_bwd"] = lambda: torch.autograd.grad(o, (qh, kh, vh), heads_of(do), retain_graph=True)
            for name, fn in fns.items():
                first = cuda_ms(fn, warmup=1, calls=1)  # a slow route gets fewer calls
                calls = max(2, min(20, int(200 / max(first, 1e-3))))
                row[f"{name}_ms"] = cuda_ms(fn, warmup=1, calls=calls)
                if name in ("fwd", "bwd", "tiled_fwd", "tiled_bwd"):
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
            kernel = re.search(r"(?<=\d)attention_[a-z_]+?_(?:mma|tiled|wgmma)_kernel(?:I(?:Li\d+E)+E)?", function)
            if kernel:
                named = ", ".join(f"{op} {mix[op]}" for op in ("HGMMA", "UTMALDG", "SYNCS", "HMMA", "LDSM", "MUFU"))
                rest = ", ".join(f"{op} {n}" for op, n in mix.most_common(12) if op not in named)
                print(f"{name}: {kernel.group(0)}: {sum(mix.values())} instructions; {named}; {rest}")


# the edits of each ``--ablate`` variant to csrc/attention_fwd.cu, as
# (text, replacement) pairs; each text must be in the source as it is
_PASS1 = """      float s[kSlabs][kN / 8][4];
      scores(s);
      sm90::turn_pass(wg);
      const Columns cols = sm90::read_tile_bits(bits + 4 * stage, lane);
      sm90::bar_arrive_warp(empty + stage);
#pragma unroll
      for (int sl = 0; sl < kSlabs; ++sl) sm90::tile_row_max<kN>(s[sl], cols, scale, m0[sl], m1[sl]);"""
_NO_PASS1 = """      sm90::turn_wait(wg);
      sm90::turn_pass(wg);
      sm90::bar_arrive_warp(empty + stage);
      for (int sl = 0; sl < kSlabs; ++sl) m0[sl] = m1[sl] = 0.f;"""
_PASS2 = """      float s[kSlabs][kN / 8][4];
      scores(s);"""
_NO_PASS2 = """      float s[kSlabs][kN / 8][4];
      for (int sl = 0; sl < kSlabs; ++sl) sm90::zero(s[sl]);
      sm90::turn_wait(wg);"""
_EXP = ("      for (int sl = 0; sl < kSlabs; ++sl) sm90::tile_exp<kN>(s[sl], cols, sl2e, ml0[sl], ml1[sl], mb0[sl], "
        "mb1[sl]);\n")
_PV = "          sm90::Wgmma<kD>::rs(acc[sl], p[sl][k], L::template mnmajor<kN>(v_tiles + stage * kTile, k), 1);\n"
ABLATIONS = {
    "kernel": [],
    "loads": [(_PASS1, _NO_PASS1), (_PASS2, _NO_PASS2), (_EXP, ""), (_PV, "")],
    "no_pass1": [(_PASS1, _NO_PASS1)],
    "no_exp": [(_EXP, "")],
    "no_pv": [(_PV, "")],
}
ABLATE_SHAPES = ((256, 512, 768, 12), (256, 128, 768, 24), (256, 128, 768, 6))

_ABLATE_TIMER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from imagegenerator_tpu_torch.ops.kernels import attention
sys.path.insert(0, sys.argv[2])
from probe_torch_attention import ABLATE_SHAPES, cuda_ms
gen = torch.Generator(device="cuda").manual_seed(0)
for B, T, H, heads in ABLATE_SHAPES:
    q, k, v = (torch.randn((B, T, H), generator=gen, device="cuda").bfloat16() for _ in range(3))
    mask = torch.ones((B, T), dtype=torch.int32, device="cuda")
    for rate in (0.0, 0.1):
        drop = attention._dropout_args(rate, 7)
        ms = cuda_ms(lambda: attention._launch_fwd(q, k, v, mask, heads, drop, "wgmma"), warmup=3, calls=20)
        print(json.dumps({"shape": [B, T, H], "heads": heads, "rate": rate, "ms": ms}), flush=True)
"""


def ablate(out) -> None:
    """Build the Hopper forward's ablations side by side and time them
    (``--ablate``)."""
    import os

    root = Path(__file__).resolve().parents[1]
    work = root / "build" / "probe_ablate"
    source = (root / "imagegenerator_tpu_torch" / "csrc" / "attention_fwd.cu").read_text()
    builds = {}
    for name, edits in ABLATIONS.items():
        copy = work / name
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(root / "imagegenerator_tpu_torch", copy / "imagegenerator_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"--ablate {name}: the forward's source no longer has {old[:60]!r}")
            text = text.replace(old, new)
        (copy / "imagegenerator_tpu_torch" / "csrc" / "attention_fwd.cu").write_text(text)
        code = (f"import sys; sys.path.insert(0, {str(copy)!r}); "
                "from imagegenerator_tpu_torch.ops.kernels import _build; _build.library('attention_fwd')")
        builds[name] = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
    for name, proc in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"--ablate {name}: the build failed:\n{log[-4000:]}")
    for name in ABLATIONS:
        run = subprocess.run([sys.executable, "-c", _ABLATE_TIMER, str(work / name), str(Path(__file__).parent)],
                             capture_output=True, text=True, timeout=600, env=dict(os.environ))
        if run.returncode:
            raise SystemExit(f"--ablate {name}: the timing failed:\n{run.stderr[-4000:]}")
        for line in run.stdout.splitlines():
            row = {"variant": name, **json.loads(line)}
            print(json.dumps(row), flush=True)
            out.append(row)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--times", action="store_true", help="time the wrappers at TIMED instead")
    parser.add_argument("--out", default=None, help="with --times or --ablate: write the readings here, a line each")
    parser.add_argument("--mix", action="store_true", help="print the instruction mix alone")
    parser.add_argument("--ablate", action="store_true",
                        help="time the Hopper forward with parts of its work cut out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_torch_attention: no CUDA device", file=sys.stderr)
        return 1
    from imagegenerator_tpu_torch.ops.kernels import _build, attention

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.ablate:
        readings = []
        ablate(readings)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in readings))
        return 0
    _build.build_all()
    if args.mix:
        instruction_mix(_build)
        return 0
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
