#!/usr/bin/env python3
"""What a launch of the LayerNorm forward costs the host, piece by piece,
and how ``vq_argmin``'s time moves with its grid. Run on a CUDA card from
the repository root:

    python3 tools/probe_torch_launch.py

1. Builds ``csrc/layernorm_fwd.cu`` and ``csrc/vq_argmin.cu``, prints what
   ``ptxas`` says of each kernel, and holds both to their plain versions
   at the main paths' shapes and a few ragged ones (a short check, not
   ``chip_smoke.py``'s).
2. LayerNorm forward at (1024, 768) f32: host microseconds per call over a
   loop of 1000 calls between two synchronisations (the device needs about
   3 us a call, so the loop runs at the host's pace), for the wrapper, for
   ``F.layer_norm``, for the launch path this wrapper replaced (a Triton
   kernel of one program per row, kept in this file for the comparison
   alone, behind three ``torch.empty``, ``torch.cuda.device`` and the
   checks) and for each piece of either path on its own. Then the two
   kernels' device times by ``torch.profiler`` in turns, on one input that
   stays in L2 and on 24 inputs (72 MB) taken in turn, so that each launch
   reads from device memory.
3. ``vq_argmin`` at N = 64, 256, 512, 4096 (K 16384, d 256, f32) by CUDA
   events, beside ``(c2 - 2 x @ cb.T).argmin(-1)``, for several values of
   ``vq_argmin.TARGET_BLOCKS`` (the grid's size along K).
4. The instruction mix of the f32 ``vq_argmin`` kernel by ``cuobjdump
   -sass``: HMMA (tensor-core products) beside F2FP / FADD (the TF32
   split), LDS (fragment loads) and the rest, which is what competes
   with the products for the scheduler.

Prints the card's name and power limit first; every number is of that card.
"""

from __future__ import annotations

import collections
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from imagegenerator_tpu_torch.ops.kernels import _build, layernorm, vq_argmin  # noqa: E402

LN_SHAPE = (1024, 768)
CALLS = 1000


def host_us(fn, calls=CALLS, runs=5) -> float:
    """Median over ``runs`` of the host's microseconds per call of ``fn``
    in a loop of ``calls`` between two synchronisations."""
    for _ in range(20):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e6 / calls)
    return statistics.median(times)


def event_ms(fn, inner=20, runs=5) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_us(fn, calls=48) -> float:
    """Device microseconds per call of ``fn`` (one kernel a call) by
    ``torch.profiler``: the mean over the launches it recorded (it loses
    the first one or two of a trace)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        count = sum(e.count for e in events)
        if count:
            return sum(e.self_device_time_total for e in events) / count
    raise RuntimeError("torch.profiler recorded no kernel")


def triton_forward():
    """The forward this package launched before: one Triton program per
    row, the row in a block of ``next_pow2(D)``."""
    import triton
    import triton.language as tl

    @triton.jit
    def kernel(x_ptr, w_ptr, b_ptr, y_ptr, mean_ptr, rstd_ptr, d, eps, BLOCK_D: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        keep = cols < d
        x = tl.load(x_ptr + row * d + cols, mask=keep, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=0) / d
        xc = tl.where(keep, x - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / d
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(w_ptr + cols, mask=keep, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + cols, mask=keep, other=0.0).to(tl.float32)
        tl.store(y_ptr + row * d + cols, xc * rstd * w + b, mask=keep)
        tl.store(mean_ptr + row, mean)
        tl.store(rstd_ptr + row, rstd)

    return kernel


def check_kernels(gen) -> None:
    for name in ("layernorm_fwd", "vq_argmin"):
        _build.library(name)
        for line in _build.build_log(name).splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()[:150]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    for n, d, dtype in ((1024, 768, torch.float32), (1001, 768, torch.bfloat16), (5, 1000, torch.float32),
                        (33, 4100, torch.float16), (1, 8, torch.float32), (7, 1030, torch.bfloat16)):
        x = (torch.randn((n, d), generator=gen, device="cuda") * 3 + 0.5).to(dtype)
        w = 1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
        b = 0.1 * torch.randn((d,), generator=gen, device="cuda")
        got = layernorm.layernorm_fwd(x, w, b, 1e-12)
        torch.cuda.synchronize()
        want = layernorm.layernorm_reference(x, w, b, 1e-12)
        errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(got, want)]
        route = layernorm.fwd_route(d, dtype, w.dtype, b.dtype)
        print(f"  layernorm_fwd ({n}, {d}) {dtype} route {route}: max abs y {errs[0]:.2e}, "
              f"mean {errs[1]:.2e}, rstd {errs[2]:.2e} (relative {errs[2] / want[2].abs().max().item():.2e})")
        assert errs[0] < 1e-4 and errs[1] < 1e-5
    for n, k, d, dtype in ((64, 16384, 256, torch.float32), (512, 16384, 256, torch.float32),
                           (64, 16384, 256, torch.bfloat16), (1000, 1000, 256, torch.float32),
                           (37, 32, 8, torch.float32), (65, 65, 33, torch.float32),
                           (65, 300, 33, torch.bfloat16), (300, 5000, 1, torch.float32)):
        for kind in ("normal", "integer"):
            if kind == "normal":
                cb = torch.randn((k, d), generator=gen, device="cuda")
                x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
            else:
                cb = torch.randint(-2, 3, (k, d), generator=gen, device="cuda").float()
                x = torch.randint(-2, 3, (n, d), generator=gen, device="cuda").to(dtype)
            got = vq_argmin.vq_argmin(x, cb)
            again = vq_argmin.vq_argmin(x, cb)
            torch.cuda.synchronize()
            want = vq_argmin.vq_argmin_reference(x, cb)
            split = vq_argmin.vq_argmin_reference_3xtf32(x, cb)
            print(f"  vq_argmin ({n}, {k}, {d}) {dtype} {kind}: {(got != want).sum().item()} of {n} differ "
                  f"from the plain version, {(got != split).sum().item()} from the 3xTF32 plain version, "
                  f"{(got != again).sum().item()} from a second call")
            assert kind == "normal" or torch.equal(got, want)
            assert torch.equal(got, again)


def layernorm_pieces(gen) -> None:
    n, d = LN_SHAPE
    x = torch.randn(LN_SHAPE, generator=gen, device="cuda")
    w, b = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
    device = x.device
    y = torch.empty_like(x)
    mean = torch.empty((n, 1), device="cuda")
    rstd = torch.empty_like(mean)
    fn, raw_stream = layernorm._fwd_entry()
    triton_kernel = triton_forward()
    stats = torch.empty((2, n, 1), device="cuda")
    codes = layernorm.fwd_codes(x.dtype, w.dtype, b.dtype, "warp")

    def c_call(rows=n):
        return fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), stats.data_ptr(),
                  rows, d, 1e-12, codes, raw_stream(0))

    def triton_call():
        triton_kernel[(n,)](x, w, b, y, mean, rstd, d, 1e-12, BLOCK_D=1024, num_warps=4)

    def old_path():
        layernorm._check_cuda(x, w, b)
        y_ = torch.empty((n, d), dtype=torch.promote_types(x.dtype, w.dtype), device=device)
        mean_ = torch.empty((n, 1), dtype=torch.float32, device=device)
        rstd_ = torch.empty_like(mean_)
        with torch.cuda.device(device):
            triton_kernel[(n,)](x, w, b, y_, mean_, rstd_, d, 1e-12, BLOCK_D=1024, num_warps=4)
        return y_, mean_, rstd_

    def device_context():
        with torch.cuda.device(device):
            pass

    rows = [
        ("layernorm_fwd, the wrapper as it is", lambda: layernorm.layernorm_fwd(x, w, b, 1e-12)),
        ("F.layer_norm", lambda: F.layer_norm(x, (d,), w, b, 1e-12)),
        ("the replaced path: checks, 3 x empty, device context, Triton launch", old_path),
        ("  Triton launch alone, outputs given", triton_call),
        ("  C entry point through ctypes alone, outputs given", c_call),
        ("  the same with n = 0, which launches nothing: ctypes and the arguments", lambda: c_call(0)),
        ("  _check_cuda", lambda: layernorm._check_cuda(x, w, b)),
        ("  3 x torch.empty (y, mean, rstd)", lambda: (
            torch.empty((n, d), dtype=torch.float32, device=device),
            torch.empty((n, 1), dtype=torch.float32, device=device), torch.empty_like(mean))),
        ("  _fwd_outputs: empty_like(x) and x.new_empty((2, N, 1)) cut in two", lambda: layernorm._fwd_outputs(x, w)),
        ("  torch.empty (y) alone", lambda: torch.empty((n, d), dtype=torch.float32, device=device)),
        ("  torch.empty_like(x) alone", lambda: torch.empty_like(x)),
        ("  torch.empty((2, N, 1)).unbind(0)", lambda: torch.empty((2, n, 1), dtype=torch.float32, device=device).unbind(0)),
        ("  torch.empty((2, N, 1)) alone", lambda: torch.empty((2, n, 1), dtype=torch.float32, device=device)),
        ("  .unbind(0) of a (2, N, 1) tensor alone", lambda: stats.unbind(0)),
        ("  x.new_empty((2, N, 1)) alone (x's dtype)", lambda: x.new_empty((2, n, 1))),
        ("  2 x torch.empty_like of an (N, 1) f32 tensor", lambda: (torch.empty_like(mean), torch.empty_like(mean))),
        ("  torch.empty(2 * N, dtype=f32, device=device) alone", lambda: torch.empty(2 * n, dtype=torch.float32, device=device)),
        ("  with torch.cuda.device(x.device): pass", device_context),
        ("  torch.cuda.current_device()", torch.cuda.current_device),
        ("  torch.cuda.current_stream().cuda_stream", lambda: torch.cuda.current_stream().cuda_stream),
        ("  the raw stream handle", lambda: raw_stream(0)),
        ("  torch.promote_types", lambda: torch.promote_types(x.dtype, w.dtype)),
        ("  the route and codes (one cached lookup) and the three data_ptr()", lambda: layernorm._fwd_plan(
            d, x.dtype, w.dtype, b.dtype, (x.data_ptr() | w.data_ptr() | b.data_ptr()) % 16 == 0)),
        ("  fused_layernorm (autograd.Function, no grad needed)", lambda: layernorm.fused_layernorm(x, w, b, 1e-12)),
    ]
    for name, call in rows:
        print(f"  {host_us(call):8.2f} us  {name}")

    xs = [torch.randn(LN_SHAPE, generator=gen, device="cuda") for _ in range(24)]
    turn = iter(range(10**9))

    def rotated(launch):
        return lambda: launch(xs[next(turn) % 24])

    def c_launch(inp):
        fn(inp.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), stats.data_ptr(), n, d, 1e-12, codes,
           raw_stream(0))

    def triton_launch(inp):
        triton_kernel[(n,)](inp, w, b, y, mean, rstd, d, 1e-12, BLOCK_D=1024, num_warps=4)

    for where, wrap in (("one input, in L2", lambda launch: lambda: launch(x)),
                        ("24 inputs in turn, from device memory", rotated)):
        reads = [(device_us(wrap(c_launch)), device_us(wrap(triton_launch))) for _ in range(3)]
        print(f"  device us, {where}, CUDA kernel / the Triton kernel it replaced, in turns: "
              + ", ".join(f"{a:.2f} / {t:.2f}" for a, t in reads))


def argmin_grid(gen) -> None:
    K, d = 16384, 256
    cb = (torch.rand((K, d), generator=gen, device="cuda") * 2 - 1) / K
    c2 = (cb * cb).sum(dim=1)
    default = vq_argmin.TARGET_BLOCKS
    for N in (64, 256, 512, 4096):
        x = cb[torch.randint(0, K, (N,), generator=gen, device="cuda")] * 1.5
        lib = event_ms(lambda: (c2 - 2.0 * x @ cb.t()).argmin(dim=-1))
        times = []
        for target in (132, 264, 528, 1056, 2112):
            vq_argmin.TARGET_BLOCKS = target
            times.append(f"{target}: {event_ms(lambda: vq_argmin.vq_argmin(x, cb)):.4f} "
                         f"(k_splits {vq_argmin.k_splits(N, K)})")
        vq_argmin.TARGET_BLOCKS = default
        print(f"  vq_argmin N = {N}: library {lib:.4f} ms; kernel ms by TARGET_BLOCKS {', '.join(times)}")


def argmin_sass() -> None:
    cuobjdump = shutil.which("cuobjdump") or str(Path(_build.find_nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path("vq_argmin"))],
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
        if "IfLb1" in function:  # x f32, 16-byte copies: the main path's kernel
            top = ", ".join(f"{op} {n}" for op, n in mix.most_common(14))
            print(f"  vq_argmin_kernel<float, vec>: {sum(mix.values())} instructions; {top}")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_launch: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("1. build and check")
    check_kernels(gen)
    print(f"2. LayerNorm forward {LN_SHAPE} f32, host us per call over {CALLS} calls")
    layernorm_pieces(gen)
    print("3. vq_argmin against its grid")
    argmin_grid(gen)
    print("4. vq_argmin's instruction mix")
    argmin_sass()
    return 0


if __name__ == "__main__":
    sys.exit(main())
