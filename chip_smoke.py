#!/usr/bin/env python3
"""Drive the PyTorch port's v1 sampling path, its stage-1 training step
and its v2 VQGAN+CLIP generation on one CUDA card.

    python3 chip_smoke.py            # everything, as below
    python3 chip_smoke.py --only v2  # build, then phase 7 alone (--only train: phase 6)

Phases, one or a few lines each; any failure ends the run with a
non-zero exit and no result line:

0. device — needs CUDA; prints the card's name and power limit.
1. build — compiles each CUDA source with its own nvcc, all at once, and
   the Triton kernels (LayerNorm backward, scanline lerp); prints the
   seconds each took.
2. kernel vs plain — each kernel against its plain PyTorch version on the
   same inputs, in f32 (TF32 off) and bf16, at the shapes of the main
   paths and at ragged ones, with the tolerance of each output: the
   attention forward at rate 0 and with dropout (rate 0.1 and 0.5, and
   the kernel's keep-rate read back), the attention backward (dq, dk, dv,
   with and without mask, rate 0 and 0.1), the LayerNorm forward on both
   its routes (a warp per row at D = 768 and 1000, with a row count off
   the rows per block; a block per row at D = 4100) with one planted
   fault (the last row dropped), and the LayerNorm backward (dx, dgamma,
   dbeta). The attention wrappers' counts must show
   every bf16 case on the tensor-core kernels and every f32 case on the
   FMA kernels. Then the tensor-core pair alone, forward and backward in
   bf16 at (8, 128), (256, 128), (3, 40), (3, 77), (2, 1) x 768, with and
   without mask, at rate 0, 0.1 and 0.5, and one fault planted at run
   time for each (a forward whose padded key columns score as masked
   keys, a backward that ignores the mask), which the checks must catch.
3. sampling path — a full-width, seeded random-init stage-2 state written as
   ``Stage2/params.npz``, then the sampling CLI with ``--fused_attn
   --fused_ln`` for 4 captions x 2 samples (batch 8, 256 px, bf16);
   checks the 8 PNGs and that the kernels launched 12 and 25 times, once
   per attention and LayerNorm of the one BERT forward, all 12 attention
   launches on the tensor-core kernel.
4. kernels on vs off — the same state, batch and injected noise through
   ``Stage2System`` with both kernels and with neither, in f32 (TF32 off)
   and bf16; BERT's last hidden state (which the kernels feed directly)
   and the images of ``sample`` must agree.
5. times — medians of 5 runs after 2 warm-ups: ``sample`` at batch 8
   with kernels on and off, its three stages, and each kernel against its
   plain version (the attention forward and backward at (8, 128, 768)
   bf16 at rate 0.1 and 0, by CUDA events in turns and by profiler device
   time, beside the bound and the SDPA call); then ``torch.profiler``
   over 3 ``sample`` calls: device busy time per call and the kernels
   that take most of it. A profiler reading of 0 for a call that launched
   kernels fails the phase.
6. training path — ``Stage1System.train_step`` at full width, bf16, batch
   128 (caption batch doubled to 256, T = 128), with the stage-1 bench
   headline's BERT flags (fused attention, output-recovered GELU
   backward, 16-bit dropout draws) and ``fused_ln``, text dropout on:
   3 steps from a seeded random init with seeded tokens and uint8
   images; finite metrics, every module's parameters changed, and per
   step 12 attention forwards (with dropout) and 12 backwards, all on
   the tensor-core kernels, 25 LayerNorm forwards and 25 backwards. Then
   kernels on vs off: one step
   from the same state, batch and noise with text dropout off, in f32
   (TF32 off) and bf16; the 4 metrics, the generator step's encoder and
   projection gradients and the generator's updated BatchNorm statistics
   must agree. Then times: the step with kernels on and off (median of 5
   after 2 warm-ups, img/s), ``torch.profiler`` over one step, and the
   training kernels against their plain versions: the LayerNorm forward
   and backward at (32768, 768) f32, and the attention forward and
   backward at (256, 128, 768) bf16, rate 0.1 and 0, the tensor-core
   kernels, the FMA kernels launched directly on the same inputs and the
   plain versions in turns, beside the SDPA calls and the bounds.

7. v2 generation — the codebook argmin (CUDA C++) and the scanline lerp
   (Triton) against their plain versions: the argmin at (N, K, d) =
   (64, 16384, 256), (512, 16384, 256), (1000, 1000, 256), (37, 32, 8),
   x in f32 and bf16, a taming-style U(+-1/K) codebook and an N(0, 1)
   one (a differing index passes only if the two codes' scores differ by
   at most 1e-5 of the row's score range; such rows are counted), and
   with planted exact ties and one row per codebook tile, where the
   indices must be equal, also to the plain 3xTF32 version's; three calls
   back to back through one scratch buffer (a smaller after a larger),
   and a call on a second stream, which gets a buffer of its own; the
   lerp at (4096, 3, 128) -> 128 and -> 224,
   K = 200, decreasing coordinates, coordinates outside [0, K - 1] and a
   strided 4-D source (<= 1e-6), its backward against autograd through an
   f32 dense tent product (<= 2e-2 relative). One fault is planted per
   kernel at run time (an argmin blind to the last codebook tile, an
   argmin that finds its scratch buffer as a call that did not reset it
   would leave it, a lerp with f and 1 - f swapped) and the checks must
   catch it. Then the main
   path: a seeded random-init full-width VQGAN ``.ckpt`` (taming's
   names), its yaml and a ViT-B/32 CLIP ``state_dict`` are written to a
   temporary directory and the v2 CLI runs in-process on the card with
   the warp kernel on (6 iterations, then resumed to 9): the 128 x 128
   PNG and its ``comment`` chunk, finite losses, the launch counts (the
   argmin once per step and per synth, the lerp twice per step) and the
   resume are checked. Then the engine at batch 4 in f32 and bf16: one
   step from the same state and draws with the kernels on and off
   (losses and the gradient of z). Then times: 20-step windows at batch
   1 and 4 with the kernels on and off, each kernel against its plain
   version and the library call, and ``torch.profiler`` over 5 steps.

Then one JSON line of the kernels (each with its launches on its main
path, its error, its time, its plain version's, the least time the card
could take and, where one PyTorch call computes the same function, that
call's), the card's line from nvidia-smi, and last ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
CAPTIONS = "a red bus on a street|a snowy mountain|two dogs on a beach|a bowl of fruit"
SAMPLES_PER_CAPTION = 2
BATCH = 8
ATTN_SHAPE = (BATCH, 128, 768, 12)  # B, T, H, heads: BERT-base at seq_len 128
LN_SHAPE = (1024, 768)  # B * T rows of BERT-base hidden states
TRAIN_BATCH = 128
TRAIN_ATTN = (2 * TRAIN_BATCH, 128, 768, 12)  # the doubled caption batch
TRAIN_LN = (2 * TRAIN_BATCH * 128, 768)
TRAIN_STEPS = 3
TOL = {  # (rtol, atol)
    "attn_o_f32": (1e-4, 1e-5),
    "attn_o_bf16": (2e-2, 2e-2),
    "attn_ml": (1e-4, 0.0),
    # m on the tensor-core kernels: a score is a sum of 64 exact bf16
    # products, which the tensor cores add in another order than an f32
    # GEMM does, so two sound sums differ by about 1e-6 in absolute terms
    # (1.4e-6 read on an H100). A row that keeps one key has a maximum near
    # 0, where no relative limit holds; the FMA kernels add in the GEMM's
    # order and keep the relative limit alone.
    "attn_m_mma": (1e-4, 1e-5),
    "attn_grad_f32": (1e-3, 1e-4),
    "attn_grad_bf16": (2e-2, 2e-2),
    "ln_y": (1e-5, 1e-5),
    "ln_stats": (1e-5, 0.0),
    "ln_dx_f32": (1e-4, 1e-4),
    "ln_dx_bf16": (1e-2, 1e-2),
    "ln_dparam": (1e-4, 1e-3),
}
KEEP_TOL = 0.005  # |keep rate read back - (1 - rate)|
# Kernels on vs off over one training step, text dropout off. "metric"
# and "bn": max abs difference over max(1, the plain side's max abs) of
# the 4 metrics and of the generator's updated BatchNorm statistics;
# "grads": relative L2 difference of the encoder's and the projection's
# gradients for one fixed cotangent of tem over the step's text forward.
# On an H100 sound kernels read grads 8e-7 (f32) and 4.5e-3 (bf16);
# planted faults (backward without the mask, ds scaled 8x, LayerNorm
# dgamma dropped, dx without its xhat term) read 5.1e-2 to 1.8e13 in
# either; metrics 2.7e-6 / 2.9e-4, BN statistics 3e-8 / 8e-6.
STEP_TOL = {
    "f32": {"metric": 1e-3, "bn": 1e-4, "grads": 1e-4},
    "bf16": {"metric": 2e-2, "bn": 1e-3, "grads": 2e-2},
}
IMAGE_TOL = {"f32": 1e-3, "bf16": 0.1}
# max abs, BERT's last hidden state (values within about +-4). On an H100
# a sound run reads 3.3e-6 (f32) and 2.0e-2 (bf16); a planted fault (mask
# ignored, 1 / l dropped, LayerNorm mean left out) reads 0.26 to 5.8 in
# either.
HIDDEN_TOL = {"f32": 1e-3, "bf16": 0.1}


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(name, got, want, rtol, atol, quiet=False) -> float:
    """Max abs and rel error of ``got`` against ``want``; raises unless
    ``|got - want| <= atol + rtol * |want|`` everywhere. ``quiet`` logs
    only a failure."""
    import torch

    got, want = got.double(), want.double()
    err = (got - want).abs()
    rel = err / want.abs().clamp_min(1e-30)
    ok = bool(torch.isfinite(got).all()) and bool((err <= atol + rtol * want.abs()).all())
    max_abs, max_rel = err.max().item(), rel.max().item()
    if not (ok and quiet):
        log(f"  {name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
            f"(rtol={rtol:g}, atol={atol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_abs


def cuda_ms(fn, warmup=2, runs=5, inner=20) -> float:
    """Median over ``runs`` of the mean time of ``inner`` back-to-back
    calls, by CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
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


def wall_ms(fn, runs=5) -> float:
    """Median host-clock time of one CUDA-synchronised call."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


PROFILE_TRIES = 3


def profiled(fn, calls):
    """``torch.profiler`` over ``calls`` calls after a warm-up: the host
    ms per call and the CUDA kernel events (device time per kernel).

    The profiler loses the first kernel or kernels of a trace (19 of 20
    launches recorded is usual on an H100), and now and then all of a
    short trace. A trace that comes back with no kernel
    event or no device time, although ``fn`` launches kernels, is run
    again with the host's activities recorded too, at most
    ``PROFILE_TRIES`` times, and then the phase fails: a reading of 0 is
    never returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if attempt else [])
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / calls
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum(e.count for e in events) > 0 and sum(e.self_device_time_total for e in events) > 0:
            return host_ms, events
        log(f"  profiler trace {attempt + 1} of {PROFILE_TRIES} recorded no device time "
            f"({len(events)} kernel names); running it again")
    raise AssertionError(f"torch.profiler recorded no device time in {PROFILE_TRIES} traces "
                         "over calls that launch kernels")


def device_ms(fn, calls=10) -> float:
    """Device time per call of ``fn``, which launches the same kernels in
    every call: for each kernel name its mean recorded time, times its
    launches per call. The launches per call are the recorded count over
    ``calls``, rounded up, because the profiler loses a few launches at
    the start of a trace (fewer than ``calls`` of any one name);
    dividing the summed time by ``calls`` would read low by their share.
    Unlike ``cuda_ms`` this leaves out the gaps in which the card waits
    for the host to launch the next kernel. Every ``fn`` given here
    launches at least one kernel, so 0 is a lost reading and ``profiled``
    fails on it."""
    _, events = profiled(fn, calls)
    return sum(e.self_device_time_total / e.count * -(-e.count // calls) for e in events) / 1e3


def set_tf32(enabled: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


def attention_inputs(B, T, H, dtype, gen):
    import torch

    q, k, v = (torch.randn((B, T, H), generator=gen, device="cuda").to(dtype) for _ in range(3))
    mask = torch.ones((B, T), dtype=torch.int32, device="cuda")
    for b in range(1, B - 1):  # row 0 full, ragged rows, last row fully masked
        mask[b, T - (b * T) // B:] = 0
    mask[B - 1] = 0
    return q, k, v, mask


def phase_kernels(attention, layernorm, gen):
    import torch

    log("phase 2: kernel vs plain")
    errs = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        set_tf32(False)
        reset_counts(attention, layernorm)
        for B, T, H, nh in (ATTN_SHAPE, (3, 40, 768, 12)):
            q, k, v, mask = attention_inputs(B, T, H, dtype, gen)
            o, m, l = attention.attention_fwd(q, k, v, mask, nh)
            torch.cuda.synchronize()
            ro, rm, rl = attention.attention_reference(q, k, v, mask, nh)
            where = f"attention {tag} ({B}, {T}, {H})"
            err = compare(f"{where} o", o, ro, *TOL[f"attn_o_{tag}"])
            compare(f"{where} m", m, rm, *TOL["attn_ml" if tag == "f32" else "attn_m_mma"])
            compare(f"{where} l", l, rl, *TOL["attn_ml"])
            if (B, T, H, nh) == ATTN_SHAPE:
                errs["attention", tag] = err
        check_route(attention, layernorm, tag)
        # the main path's shape; a row count off the rows per block; a width
        # whose last pieces are ragged; a width only the block route takes
        for (n, d), route in ((LN_SHAPE, "warp"), ((1001, LN_SHAPE[1]), "warp"), ((37, 1000), "warp"),
                              ((37, 4100), "block")):
            x, scale, bias = layernorm_inputs(n, d, dtype, gen)
            if layernorm.fwd_route(d, dtype, scale.dtype, bias.dtype) != route:
                raise AssertionError(f"layernorm {tag} D = {d}: not the {route} route")
            err = check_layernorm_fwd(layernorm, f"layernorm {tag} ({n}, {d}) {route} route",
                                      layernorm.layernorm_fwd, x, scale, bias)
            if (n, d) == LN_SHAPE:
                errs["layernorm", tag] = err
        if layernorm.launches != 4:
            raise AssertionError(f"{tag}: {layernorm.launches} LayerNorm forward launches counted, 4 made")

    def last_row_dropped(x, scale, bias, eps):
        # a grid one row short: the last row of the last block is never written
        y, mean, rstd = layernorm.layernorm_fwd(x[:-1], scale, bias, eps)
        return tuple(torch.cat([t, torch.zeros_like(t[:1])]) for t in (y, mean, rstd))

    x, scale, bias = layernorm_inputs(1001, LN_SHAPE[1], torch.float32, gen)
    must_catch("a LayerNorm forward that drops the last row of its last block",
               lambda: check_layernorm_fwd(layernorm, "layernorm f32 (1001, 768), last row dropped",
                                           last_row_dropped, x, scale, bias))
    return errs


def layernorm_inputs(n, d, dtype, gen):
    import torch

    x = (torch.randn((n, d), generator=gen, device="cuda") * 3 + 0.5).to(dtype)
    scale = 1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
    bias = 0.1 * torch.randn((d,), generator=gen, device="cuda")
    return x, scale, bias


def check_layernorm_fwd(layernorm, where, fwd, x, scale, bias) -> float:
    """``fwd(x, scale, bias, eps)`` against the plain forward; returns the
    max abs error of y."""
    import torch

    y, mean, rstd = fwd(x, scale, bias, 1e-12)
    torch.cuda.synchronize()
    ry, rmean, rrstd = layernorm.layernorm_reference(x, scale, bias, 1e-12)
    err = compare(f"{where} y", y, ry, *TOL["ln_y"])
    compare(f"{where} mean", mean, rmean, *TOL["ln_stats"])
    compare(f"{where} rstd", rstd, rrstd, *TOL["ln_stats"])
    return err


def phase_train_kernels(attention, layernorm, gen):
    """Phase 2, training kernels: the attention forward with dropout, the
    attention backward and the LayerNorm backward against their plain
    versions at the training path's shapes and ragged ones."""
    import torch

    log("phase 2: training kernels vs plain")
    errs = {}
    B, T, H, nh = TRAIN_ATTN
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        set_tf32(False)
        reset_counts(attention, layernorm)
        q, k, v, mask = attention_inputs(B, T, H, dtype, gen)
        for rate in (0.1, 0.5):
            o, m, l = attention.attention_fwd(q, k, v, mask, nh, rate, SEED + 7)
            torch.cuda.synchronize()
            ro, rm, rl = attention.attention_reference(q, k, v, mask, nh, rate, SEED + 7)
            where = f"attention dropout {rate} {tag} {TRAIN_ATTN[:3]}"
            errs["attention_dropout", tag, rate] = compare(f"{where} o", o, ro, *TOL[f"attn_o_{tag}"])
            compare(f"{where} m", m, rm, *TOL["attn_ml" if tag == "f32" else "attn_m_mma"])
            compare(f"{where} l", l, rl, *TOL["attn_ml"])
            del o, m, l, ro, rm, rl
        del q, k, v
        for (b, t), with_mask, rate in (
            ((B, T), True, 0.1), ((B, T), False, 0.1), ((B, T), True, 0.0), ((B, T), False, 0.0),
            ((3, 77), True, 0.1), ((3, 77), False, 0.0), ((2, 1), True, 0.1), ((2, 1), False, 0.0),
        ):
            q, k, v, mask = attention_inputs(b, t, H, dtype, gen)
            mask = mask if with_mask else None
            do = torch.randn((b, t, H), generator=gen, device="cuda").to(dtype)
            _, m, l = attention.attention_reference(q, k, v, mask, nh, rate, SEED + 8)
            got = attention.attention_bwd(q, k, v, do, mask, m, l, nh, rate, SEED + 8)
            torch.cuda.synchronize()
            want = attention.attention_bwd_reference(q, k, v, do, mask, m, l, nh, rate, SEED + 8)
            where = f"attention bwd {tag} ({b}, {t}, {H}) mask {'on' if with_mask else 'off'} rate {rate}"
            err = max(compare(f"{where} {name}", g, w, *TOL[f"attn_grad_{tag}"])
                      for name, g, w in zip(("dq", "dk", "dv"), got, want))
            errs["attention_bwd", tag, b, with_mask, rate] = err
            del q, k, v, do, got, want
        check_route(attention, layernorm, tag)
        n, d = TRAIN_LN
        x = (torch.randn((n, d), generator=gen, device="cuda") * 3 + 0.5).to(dtype)
        dy = torch.randn((n, d), generator=gen, device="cuda")
        scale = 1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
        bias = 0.1 * torch.randn((d,), generator=gen, device="cuda")
        _, mean, rstd = layernorm.layernorm_reference(x, scale, bias, 1e-12)
        got = layernorm.layernorm_bwd(dy, x, mean, rstd, scale, bias)
        torch.cuda.synchronize()
        want = layernorm.layernorm_bwd_reference(dy, x, mean, rstd, scale, bias)
        where = f"layernorm bwd x {tag} ({n}, {d})"
        errs["layernorm_bwd", tag] = compare(f"{where} dx", got[0], want[0], *TOL[f"ln_dx_{tag}"])
        compare(f"{where} dgamma", got[1], want[1], *TOL["ln_dparam"])
        compare(f"{where} dbeta", got[2], want[2], *TOL["ln_dparam"])
        del x, dy, got, want
    # the kernel's own keep rate: q = k = 0 makes p = 1 everywhere, so with
    # v = 1 each output is inv_keep * (kept keys) / T
    zeros = torch.zeros((B, T, H), device="cuda")
    for rate in (0.1, 0.5):
        o = attention.attention_fwd(zeros, zeros, torch.ones_like(zeros), None, nh, rate, SEED + 9)[0]
        kept = o.double().mean().item() * (1.0 - rate)
        ok = abs(kept - (1.0 - rate)) <= KEEP_TOL
        log(f"  attention dropout {rate}: keep rate read back {kept:.5f} "
            f"(want {1 - rate:.3f} +- {KEEP_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("attention dropout keeps the wrong share")
    return errs


def check_route(attention, layernorm, tag: str) -> None:
    """Since the counts were last set to 0: every bf16 attention launch
    (all at T <= 128) went to the tensor-core kernels, every f32 one to
    the FMA kernels."""
    counts = read_counts(attention, layernorm)
    total = counts["attention"] + counts["attention_bwd"]
    mma = counts["attention_mma"] + counts["attention_bwd_mma"]
    if total == 0 or mma != (total if tag == "bf16" else 0):
        raise AssertionError(f"{tag}: {mma} of {total} attention launches went to the tensor cores")
    log(f"  {tag}: {mma} of {total} attention launches on the tensor-core kernels")


MMA_CASES = (ATTN_SHAPE[:2], TRAIN_ATTN[:2], (3, 40), (3, 77), (2, 1))
MMA_RATES = (0.0, 0.1, 0.5)


def check_attention_bf16(attention, where, case, nh, rate, fwd=None, bwd=None):
    """One bf16 case through ``fwd`` and ``bwd`` (the wrappers unless
    given) against the plain versions; one line for the case. Returns
    the max abs errors of o and of the gradients."""
    import torch

    q, k, v, do, mask = case
    fwd, bwd = fwd or attention.attention_fwd, bwd or attention.attention_bwd
    o, m, l = fwd(q, k, v, mask, nh, rate, SEED + 11)
    torch.cuda.synchronize()
    ro, rm, rl = attention.attention_reference(q, k, v, mask, nh, rate, SEED + 11)
    err_o = compare(f"{where} o", o, ro, *TOL["attn_o_bf16"], quiet=True)
    err_m = compare(f"{where} m", m, rm, *TOL["attn_m_mma"], quiet=True)
    err_l = compare(f"{where} l", l, rl, *TOL["attn_ml"], quiet=True)
    got = bwd(q, k, v, do, mask, rm, rl, nh, rate, SEED + 11)
    torch.cuda.synchronize()
    want = attention.attention_bwd_reference(q, k, v, do, mask, rm, rl, nh, rate, SEED + 11)
    err_g = max(compare(f"{where} {name}", g, w, *TOL["attn_grad_bf16"], quiet=True)
                for name, g, w in zip(("dq", "dk", "dv"), got, want))
    log(f"  {where}: max abs o {err_o:.3e}, m {err_m:.3e}, l {err_l:.3e}, dq/dk/dv {err_g:.3e} ok")
    return err_o, err_g


def phase_mma_kernels(attention, layernorm, gen):
    """Phase 2, the tensor-core attention kernels: forward and backward in
    bf16 against the plain versions at the two main paths' shapes and at
    ragged ones, with and without the mask, at rate 0, 0.1 and 0.5; then
    one planted fault each, which the same checks must catch."""
    import torch
    import torch.nn.functional as F

    log("phase 2: tensor-core attention kernels vs plain, bf16 "
        f"(rtol, atol: o {TOL['attn_o_bf16']}, m {TOL['attn_m_mma']}, l {TOL['attn_ml']}, "
        f"grads {TOL['attn_grad_bf16']})")
    set_tf32(False)
    H, nh = ATTN_SHAPE[2:]
    reset_counts(attention, layernorm)

    def case(B, T, with_mask):
        q, k, v, mask = attention_inputs(B, T, H, torch.bfloat16, gen)
        do = torch.randn((B, T, H), generator=gen, device="cuda").bfloat16()
        return q, k, v, do, mask if with_mask else None

    for B, T in MMA_CASES:
        for with_mask in (True, False):
            inputs = case(B, T, with_mask)
            for rate in MMA_RATES:
                check_attention_bf16(
                    attention, f"attention bf16 ({B}, {T}, {H}) mask {'on' if with_mask else 'off'} rate {rate}",
                    inputs, nh, rate)
            del inputs
    check_route(attention, layernorm, "bf16")

    def padded_as_masked(q, k, v, mask, nh, rate, seed):
        # T = 77 brought to 80 by the caller, the three padded keys marked
        # as masked (-3e7) where the kernel scores its own padding -inf: a
        # fully masked row then sums l over 80 keys
        pad = -q.shape[1] % 16
        qp, kp, vp = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        o, m, l = attention.attention_fwd(qp, kp, vp, F.pad(mask, (0, pad)), nh, rate, seed)
        T = q.shape[1]
        return o[:, :T], m[..., :T], l[..., :T]

    def without_mask(q, k, v, do, mask, m, l, nh, rate, seed):
        return attention.attention_bwd(q, k, v, do, None, m, l, nh, rate, seed)

    inputs = case(3, 77, True)
    must_catch("a forward that scores its padded key columns as masked keys",
               lambda: check_attention_bf16(attention, "attention bf16 (3, 77), padding as masked",
                                            inputs, nh, 0.0, fwd=padded_as_masked))
    must_catch("a backward that ignores the key mask",
               lambda: check_attention_bf16(attention, "attention bf16 (3, 77), backward without mask",
                                            inputs, nh, 0.1, bwd=without_mask))


def png_size(path: Path) -> tuple[int, int]:
    data = path.read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")


def phase_main_path(tmp: Path, attention, layernorm):
    import numpy as np
    import torch

    from imagegenerator_tpu_torch import convert
    from imagegenerator_tpu_torch.train import sample
    from imagegenerator_tpu_torch.train.stage2 import Stage2Config, Stage2System

    log("phase 3: main path")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    system = Stage2System(Stage2Config(), device="cuda", generator=gen)
    flat = convert.stage2_to_numpy(system)
    del system
    (tmp / "ckpt" / "Stage2").mkdir(parents=True)
    np.savez(tmp / "ckpt" / "Stage2" / "params.npz", **flat)
    n_params = sum(a.size for a in flat.values())
    log(f"  full-width random init, {n_params / 1e6:.1f}M parameters, "
        f"written in {time.perf_counter() - t0:.1f} s")

    out = tmp / "samples"
    reset_counts(attention, layernorm)
    t0 = time.perf_counter()
    sample.main([
        "--stage", "2", "--checkpoint_dir", str(tmp / "ckpt"),
        "--caption", CAPTIONS, "-n", str(SAMPLES_PER_CAPTION),
        "-o", str(out), "--seed", str(SEED), "--fused_attn", "--fused_ln",
    ])
    torch.cuda.synchronize()
    launches = read_counts(attention, layernorm)
    log(f"  sample CLI: {time.perf_counter() - t0:.1f} s (load, first calls, "
        f"PNG writes); launches {launches}")
    pngs = sorted(out.glob("sample_*.png"))
    sizes = {png_size(p) for p in pngs}
    if len(pngs) != BATCH or sizes != {(256, 256)}:
        raise AssertionError(f"expected {BATCH} PNGs of 256x256, got {len(pngs)} {sizes}")
    # one BERT-base forward, no dropout, no backward
    # and all 12 attention forwards on the tensor-core kernel
    want = {"attention": 12, "attention_mma": 12, "attention_dropout": 0, "attention_bwd": 0,
            "attention_bwd_mma": 0, "layernorm": 25, "layernorm_bwd": 0}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    log(f"  {len(pngs)} PNGs at 256x256; launches match one BERT forward {want}")
    return flat, launches


def reset_counts(attention, layernorm) -> None:
    attention.launches = attention.dropout_launches = attention.bwd_launches = 0
    attention.mma_launches = attention.mma_bwd_launches = 0
    layernorm.launches = layernorm.bwd_launches = 0


def read_counts(attention, layernorm) -> dict:
    return {
        "attention": attention.launches, "attention_mma": attention.mma_launches,
        "attention_dropout": attention.dropout_launches,
        "attention_bwd": attention.bwd_launches, "attention_bwd_mma": attention.mma_bwd_launches,
        "layernorm": layernorm.launches, "layernorm_bwd": layernorm.bwd_launches,
    }


def path_inputs(gen):
    import torch

    from imagegenerator_tpu_torch.data.tokenizer import HashTokenizer

    texts = [c for c in CAPTIONS.split("|") for _ in range(SAMPLES_PER_CAPTION)]
    batch = {k: torch.from_numpy(v).cuda() for k, v in HashTokenizer()(texts).items()}
    noise = {
        "ca1_eps": torch.randn((BATCH, 128), generator=gen, device="cuda"),
        "z": torch.randn((BATCH, 100), generator=gen, device="cuda"),
        "ca2_eps": torch.randn((BATCH, 128), generator=gen, device="cuda"),
    }
    return batch, noise


def systems(flat, dtype):
    import dataclasses

    from imagegenerator_tpu_torch import convert
    from imagegenerator_tpu_torch.models.bert import BertConfig
    from imagegenerator_tpu_torch.train.stage2 import Stage2Config

    on = Stage2Config(compute_dtype=dtype, bert=BertConfig(fused_attention=True, fused_ln=True))
    off = dataclasses.replace(on, bert=BertConfig())
    return convert.stage2_from_numpy(flat, on, "cuda"), convert.stage2_from_numpy(flat, off, "cuda")


def on_off_outputs(flat, batch, noise, dtype):
    """BERT's last hidden state and the images of ``sample``, f32, from
    the systems with both kernels (first of each pair) and with neither."""
    import torch

    set_tf32(False)
    on, off = systems(flat, dtype)
    with torch.no_grad():
        hidden = [s.encoder(batch["input_ids"], batch["attention_mask"]).float() for s in (on, off)]
    images = [s.sample(batch, noise=noise).float() for s in (on, off)]
    torch.cuda.synchronize()
    return {"hidden": hidden, "image": images}


def phase_on_off(flat, batch, noise):
    import torch

    log("phase 4: whole path, kernels on vs off")
    shapes = {"hidden": (BATCH, 128, 768), "image": (BATCH, 256, 256, 3)}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        outs = on_off_outputs(flat, batch, noise, dtype)
        for what, limit in (("hidden", HIDDEN_TOL[tag]), ("image", IMAGE_TOL[tag])):
            a, b = outs[what]
            if a.shape != shapes[what] or not bool(torch.isfinite(a).all() & torch.isfinite(b).all()):
                raise AssertionError(f"{tag} {what}: {tuple(a.shape)} not finite or mis-shaped")
            diff = (a - b).abs().max().item()
            ok = diff <= limit
            log(f"  {tag}: max abs {what} diff {diff:.3e} (limit {limit:g}) "
                f"{'ok' if ok else 'FAIL'}; range [{a.min().item():.3f}, {a.max().item():.3f}]")
            if not ok:
                raise AssertionError(f"{tag}: kernels-on {what} disagrees with kernels-off")


def phase_times(flat, batch, noise, attention, layernorm, gen, card):
    import torch

    log(f"phase 5: times on {card} (medians of 5 after 2 warm-ups)")
    set_tf32(False)
    on, off = systems(flat, torch.bfloat16)
    samples = {"on": [], "off": []}
    for _ in range(2):
        on.sample(batch, noise=noise)
        off.sample(batch, noise=noise)
    for i in range(5):
        for tag in (("off", "on") if i % 2 == 0 else ("on", "off")):
            system = on if tag == "on" else off
            samples[tag].append(wall_ms(lambda: system.sample(batch, noise=noise), runs=1))
    sample_ms = {k: statistics.median(v) for k, v in samples.items()}
    for tag in ("on", "off"):
        ms = sample_ms[tag]
        log(f"  sample batch {BATCH} bf16 kernels {tag}: {ms:.3f} ms, "
            f"{BATCH / ms * 1e3:.1f} img/s [{card}]")
    ids, mask = batch["input_ids"], batch["attention_mask"]
    for tag, system in (("on", on), ("off", off)):
        with torch.no_grad():
            tem = system.embed_texts(ids, mask)
            fake_64 = system._frozen_64_from_tem(tem, None, noise)
            c_hat2 = system.con_augment_2(tem, eps=noise["ca2_eps"])[0]
            stages = {
                "text encode": lambda: system.embed_texts(ids, mask),
                "CA1 + G1": lambda: system._frozen_64_from_tem(tem, None, noise),
                "G2": lambda: system.gen_2(fake_64, c_hat2),
            }
            times = ", ".join(f"{name} {wall_ms(fn):.3f} ms" for name, fn in stages.items())
        log(f"  stages, kernels {tag}: {times}")
        host_ms, events = profiled(lambda: system.sample(batch, noise=noise), calls=3)
        busy = sum(e.self_device_time_total for e in events) / 1e3 / 3
        log(f"  profiled, kernels {tag}: host {host_ms:.3f} ms/call, device busy "
            f"{busy:.3f} ms/call ({100 * busy / host_ms:.1f}%), "
            f"{sum(e.count for e in events) // 3} kernels/call")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]:
            log(f"    {e.self_device_time_total / 3e3:8.3f} ms {e.count // 3:4d}x {e.key[:90]}")
    del on, off

    B, T, H, nh = ATTN_SHAPE
    q, k, v, mask = attention_inputs(B, T, H, torch.bfloat16, gen)
    x = torch.randn(LN_SHAPE, generator=gen, device="cuda")
    scale = torch.ones(LN_SHAPE[1], device="cuda")
    bias = torch.zeros(LN_SHAPE[1], device="cuda")
    # the sampling path runs the forward at rate 0: that row goes into the
    # kernels' line; the others are this shape's times for the record
    timed = {"attention": kernel_entry(attention_times(attention, ATTN_SHAPE, gen, card, fma=False)["fwd", 0.0])}
    kernel = lambda: layernorm.layernorm_fwd(x, scale, bias, 1e-12)
    plain = lambda: layernorm.layernorm_reference(x, scale, bias, 1e-12)
    timed["layernorm"] = {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain)}
    dev = (device_ms(kernel), device_ms(plain))
    log(f"  layernorm f32 {LN_SHAPE}: kernel {timed['layernorm']['ms']:.4f} ms, plain "
        f"{timed['layernorm']['plain_ms']:.4f} ms back to back by CUDA events; device time "
        f"kernel {dev[0]:.4f} ms, plain {dev[1]:.4f} ms (inputs L2-resident) [{card}]")
    lib = library_times((q, k, v, mask, None, nh), (x, scale, bias, None))
    timed["attention"].update(library_ms=lib["sdpa_fwd"])
    # the kernel and the library call in turns, each timed the same way (both
    # are launch cost at this shape): the medians go into the kernels' line
    ln_lib = lambda: torch.nn.functional.layer_norm(x, x.shape[-1:], scale, bias, 1e-12)
    turns = [(cuda_ms(kernel), cuda_ms(ln_lib)) for _ in range(3)]
    log(f"  layernorm f32 {LN_SHAPE} back to back, kernel / F.layer_norm in turns: "
        + ", ".join(f"{a:.4f} / {b:.4f}" for a, b in turns) + f" ms [{card}]")
    timed["layernorm"].update(ms=statistics.median(a for a, _ in turns),
                              library_ms=statistics.median(b for _, b in turns),
                              **layernorm_bound(LN_SHAPE, False))
    for name in ("attention", "layernorm"):
        t = timed[name]
        log(f"  {name}: library call {t['library_ms']:.4f} ms "
            f"({'F.scaled_dot_product_attention' if name == 'attention' else 'F.layer_norm'}), "
            f"bound {t['bound_ms']:.5f} ms by {t['bound_by']} [{card}]")
    # 24 inputs of 3 MB (72 MB, more than the 50 MB L2) taken in turn, so
    # each launch reads its input from device memory
    xs = [torch.randn(LN_SHAPE, generator=gen, device="cuda") for _ in range(24)]
    turn = iter(range(10**9))
    ln_hbm = device_ms(lambda: layernorm.layernorm_fwd(xs[next(turn) % 24], scale, bias, 1e-12), calls=24)
    moved = 2 * x.numel() * x.element_size() + 2 * LN_SHAPE[0] * 4
    log(f"  layernorm f32 {LN_SHAPE}, inputs rotated through 72 MB: device time "
        f"{ln_hbm:.4f} ms, {moved / ln_hbm / 1e9:.3f} TB/s [{card}]")
    return sample_ms, timed["attention"], timed["layernorm"]


def attention_times(attention, shape, gen, card, fma: bool) -> dict:
    """Times of the bf16 attention forward and backward at ``shape``, at
    rate 0.1 and 0: the tensor-core kernels through the wrappers, the plain
    versions and, with ``fma``, the FMA kernels launched directly on the
    same inputs; each by CUDA events back to back, taken in turns (plain,
    tensor cores, FMA, FMA, tensor cores, plain; the mean of a route's two
    turns is kept), and by profiler device time. Returns
    ``{(which, rate): {"ms", "device_ms", "plain_ms", "plain_device_ms",
    "fma_ms", "fma_device_ms", "bound_ms", "bound_by"}}``."""
    import torch

    B, T, H, nh = shape
    q, k, v, mask = attention_inputs(B, T, H, torch.bfloat16, gen)
    do = torch.randn((B, T, H), generator=gen, device="cuda").bfloat16()
    inner, calls = (20, 10) if B <= 32 else (5, 5)
    out = {}
    for rate in (0.1, 0.0):
        drop = attention._dropout_args(rate, SEED)
        _, m, l = attention.attention_fwd(q, k, v, mask, nh, rate, SEED)
        routes = {
            "fwd": {"mma": lambda: attention.attention_fwd(q, k, v, mask, nh, rate, SEED),
                    "fma": lambda: attention._launch_fwd(q, k, v, mask, nh, drop, "fma"),
                    "plain": lambda: attention.attention_reference(q, k, v, mask, nh, rate, SEED)},
            "bwd": {"mma": lambda: attention.attention_bwd(q, k, v, do, mask, m, l, nh, rate, SEED),
                    "fma": lambda: attention._launch_bwd(q, k, v, do, mask, m, l, nh, drop, "fma"),
                    "plain": lambda: attention.attention_bwd_reference(q, k, v, do, mask, m, l, nh, rate, SEED)},
        }
        for which, fns in routes.items():
            turns = ["plain", "mma"] + (["fma", "fma"] if fma else []) + ["mma", "plain"]
            read = {name: [] for name in turns}
            for name in turns:
                read[name].append(cuda_ms(fns[name], inner=inner))
            dev = {name: device_ms(fns[name], calls=calls) for name in read}
            t = {"ms": statistics.mean(read["mma"]), "device_ms": dev["mma"],
                 "plain_ms": statistics.mean(read["plain"]), "plain_device_ms": dev["plain"],
                 "fma_ms": statistics.mean(read["fma"]) if fma else None,
                 "fma_device_ms": dev.get("fma"), **attention_bound(shape, 2, which == "bwd")}
            out[which, rate] = t
            turns_of = lambda name: " and ".join(f"{x:.4f}" for x in read[name])
            log(f"  attention {which} bf16 {shape[:3]} rate {rate}: tensor-core kernel {t['ms']:.4f} ms "
                f"back to back by CUDA events (turns {turns_of('mma')}), device {t['device_ms']:.4f} ms; "
                f"plain {t['plain_ms']:.4f} ms ({turns_of('plain')}), device {t['plain_device_ms']:.4f} ms; "
                + (f"FMA kernel {t['fma_ms']:.4f} ms ({turns_of('fma')}), device {t['fma_device_ms']:.4f} ms; "
                   if fma else "")
                + f"bound {t['bound_ms']:.5f} ms by {t['bound_by']}, device / bound "
                f"{t['device_ms'] / t['bound_ms']:.2f} [{card}]")
    return out


def kernel_entry(t: dict) -> dict:
    """The timing keys of a kernel's entry in the ``kernels`` line."""
    return {key: t[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")}


def train_config(fused: bool, text_dropout: bool, dtype):
    """Full-width ``Stage1Config`` with the stage-1 bench headline's BERT
    flags; ``fused`` turns both kernels on (with ``fused_ln``)."""
    from imagegenerator_tpu_torch.models.bert import BertConfig
    from imagegenerator_tpu_torch.train.stage1 import Stage1Config

    bert = BertConfig(fused_attention=fused, fused_ln=fused, gelu_output_bwd=True, dropout_bits=16)
    return Stage1Config(compute_dtype=dtype, bert=bert, text_dropout=text_dropout)


def train_batch(cfg, gen):
    """Seeded tokens with ragged padding and uint8 64 px images."""
    import torch

    B, T = TRAIN_BATCH, cfg.seq_len
    lengths = torch.randint(8, T + 1, (B,), generator=gen, device="cuda")
    return {
        "input_ids": torch.randint(1, cfg.bert.vocab_size, (B, T), generator=gen, device="cuda",
                                   dtype=torch.int32),
        "attention_mask": (torch.arange(T, device="cuda")[None, :] < lengths[:, None]).int(),
        "image": torch.randint(0, 256, (B, cfg.resolution, cfg.resolution, 3), generator=gen,
                               device="cuda", dtype=torch.uint8),
    }


def train_noise(cfg, gen):
    import torch

    B, n = TRAIN_BATCH, cfg.n_critic
    return {
        "perm": torch.randperm(B, generator=gen, device="cuda"),
        "ca_eps": torch.randn((n, B, cfg.c_dim), generator=gen, device="cuda"),
        "z": torch.randn((n, B, cfg.z_dim), generator=gen, device="cuda"),
        "gp_eps": torch.rand((n, B, 1, 1, 1), generator=gen, device="cuda"),
    }


def text_grads(system, batch, perm, cot) -> dict:
    """The encoder's and projection's gradients of ``sum(tem * cot)``
    over the step's text forward (the doubled caption batch, dropout
    off), each module's flattened into one vector."""
    import torch

    ids, mask = batch["input_ids"], batch["attention_mask"]
    tem = system.encode_text(torch.cat([ids, ids[perm]]), torch.cat([mask, mask[perm]]))
    params = {m: list(getattr(system, m).parameters()) for m in ("encoder", "projection")}
    grads = iter(torch.autograd.grad((tem.float() * cot).sum(), params["encoder"] + params["projection"]))
    return {m: torch.cat([next(grads).flatten() for _ in ps]) for m, ps in params.items()}


def train_system(cfg, state):
    from imagegenerator_tpu_torch.train.stage1 import Stage1System

    system = Stage1System(cfg, device="meta")
    system.load_state_dict({k: v.clone() for k, v in state.items()}, assign=True)
    return system


def phase_train(attention, layernorm, gen, card):
    import torch

    from imagegenerator_tpu_torch.train.stage1 import MODULES, Stage1System

    log(f"phase 6: training path, batch {TRAIN_BATCH}, bf16")
    set_tf32(False)
    cfg = train_config(True, True, torch.bfloat16)
    t0 = time.perf_counter()
    system = Stage1System(cfg, device="cuda", generator=gen)
    init = {k: v.clone() for k, v in system.state_dict().items()}
    batch = train_batch(cfg, gen)
    host = torch.Generator().manual_seed(SEED)
    n_params = sum(p.numel() for p in system.parameters())
    log(f"  full-width random init, {n_params / 1e6:.1f}M parameters, "
        f"{time.perf_counter() - t0:.1f} s")
    per_step = {"attention": 12, "attention_mma": 12, "attention_dropout": 12, "attention_bwd": 12,
                "attention_bwd_mma": 12, "layernorm": 25, "layernorm_bwd": 25}
    totals = dict.fromkeys(per_step, 0)
    for i in range(TRAIN_STEPS):
        reset_counts(attention, layernorm)
        t0 = time.perf_counter()
        metrics = system.train_step(batch, generator=gen, host_generator=host)
        torch.cuda.synchronize()
        counts = read_counts(attention, layernorm)
        values = {k: v.item() for k, v in metrics.items()}
        log(f"  step {i + 1}: {time.perf_counter() - t0:.2f} s, "
            + ", ".join(f"{k} {v:.5g}" for k, v in values.items()) + f"; launches {counts}")
        if counts != per_step:
            raise AssertionError(f"step {i + 1}: kernel launches {counts}, expected {per_step}")
        if not all(map(torch.isfinite, metrics.values())):
            raise AssertionError(f"step {i + 1}: metrics not finite")
        for k in totals:
            totals[k] += counts[k]
    after = system.state_dict()
    for module in MODULES:
        if not any(not torch.equal(after[k], v) for k, v in init.items()
                   if k.startswith(module + ".")):
            raise AssertionError(f"{module}: no parameter changed in {TRAIN_STEPS} steps")
    log(f"  every module's parameters changed; launches over {TRAIN_STEPS} steps {totals}")
    state = {k: v.clone() for k, v in system.state_dict().items()}
    del system, init, after

    log("phase 6: one step, kernels on vs off (text dropout off)")
    noise = train_noise(cfg, gen)
    cot = torch.randn((2 * TRAIN_BATCH, cfg.tem_size), generator=gen, device="cuda")
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        set_tf32(False)
        on = train_system(train_config(True, False, dtype), state)
        off = train_system(train_config(False, False, dtype), state)
        # from the same state: before the step, which moves each side's
        # parameters by its own (ill-conditioned) generator-step gradients
        grads_on, grads_off = text_grads(on, batch, noise["perm"], cot), text_grads(off, batch, noise["perm"], cot)
        m_on, m_off = on.train_step(batch, noise=noise), off.train_step(batch, noise=noise)
        torch.cuda.synchronize()
        for module in ("encoder", "projection"):
            got = torch.cat([p.grad.flatten().double() for p in getattr(on, module).parameters()])
            want = torch.cat([p.grad.flatten().double() for p in getattr(off, module).parameters()])
            log(f"  {tag} generator-step {module} grads: relative L2 difference "
                f"{((got - want).norm() / want.norm()).item():.3e} (reported, not held: "
                f"ill-conditioned through the KL term's 2 / sigma)")
        readings = {f"metric {k}": ("metric", m_on[k], m_off[k]) for k in m_on}
        stats = [(b, off.generator.get_buffer(n)) for n, b in on.generator.named_buffers()]
        readings["generator BN stats"] = ("bn", torch.cat([a.flatten() for a, _ in stats]),
                                          torch.cat([b.flatten() for _, b in stats]))
        for module in grads_on:
            readings[f"{module} grads, fixed tem cotangent"] = ("grads", grads_on[module], grads_off[module])
        for what, (kind, a, b) in readings.items():
            a, b = a.double(), b.double()
            if not bool(torch.isfinite(a).all() & torch.isfinite(b).all()):
                raise AssertionError(f"{tag} {what}: not finite")
            if kind == "grads":
                rel, how = ((a - b).norm() / b.norm()).item(), "relative L2 difference"
            else:
                rel = (a - b).abs().max().item() / max(1.0, b.abs().max().item())
                how = "max abs diff / max(1, max abs)"
            limit = STEP_TOL[tag][kind]
            ok = rel <= limit
            log(f"  {tag} {what}: {how} {rel:.3e} (limit {limit:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tag}: kernels-on {what} disagrees with kernels-off")
        del on, off

    log(f"phase 6: times on {card} (medians of 5 after 2 warm-ups)")
    set_tf32(False)
    systems = {"on": train_system(train_config(True, True, torch.bfloat16), state),
               "off": train_system(train_config(False, True, torch.bfloat16), state)}
    gens = {k: (torch.Generator(device="cuda").manual_seed(1), torch.Generator().manual_seed(2))
            for k in systems}

    def step(tag):
        return systems[tag].train_step(batch, generator=gens[tag][0], host_generator=gens[tag][1])

    for _ in range(2):
        step("on")
        step("off")
    samples = {"on": [], "off": []}
    for i in range(5):
        for tag in (("off", "on") if i % 2 == 0 else ("on", "off")):
            samples[tag].append(wall_ms(lambda: step(tag), runs=1))
    step_ms = {k: statistics.median(v) for k, v in samples.items()}
    for tag in ("on", "off"):
        log(f"  train_step batch {TRAIN_BATCH} bf16 kernels {tag}: {step_ms[tag]:.3f} ms, "
            f"{TRAIN_BATCH / step_ms[tag] * 1e3:.1f} img/s (steps {', '.join(f'{t:.1f}' for t in samples[tag])}) "
            f"[{card}]")
    for tag in ("on", "off"):
        host_ms, events = profiled(lambda: step(tag), calls=1)
        busy = sum(e.self_device_time_total for e in events) / 1e3
        log(f"  profiled step, kernels {tag}: host {host_ms:.3f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / host_ms:.1f}%), {sum(e.count for e in events)} kernels")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x {e.key[:90]}")
    del systems, state

    at = attention_times(attention, TRAIN_ATTN, gen, card, fma=True)
    timed = {"attention_fwd_dropout": kernel_entry(at["fwd", 0.1]),
             "attention_bwd": kernel_entry(at["bwd", 0.1])}
    for which in ("fwd", "bwd"):
        t = at[which, 0.1]
        log(f"  attention {which} bf16 {TRAIN_ATTN[:3]} rate 0.1, tensor-core kernel over FMA kernel: "
            f"device {t['device_ms'] / t['fma_device_ms']:.3f}, back to back {t['ms'] / t['fma_ms']:.3f} [{card}]")
    n, d = TRAIN_LN
    x = torch.randn((n, d), generator=gen, device="cuda")
    dy = torch.randn((n, d), generator=gen, device="cuda")
    scale = torch.ones(d, device="cuda")
    _, mean, rstd = layernorm.layernorm_fwd(x, scale, scale, 1e-12)
    fwd = {"kernel": lambda: layernorm.layernorm_fwd(x, scale, scale, 1e-12),
           "plain": lambda: layernorm.layernorm_reference(x, scale, scale, 1e-12)}
    fwd_ms = {k: cuda_ms(f, inner=5) for k, f in fwd.items()}
    fwd_dev = {k: device_ms(f, calls=5) for k, f in fwd.items()}
    fwd_bound = layernorm_bound(TRAIN_LN, False)
    log(f"  layernorm_fwd f32 {TRAIN_LN}: kernel {fwd_ms['kernel']:.4f} ms, plain {fwd_ms['plain']:.4f} ms "
        f"back to back by CUDA events; device time kernel {fwd_dev['kernel']:.4f} ms, plain "
        f"{fwd_dev['plain']:.4f} ms; bound {fwd_bound['bound_ms']:.5f} ms by {fwd_bound['bound_by']}, "
        f"device / bound {fwd_dev['kernel'] / fwd_bound['bound_ms']:.2f} [{card}]")
    kernel = lambda: layernorm.layernorm_bwd(dy, x, mean, rstd, scale, scale)
    plain = lambda: layernorm.layernorm_bwd_reference(dy, x, mean, rstd, scale, scale)
    timed["layernorm_bwd"] = {"ms": cuda_ms(kernel, inner=5), "plain_ms": cuda_ms(plain, inner=5)}
    dev = (device_ms(kernel, calls=5), device_ms(plain, calls=5))
    log(f"  layernorm_bwd f32 {TRAIN_LN}: kernel {timed['layernorm_bwd']['ms']:.4f} ms, plain "
        f"{timed['layernorm_bwd']['plain_ms']:.4f} ms back to back by CUDA events; device time "
        f"kernel {dev[0]:.4f} ms, plain {dev[1]:.4f} ms [{card}]")
    # the library calls compute the functions at rate 0: none draws the
    # package's counter-hash dropout, so they stand beside the kernels'
    # rate-0 times and the two dropout rows of the kernels' line have none
    B, T, H, nh = TRAIN_ATTN
    q, k, v, mask = attention_inputs(B, T, H, torch.bfloat16, gen)
    do = torch.randn((B, T, H), generator=gen, device="cuda").bfloat16()
    lib = library_times((q, k, v, mask, do, nh), (x, scale, scale, dy))
    log(f"  at rate 0, bf16 {TRAIN_ATTN[:3]}: attention_fwd kernel {at['fwd', 0.0]['ms']:.4f} ms, "
        f"F.scaled_dot_product_attention {lib['sdpa_fwd']:.4f} ms; attention_bwd kernel "
        f"{at['bwd', 0.0]['ms']:.4f} ms, its autograd backward {lib['sdpa_bwd']:.4f} ms [{card}]")
    log(f"  layernorm f32 {TRAIN_LN}: F.layer_norm {lib['ln_fwd']:.4f} ms, its autograd backward "
        f"{lib['ln_bwd']:.4f} ms [{card}]")
    timed["attention_fwd_dropout"].update(library_ms=None)
    timed["attention_bwd"].update(library_ms=None)
    timed["layernorm_bwd"].update(library_ms=lib["ln_bwd"], **layernorm_bound(TRAIN_LN, True))
    for name, t in timed.items():
        log(f"  {name}: bound {t['bound_ms']:.5f} ms by {t['bound_by']} [{card}]")
    return totals, timed


# ------------------------------------------------------------------ v2

V2_ARGS = ["-p", "a watercolor fox|stormy sea:0.5", "-se", "3", "-sd", str(SEED)]
V2_ITERS, V2_RESUMED_ITERS, V2_EVERY = 6, 9, 3
V2_IMAGE = 128
VQ_SHAPE = (64, 16384, 256)  # N, K, d on the main path: an 8 x 8 latent, the ImageNet f16 codebook
VQ_TIMED_N = (64, 256, 512, 4096)
LERP_SHAPE = (32 * 128, 3, 128, 128)  # S, C, K, O: 32 cutouts of 128 scanlines, 128 px
V2_WINDOW = 20
ARGMIN_GAP = 1e-5  # of the row's score range, between the kernel's code and the plain version's
LERP_TOL = (0.0, 1e-6)
LERP_BWD_TOL = (2e-2, 2e-2)  # the bf16 rounding of the weights and the cotangent
# kernels on vs off over one v2 step from the same state and draws:
# relative L2 of the losses and of the gradient of z
V2_STEP_TOL = {"f32": 1e-4, "bf16": 2e-2}
# the warp through the scanline kernel against the dense form, which
# rounds weights and pixels to bf16: cutouts max abs, and relative L2 of
# the image gradient of sum(cutouts ** 2) (each image pixel sums over its
# 32 cutouts, so no absolute limit fits) and of the step's losses
WARP_TOL = {"cuts": 2e-2, "grad": 2e-2, "losses": 2e-2}
PEAK = {"bytes": 3.35e12, "f32": 67e12, "tf32": 494e12, "bf16": 989e12}  # the card's published peaks


def bound(moved: float, operations: float, unit: str) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the memory
    rate and the operations over the peak rate of ``unit``."""
    by_bytes, by_ops = moved / PEAK["bytes"], operations / PEAK[unit]
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def attention_bound(shape, itemsize, backward: bool) -> dict:
    B, T, H, nh = shape
    tensors = 7 if backward else 4  # q, k, v, o | q, k, v, do, dq, dk, dv
    moved = tensors * B * T * H * itemsize + B * T * 4 + 2 * B * nh * T * 4  # + mask, m, l
    products = 5 if backward else 2  # (T, T) products of width H / heads per head
    return bound(moved, products * 2 * B * T * T * H, "bf16" if itemsize == 2 else "f32")


def layernorm_bound(shape, backward: bool) -> dict:
    n, d = shape
    moved = (3 if backward else 2) * n * d * 4 + 2 * n * 4 + (3 if backward else 2) * d * 4
    return bound(moved, (12 if backward else 8) * n * d, "f32")


def sdpa_inputs(q, k, v, mask, nh):
    B, T, H = q.shape
    heads = [t.reshape(B, T, nh, H // nh).transpose(1, 2) for t in (q, k, v)]
    return heads, mask[:, None, None, :].bool()


def library_times(attention_case, ln_case) -> dict:
    """The one PyTorch call that computes each v1 kernel's function, at
    the kernel's timed shape: ``scaled_dot_product_attention`` (rate 0)
    and its autograd backward, ``F.layer_norm`` and its backward. Timed
    here, used nowhere in the port."""
    import torch
    import torch.nn.functional as F

    q, k, v, mask, do, nh = attention_case
    (qh, kh, vh), keep = sdpa_inputs(q, k, v, mask, nh)
    out = {"sdpa_fwd": cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep), inner=5)}
    if do is not None:
        leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
        o = F.scaled_dot_product_attention(*leaves, attn_mask=keep)
        doh = do.reshape(o.shape[0], o.shape[2], nh, -1).transpose(1, 2)
        out["sdpa_bwd"] = cuda_ms(lambda: torch.autograd.grad(o, leaves, doh, retain_graph=True), inner=5)
    x, scale, bias, dy = ln_case
    out["ln_fwd"] = cuda_ms(lambda: F.layer_norm(x, x.shape[-1:], scale, bias, 1e-12), inner=5)
    if dy is not None:
        leaves = [t.detach().requires_grad_(True) for t in (x, scale, bias)]
        y = F.layer_norm(leaves[0], x.shape[-1:], leaves[1], leaves[2], 1e-12)
        out["ln_bwd"] = cuda_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True), inner=5)
    return out


def must_catch(what: str, check) -> None:
    """``check`` runs one of the phase's comparisons on a kernel with a
    planted fault; it has to raise."""
    try:
        check()
    except AssertionError as e:
        log(f"  planted fault, {what}: caught ({e})")
        return
    raise AssertionError(f"planted fault not caught: {what}")


def check_argmin(name, fn, x, cb, exact: bool):
    """``fn(x, cb)`` against the plain version. Indices must be equal;
    unless ``exact``, a differing index passes if the two codes' scores
    (in f64) differ by at most ``ARGMIN_GAP`` of the row's score range.
    Returns (largest such gap, rows that differ)."""
    import torch

    from imagegenerator_tpu_torch.ops.kernels import vq_argmin

    got = fn(x, cb)
    torch.cuda.synchronize()
    want = vq_argmin.vq_argmin_reference(x, cb)
    if got.dtype != torch.int32 or got.shape != want.shape:
        raise AssertionError(f"{name}: got {got.dtype} {tuple(got.shape)}")
    if int(got.min()) < 0 or int(got.max()) >= cb.shape[0]:
        raise AssertionError(f"{name}: index outside [0, {cb.shape[0]})")
    differ = (got != want).nonzero().flatten()
    gap = 0.0
    if differ.numel():
        if exact:
            raise AssertionError(f"{name}: {differ.numel()} indices differ where they must be equal")
        cbd = cb.double()
        scores = (cbd * cbd).sum(dim=1)[None, :] - 2.0 * x[differ].double() @ cbd.t()
        span = scores.amax(dim=1) - scores.amin(dim=1)
        a = scores.gather(1, got[differ].long()[:, None])[:, 0]
        b = scores.gather(1, want[differ].long()[:, None])[:, 0]
        gap = ((a - b).abs() / span).max().item()
    ok = gap <= ARGMIN_GAP
    log(f"  {name}: {differ.numel()} of {x.shape[0]} indices differ, largest score gap "
        f"{gap:.3e} of the row's range (limit {0 if exact else ARGMIN_GAP:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return gap, int(differ.numel())


def codebooks(K, d, gen):
    import torch

    return {"taming": (torch.rand((K, d), generator=gen, device="cuda") * 2 - 1) / K,
            "normal": torch.randn((K, d), generator=gen, device="cuda")}


def phase_v2_kernels(vq_argmin, scanline_lerp, gen):
    import torch

    log("phase 7: v2 kernels vs plain")
    set_tf32(False)
    errs = {}
    argmin = vq_argmin.vq_argmin
    for N, K, d in (VQ_SHAPE, (512, 16384, 256), (1000, 1000, 256), (37, 32, 8)):
        for kind, cb in codebooks(K, d, gen).items():
            rows = torch.randint(0, K, (N,), generator=gen, device="cuda")
            if kind == "taming":  # near a code, at the codebook's own scale
                x = cb[rows] + (torch.rand((N, d), generator=gen, device="cuda") - 0.5) / K
            else:
                x = torch.randn((N, d), generator=gen, device="cuda")
            for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                errs["vq", N, kind, tag] = check_argmin(
                    f"vq_argmin ({N}, {K}, {d}) {kind} codebook, x {tag}", argmin, x.to(dtype), cb, False)
    # torch's own argmin on the card: does it name the first minimum?
    ties = torch.zeros((4, 1024), device="cuda")
    log(f"  torch.argmin of an all-equal row on the card: {ties.argmin(dim=1).tolist()} "
        "(the plain version does not rely on it)")

    # planted exact ties: integer-valued codes and rows, so every score is
    # exact in f32 whatever the order of the sums; duplicate codes
    N, K, d = VQ_SHAPE
    cb = torch.randint(-2, 3, (K, d), generator=gen, device="cuda").float()
    cb[K - 1], cb[K // 2 + 3], cb[K - 70] = cb[5], cb[5], cb[64]
    x = torch.randint(-2, 3, (N, d), generator=gen, device="cuda").float()
    x[0], x[1], x[2] = cb[5], cb[64], cb[K - 1]
    check_argmin("vq_argmin planted ties, integer scores", argmin, x, cb, True)
    got = argmin(x[:3].contiguous(), cb).tolist()
    if got != [5, 64, 5]:
        raise AssertionError(f"planted ties went to {got}, not to the lowest indices [5, 64, 5]")
    log("  duplicated codes: the lowest index of each wins")
    # the kernel's arithmetic in plain PyTorch: equal where the sums are exact
    if not torch.equal(argmin(x, cb), vq_argmin.vq_argmin_reference_3xtf32(x, cb)):
        raise AssertionError("planted ties: the kernel and the plain 3xTF32 version differ")
    xn, cbn = torch.randn((512, d), generator=gen, device="cuda"), codebooks(K, d, gen)["normal"]
    differ = int((argmin(xn, cbn) != vq_argmin.vq_argmin_reference_3xtf32(xn, cbn)).sum())
    log(f"  against the plain 3xTF32 version: equal on the integer case; {differ} of 512 rows differ "
        "on a normal codebook (reported: the two add in different orders)")

    # one scratch buffer, calls in a row: each must find it as new. Larger,
    # then smaller, then two of one size with different rows.
    calls = [torch.randint(-2, 3, (rows, d), generator=gen, device="cuda").float()
             for rows in (300, N, N)]
    outs = [argmin(rows, cb) for rows in calls]  # launched back to back, read afterwards
    torch.cuda.synchronize()
    for i, (rows, out) in enumerate(zip(calls, outs)):
        check_argmin(f"vq_argmin call {i + 1} of 3 back to back through one scratch buffer, "
                     f"N = {rows.shape[0]}", lambda *_: out, rows, cb, True)
    here = torch.cuda.current_stream()
    held = dict(vq_argmin._scratch)
    side = torch.cuda.Stream()
    side.wait_stream(here)
    with torch.cuda.stream(side):
        check_argmin("vq_argmin on a second stream", argmin, calls[1], cb, True)
    here.wait_stream(side)
    new = [key for key in vq_argmin._scratch if key not in held]
    if len(new) != 1 or any(vq_argmin._scratch[new[0]][0].data_ptr() == keys.data_ptr()
                            for keys, _ in held.values()):
        raise AssertionError("the second stream did not get a scratch buffer of its own")
    log(f"  scratch buffers: {len(held)} before, the second stream added its own")

    def scratch_not_reset(x, c):
        # what a call that skipped its reset would leave: a row's key still
        # holding an earlier minimum (here the least key there is)
        keys, _ = vq_argmin.scratch_for(x.device.index, here.cuda_stream, x.shape[0])
        keys[: x.shape[0]] = 0
        return argmin(x, c)

    must_catch("an argmin whose scratch buffer was not reset by the call before",
               lambda: check_argmin("vq_argmin, scratch not reset", scratch_not_reset, calls[1], cb, True))
    check_argmin("vq_argmin, the call after that one", argmin, calls[2], cb, True)

    # one row copied from each 64-code tile, the last included
    cb = codebooks(K, d, gen)["normal"]
    picks = torch.arange(0, K, 64, device="cuda") + torch.randint(0, 64, (K // 64,), generator=gen, device="cuda")

    def every_tile(fn):
        rows = cb[picks].contiguous()
        check_argmin("vq_argmin, one row per codebook tile", fn, rows, cb, True)
        if not torch.equal(fn(rows, cb).long(), picks):
            raise AssertionError("a row copied from the codebook did not find its own code")

    every_tile(argmin)
    must_catch("an argmin that ignores the last codebook tile",
               lambda: every_tile(lambda x, c: argmin(x, c[: K - 64].contiguous())))

    # ------------------------------------------------------ scanline lerp
    fwd = scanline_lerp.scanline_lerp_fwd

    def check_lerp(name, fn, src4, coords):
        got = fn(src4, coords)
        torch.cuda.synchronize()
        S, C, K_ = src4.shape[0] * src4.shape[1], src4.shape[2], src4.shape[3]
        want = scanline_lerp.scanline_lerp_reference(src4.reshape(S, C, K_), coords)
        return compare(name, got.reshape(want.shape), want, *LERP_TOL)

    def monotone(S, O, K_, decreasing=False):
        steps = torch.rand((S, O), generator=gen, device="cuda") * (1.1 * K_ / O) + 0.45 * K_ / O
        coords = steps.cumsum(dim=1) - 2.0  # starts below 0 and ends past K - 1: border clamp
        return coords.flip(1).contiguous() if decreasing else coords

    S, C, K_, O = LERP_SHAPE
    src = torch.rand((1, S, C, K_), generator=gen, device="cuda")
    errs["lerp"] = check_lerp(f"scanline_lerp ({S}, {C}, {K_}) -> {O}", fwd, src, monotone(S, O, K_))
    check_lerp(f"scanline_lerp ({S}, {C}, {K_}) -> 224", fwd, src, monotone(S, 224, K_))
    check_lerp(f"scanline_lerp ({S}, {C}, {K_}) -> {O}, decreasing", fwd, src, monotone(S, O, K_, True))
    wild = torch.rand((S, O), generator=gen, device="cuda") * (K_ + 40) - 20
    check_lerp(f"scanline_lerp ({S}, {C}, {K_}) -> {O}, coords in [-20, K + 20)", fwd, src, wild)
    wide = torch.rand((1, 600, C, 200), generator=gen, device="cuda")
    check_lerp("scanline_lerp (600, 3, 200) -> 224, K = 200", fwd, wide, monotone(600, 224, 200))
    check_lerp("scanline_lerp (7, 1, 2) -> 5, K = 2", fwd,
               torch.rand((1, 7, 1, 2), generator=gen, device="cuda"), monotone(7, 5, 2))
    nhwc = torch.rand((S // K_, K_, K_, C), generator=gen, device="cuda")  # N, H, W, C
    check_lerp("scanline_lerp on the NHWC image's (N, H, C, W) view", fwd,
               nhwc.permute(0, 1, 3, 2), monotone(S, O, K_))
    check_lerp("scanline_lerp on pass 2's (N, Wo, C, H) view", fwd,
               nhwc.permute(0, 2, 3, 1).contiguous().permute(0, 3, 2, 1), monotone(S, O, K_))

    def swapped(src4, coords):  # f and 1 - f swapped: the position mirrored in its cell
        k = src4.shape[-1]
        s = coords.clamp(0.0, k - 1.0)
        k0 = s.long().clamp_max(k - 2).float()
        return fwd(src4, 2.0 * k0 + 1.0 - s)

    must_catch("a lerp with f and 1 - f swapped",
               lambda: check_lerp("scanline_lerp, swapped", swapped, src, monotone(S, O, K_)))

    # backward: the autograd.Function against autograd through the f32
    # dense tent product
    coords = monotone(S, O, K_)
    leaf = src[0].clone().requires_grad_(True)
    cot = torch.randn((S, C, O), generator=gen, device="cuda")
    (got,) = torch.autograd.grad(scanline_lerp.scanline_lerp(leaf, coords), leaf, cot)
    dense_leaf = src[0].clone().requires_grad_(True)
    dense = torch.einsum("sok,sck->sco", scanline_lerp.tent_weights(coords, K_), dense_leaf)
    (want,) = torch.autograd.grad(dense, dense_leaf, cot)
    errs["lerp_bwd"] = compare(f"scanline_lerp backward ({S}, {C}, {K_}) <- {O}", got, want, *LERP_BWD_TOL)
    return errs


def v2_configs():
    from imagegenerator_tpu_torch.v2.clip import CLIPConfig
    from imagegenerator_tpu_torch.v2.vqgan import VQGANConfig

    return VQGANConfig.imagenet_f16_16384(), CLIPConfig.vit_b32()


def v2_counts(vq_argmin, scanline_lerp) -> dict:
    return {"vq_argmin": vq_argmin.launches, "scanline_lerp": scanline_lerp.launches}


def png_comment(path: Path) -> str:
    data = path.read_bytes()
    at = data.find(b"tEXtcomment\0")
    if at < 0:
        raise AssertionError(f"{path} has no comment chunk")
    length = int.from_bytes(data[at - 4:at], "big")
    return data[at + 12:at + 4 + length].decode("latin-1")


def run_v2_cli(args) -> str:
    """The v2 CLI in-process with the warp kernel on; returns what it
    printed (and prints it)."""
    import contextlib
    import io
    import os

    from imagegenerator_tpu_torch.v2 import generate

    before = os.environ.get("IMAGEGEN_WARP_KERNEL")
    os.environ["IMAGEGEN_WARP_KERNEL"] = "1"
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            generate.main(args)
    finally:
        if before is None:
            del os.environ["IMAGEGEN_WARP_KERNEL"]
        else:
            os.environ["IMAGEGEN_WARP_KERNEL"] = before
        for line in printed.getvalue().splitlines():
            log(f"    | {line}")
    return printed.getvalue()


def phase_v2_path(tmp: Path, vq_argmin, scanline_lerp):
    import math

    import numpy as np
    import torch

    from imagegenerator_tpu_torch.v2.clip import CLIP
    from imagegenerator_tpu_torch.v2.vqgan import VQModel

    log("phase 7: v2 main path, full width")
    t0 = time.perf_counter()
    vq_cfg, clip_cfg = v2_configs()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    vq_state = VQModel(vq_cfg, device="cuda", generator=gen).state_dict()
    clip_state = CLIP(clip_cfg, device="cuda", generator=gen).state_dict()
    ckpt, conf, clip_pt = tmp / "vqgan.ckpt", tmp / "vqgan.yaml", tmp / "ViT-B-32.pt"
    torch.save({"state_dict": {k: v.cpu() for k, v in vq_state.items()}}, ckpt)
    torch.save({k: v.cpu() for k, v in clip_state.items()}, clip_pt)
    # taming's yaml; written in JSON's syntax, which is YAML too
    conf.write_text(json.dumps({"model": {
        "target": "taming.models.vqgan.VQModel",
        "params": {"embed_dim": vq_cfg.embed_dim, "n_embed": vq_cfg.n_embed, "ddconfig": {
            "z_channels": vq_cfg.z_channels, "resolution": vq_cfg.resolution,
            "in_channels": vq_cfg.in_channels, "out_ch": vq_cfg.out_ch, "ch": vq_cfg.ch,
            "ch_mult": list(vq_cfg.ch_mult), "num_res_blocks": vq_cfg.num_res_blocks,
            "attn_resolutions": list(vq_cfg.attn_resolutions), "dropout": vq_cfg.dropout}}}}))
    n_vq = sum(v.numel() for v in vq_state.values())
    n_clip = sum(v.numel() for v in clip_state.values())
    log(f"  full-width random init: VQGAN {n_vq / 1e6:.1f}M, CLIP ViT-B/32 {n_clip / 1e6:.1f}M "
        f"parameters, written in {time.perf_counter() - t0:.1f} s")

    out, state_path = tmp / "out.png", tmp / "s.npz"
    files = ["-conf", str(conf), "-ckpt", str(ckpt), "--clip_checkpoint", str(clip_pt),
             "-o", str(out), "--state", str(state_path)]
    launches = None
    for iters, start in ((V2_ITERS, 0), (V2_RESUMED_ITERS, V2_ITERS)):
        vq_argmin.launches = scanline_lerp.launches = 0
        t0 = time.perf_counter()
        printed = run_v2_cli(V2_ARGS + ["-i", str(iters)] + files)
        torch.cuda.synchronize()
        counts = v2_counts(vq_argmin, scanline_lerp)
        log(f"  v2 CLI to iteration {iters}: {time.perf_counter() - t0:.1f} s; launches {counts}")
        if start and f"Resumed state at iteration {start}" not in printed:
            raise AssertionError(f"the second run did not resume at {start}")
        steps = iters - start
        checkins = steps // V2_EVERY + 1  # each: one synth and one loss evaluation
        want = {"vq_argmin": steps + 2 * checkins, "scanline_lerp": 2 * steps + 2 * checkins}
        if counts != want:
            raise AssertionError(f"kernel launches {counts}, expected {want}")
        losses = [float(l.split("loss: ")[1].split(",")[0]) for l in printed.splitlines()
                  if l.startswith(("i: ", "progress: "))]
        if len(losses) != checkins + steps // V2_EVERY or not all(map(math.isfinite, losses)):
            raise AssertionError(f"losses {losses}")
        if png_size(out) != (V2_IMAGE, V2_IMAGE):
            raise AssertionError(f"{out}: size {png_size(out)}")
        comment = png_comment(out)
        if comment != str(V2_ARGS[1].split("|")):
            raise AssertionError(f"comment chunk {comment!r}")
        with np.load(state_path) as d:
            saved = (int(d["iters_done"]), int(d["leaf_4"]), tuple(d["leaf_0"].shape))
        if saved != (iters, iters, (1, 8, 8, 256)):
            raise AssertionError(f"state file {saved}")
        log(f"  {V2_IMAGE}x{V2_IMAGE} PNG, comment {comment!r}; {len(losses)} finite losses; "
            f"state file at iteration {iters}; launches match {want}")
        launches = launches or counts
    return launches, vq_state, clip_state


def v2_engine(vq_state, clip_state, dtype, kernels: bool, vq_kernel=None):
    """A full-width engine sharing the given weights. ``kernels``: the
    warp through the scanline kernel and the argmin kernel, or the dense
    warp and the plain argmin; ``vq_kernel`` overrides the argmin's."""
    from imagegenerator_tpu_torch.v2.engine import GenerateEngine

    vq_on = kernels if vq_kernel is None else vq_kernel
    return GenerateEngine(*v2_configs(), vq_state, clip_state, compute_dtype=dtype,
                          warp_kernel=kernels, use_vq_kernel=None if vq_on else False, device="cuda")


def v2_prompts(engine, batch):
    import numpy as np
    import torch

    from imagegenerator_tpu_torch.v2.engine import pad_prompt_specs
    from imagegenerator_tpu_torch.v2.prompts import split_prompt
    from imagegenerator_tpu_torch.v2.tokenizer import open_tokenizer

    sets = [["a watercolor fox", "stormy sea:0.5"], ["a red bus on a street"],
            ["two dogs on a beach:1:0.2", "blurry:-0.5"], ["a bowl of fruit"]][:batch]
    tokenizer = open_tokenizer(None, engine.clip_config.context_length, engine.clip_config.vocab_size)
    rows = []
    for prompts in sets:
        parts = [split_prompt(p) for p in prompts]
        embeds = [engine.encode_text(tokenizer([text])).cpu().numpy()[0] for text, _, _ in parts]
        rows.append(pad_prompt_specs(embeds, [w for _, w, _ in parts], [s for _, _, s in parts], pad_to=2))
    return tuple(torch.from_numpy(np.concatenate([r[k] for r in rows])).cuda() for k in range(3))


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-300)).item()


def phase_v2_on_off(vq_state, clip_state, gen):
    import torch

    log("phase 7: one v2 step at batch 4, kernels on vs off")
    set_tf32(False)
    for dtype, tag in ((None, "f32"), (torch.bfloat16, "bf16")):
        engines = {
            "kernels on": v2_engine(vq_state, clip_state, dtype, True),
            "plain argmin": v2_engine(vq_state, clip_state, dtype, True, vq_kernel=False),
            "dense warp": v2_engine(vq_state, clip_state, dtype, False, vq_kernel=True),
        }
        on = engines["kernels on"]
        z0 = on.random_token_latent(gen, 4, 8, 8)
        prompts = v2_prompts(on, 4)
        draws = on.make_cutouts.draw(gen, on.image_shape(z0), "cuda")
        runs = {}
        for name, engine in engines.items():
            state, losses = engine.step(engine.init_state(z0), None, *prompts, draws=draws)
            torch.cuda.synchronize()
            runs[name] = (losses, state.z.grad.clone())
            if not bool(torch.isfinite(losses).all() & torch.isfinite(state.z.grad).all()):
                raise AssertionError(f"{tag} {name}: losses or gradient not finite")
        log(f"  {tag} losses, kernels on: {[round(v, 5) for v in runs['kernels on'][0].flatten().tolist()]}; "
            f"|grad z| {runs['kernels on'][1].norm().item():.4e}")
        for name, limit in (("plain argmin", V2_STEP_TOL[tag]), ("dense warp", None)):
            d_loss = rel_l2(runs["kernels on"][0], runs[name][0])
            d_grad = rel_l2(runs["kernels on"][1], runs[name][1])
            limits = (limit, limit) if limit else (WARP_TOL["losses"], None)
            ok = d_loss <= limits[0] and (limits[1] is None or d_grad <= limits[1])
            log(f"  {tag} kernels on vs {name}: losses relative L2 {d_loss:.3e} (limit {limits[0]:g}), "
                f"grad z relative L2 {d_grad:.3e} "
                f"({'limit %g' % limits[1] if limits[1] else 'reported, not held'}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tag}: kernels on disagree with {name}")
        if dtype is None:
            # the cutouts themselves, and their image gradient, at the
            # tolerance the JAX package holds its two warps to
            image = on.synth(z0).detach()
            outs = {}
            for name in ("kernels on", "dense warp"):
                leaf = image.clone().requires_grad_(True)
                cuts = engines[name].make_cutouts.apply(draws, leaf)
                (grad,) = torch.autograd.grad((cuts ** 2).sum(), leaf)
                outs[name] = (cuts.detach(), grad)
            diff = (outs["kernels on"][0] - outs["dense warp"][0]).abs().max().item()
            log(f"  cutouts {tuple(outs['kernels on'][0].shape)}, scanline kernel vs dense warp: "
                f"max abs {diff:.3e} (limit {WARP_TOL['cuts']:g}) {'ok' if diff <= WARP_TOL['cuts'] else 'FAIL'}")
            if diff > WARP_TOL["cuts"]:
                raise AssertionError("the two warps' cutouts disagree")
            d_grad = rel_l2(outs["kernels on"][1], outs["dense warp"][1])
            ok = d_grad <= WARP_TOL["grad"]
            log(f"  image gradient of sum(cutouts ** 2), scanline kernel vs dense warp: relative L2 "
                f"{d_grad:.3e} (limit {WARP_TOL['grad']:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("the two warps' image gradients disagree")
        del engines, runs


def phase_v2_times(vq_state, clip_state, vq_argmin, scanline_lerp, gen, card):
    import torch

    log(f"phase 7: v2 times on {card}")
    # torch's defaults, which the CLI runs under
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    step_ms = {}
    for batch in (1, 4):
        engines = {tag: v2_engine(vq_state, clip_state, None, tag == "on") for tag in ("on", "off")}
        prompts = v2_prompts(engines["on"], batch)
        z0 = engines["on"].random_token_latent(gen, batch, 8, 8)
        states = {tag: e.init_state(z0) for tag, e in engines.items()}

        def window(tag, n=V2_WINDOW):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engines[tag].chain(states[tag], n, SEED, *prompts)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        for tag in engines:
            window(tag, 3)
        samples = {"on": [], "off": []}
        for i in range(5):
            for tag in (("off", "on") if i % 2 == 0 else ("on", "off")):
                samples[tag].append(window(tag))
        for tag in ("on", "off"):
            ms = statistics.median(samples[tag])
            step_ms[batch, tag] = ms
            log(f"  v2 step batch {batch} f32 kernels {tag}: {ms:.3f} ms per step, "
                f"{1e3 / ms:.2f} steps/s, {batch * 1e3 / ms:.2f} prompt-steps/s (windows of "
                f"{V2_WINDOW}: {', '.join(f'{t:.2f}' for t in samples[tag])}) [{card}]")
        for tag in ("on", "off"):
            host_ms, events = profiled(lambda: engines[tag].chain(states[tag], 5, SEED, *prompts), calls=1)
            busy = sum(e.self_device_time_total for e in events) / 1e3
            log(f"  profiled 5 steps batch {batch}, kernels {tag}: host {host_ms / 5:.3f} ms per step, "
                f"device busy {busy / 5:.3f} ms per step ({100 * busy / host_ms:.1f}%), "
                f"{sum(e.count for e in events) // 5} kernels per step")
            for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
                log(f"    {e.self_device_time_total / 5e3:8.3f} ms {e.count // 5:5d}x {e.key[:90]}")
        log(f"  peak device memory so far: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del engines, states

    set_tf32(False)
    timed = {}
    _, K, d = VQ_SHAPE
    cb = codebooks(K, d, gen)["taming"]
    c2 = (cb * cb).sum(dim=1)
    for N in VQ_TIMED_N:
        x = cb[torch.randint(0, K, (N,), generator=gen, device="cuda")] * 1.5
        t = {
            "ms": cuda_ms(lambda: vq_argmin.vq_argmin(x, cb)),
            "plain_ms": cuda_ms(lambda: vq_argmin.vq_argmin_reference(x, cb)),
            "library_ms": cuda_ms(lambda: (c2 - 2.0 * x @ cb.t()).argmin(dim=-1)),
            **bound(4 * (N * d + K * d + N), 2 * N * K * d + 2 * K * d, "f32"),
        }
        # the work as the kernel does it: three TF32 products on the tensor cores
        as_done = bound(4 * (N * d + K * d + N), 6 * N * K * d, "tf32")["bound_ms"]
        cdist_ms = cuda_ms(lambda: torch.cdist(x, cb).argmin(dim=-1))
        dev = (device_ms(lambda: vq_argmin.vq_argmin(x, cb)),
               device_ms(lambda: (c2 - 2.0 * x @ cb.t()).argmin(dim=-1)))
        log(f"  vq_argmin f32 ({N}, {K}, {d}): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"library (c2 - 2 x @ cb.T).argmin {t['library_ms']:.4f} ms with c2 given, "
            f"cdist().argmin {cdist_ms:.4f} ms, back to back by CUDA events; device time kernel "
            f"{dev[0]:.4f} ms, library {dev[1]:.4f} ms; bound {t['bound_ms']:.4f} ms by {t['bound_by']}, "
            f"device / bound {dev[0] / t['bound_ms']:.2f}; as done (3 TF32 products on the tensor cores) "
            f"{as_done:.4f} ms [{card}]")
        if N == VQ_SHAPE[0]:
            timed["vq_argmin"] = t
    S, C, K_, O = LERP_SHAPE
    src = torch.rand((1, S, C, K_), generator=gen, device="cuda")
    coords = torch.rand((S, O), generator=gen, device="cuda") * (K_ - 1)
    t = {
        "ms": cuda_ms(lambda: scanline_lerp.scanline_lerp_fwd(src, coords)),
        "plain_ms": cuda_ms(lambda: scanline_lerp.scanline_lerp_reference(src[0], coords)),
        "library_ms": None,  # no one PyTorch call computes a per-row two-tap lerp
        **bound(4 * (S * C * K_ + S * O + S * C * O), S * O * (5 + 3 * C), "f32"),
    }
    dev = device_ms(lambda: scanline_lerp.scanline_lerp_fwd(src, coords))
    log(f"  scanline_lerp f32 ({S}, {C}, {K_}) -> {O}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms "
        f"back to back by CUDA events; device time kernel {dev:.4f} ms; bound {t['bound_ms']:.4f} ms by "
        f"{t['bound_by']}; no library call [{card}]")
    timed["scanline_lerp"] = t
    return step_ms, timed


def phase_v2(vq_argmin, scanline_lerp, gen, card):
    errs = phase_v2_kernels(vq_argmin, scanline_lerp, gen)
    with tempfile.TemporaryDirectory() as tmp:
        launches, vq_state, clip_state = phase_v2_path(Path(tmp), vq_argmin, scanline_lerp)
    phase_v2_on_off(vq_state, clip_state, gen)
    _, timed = phase_v2_times(vq_state, clip_state, vq_argmin, scanline_lerp, gen, card)
    return launches, errs, timed


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=["train", "v2"], default=None,
                        help="build, then run one slice's phases alone (no result line)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from imagegenerator_tpu_torch.ops.kernels import (
        _build,
        attention,
        layernorm,
        scanline_lerp,
        vq_argmin,
    )

    log("phase 0: device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"  {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("phase 1: build")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"  nvcc, {len(_build.names())} sources in parallel: {time.perf_counter() - t0:.2f} s "
        f"({_build.build_dir()})")
    for name in _build.names():
        lib = _build.library(name)
        for line in _build.build_log(name).splitlines():
            entry = re.search(r"Compiling entry function '\w*\d([a-z_]+_kernel)(\w*)'", line)
            if entry:  # the kernel's name and what is left of its mangled signature
                log(f"    {name}: {entry.group(1)} <{entry.group(2)[:24]}>")
            elif "registers" in line or "spill" in line:
                log(f"    {name}:   {line.strip()}")
        if name in ("attention_fwd", "attention_bwd"):
            log(f"    {name}: the tensor-core kernel takes {getattr(lib, name + '_mma_smem')()} bytes "
                "of dynamic shared memory a block")
    import triton

    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        xs = torch.zeros((8, LN_SHAPE[1]), dtype=dtype, device="cuda")
        w = torch.ones(LN_SHAPE[1], device="cuda")
        _, mean, rstd = layernorm.layernorm_fwd(xs, w, w, 1e-12)
        layernorm.layernorm_bwd(w.expand_as(xs).contiguous(), xs, mean, rstd, w, w)
    scanline_lerp.scanline_lerp_fwd(torch.zeros((1, 8, 3, 16), device="cuda"), torch.zeros((8, 16), device="cuda"))
    torch.cuda.synchronize()
    log(f"  triton {triton.__version__} layernorm bwd and scanline lerp compile: "
        f"{time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if args.only == "train":
        phase_train(attention, layernorm, gen, card)
    if args.only == "v2":
        phase_v2(vq_argmin, scanline_lerp, gen, card)
    if args.only:
        print(card)
        return 0
    errs = phase_kernels(attention, layernorm, gen)
    errs.update(phase_train_kernels(attention, layernorm, gen))
    phase_mma_kernels(attention, layernorm, gen)
    with tempfile.TemporaryDirectory() as tmp:
        flat, launches = phase_main_path(Path(tmp), attention, layernorm)
    batch, noise = path_inputs(gen)
    phase_on_off(flat, batch, noise)
    _, attn_t, ln_t = phase_times(flat, batch, noise, attention, layernorm, gen, card)
    del flat, batch, noise
    train_launches, train_t = phase_train(attention, layernorm, gen, card)
    v2_launches, v2_errs, v2_t = phase_v2(vq_argmin, scanline_lerp, gen, card)
    B = TRAIN_ATTN[0]

    # launches: on the kernel's own main path (the sampling CLI's run, the
    # stage-1 steps, the v2 CLI's first run); errors, times and bounds at
    # that path's shape
    kernels = [
        {"name": "attention_fwd", "route": "cuda",
         "source": "imagegenerator_tpu_torch/csrc/attention_fwd.cu",
         "replaces": "imagegenerator_tpu/ops/pallas/attention.py:277",
         "launches": launches["attention"], "max_abs_err": errs["attention", "bf16"],
         **attn_t},
        {"name": "attention_fwd_dropout", "route": "cuda",
         "source": "imagegenerator_tpu_torch/csrc/attention_fwd.cu",
         "replaces": "imagegenerator_tpu/ops/pallas/attention.py:277",
         "launches": train_launches["attention_dropout"],
         "max_abs_err": errs["attention_dropout", "bf16", 0.1], **train_t["attention_fwd_dropout"]},
        {"name": "attention_bwd", "route": "cuda",
         "source": "imagegenerator_tpu_torch/csrc/attention_bwd.cu",
         "replaces": "imagegenerator_tpu/ops/pallas/attention.py:308",
         "launches": train_launches["attention_bwd"],
         "max_abs_err": errs["attention_bwd", "bf16", B, True, 0.1], **train_t["attention_bwd"]},
        {"name": "layernorm_fwd", "route": "cuda",
         "source": "imagegenerator_tpu_torch/csrc/layernorm_fwd.cu",
         "replaces": "imagegenerator_tpu/ops/pallas/layernorm.py:99",
         "launches": launches["layernorm"], "max_abs_err": errs["layernorm", "f32"],
         **ln_t},
        {"name": "layernorm_bwd", "route": "triton",
         "source": "imagegenerator_tpu_torch/ops/kernels/layernorm.py",
         "replaces": "imagegenerator_tpu/ops/pallas/layernorm.py:145",
         "launches": train_launches["layernorm_bwd"], "max_abs_err": errs["layernorm_bwd", "f32"],
         **train_t["layernorm_bwd"]},
        # max_abs_err: the largest score gap, as a share of the row's score
        # range, between the kernel's code and the plain version's (0 when
        # every index is equal)
        {"name": "vq_argmin", "route": "cuda",
         "source": "imagegenerator_tpu_torch/csrc/vq_argmin.cu",
         "replaces": "imagegenerator_tpu/ops/pallas/vq_kernel.py:81",
         "launches": v2_launches["vq_argmin"],
         "max_abs_err": v2_errs["vq", VQ_SHAPE[0], "taming", "f32"][0], **v2_t["vq_argmin"]},
        {"name": "scanline_lerp", "route": "triton",
         "source": "imagegenerator_tpu_torch/ops/kernels/scanline_lerp.py",
         "replaces": "imagegenerator_tpu/ops/pallas/scanline_lerp.py:105",
         "launches": v2_launches["scanline_lerp"], "max_abs_err": v2_errs["lerp"],
         **v2_t["scanline_lerp"]},
    ]
    for kernel in kernels:
        if kernel["launches"] < 1:
            raise AssertionError(f"{kernel['name']} was not launched on its main path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
