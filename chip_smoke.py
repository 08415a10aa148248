#!/usr/bin/env python3
"""Drive the PyTorch port's v1 sampling path once on one CUDA card.

    python3 chip_smoke.py

Phases, one or a few lines each; any failure ends the run with a
non-zero exit and no result line:

0. device — needs CUDA; prints the card's name and power limit.
1. build — compiles the CUDA kernel library with nvcc and the Triton
   LayerNorm kernel; prints the seconds each took.
2. kernel vs plain — each kernel against its plain PyTorch version on the
   same inputs, in f32 (TF32 off) and bf16, at the shapes of the main
   path and at ragged ones, with the tolerance of each output.
3. main path — a full-width, seeded random-init stage-2 state written as
   ``Stage2/params.npz``, then the sampling CLI with ``--fused_attn
   --fused_ln`` for 4 captions x 2 samples (batch 8, 256 px, bf16);
   checks the 8 PNGs and that the kernels launched 12 and 25 times, once
   per attention and LayerNorm of the one BERT forward.
4. kernels on vs off — the same state, batch and injected noise through
   ``Stage2System`` with both kernels and with neither, in f32 (TF32 off)
   and bf16; BERT's last hidden state (which the kernels feed directly)
   and the images of ``sample`` must agree.
5. times — medians of 5 runs after 2 warm-ups: ``sample`` at batch 8
   with kernels on and off, its three stages, and each kernel against its
   plain version; then ``torch.profiler`` over 3 ``sample`` calls: device
   busy time per call and the kernels that take most of it.

Then one JSON line of the kernels, the card's line from nvidia-smi, and
last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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
TOL = {  # (rtol, atol)
    "attn_o_f32": (1e-4, 1e-5),
    "attn_o_bf16": (2e-2, 2e-2),
    "attn_ml": (1e-4, 0.0),
    "ln_y": (1e-5, 1e-5),
    "ln_stats": (1e-5, 0.0),
}
IMAGE_TOL = {"f32": 1e-3, "bf16": 0.1}
# max abs, BERT's last hidden state (values within about +-4). On an H100
# a sound run reads 3.3e-6 (f32) and 2.0e-2 (bf16); a planted fault (mask
# ignored, 1 / l dropped, LayerNorm mean left out) reads 0.26 to 5.8 in
# either.
HIDDEN_TOL = {"f32": 1e-3, "bf16": 0.1}


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(name, got, want, rtol, atol) -> float:
    """Max abs and rel error of ``got`` against ``want``; raises unless
    ``|got - want| <= atol + rtol * |want|`` everywhere."""
    import torch

    got, want = got.double(), want.double()
    err = (got - want).abs()
    rel = err / want.abs().clamp_min(1e-30)
    ok = bool(torch.isfinite(got).all()) and bool((err <= atol + rtol * want.abs()).all())
    max_abs, max_rel = err.max().item(), rel.max().item()
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


def profiled(fn, calls):
    """``torch.profiler`` over ``calls`` calls after a warm-up: the host
    ms per call and the CUDA kernel events (device time per kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / calls
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return host_ms, events


def device_ms(fn, calls=10) -> float:
    """Device time per call: the summed time of the kernels ``fn``
    launches. Unlike ``cuda_ms`` it leaves out the gaps in which the card
    waits for the host to launch the next kernel."""
    _, events = profiled(fn, calls)
    return sum(e.self_device_time_total for e in events) / 1e3 / calls


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
        for B, T, H, nh in (ATTN_SHAPE, (3, 40, 768, 12)):
            q, k, v, mask = attention_inputs(B, T, H, dtype, gen)
            o, m, l = attention.attention_fwd(q, k, v, mask, nh)
            torch.cuda.synchronize()
            ro, rm, rl = attention.attention_reference(q, k, v, mask, nh)
            where = f"attention {tag} ({B}, {T}, {H})"
            err = compare(f"{where} o", o, ro, *TOL[f"attn_o_{tag}"])
            compare(f"{where} m", m, rm, *TOL["attn_ml"])
            compare(f"{where} l", l, rl, *TOL["attn_ml"])
            if (B, T, H, nh) == ATTN_SHAPE:
                errs["attention", tag] = err
        for n in (LN_SHAPE[0], 1000):
            d = LN_SHAPE[1]
            x = (torch.randn((n, d), generator=gen, device="cuda") * 3 + 0.5).to(dtype)
            scale = 1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
            bias = 0.1 * torch.randn((d,), generator=gen, device="cuda")
            y, mean, rstd = layernorm.layernorm_fwd(x, scale, bias, 1e-12)
            torch.cuda.synchronize()
            ry, rmean, rrstd = layernorm.layernorm_reference(x, scale, bias, 1e-12)
            where = f"layernorm {tag} ({n}, {d})"
            err = compare(f"{where} y", y, ry, *TOL["ln_y"])
            compare(f"{where} mean", mean, rmean, *TOL["ln_stats"])
            compare(f"{where} rstd", rstd, rrstd, *TOL["ln_stats"])
            if n == LN_SHAPE[0]:
                errs["layernorm", tag] = err
    return errs


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
    attention.launches = 0
    layernorm.launches = 0
    t0 = time.perf_counter()
    sample.main([
        "--stage", "2", "--checkpoint_dir", str(tmp / "ckpt"),
        "--caption", CAPTIONS, "-n", str(SAMPLES_PER_CAPTION),
        "-o", str(out), "--seed", str(SEED), "--fused_attn", "--fused_ln",
    ])
    torch.cuda.synchronize()
    launches = {"attention": attention.launches, "layernorm": layernorm.launches}
    log(f"  sample CLI: {time.perf_counter() - t0:.1f} s (load, first calls, "
        f"PNG writes); launches {launches}")
    pngs = sorted(out.glob("sample_*.png"))
    sizes = {png_size(p) for p in pngs}
    if len(pngs) != BATCH or sizes != {(256, 256)}:
        raise AssertionError(f"expected {BATCH} PNGs of 256x256, got {len(pngs)} {sizes}")
    want = {"attention": 12, "layernorm": 25}  # one BERT-base forward
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    log(f"  {len(pngs)} PNGs at 256x256; launches match one BERT forward {want}")
    return flat, launches


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
    timed = {}
    for name, kernel, plain in (
        ("attention", lambda: attention.attention_fwd(q, k, v, mask, nh),
         lambda: attention.attention_reference(q, k, v, mask, nh)),
        ("layernorm", lambda: layernorm.layernorm_fwd(x, scale, bias, 1e-12),
         lambda: layernorm.layernorm_reference(x, scale, bias, 1e-12)),
    ):
        timed[name] = {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain)}
        dev = (device_ms(kernel), device_ms(plain))
        shape = f"bf16 {ATTN_SHAPE[:3]}" if name == "attention" else f"f32 {LN_SHAPE}"
        log(f"  {name} {shape}: kernel {timed[name]['ms']:.4f} ms, plain "
            f"{timed[name]['plain_ms']:.4f} ms back to back by CUDA events; device time "
            f"kernel {dev[0]:.4f} ms, plain {dev[1]:.4f} ms (inputs L2-resident) [{card}]")
    # 24 inputs of 3 MB (72 MB, more than the 50 MB L2) taken in turn, so
    # each launch reads its input from device memory
    xs = [torch.randn(LN_SHAPE, generator=gen, device="cuda") for _ in range(24)]
    turn = iter(range(10**9))
    ln_hbm = device_ms(lambda: layernorm.layernorm_fwd(xs[next(turn) % 24], scale, bias, 1e-12), calls=24)
    moved = 2 * x.numel() * x.element_size() + 2 * LN_SHAPE[0] * 4
    log(f"  layernorm f32 {LN_SHAPE}, inputs rotated through 72 MB: device time "
        f"{ln_hbm:.4f} ms, {moved / ln_hbm / 1e9:.3f} TB/s [{card}]")
    return sample_ms, timed["attention"], timed["layernorm"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from imagegenerator_tpu_torch.ops.kernels import _build, attention, layernorm

    log("phase 0: device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"  {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("phase 1: build")
    t0 = time.perf_counter()
    _build.library()
    log(f"  nvcc library: {time.perf_counter() - t0:.2f} s ({_build.library_path()})")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log(f"    {line.strip()}")
    import triton

    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        xs = torch.zeros((8, LN_SHAPE[1]), dtype=dtype, device="cuda")
        w = torch.ones(LN_SHAPE[1], device="cuda")
        layernorm.layernorm_fwd(xs, w, w, 1e-12)
    torch.cuda.synchronize()
    log(f"  triton {triton.__version__} layernorm compile: {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = phase_kernels(attention, layernorm, gen)
    with tempfile.TemporaryDirectory() as tmp:
        flat, launches = phase_main_path(Path(tmp), attention, layernorm)
    batch, noise = path_inputs(gen)
    phase_on_off(flat, batch, noise)
    _, attn_t, ln_t = phase_times(flat, batch, noise, attention, layernorm, gen, card)

    kernels = [
        {"name": "attention_fwd", "route": "cuda",
         "source": "imagegenerator_tpu_torch/csrc/attention_fwd.cu",
         "replaces": "imagegenerator_tpu/ops/pallas/attention.py:277",
         "launches": launches["attention"], "max_abs_err": errs["attention", "bf16"],
         **attn_t},
        {"name": "layernorm_fwd", "route": "triton",
         "source": "imagegenerator_tpu_torch/ops/kernels/layernorm.py",
         "replaces": "imagegenerator_tpu/ops/pallas/layernorm.py:99",
         "launches": launches["layernorm"], "max_abs_err": errs["layernorm", "f32"],
         **ln_t},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
