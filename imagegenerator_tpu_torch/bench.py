"""Benchmark suite of the PyTorch port: the JAX package's ``bench.py``
targets, metric names, windows and orchestrator, timed on the card.

    python -m imagegenerator_tpu_torch.bench                        # all ten targets
    BENCH_TARGET=stage1 python -m imagegenerator_tpu_torch.bench    # one, in this process
    BENCH_TARGET=v2,v2_batched python -m imagegenerator_tpu_torch.bench

The default run is an orchestrator: one child process per target
(``python -m imagegenerator_tpu_torch.bench`` with ``BENCH_TARGET`` set
and ``BENCH_SUBPROC=0``), headlines first (stage2, stage1, v2), then the
variants, host and e2e last. A child that hangs is killed with its whole
process group at its timeout (its CUDA context goes with it) and the run
goes on after an explicit ``{"metric": <target>, "error": "timeout"}``
line; a child that dies gives ``child_exit_<rc>``; a target that no
longer fits the budget gives ``skipped_budget``; a failed headline is
tried once more (``retry_skipped_budget`` when that no longer fits), its
lines marked ``"attempt": 2``. Every forwarded line carries the run's
cumulative ``elapsed_s``. The first child measures the session's GEMM
roofline and reads the card's name and power limit; the parent hands
both to the children after it. The stage-2 headline is printed again as
the last line (``"reemitted_headline": true``). The parent never touches
the card: it imports no model and initialises no CUDA.

Every number is the median of ``BENCH_REPS`` timed windows (5 for the
headlines, host and e2e; 3 for the variants), with the spread per step.
A window launches its steps asynchronously and ends in
``torch.cuda.synchronize()``. Each line carries ``"backend": "torch"``,
the card's name and power limit (``device``, ``power_limit_w``, as
``nvidia-smi`` gives them), the compute ``dtype`` and, for targets that
step, ``kernel_launches_per_step``: the hand kernels' launch counters
(``ops/kernels/*``) over the timed windows divided by the steps.

No line has ``vs_baseline``: the only baseline in the repository
(``BENCH_BASELINE.json``) was measured on a TPU, and no number here is
divided by it. ``mfu`` is against this card's dense bf16 tensor-core peak
(``_PEAK_TFLOPS``, NVIDIA's H100 datasheet; ``BENCH_PEAK_TFLOPS``
overrides, an unknown card has no ``mfu``), whatever ``BENCH_DTYPE`` is,
as in the JAX bench. ``flops_per_step`` is counted over one extra,
untimed step under ``torch.utils.flop_counter.FlopCounterMode`` (aten
products and convolutions), plus the model FLOPs of the hand kernels,
which it cannot see and whose wrappers count them by formula
(``attention.fwd_flops``/``bwd_flops``, ``vq_argmin.argmin_flops``;
LayerNorm and the scanline lerp add none, as FlopCounterMode counts no
normalisation or elementwise work). So a step counts the same on the
kernel route as on the plain one. Under ``IMAGEGEN_WARP_KERNEL=1`` the v2
count leaves out the dense warp's contraction, which the lerp kernel
does not do.

Targets (each a full-width, seeded random init built on the card):
  stage2        Stage2Config(), batch 256, bf16, n_critic 5; with
                BENCH_PRECOMPUTED=1 (default) ``tem`` from
                ``Stage2System.embed_texts`` outside the window, f32 images
                in [-1, 1] (as the JAX bench's stage2 runs); golden pins
                exact GELU, plain attention and 32-bit dropout
  stage1        Stage1Config(), batch 128: output-recovered GELU backward,
                fused attention, 16-bit dropout, BENCH_LN=xla; golden:
                exact GELU, plain attention, 32-bit dropout, no override
                read; fast: tanh GELU, 8-bit dropout; fast_reuse adds
                ``text_reuse_mismatched``
  v2            VQGAN imagenet_f16_16384 + CLIP ViT-B/32, 128 px, 32
                cutouts; windows of BENCH_V2_CHAINS x GenerateEngine.chain
                of BENCH_CHAIN iterations, a seed per chain; batch 1
                (steps/sec) or 4 (v2_batched, prompt-steps/sec)
  host          768 synthetic ~640 px JPEGs (Pillow) in a ``mem://`` store
                through CocoCaptions + HashTokenizer + DataLoader host
                batches, uint8 at 256 px, 16 workers; no device work
  e2e           the stage-2 step fed by the DataLoader over
                PrecomputedTextDataset/TemCollate (``tem`` in the
                compute dtype, as the JAX bench: bf16 collated into a
                pinned torch tensor), uint8 images pinned and copied
                asynchronously; one warm epoch of 4 batches, then
                whole-epoch windows

Env knobs (the JAX bench's, same defaults):
  BENCH_TARGET      all | a target | a comma-separated list (in-process)
  BENCH_SUBPROC     1 (default): orchestrate the "all" run; 0: in process
                    under SIGALRM
  BENCH_BUDGET_S    840: the "all" run's wall budget
  BENCH_SUB_TIMEOUT overrides every per-target timeout
  BENCH_BATCH, BENCH_STEPS (8), BENCH_REPS, BENCH_CHAIN (20),
  BENCH_V2_CHAINS (3), BENCH_DTYPE (bf16 | f32), BENCH_PRECOMPUTED,
  BENCH_GELU, BENCH_LN (xla | pallas: the hand kernel), BENCH_ATTN (xla:
  the plain route | pallas: the hand kernels), BENCH_DROPOUT_BITS,
  BENCH_TEXT_REUSE, BENCH_REMAT, BENCH_HOST_IMAGES (768), BENCH_HOST_RES
  (256), BENCH_HOST_WORKERS (16), BENCH_E2E_BATCHES (4), BENCH_IMAGE_DTYPE
  (u8 | f32), BENCH_PEAK_TFLOPS, BENCH_ROOFLINE (0 skips the probe)
  Set by the orchestrator for its children: BENCH_SESSION_ROOFLINE,
  BENCH_CARD, BENCH_CHILD_TIMEOUT (arms the pre-kill stack dump)
  BENCH_DEVICE      cpu runs on the CPU (the tests' tiny runs); unset, the
                    card, and without one the bench raises
Not read: BENCH_RNG (rbg/threefry) and BENCH_UNROLL /
IMAGEGEN_CHAIN_UNROLL (``unroll_critic``, the chain's scan unroll) are XLA
knobs with no counterpart in eager PyTorch; the configs keep the JAX
bench's ``unroll_critic=5``, which has no effect here.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

_T0 = time.monotonic()
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX bench's default ``unroll_critic`` (BENCH_UNROLL); no effect in
# eager PyTorch, kept so that the configs equal the JAX bench's.
UNROLL_CRITIC = 5


def _hb(msg: str):
    """Phase heartbeat to stderr: a hang names its last-started phase."""
    print(f"[bench hb {time.monotonic() - _T0:6.1f}s] {msg}", file=sys.stderr, flush=True)


# the variants run 3 timed windows, the headlines, host and e2e 5, so
# that the default run fits BENCH_BUDGET_S; BENCH_REPS overrides all
_SHORT_REPS_TARGETS = {
    "stage1_golden", "stage1_fast", "stage1_fast_reuse",
    "stage2_golden", "v2_batched",
}


def _reps() -> int:
    env = os.environ.get("BENCH_REPS")
    if env:
        return max(1, int(env))
    if os.environ.get("BENCH_TARGET") in _SHORT_REPS_TARGETS:
        return 3
    return 5


def _median_stats(per_step_samples: list) -> tuple:
    """Median seconds/step over the timed windows + spread extras."""
    med = statistics.median(per_step_samples)
    return med, {
        "windows": len(per_step_samples),
        "spread_per_step_ms": [round(s * 1e3, 3) for s in sorted(per_step_samples)],
    }


def _host_spin_ms() -> float:
    """Host-speed probe: a fixed pure-Python spin, median of 3 (the
    host-bound metrics scale with it)."""

    def _spin():
        t0 = time.perf_counter()
        x = 0
        for i in range(500_000):
            x += i * i
        return time.perf_counter() - t0

    return round(statistics.median(_spin() for _ in range(3)) * 1e3, 2)


# ------------------------------------------------------------- the device


def _device():
    """The card, or the CPU under ``BENCH_DEVICE=cpu``; raises without a
    card otherwise (``utils/device.py::entry_device``)."""
    from imagegenerator_tpu_torch.utils.device import entry_device

    return entry_device(os.environ.get("BENCH_DEVICE") or None)


def _fence(device) -> None:
    """The end of a timed window: wait for the card's queued work."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dtype():
    import torch

    return torch.bfloat16 if os.environ.get("BENCH_DTYPE", "bf16") == "bf16" else torch.float32


def _dtype_name() -> str:
    return "bf16" if os.environ.get("BENCH_DTYPE", "bf16") == "bf16" else "f32"


_CARD: list = []


def _card() -> tuple:
    """``(name, power limit in W)`` of the card as ``nvidia-smi
    --query-gpu=name,power.limit`` gives them, read once per run (the
    orchestrator passes the first child's reading on in ``BENCH_CARD``);
    ``("cpu", None)`` on the CPU."""
    if _CARD:
        return _CARD[0]
    env = os.environ.get("BENCH_CARD")
    if env:
        name, limit = json.loads(env)
    elif _device().type != "cuda":
        name, limit = "cpu", None
    else:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout
        name, _, watts = out.strip().splitlines()[0].rpartition(",")
        name = name.strip()
        try:
            limit = float(watts.split()[0])
        except (IndexError, ValueError):  # "[N/A]" on a card that reports none
            limit = None
    _CARD.append((name, limit))
    return _CARD[0]


def _emit(metric, value, unit, **extra):
    name, limit = _card()
    record = {
        "metric": metric,
        "value": round(value, 3),
        "unit": unit,
        # cumulative process-elapsed seconds (the orchestrator rewrites
        # this with its own clock when it forwards a child's line)
        "elapsed_s": round(time.monotonic() - _T0, 1),
        "backend": "torch",
        "device": name,
        "power_limit_w": limit,
    }
    record.update(extra)
    _LAST_RECORDS[metric] = record
    print(json.dumps(record), flush=True)


# last record per metric name, for the in-process all-run's final
# stage-2 headline re-emit
_LAST_RECORDS: dict = {}


# Dense bf16 tensor-core peak per card, by a piece of
# torch.cuda.get_device_name() (NVIDIA's H100 datasheet); the mfu
# denominator. BENCH_PEAK_TFLOPS overrides.
_PEAK_TFLOPS = (
    ("H100 80GB HBM3", 989.4),  # SXM
    ("H100 NVL", 835.5),
    ("H100 PCIe", 756.5),
)


def _peak_flops() -> float:
    env = os.environ.get("BENCH_PEAK_TFLOPS")
    if env:
        return float(env) * 1e12
    device = _device()
    if device.type != "cuda":
        return 0.0
    import torch

    kind = torch.cuda.get_device_name(device)
    for sub, tf in _PEAK_TFLOPS:
        if sub in kind:
            return tf * 1e12
    return 0.0  # unknown card: mfu omitted


_ROOFLINE_CACHE: list = []


def _session_roofline() -> float:
    """Achievable bf16 GEMM TFLOP/s on this card now: chained 8192^3
    ``torch.matmul``s, 10 a trial, best of 2 trials, each ended by a
    synchronise; cached per process and emitted once as
    ``session_gemm_roofline_tflops``. A library product as a yardstick
    (a card under a lower power limit or beside busy neighbours delivers
    less than its datasheet), not a kernel of the system. 0 on the CPU."""
    if _ROOFLINE_CACHE:
        return _ROOFLINE_CACHE[0]
    env_roof = os.environ.get("BENCH_SESSION_ROOFLINE")
    if env_roof:
        _ROOFLINE_CACHE.append(float(env_roof))
        return _ROOFLINE_CACHE[0]
    device = _device()
    if device.type != "cuda" or os.environ.get("BENCH_ROOFLINE") == "0":
        _ROOFLINE_CACHE.append(0.0)
        return 0.0
    import torch

    _hb("roofline probe")
    n, reps = 8192, 10
    gen = torch.Generator(device).manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=device, dtype=torch.bfloat16)
    # scaled so that a chain of products keeps its values near 1
    b = torch.randn((n, n), generator=gen, device=device, dtype=torch.bfloat16) / n**0.5
    torch.matmul(a, b)
    torch.cuda.synchronize(device)
    best = 0.0
    for _trial in range(2):
        t0 = time.perf_counter()
        c = a
        for _ in range(reps):
            c = torch.matmul(c, b)
        torch.cuda.synchronize(device)
        best = max(best, 2 * n**3 * reps / (time.perf_counter() - t0) / 1e12)
    del a, b, c
    _ROOFLINE_CACHE.append(best)
    peak = _peak_flops()
    _emit(
        "session_gemm_roofline_tflops",
        best,
        "TFLOP/s",
        **({"pct_of_paper_peak": round(100 * best * 1e12 / peak, 1)} if peak else {}),
    )
    return best


def _kernel_flops() -> int:
    """Model FLOPs the hand kernels have launched so far (their wrappers
    count them; FlopCounterMode cannot see a ``ctypes`` launch)."""
    from imagegenerator_tpu_torch.ops.kernels import attention, vq_argmin

    return attention.flops + vq_argmin.flops


def _count_flops(step) -> float:
    """FLOPs of one call of ``step``: FlopCounterMode's aten count plus
    the hand kernels' (see the module docstring). Untimed."""
    from torch.utils.flop_counter import FlopCounterMode

    before = _kernel_flops()
    with FlopCounterMode(display=False) as counter:
        step()
    _fence(_device())
    return float(counter.get_total_flops() + _kernel_flops() - before)


def _mfu_extras(flops_per_step: float, seconds_per_step: float) -> dict:
    """Achieved TFLOP/s, and its share of the card's bf16 peak and of the
    session's GEMM roofline (neither on the CPU)."""
    if flops_per_step <= 0:
        return {}
    achieved = flops_per_step / seconds_per_step
    extras = {
        "flops_per_step": flops_per_step,
        "tflops_per_sec": round(achieved / 1e12, 2),
    }
    peak = _peak_flops()
    if peak > 0:
        extras["mfu"] = round(achieved / peak, 4)
    roof = _session_roofline()
    if roof > 0:
        extras["pct_of_session_roofline"] = round(achieved / 1e10 / roof, 1)
    return extras


# (name in the line, kernel module, its counter)
_COUNTERS = (
    ("attention_fwd", "attention", "launches"),
    ("attention_fwd_dropout", "attention", "dropout_launches"),
    ("attention_fwd_mma", "attention", "mma_launches"),
    ("attention_bwd", "attention", "bwd_launches"),
    ("attention_bwd_mma", "attention", "mma_bwd_launches"),
    ("attention_fwd_wgmma", "attention", "wgmma_launches"),
    ("attention_bwd_wgmma", "attention", "wgmma_bwd_launches"),
    ("layernorm_fwd", "layernorm", "launches"),
    ("layernorm_bwd", "layernorm", "bwd_launches"),
    ("vq_argmin", "vq_argmin", "launches"),
    ("scanline_lerp", "scanline_lerp", "launches"),
)


def _launch_counts() -> dict:
    import importlib

    return {
        name: getattr(importlib.import_module(f"imagegenerator_tpu_torch.ops.kernels.{module}"), counter)
        for name, module, counter in _COUNTERS
    }


def _launches_per_step(before: dict, steps: int) -> dict:
    after = _launch_counts()
    return {k: (after[k] - before[k]) / steps for k in after}


def _step_windows(step, steps: int):
    """``BENCH_REPS`` windows of ``steps`` calls, launched back to back
    and ended by a fence: seconds per step of each window, and the hand
    kernels' launches per step over them all."""
    device = _device()
    before = _launch_counts()
    samples = []
    for _ in range(_reps()):
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        _fence(device)
        samples.append((time.perf_counter() - t0) / steps)
    return samples, _launches_per_step(before, steps * len(samples))


# ------------------------------------------------------------- training


def _bench_bert_cfg(gelu="exact", ln="xla", attn="xla", pinned=False, dropout_bits=32):
    """Text-encoder config of a training target from its defaults;
    BENCH_GELU / BENCH_LN / BENCH_ATTN / BENCH_DROPOUT_BITS override,
    unless ``pinned`` (the golden targets, whose config is frozen).
    ``pallas`` names the port's hand kernels, ``xla`` the plain route."""
    import dataclasses

    from imagegenerator_tpu_torch.models.bert import BertConfig

    cfg = BertConfig()
    if not pinned:
        gelu = os.environ.get("BENCH_GELU", gelu)
        ln = os.environ.get("BENCH_LN", ln)
        attn = os.environ.get("BENCH_ATTN", attn)
        dropout_bits = int(os.environ.get("BENCH_DROPOUT_BITS", str(dropout_bits)))
    if gelu == "tanh":
        cfg = dataclasses.replace(cfg, gelu_approximate=True)
    elif gelu == "exact_outbwd":
        cfg = dataclasses.replace(cfg, gelu_output_bwd=True)
    if ln == "pallas":
        cfg = dataclasses.replace(cfg, fused_ln=True)
    if attn == "pallas":
        cfg = dataclasses.replace(cfg, fused_attention=True)
    if dropout_bits != 32:
        cfg = dataclasses.replace(cfg, dropout_bits=dropout_bits)
    return cfg


def _stage1_config(fastpath=False, reuse=False, golden=False):
    """The stage-1 target's config: the headline (output-recovered GELU
    backward, fused attention, 16-bit dropout), ``fastpath`` (tanh GELU,
    8-bit dropout), ``reuse`` (mismatched pairs reuse the matched
    embeddings; BENCH_TEXT_REUSE=1 turns it on for any stage-1 target) or
    ``golden`` (exact GELU, plain attention, 32-bit dropout, pinned)."""
    from imagegenerator_tpu_torch.train.stage1 import Stage1Config

    if golden:
        bert_cfg = _bench_bert_cfg(gelu="exact", attn="xla", pinned=True)
    else:
        bert_cfg = _bench_bert_cfg(
            gelu="tanh" if fastpath else "exact_outbwd", attn="pallas",
            dropout_bits=8 if fastpath else 16,
        )
    return Stage1Config(
        compute_dtype=_dtype(), unroll_critic=UNROLL_CRITIC,
        remat=os.environ.get("BENCH_REMAT", "0") == "1",
        bert=bert_cfg,
        text_reuse_mismatched=True if reuse or os.environ.get("BENCH_TEXT_REUSE", "0") == "1" else None,
    )


def _stage1_setup(batch, fastpath=False, reuse=False, golden=False, config=None):
    """The stage-1 system and batch of a target (``config``, where given,
    in place of the target's): a seeded random init on the device, random
    token ids, an all-ones mask and f32 images in [-1, 1]. Returns
    ``(system, data, step)``; ``step()`` runs one ``train_step`` on
    ``data``. Shared with ``tools/profile_opclass.py``."""
    import torch

    from imagegenerator_tpu_torch.train.stage1 import Stage1System

    cfg = config or _stage1_config(fastpath, reuse, golden)
    device = _device()
    system = Stage1System(cfg, device=device, generator=torch.Generator(device).manual_seed(0))
    data_gen = torch.Generator(device).manual_seed(1)
    res = cfg.resolution
    data = {
        "input_ids": torch.randint(0, cfg.bert.vocab_size, (batch, cfg.seq_len), generator=data_gen,
                                   device=device, dtype=torch.int32),
        "attention_mask": torch.ones((batch, cfg.seq_len), dtype=torch.int32, device=device),
        "image": torch.rand((batch, res, res, 3), generator=data_gen, device=device) * 2.0 - 1.0,
    }
    step_gen = torch.Generator(device).manual_seed(2)
    host_gen = torch.Generator().manual_seed(2)  # the fused attention's dropout seeds

    def step():
        return system.train_step(data, generator=step_gen, host_generator=host_gen)

    return system, data, step


def bench_stage1(fastpath: bool = False, reuse: bool = False, golden: bool = False, config=None):
    """Stage-I 64 px train step, images/sec: BERT fine-tuned inside the
    GAN step, n_critic 5. Variants as in ``_stage1_config``."""
    batch = int(os.environ.get("BENCH_BATCH", "128"))
    steps = int(os.environ.get("BENCH_STEPS", "8"))
    _hb("stage1: init")
    _, _, step = _stage1_setup(batch, fastpath=fastpath, reuse=reuse, golden=golden, config=config)
    _hb("stage1: warm step")
    step()
    _fence(_device())
    flops = _count_flops(step)
    _hb("stage1: timed windows")
    samples, launches = _step_windows(step, steps)
    med, stats = _median_stats(samples)
    # the name follows the effective config: BENCH_TEXT_REUSE=1 applies
    # reuse to any stage-1 target, and the name must say so
    if fastpath:
        name = "stage1_64px_fastpath"
    elif golden:
        name = "stage1_64px_train_golden"
    else:
        name = "stage1_64px_train"
    if reuse or os.environ.get("BENCH_TEXT_REUSE", "0") == "1":
        name += "_reuse"
    name += "_images_per_sec_per_chip"
    _emit(
        name,
        batch / med,
        "images/sec/chip",
        dtype=_dtype_name(),
        kernel_launches_per_step=launches,
        **stats,
        **_mfu_extras(flops, med),
    )


def _stage2_config(golden=False):
    """The stage-2 target's config: the headline's text encoder (used
    in-step only by the tokens route, BENCH_PRECOMPUTED=0) or the pinned
    golden one."""
    from imagegenerator_tpu_torch.train.stage2 import Stage2Config

    bert_cfg = _bench_bert_cfg(
        gelu="exact" if golden else "exact_outbwd",
        attn="xla" if golden else "pallas",
        pinned=golden,
        dropout_bits=32 if golden else 16,
    )
    return Stage2Config(compute_dtype=_dtype(), unroll_critic=UNROLL_CRITIC, bert=bert_cfg)


def _stage2_setup(batch, precomputed, golden=False, image_dtype="float32", config=None):
    """The stage-2 system and batch of a target (``config``, where given,
    in place of the target's): a seeded random init on the device, random
    token ids with an all-ones mask, and images, f32 in [-1, 1] or uint8.
    With ``precomputed`` the batch holds ``tem`` from ``embed_texts`` in
    place of the tokens. Returns ``(system, data, step)``; ``step(batch=
    data)`` runs one ``train_step``. Shared with ``tools/profile_opclass.py``."""
    import torch

    from imagegenerator_tpu_torch.train.stage2 import Stage2System

    cfg = config or _stage2_config(golden)
    device = _device()
    system = Stage2System(cfg, device=device, generator=torch.Generator(device).manual_seed(0))
    data_gen = torch.Generator(device).manual_seed(1)
    res = cfg.resolution
    data = {
        "input_ids": torch.randint(0, cfg.bert.vocab_size, (batch, cfg.seq_len), generator=data_gen,
                                   device=device, dtype=torch.int32),
        "attention_mask": torch.ones((batch, cfg.seq_len), dtype=torch.int32, device=device),
        "image": (
            torch.randint(0, 256, (batch, res, res, 3), generator=data_gen, device=device,
                          dtype=torch.uint8)
            if image_dtype == "uint8"
            else torch.rand((batch, res, res, 3), generator=data_gen, device=device) * 2.0 - 1.0
        ),
    }
    if precomputed:
        # offline-embedded captions: the frozen encoder makes them constants
        data = {"tem": system.embed_texts(data["input_ids"], data["attention_mask"]), "image": data["image"]}
    step_gen = torch.Generator(device).manual_seed(2)

    def step(batch=data):
        return system.train_step(batch, generator=step_gen)

    return system, data, step


def bench_stage2(golden: bool = False, config=None):
    """Stage-II 256 px train step, the headline, images/sec: batch 256,
    n_critic 5, f32 images resident on the device."""
    batch = int(os.environ.get("BENCH_BATCH", "256"))
    steps = int(os.environ.get("BENCH_STEPS", "8"))
    precomputed = os.environ.get("BENCH_PRECOMPUTED", "1") == "1"
    _hb("stage2: init")
    _, _, step = _stage2_setup(batch, precomputed, golden, config=config)
    _hb("stage2: warm step")
    step()
    _fence(_device())
    flops = _count_flops(step)
    _hb("stage2: timed windows")
    samples, launches = _step_windows(step, steps)
    med, stats = _median_stats(samples)
    name = (
        "stage2_256px_train_golden_images_per_sec_per_chip"
        if golden
        else "stage2_256px_train_images_per_sec_per_chip"
    )
    _emit(
        name,
        batch / med,
        "images/sec/chip",
        precomputed_tem=precomputed,
        image_dtype="float32",
        dtype=_dtype_name(),
        kernel_launches_per_step=launches,
        **stats,
        **_mfu_extras(flops, med),
    )


# ------------------------------------------------------------------- v2


def _v2_setup(batch, config=None):
    """The v2 workload: a full-width f16-16384 VQGAN and ViT-B/32 CLIP
    engine (``config``, a ``(VQGANConfig, CLIPConfig)`` pair, in place of
    them), seeded random weights on the device, 32 cutouts, a random
    token latent of a 128 px image for ``batch`` prompt sets, and zero
    prompt embeddings. Returns ``(engine, state, (embeds, weights,
    stops))``. Shared with ``tools/profile_opclass.py``."""
    import torch

    from imagegenerator_tpu_torch.v2.clip import CLIPConfig
    from imagegenerator_tpu_torch.v2.engine import GenerateEngine
    from imagegenerator_tpu_torch.v2.vqgan import VQGANConfig

    vq_cfg, clip_cfg = config or (VQGANConfig.imagenet_f16_16384(), CLIPConfig.vit_b32())
    device = _device()
    engine = GenerateEngine(
        vqgan_config=vq_cfg,
        clip_config=clip_cfg,
        cutn=32,
        step_size=0.1,
        compute_dtype=_dtype(),
        device=device,
        generator=torch.Generator(device).manual_seed(0),
    )
    h = w = 128 // vq_cfg.f
    z = engine.random_token_latent(torch.Generator(device).manual_seed(2), batch, h, w)
    state = engine.init_state(z)
    embeds = torch.zeros((batch, 1, clip_cfg.embed_dim), device=device)
    weights = torch.ones((batch, 1), device=device)
    stops = torch.full((batch, 1), -float("inf"), device=device)
    return engine, state, (embeds, weights, stops)


def bench_v2(batched: bool = False, config=None):
    """VQGAN-CLIP latent-optimisation steps/sec: 128 px, 32 cutouts, Adam
    on z. A window is BENCH_V2_CHAINS chains of BENCH_CHAIN iterations
    (``GenerateEngine.chain``, no host synchronisation inside), each chain
    with its own seed. ``batched`` (or BENCH_BATCH > 1) packs B prompt
    sets into a step and reports prompt-steps/sec under its own name."""
    chain = int(os.environ.get("BENCH_CHAIN", "20"))
    batch = int(os.environ.get("BENCH_BATCH", "4" if batched else "1"))
    chains_per_window = int(os.environ.get("BENCH_V2_CHAINS", "3"))
    device = _device()
    _hb("v2: init")
    engine, state, prompts = _v2_setup(batch, config)
    _hb("v2: warm chain")
    engine.chain(state, chain, 3, *prompts)
    _fence(device)
    flops = _count_flops(lambda: engine.chain(state, 1, 5, *prompts))
    _hb("v2: timed windows")
    before = _launch_counts()
    samples = []
    for r in range(_reps()):
        t0 = time.perf_counter()
        for w in range(chains_per_window):
            engine.chain(state, chain, 4000 + r * 131 + w, *prompts)
        _fence(device)
        samples.append((time.perf_counter() - t0) / (chain * chains_per_window))
    launches = _launches_per_step(before, chain * chains_per_window * len(samples))
    med, stats = _median_stats(samples)
    name = "vqgan_clip_batched_steps_per_sec" if batch > 1 else "vqgan_clip_latent_opt_steps_per_sec"
    _emit(
        name,
        batch / med,
        "steps/sec" if batch == 1 else "prompt-steps/sec",
        chain=chain,
        batch=batch,
        dtype=_dtype_name(),
        kernel_launches_per_step=launches,
        **stats,
        **_mfu_extras(flops, med),
    )


# ----------------------------------------------------------------- host


def _build_mem_jpeg_dataset(n: int, src_px: int = 640):
    """Synthetic COCO-like ``mem://`` store: n JPEGs (smooth upscaled
    low-frequency content, as photographs are; noise would decode
    unrealistically slowly) and their caption annotations."""
    import io

    import numpy as np

    from imagegenerator_tpu_torch.data.storage import open_store

    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError("the host and e2e targets write their JPEGs with Pillow, "
                           "which is not installed") from None
    store = open_store("mem://bench-host")
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i in range(n):
        small = rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
        img = Image.fromarray(small).resize((src_px, src_px), Image.Resampling.BICUBIC)
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=90)
        store.write_bytes(f"imgs/{i}.jpg", buf.getvalue())
        images.append({"id": i, "file_name": f"{i}.jpg"})
        anns.append({"image_id": i, "caption": f"a synthetic benchmark photo {i}"})
    store.write_text("ann/captions.json", json.dumps({"images": images, "annotations": anns}))
    return store


def bench_host():
    """Host data-pipeline throughput, images/sec: the JPEGs decoded,
    resized (uint8, normalised later on the device), tokenized and
    collated by the DataLoader's host batches. No device work."""
    from imagegenerator_tpu_torch.data.coco import CocoCaptions, describe_routes
    from imagegenerator_tpu_torch.data.pipeline import DataLoader
    from imagegenerator_tpu_torch.data.tokenizer import HashTokenizer

    n = int(os.environ.get("BENCH_HOST_IMAGES", "768"))
    res = int(os.environ.get("BENCH_HOST_RES", "256"))
    batch = int(os.environ.get("BENCH_BATCH", "128"))
    workers = int(os.environ.get("BENCH_HOST_WORKERS", "16"))

    _hb("host: synthetic JPEG dataset build")
    store = _build_mem_jpeg_dataset(n)
    ds = CocoCaptions(store, "imgs", "ann/captions.json", image_size=res)
    tok = HashTokenizer(max_length=128)
    loader = DataLoader(ds, tok, batch_size=batch, num_workers=workers, device=_device())

    try:
        loadavg = round(os.getloadavg()[0], 2)
    except OSError:
        loadavg = None
    spin_ms = _host_spin_ms()
    _hb("host: warm epoch")
    for _ in loader._host_batches():
        pass
    samples = []
    for _ in range(_reps()):
        t0 = time.perf_counter()
        count = 0
        for b in loader._host_batches():
            count += b["image"].shape[0]
        samples.append((time.perf_counter() - t0) / count)  # sec/img
    med, stats = _median_stats(samples)
    ncores = os.cpu_count() or 1
    _emit(
        "host_pipeline_images_per_sec",
        1.0 / med,
        "images/sec",
        host_cores=ncores,
        images_per_sec_per_core=round(1.0 / med / ncores, 2),
        host_spin_ms=spin_ms,
        routes=describe_routes(),
        **({"loadavg_at_start": loadavg} if loadavg is not None else {}),
        **stats,
    )


def bench_e2e(config=None):
    """End-to-end stage-2 training, images/sec: the DataLoader decodes
    the JPEGs and feeds the step while it runs, the captions embedded
    once beforehand. BENCH_REPS whole-epoch windows after one warm epoch
    (every window decodes every image again: the loader caches nothing).
    The images cross the link as uint8 (BENCH_IMAGE_DTYPE=f32: normalised
    on the host, 4x the bytes), ``tem`` in the compute dtype (bf16: 256
    KiB a batch of 256 x 512), both through pinned memory, asynchronously."""
    from imagegenerator_tpu_torch.data.coco import CocoCaptions
    from imagegenerator_tpu_torch.data.pipeline import DataLoader
    from imagegenerator_tpu_torch.data.text_cache import (
        PrecomputedTextDataset,
        TemCollate,
        precompute_caption_embeddings,
    )
    from imagegenerator_tpu_torch.data.tokenizer import HashTokenizer

    batch = int(os.environ.get("BENCH_BATCH", "256"))
    nbatches = int(os.environ.get("BENCH_E2E_BATCHES", "4"))
    workers = int(os.environ.get("BENCH_HOST_WORKERS", "16"))
    image_dtype = "float32" if os.environ.get("BENCH_IMAGE_DTYPE", "u8") == "f32" else "uint8"
    device = _device()

    _hb("e2e: stage-2 init")
    system, _, step = _stage2_setup(batch, True, image_dtype=image_dtype, config=config)
    cfg = system.config
    _hb("e2e: synthetic JPEG dataset build")
    store = _build_mem_jpeg_dataset(batch * nbatches)
    ds = CocoCaptions(store, "imgs", "ann/captions.json", image_size=cfg.resolution,
                      image_dtype=image_dtype)
    tok = HashTokenizer(vocab_size=cfg.bert.vocab_size, max_length=cfg.seq_len)
    _hb("e2e: caption-embedding precompute")
    tems = precompute_caption_embeddings(
        system.embed_texts, tok, [e.caption for e in ds.entries], cfg.tem_size,
        batch_size=batch, device=device,
    )
    loader = DataLoader(PrecomputedTextDataset(ds, tems), TemCollate(_dtype()), batch_size=batch,
                        num_workers=workers, device=device)

    _hb("e2e: warm epoch (loader + copies + steps)")
    for dev_batch in loader:
        step(dev_batch)
    _fence(device)
    _hb("e2e: timed epoch windows")
    before = _launch_counts()
    samples, steps = [], 0
    for r in range(_reps()):
        t0 = time.perf_counter()
        count = 0
        for dev_batch in loader:
            step(dev_batch)
            count += batch
        _fence(device)
        samples.append((time.perf_counter() - t0) / count)  # sec/img
        steps += count // batch
        _hb(f"e2e: window {r + 1}/{_reps()} done")
    med, stats = _median_stats(samples)
    _emit(
        "stage2_e2e_from_loader_images_per_sec",
        1.0 / med,
        "images/sec",
        host_cores=os.cpu_count() or 1,
        host_spin_ms=_host_spin_ms(),
        transfer_dtype=image_dtype,
        dtype=_dtype_name(),
        kernel_launches_per_step=_launches_per_step(before, steps),
        **stats,
    )


_TARGET_FNS = {
    "v2": bench_v2,
    "v2_batched": lambda config=None: bench_v2(batched=True, config=config),
    "stage1": bench_stage1,
    "stage1_golden": lambda config=None: bench_stage1(golden=True, config=config),
    "stage1_fast": lambda config=None: bench_stage1(fastpath=True, config=config),
    "stage1_fast_reuse": lambda config=None: bench_stage1(fastpath=True, reuse=True, config=config),
    "host": bench_host,
    "e2e": bench_e2e,
    "stage2": bench_stage2,
    "stage2_golden": lambda config=None: bench_stage2(golden=True, config=config),
}

# Default-run order: the three headlines first, variants next, host-bound
# last. Seconds are per-target watchdog timeouts (BENCH_SUB_TIMEOUT
# overrides all), the JAX bench's.
_DEFAULT_ORDER = [
    ("stage2", 480),
    ("stage1", 360),
    ("v2", 360),
    ("stage1_golden", 240),
    ("stage2_golden", 240),
    ("stage1_fast", 240),
    ("stage1_fast_reuse", 240),
    ("v2_batched", 240),
    ("host", 180),
    ("e2e", 360),
]
_HEADLINES = ("stage2", "stage1", "v2")
_HEADLINE_METRIC = "stage2_256px_train_images_per_sec_per_chip"


def _emit_error(target: str, error: str, **extra):
    record = {"metric": target, "error": error, "elapsed_s": round(time.monotonic() - _T0, 1)}
    record.update(extra)
    print(json.dumps(record), flush=True)


def _watchdog_setup():
    """Child-process hang forensics: crash tracebacks always on, and an
    all-thread stack dump just before the orchestrator's kill lands
    (BENCH_CHILD_TIMEOUT)."""
    import faulthandler

    faulthandler.enable()
    t = os.environ.get("BENCH_CHILD_TIMEOUT")
    if t:
        faulthandler.dump_traceback_later(max(10.0, float(t) - 8.0), exit=False)


class _AlarmTimeout(Exception):
    pass


def _run_targets(targets, reemit_headline=False):
    """In-process runner (a child, or the BENCH_SUBPROC=0 run). A run of
    several targets guards each with SIGALRM (best effort: a hang inside
    a CUDA call returns to the interpreter only when the call does; the
    orchestrator's process-group kill is the hard line). With
    ``reemit_headline`` the stage-2 headline is printed again last."""
    import signal

    _watchdog_setup()
    device = _device()
    _hb(f"device {device}: {_card()[0]}")
    _session_roofline()  # the card's context line first (none on the CPU)
    use_alarm = (
        len(targets) > 1
        and hasattr(signal, "SIGALRM")
        and os.environ.get("BENCH_ALARM", "1") == "1"
    )
    per_bench = int(float(os.environ.get("BENCH_SUB_TIMEOUT", "0")) or 0)
    for t in targets:
        fn = _TARGET_FNS[t]
        # helpers keyed on BENCH_TARGET (the variants' 3 windows) see the
        # running target in process too
        os.environ["BENCH_TARGET"] = t
        _hb(f"bench {t}: start")
        if not use_alarm:
            fn()
            _hb(f"bench {t}: done")
            continue
        tmo = per_bench or dict(_DEFAULT_ORDER).get(t, 360)

        def _on_alarm(signum, frame):
            raise _AlarmTimeout()

        prev = signal.signal(signal.SIGALRM, _on_alarm)
        signal.alarm(tmo)
        try:
            fn()
            _hb(f"bench {t}: done")
        except _AlarmTimeout:
            _emit_error(t, "timeout", timeout_s=tmo, watchdog="sigalrm")
            _hb(f"bench {t}: SIGALRM timeout after {tmo}s; continuing")
        finally:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, prev)
    if reemit_headline:
        headline = _LAST_RECORDS.get(_HEADLINE_METRIC)
        if headline is not None:
            headline = dict(headline)
            headline["reemitted_headline"] = True
            headline["elapsed_s"] = round(time.monotonic() - _T0, 1)
            print(json.dumps(headline), flush=True)
        else:
            _emit_error("stage2", "headline_missing")


def _child_argv() -> list:
    """Command line of a target's child process (the orchestrator's tests
    put a scripted fake child here)."""
    return [sys.executable, "-m", "imagegenerator_tpu_torch.bench"]


def _kill_group(proc) -> None:
    """Kill a child's whole process group and reap the child: nothing it
    started may hold the card for the next target."""
    import signal

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    proc.wait()


def _orchestrate():
    """The BENCH_TARGET=all run: one child process (its own process
    group) per target, headlines first, per-target kill timeouts,
    explicit error and skip lines, one retry for a failed headline, the
    stage-2 headline printed again last. The parent never touches the
    card."""
    import threading

    budget = float(os.environ.get("BENCH_BUDGET_S", "840"))
    sub_tmo = float(os.environ.get("BENCH_SUB_TIMEOUT", "0") or 0)
    results = {}
    roofline = [None]
    card = [None]

    def _elapsed():
        return time.monotonic() - _T0

    def run_one(target: str, timeout_s: float, attempt: int = 1) -> bool:
        env = dict(os.environ)
        env["BENCH_TARGET"] = target
        env["BENCH_SUBPROC"] = "0"
        env["BENCH_CHILD_TIMEOUT"] = str(int(timeout_s))
        env["PYTHONPATH"] = os.pathsep.join(p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
        if roofline[0]:
            env["BENCH_SESSION_ROOFLINE"] = repr(roofline[0])
        if card[0]:
            env["BENCH_CARD"] = json.dumps(card[0])
        _hb(f"launch {target} (timeout {int(timeout_s)}s)")
        proc = subprocess.Popen(_child_argv(), stdout=subprocess.PIPE, env=env, text=True,
                                start_new_session=True)
        metric_lines = []

        def reader():
            for line in proc.stdout:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    # parent stdout stays strictly JSON metric lines
                    print(f"[bench child {target}] {line}", file=sys.stderr, flush=True)
                    continue
                if rec.get("metric") == "session_gemm_roofline_tflops":
                    if roofline[0] is not None:
                        continue  # one context line per run
                    roofline[0] = float(rec["value"])
                else:
                    metric_lines.append(rec)
                if card[0] is None and "device" in rec:
                    card[0] = [rec["device"], rec.get("power_limit_w")]
                rec["elapsed_s"] = round(_elapsed(), 1)
                if attempt > 1:
                    # a failed first attempt may have forwarded a metric
                    # line already; the retry's stays distinguishable
                    rec["attempt"] = attempt
                print(json.dumps(rec), flush=True)

        th = threading.Thread(target=reader, daemon=True)
        th.start()
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            _kill_group(proc)  # at the timeout, or whatever the child left running
        th.join(5 if rc is None else 10)
        if rc is None:
            _emit_error(target, "timeout", timeout_s=int(timeout_s), watchdog="subprocess_kill")
            return False
        if rc != 0:
            _emit_error(target, f"child_exit_{rc}")
            return False
        if not metric_lines:
            _emit_error(target, "no_metric_output")
            return False
        results[target] = metric_lines[-1]
        return True

    order = list(_DEFAULT_ORDER)
    if int(os.environ.get("BENCH_BATCH", "1")) > 1:
        # BENCH_BATCH > 1 makes bench_v2 itself the batched shape; the
        # variant would emit the same metric name twice
        order = [(t, s) for t, s in order if t != "v2_batched"]
    failed_headlines = []
    for target, tmo in order:
        tmo = sub_tmo or tmo
        remaining = budget - _elapsed()
        if remaining < 45:
            _emit_error(target, "skipped_budget", budget_s=budget)
            continue
        ok = run_one(target, min(tmo, remaining - 10))
        if not ok and target in _HEADLINES:
            failed_headlines.append((target, tmo))
    for target, tmo in failed_headlines:
        remaining = budget - _elapsed()
        if remaining < 60:
            _emit_error(target, "retry_skipped_budget", budget_s=budget)
            continue
        _hb(f"retry failed headline {target}")
        run_one(target, min(tmo, remaining - 10), attempt=2)
    headline = results.get("stage2")
    if headline is not None:
        headline = dict(headline)
        headline["reemitted_headline"] = True
        headline["elapsed_s"] = round(_elapsed(), 1)
        print(json.dumps(headline), flush=True)
    else:
        _emit_error("stage2", "headline_missing")


def main():
    target = os.environ.get("BENCH_TARGET", "all")
    if target == "all":
        if os.environ.get("BENCH_SUBPROC", "1") == "1":
            _orchestrate()
        else:
            _run_targets([t for t, _ in _DEFAULT_ORDER
                          if t != "v2_batched" or int(os.environ.get("BENCH_BATCH", "1")) == 1],
                         reemit_headline=True)
        return
    _run_targets([t.strip() for t in target.split(",") if t.strip()])


if __name__ == "__main__":
    main()
