#!/usr/bin/env python3
"""Drive the PyTorch port's v1 sampling path, its stage-1 and stage-2
training steps, the chain of its training and sampling CLIs, its v2
VQGAN+CLIP generation, its data and tensor parallelism, remat, its
evaluation CLI, its dry run, its bench, its weights-day playbook and its
attention kernels over every shape of the JAX fused path on one CUDA
card (or more, where there are).

    python3 chip_smoke.py            # everything, as below
    python3 chip_smoke.py --only v2  # build, then phase 7 alone (--only train: phase 6,
                                     # --only train2: phase 8, --only dp: phase 9,
                                     # --only eval: phase 10)
    python3 chip_smoke.py --only d2-trace  # phase 8 (a)'s f32 step traced per critic
                                           # update on six states (phase_d2_trace)
    python3 chip_smoke.py --only tiny-trace  # phase 8 (c)'s tiny step under other
                                             # rounding (phase_tiny_trace)
    python3 chip_smoke.py --only tiny-witness  # phase 8 (c)'s f32 steps, card and CPU,
                                               # against float64 (phase_tiny_witness)
    python3 chip_smoke.py --only tp  # build, then phase 11 alone
    python3 chip_smoke.py --only bench  # build, then phase 12 alone
    python3 chip_smoke.py --only weights-day  # build, then phase 13 alone
    python3 chip_smoke.py --only attention-shapes  # build, then phase 14 alone
    python3 chip_smoke.py --only batchnorm  # build, then phase 15 alone, and its
                                            # rows of the kernels line

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
   (losses and the gradient of z). Then times: 10-step windows at batch
   1 and 4 with the kernels on and off, in f32 (3 windows) and in bf16 (2
   windows), each kernel against its plain version and the library call,
   and ``torch.profiler`` over 5 steps. Then 256 px, where the image is
   larger than CLIP's 224 px and the cutouts take the lanczos path: the
   CLI for 3 iterations with the warp kernel on and off (the argmin's
   launches counted, each over N = 256 rows), one batch-1 step kernels on
   vs off at the limits above, and 10-step windows in f32.
8. stage-2 training at full width — ``Stage2Config()`` (BERT-base, G1 to
   64 px, G2 with 4 residual blocks to 256 px, D2 (16, 32, 64, 128, 256,
   512)), bf16, n_critic 5, from a seeded random init. The ``tem`` route
   (precomputed caption embeddings) at batch 256 with uint8 images: 2
   warm-ups, the median of 5 steps, images/s, peak memory and a
   ``torch.profiler`` table (device busy share, device time by class of
   kernel, the top kernels, the kernel count); a batch that does not fit
   is halved, and the log says so. The tokens route at the same batch with
   the kernels on: per step 12 tensor-core attention forwards, 0
   backwards, 25 LayerNorm forwards, 0 backwards; the caption-embedding
   cache over 600 captions (a BERT forward per sweep of 256, then read
   back from the store with no launch). Correctness at batch 32,
   each check with one planted fault that it must catch: (a) one tokens
   step with the kernels on against off from the same state, batch and
   noise, in f32 (TF32 off) and bf16, after a plain warm-up step: the 4
   metrics, G2's BatchNorm statistics, and D2's before the critic's first
   update (after the step D2's are printed beside a witness, not held: see
   ``_train2_checks``); (b) the ``tem`` route fed ``embed_texts(tokens)``
   against the tokens route, same limits; (c) one step at
   ``Stage2Config.tiny()`` on the card, f32, against the same step in
   float64 on the CPU, noise replayed, four times: metrics, BatchNorm
   statistics, the optimizers' first moments and the updated parameters
   at 1e-4, with the card's convolutions off cuDNN (``exact_f32``; the
   same step on cuDNN and the CPU's own f32 step are printed beside it
   against float64, not held); (d) the frozen stack
   bit-equal after all the steps above. Then the chain through the entry
   points, full width, bf16, ``--fused_attn --fused_ln --ema 0.999``,
   batch 32, on 64 captioned 640 x 480 PNGs the script writes (read back
   by the standard-library PNG reader where Pillow is not installed):
   ``train.cli --stage 1`` for one epoch (2 steps), ``train.cli --stage 2
   --stage1_checkpoint ...`` for one epoch, each run a second time, which
   must resume (``Loaded checkpoint at epoch 0``) and take no step; then
   ``train.sample --stage 2 --ema`` on that checkpoint: 256 x 256 PNGs
   with their ``comment`` chunks. The checkpoint layout and the kernels'
   launch counts are checked (stage 1: attention forward and backward,
   LayerNorm both ways; stage 2 and sampling: forwards only).
9. data parallelism, two ranks: one card each over NCCL where there are
   two cards, else both on ``cuda:0`` over gloo (the log says which and
   how many cards). The script starts itself once per rank
   (``--dp-worker``). (1) Tiny f32 steps of both stages, two each, on
   the card against the same two ranks over gloo on the CPU, at phase 8
   (c)'s limits and off cuDNN as there; after every step the ranks' parameters and optimizer
   state bit-equal, their BatchNorm statistics apart (by how much is
   printed). (2) Two planted faults, each caught: a reduce that sums
   instead of averaging (the card leaves the CPU), and rank 1 without the
   critic's reduce (the ranks' parameters part). (3) Full width, bf16, a
   rank's share: the stage-1 step at batch 128 with phase 6's BERT flags
   (12 attention and 25 LayerNorm launches each way per rank per step) and
   the stage-2 ``tem`` route at batch 256; step ms, images/s over the
   ranks, and from ``torch.profiler`` the time in the reduces. (4)
   ``torchrun --standalone --nproc_per_node 2 -m
   imagegenerator_tpu_torch.train.cli --multihost --stage 2`` at full
   width, batch 32 a rank, on 64 PNGs as phase 8 writes them, twice:
   rank 0 alone logs steps and writes the checkpoint, both ranks resume,
   ``--profile_dir`` leaves one trace per rank.
10. the CLIP family and evaluation, full width, from seeded random
   weights written under OpenAI's names (``seeded_clip_state``: He-scaled
   convolutions, BatchNorm statistics away from the identity, and in the
   file BatchNorm's counters and ``logit_scale``, as published). (1)
   RN50's image tower at batch 4 and its text tower on the card (f32, off
   TF32 and cuDNN) against the CPU, max abs difference over the largest
   output <= 1e-4; a planted fault (the attention pool without its mean
   token) must be caught. (2) The v2 CLI with ``-m RN50`` (the slice's
   path: the ImageNet f16 VQGAN, 128 px, 32 cutouts at 224 px, f32, warp
   kernel on) for 3 iterations: PNG, ``comment`` chunk, finite losses,
   launch counts; one step's launches (one ``vq_argmin``, two
   ``scanline_lerp``); one batch-4 step kernels on vs off at phase 7's
   limits in f32; 10-step windows at batch 1, kernels on and off. (3)
   The evaluation CLI on 512 generated 256 px images (an ``.npz``)
   against 512 reference PNGs (blocky colour fields of two different
   laws) with 512 captions (``@file``), ``--batch 64``, ViT-B/32 and
   RN50 in f32 and bf16: the JSON line's keys, counts and finite values,
   the CLIPScore in [0, 100], and both numbers against numpy's from the
   card's embeddings (1e-6 relative plus half a unit of the digit the
   line keeps); 512 samples span at most 511 dimensions, so both towers'
   covariances (512 and 1024 dimensions) must take the eps
   regularisation; then phase 8's sampled PNGs scored against their
   captions (sample -> evaluate; left out under ``--only eval``). A
   witness, printed and not held: RN50's numbers from embeddings at
   batch 64 and at 32 in one process, TF32 off, and the v2 losses of
   one batch-4 engine against two batch-2 halves (``shard=``) over 3
   iterations. (4) ``torchrun --standalone
   --nproc_per_node 2`` (a card a rank over NCCL where there are two,
   else both on ``cuda:0`` over gloo) against one process, both with
   TF32 off (``NVIDIA_TF32_OVERRIDE=0``): the eval CLI with ``--dp 2``
   (its line equal, floats to 1e-5 relative), and the v2 CLI at batch 4
   (``--prompts_file`` of 4 lines, RN50, 3 iterations; loss lines to
   1e-4 relative, PNG pixels within 1 of 255). (5) Times: each tower's
   embedding rate at batch 64 from 256 px images on the card (the
   resize included) under the CLI's defaults, in f32 and bf16, and the
   device's busy share over one batch; the CLI's wall seconds and the
   RN50 v2 step's ms come from (2) and (3).
11. tensor parallelism, remat and the dry run (``--only tp``). (a) The
   attention pair on a model rank's head group, (256, 128, 384) bf16 with
   6 of BERT-base's 12 heads, the seed folded by the shard's head offset,
   against the plain version of the whole width's heads 6-11 at rate 0.1
   and 0, a planted fault each (the seed without the head offset, a
   backward that ignores the mask), times beside the bound and SDPA. Then
   phase 6's full-width stage-1 step (batch 128, bf16, ``--fused_attn
   --fused_ln``, text dropout on) on (data, model) grids of (1, 2) and
   (2, 2) ranks, the script started once per rank (``--tp-worker``), on
   ``cuda:0`` over gloo (and a card each over NCCL where there are as
   many cards as ranks), against the one-process step on the same batch
   and generators at ``STEP_TOL['bf16']``: the metrics, the generator's
   BatchNorm statistics and the encoder's gradients under a fixed
   cotangent of tem; each rank's launches, 12 + 12 attention on the
   tensor-core kernels at width 384 and 25 + 25 LayerNorm. (b)
   ``torchrun ... train.cli --multihost --tp 2 --stage 1 --fused_attn
   --fused_ln`` (tiny GAN nets over a 2-layer encoder of head dim 64),
   twice: trains, saves, resumes; the checkpoint loads in one process.
   (c) remat against none, f32, the full-width stage-1 step and the
   stage-2 step at batch 32: metrics at 1e-5, peak memory (stage 1's
   must be lower with remat) and step times.
   (d) CLIP ViT-B/32 split over two model ranks against one process at
   1e-5 of the largest output. (e) ``dryrun.dryrun_multichip(2)``.
12. the bench (``--only bench``): ``python -m imagegenerator_tpu_torch.bench``
   as a process, orchestrated over all ten targets at full width with
   short windows (``BENCH_SHORT``: one window of 2 steps, chains of 5, 128
   host images, 2 e2e batches). It must print one metric line per target
   and no error or skip line, the stage-2 line last, the GEMM roofline
   inside (0, 1.05 x the card's bf16 peak], every training and v2 line's
   ``mfu`` inside (0, 1.05), and each line's kernel launches per step as
   ``BENCH_LAUNCHES`` has them (stage 1: 12 attention forwards, all with
   dropout, and 12 backwards, on the tensor cores; v2: one codebook
   argmin). The stage-1 line's ``flops_per_step`` (kernel route: the
   kernels' formulas) must equal the same step counted on the plain route
   in this process within 0.1%; the bench's stage-2 step (f32 images)
   must be within 15% of phase 8's median (uint8 images; timed here the
   same way under ``--only bench``); then ``python -m
   imagegenerator_tpu_torch.tools.profile_opclass --workload stage1``
   must give the hand kernels device time and shares that sum to 100 +-
   0.5%.
13. the weights day (``--only weights-day``): the port's playbook
   (``python -m imagegenerator_tpu_torch.tools.validate_real_weights``)
   on the card, f32 with TF32 off, over phase 7's seeded full-width VQGAN
   and CLIP ViT-B/32, a seeded BERT-base under HF names and a merges file
   of the published length: every section and MANIFEST, the generation
   through the v2 CLI with its ``vq_argmin`` launches counted (one per
   iteration, two per checkin, one for the VQGAN section's probe); its
   VQGAN, CLIP and BERT sections again on the CPU: VQGAN indices equal,
   ``z_q`` and the decoded image at phase 7's f32 relative L2 (1e-4), CLIP
   embeddings and BERT's CLS at phase 4's f32 limit (1e-3 of max(1, the
   CPU's max abs)); BERT's CLS with the attention and LayerNorm kernels on
   (12 + 25 launches) against off at phase 4's 1e-3. Prints the
   generation's launches and the phase's wall seconds.

14. attention over every shape the JAX fused path takes (``--only
   attention-shapes``). (a) The pair over a covering grid: f32 and bf16 x
   head dims 8, 16, 40, 64, 128, 256, 320 x T = 1, 77, 128, 136, 256,
   512, 1024 x no mask, ragged rows, a fully masked row x rate 0 and 0.1
   (B 3, 2 heads), each case through the wrappers against the plain
   versions at phase 2's limits (m at atol 1e-5 on every route), each on
   the route ``kernel_route`` names, its counters read: bf16 with head dim
   32, 64 or 128 on the Hopper kernels (wgmma on TMA-fed tiles) at every
   T but the whole-head kernels' d = 64, T <= 128, the other bf16 head
   dims up to 256 on the mma.sync kernels, f32 and bf16 at 320 on the FMA
   kernels; the keep-mask bits read back from both kernels (q = k = 0,
   one-hot v and dO) equal the plain version's, on the route of the case;
   on the Hopper route two backward runs give equal bits; two planted
   faults on the Hopper route (the scale left at 1/8 at head dim 32; the
   keep-mask hash read at the query one row on). (b) Times of the pair at
   (256, 256, 768) and (256, 512, 768), at (256, 128, 768) with 24 heads
   of 32 and 6 of 128 (the Hopper kernels, each beside the mma.sync tiled
   kernels at the same shape through the C entry points' route argument),
   with 16 heads of 48 (the mma.sync tiled kernels) and with 12 heads
   (the whole-head kernels, beside PERF.md's device times): CUDA events in
   turns with the plain versions, profiler device time, rate 0.1 and 0,
   SDPA and its backward at rate 0, the bound. (c) The full-width stage-1
   step (bf16, ``--fused_attn`` with 16-bit masks, ``--fused_ln``, text
   dropout on) at seq_len 256 and 512: one step at batch 32 (12 + 12
   attention launches, all on the Hopper kernels, 25 + 25 LayerNorm), then
   at batch 128 with remat (halved while it does not fit) kernels on and
   off in turns; at 512 phase 6's kernels-on-vs-off check at batch 32;
   one step each with 24 heads of 32, 6 of 128 and 16 of 48 at seq_len
   128 for their launches. (d) The tiny stage-1 step (``BertConfig.tiny``:
   head dim 8) with fused attention and text dropout on, f32, on the card
   (FMA kernels, off cuDNN) against the same step on the CPU, masks and
   seeds replayed, at phase 8 (c)'s limits.

15. the BatchNorm kernels (``--only batchnorm``; csrc/batch_norm_nhwc.cu).
   (a) ``tests/test_torch_kernels_cuda.py -k batch_norm``: each pass
   against its plain version at every BatchNorm shape of G1, D1, G2 and
   D2 at batch 256 in bf16, the Functions against the layer's composition,
   two calls to equal bits, the counters of a tiny stage-2 step with the
   plain versions refused, other dtypes refused. (b) At G2's largest map
   (128 x 128 x 80, batch 256, bf16) the three passes against their plain
   versions with one planted fault (the forward's eps at 0.25). (c) The
   full-width stage-2 step (bf16, tokens route) at batch 32: the kernel
   launches of each route a step. (d) ``tools/probe_torch_batchnorm.py`` at G2's
   128 x 128 x 80 and 16 x 16 x 640 and D2's 64 x 64 x 32: kernel, plain
   (the layer's composition) and ``F.batch_norm`` times and the bound.

Then one JSON line of the kernels (each with its launches on its main
path, its error, its time, its plain version's, the least time the card
could take and, where one PyTorch call computes the same function, that
call's; the v2 kernels also with their launches at 256 px and on one
RN50 step, the v1 training kernels with one rank's launches in a step of
phase 11's grid, the attention pair's rows at that rank's width 384, and
phase 14's rows: the Hopper kernels at seq_len 256 and 512 and at head
dims 32 and 128, the mma.sync tiled kernels at head dim 48, the
whole-head kernels, each with the launches of one step of that
configuration), the card's line from nvidia-smi, and last ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import contextlib
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
# The stage-2 step (phase 8) holds G2's statistics as "bn" and has two
# limits of its own in bf16, "gp" and "bn_critic": between the two sides'
# BERT outputs (which differ by 2e-2 in bf16) and gp lie five Adam updates
# of the critic, and gp = (|grad| - 1)^2 moves about three times as far as
# the gradient's norm. Sound kernels read gp 1.1e-2 in bf16 (9.2e-5 in
# f32). "bn_critic" holds D2's statistics before the critic's first
# update, where sound f32 kernels read 1.2e-7 to 1.5e-7 (after the step
# they are not held: see _train2_checks).
STEP_TOL = {
    "f32": {"metric": 1e-3, "bn": 1e-4, "grads": 1e-4, "gp": 1e-3, "bn_critic": 1e-4},
    "bf16": {"metric": 2e-2, "bn": 1e-3, "grads": 2e-2, "gp": 5e-2, "bn_critic": 2e-2},
}
IMAGE_TOL = {"f32": 1e-3, "bf16": 0.1}
# max abs, BERT's last hidden state (values within about +-4). On an H100
# a sound run reads 3.3e-6 (f32) and 2.0e-2 (bf16); a planted fault (mask
# ignored, 1 / l dropped, LayerNorm mean left out) reads 0.26 to 5.8 in
# either.
HIDDEN_TOL = {"f32": 1e-3, "bf16": 0.1}


_START = time.perf_counter()


def log(msg: str) -> None:
    if msg.startswith("phase "):  # the run's seconds so far, against its time limit
        msg = f"[{time.perf_counter() - _START:7.1f} s] {msg}"
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
    fails on it. A short trace can lose every launch in each of
    ``profiled``'s tries (10 launches of a 0.09 ms kernel, three times
    running, on an H100): then it is traced again over ten times as many
    calls before the phase fails."""
    for n in (calls, 10 * calls):
        try:
            _, events = profiled(fn, n)
            break
        except AssertionError:
            if n != calls:
                raise
            log(f"  {PROFILE_TRIES} traces of {n} calls lost every launch; tracing {10 * n} calls")
    return sum(e.self_device_time_total / e.count * -(-e.count // n) for e in events) / 1e3


def set_tf32(enabled: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


@contextlib.contextmanager
def exact_f32():
    """TF32 off and cuDNN off: convolutions take PyTorch's own CUDA
    kernels (im2col and cuBLAS products in f32), whose arithmetic no
    library heuristic picks. For the card-vs-CPU holds at ``TINY_TOL``:
    on one machine phase 8 (c) on cuDNN read ``loss_critic`` at 1.19x its
    limit and G2's first convolution's moment at 57x, the pattern of a
    convolution backward in reduced precision
    (``--only tiny-trace`` reads it from a CPU step whose
    convolution backward takes TF32-rounded operands), where other
    machines read 0.1x with cuDNN's deterministic, benchmarked or default
    engines alike."""
    import torch

    set_tf32(False)
    before = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = before


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
    attention.wgmma_launches = attention.wgmma_bwd_launches = 0
    layernorm.launches = layernorm.bwd_launches = 0


def read_counts(attention, layernorm) -> dict:
    return {
        "attention": attention.launches, "attention_mma": attention.mma_launches,
        "attention_dropout": attention.dropout_launches,
        "attention_bwd": attention.bwd_launches, "attention_bwd_mma": attention.mma_bwd_launches,
        "layernorm": layernorm.launches, "layernorm_bwd": layernorm.bwd_launches,
    }


def read_wgmma(attention) -> dict:
    """The Hopper attention kernels' launches (a part of the tensor-core
    counts of ``read_counts``)."""
    return {"attention_wgmma": attention.wgmma_launches, "attention_bwd_wgmma": attention.wgmma_bwd_launches}


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
            fake_64 = system.frozen_64(tem, noise["ca1_eps"], noise["z"])
            c_hat2 = system.con_augment_2(tem, eps=noise["ca2_eps"])[0]
            stages = {
                "text encode": lambda: system.embed_texts(ids, mask),
                "CA1 + G1": lambda: system.frozen_64(tem, noise["ca1_eps"], noise["z"]),
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


def train_batch(cfg, gen, B=TRAIN_BATCH):
    """Seeded tokens with ragged padding and uint8 64 px images."""
    import torch

    T = cfg.seq_len
    lengths = torch.randint(8, T + 1, (B,), generator=gen, device="cuda")
    return {
        "input_ids": torch.randint(1, cfg.bert.vocab_size, (B, T), generator=gen, device="cuda",
                                   dtype=torch.int32),
        "attention_mask": (torch.arange(T, device="cuda")[None, :] < lengths[:, None]).int(),
        "image": torch.randint(0, 256, (B, cfg.resolution, cfg.resolution, 3), generator=gen,
                               device="cuda", dtype=torch.uint8),
    }


def train_noise(cfg, gen, B=TRAIN_BATCH):
    import torch

    n = cfg.n_critic
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


def on_off_readings(on, off, batch, noise, cot) -> dict:
    """One step of two stage-1 systems from the same state, the kernels on
    and off, with the same batch and noise: ``{what: (kind, on, off)}`` of
    the 4 metrics, the generator's updated BatchNorm statistics and the
    encoder's and projection's gradients of ``sum(tem * cot)`` over the
    step's text forward, taken before the step (which moves each side's
    parameters by its own ill-conditioned generator-step gradients)."""
    import torch

    grads_on, grads_off = text_grads(on, batch, noise["perm"], cot), text_grads(off, batch, noise["perm"], cot)
    m_on, m_off = on.train_step(batch, noise=noise), off.train_step(batch, noise=noise)
    torch.cuda.synchronize()
    readings = {f"metric {k}": ("metric", m_on[k], m_off[k]) for k in m_on}
    stats = [(b, off.generator.get_buffer(n)) for n, b in on.generator.named_buffers()]
    readings["generator BN stats"] = ("bn", torch.cat([a.flatten() for a, _ in stats]),
                                      torch.cat([b.flatten() for _, b in stats]))
    for module in grads_on:
        readings[f"{module} grads, fixed tem cotangent"] = ("grads", grads_on[module], grads_off[module])
    return readings


def hold_on_off(tag, readings) -> None:
    """Phase 6's kernels-on-vs-off readings ``{what: (kind, on, off)}`` at
    ``STEP_TOL[tag][kind]``: relative L2 for gradients, else max abs
    difference over max(1, the plain side's max abs)."""
    import torch

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
    per_step = WITH_BACKWARD
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
        hold_on_off(tag, on_off_readings(on, off, batch, noise, cot))
        for module in ("encoder", "projection"):
            got = torch.cat([p.grad.flatten().double() for p in getattr(on, module).parameters()])
            want = torch.cat([p.grad.flatten().double() for p in getattr(off, module).parameters()])
            log(f"  {tag} generator-step {module} grads: relative L2 difference "
                f"{((got - want).norm() / want.norm()).item():.3e} (reported, not held: "
                f"ill-conditioned through the KL term's 2 / sigma)")
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
V2_LANCZOS, V2_LANCZOS_ITERS = 256, 3  # larger than ViT-B/32's 224 px: the lanczos cutouts
VQ_SHAPE = (64, 16384, 256)  # N, K, d on the main path: an 8 x 8 latent, the ImageNet f16 codebook
VQ_TIMED_N = (64, 256, 512, 4096)
LERP_SHAPE = (32 * 128, 3, 128, 128)  # S, C, K, O: 32 cutouts of 128 scanlines, 128 px
V2_WINDOW = 10  # steps a timing window
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


def run_cli(main, argv) -> str:
    """``main(argv)`` in-process; returns what it printed (and logs it)."""
    import contextlib
    import io

    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            main(argv)
    finally:
        for line in printed.getvalue().splitlines():
            log(f"    | {line}")
    return printed.getvalue()


def run_v2_cli(args, warp_kernel: str = "1") -> str:
    """The v2 CLI in-process with the warp kernel on (``warp_kernel="0"``:
    off); returns what it printed (and prints it)."""
    import os

    from imagegenerator_tpu_torch.v2 import generate

    before = os.environ.get("IMAGEGEN_WARP_KERNEL")
    os.environ["IMAGEGEN_WARP_KERNEL"] = warp_kernel
    try:
        return run_cli(generate.main, args)
    finally:
        if before is None:
            del os.environ["IMAGEGEN_WARP_KERNEL"]
        else:
            os.environ["IMAGEGEN_WARP_KERNEL"] = before


def write_vqgan(tmp: Path, gen) -> dict:
    """A seeded random-init full-width VQGAN written to ``tmp`` as
    taming's ``vqgan.ckpt`` (Lightning layout) and ``vqgan.yaml``; its
    ``state_dict`` on the card."""
    import torch

    from imagegenerator_tpu_torch.v2.vqgan import VQModel

    vq_cfg, _ = v2_configs()
    vq_state = VQModel(vq_cfg, device="cuda", generator=gen).state_dict()
    torch.save({"state_dict": {k: v.cpu() for k, v in vq_state.items()}}, tmp / "vqgan.ckpt")
    # taming's yaml; written in JSON's syntax, which is YAML too
    (tmp / "vqgan.yaml").write_text(json.dumps({"model": {
        "target": "taming.models.vqgan.VQModel",
        "params": {"embed_dim": vq_cfg.embed_dim, "n_embed": vq_cfg.n_embed, "ddconfig": {
            "z_channels": vq_cfg.z_channels, "resolution": vq_cfg.resolution,
            "in_channels": vq_cfg.in_channels, "out_ch": vq_cfg.out_ch, "ch": vq_cfg.ch,
            "ch_mult": list(vq_cfg.ch_mult), "num_res_blocks": vq_cfg.num_res_blocks,
            "attn_resolutions": list(vq_cfg.attn_resolutions), "dropout": vq_cfg.dropout}}}}))
    return vq_state


def write_v2_files(tmp: Path) -> tuple:
    """Phase 7's seeded full-width VQGAN (``vqgan.ckpt``, ``vqgan.yaml``)
    and CLIP ViT-B/32 (``ViT-B-32.pt``, a ``state_dict`` under OpenAI's
    names) in ``tmp``; their ``state_dict``s on the card."""
    import torch

    from imagegenerator_tpu_torch.v2.clip import CLIP

    _, clip_cfg = v2_configs()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    vq_state = write_vqgan(tmp, gen)
    clip_state = CLIP(clip_cfg, device="cuda", generator=gen).state_dict()
    torch.save({k: v.cpu() for k, v in clip_state.items()}, tmp / "ViT-B-32.pt")
    return vq_state, clip_state


def phase_v2_path(tmp: Path, vq_argmin, scanline_lerp):
    import math

    import numpy as np
    import torch

    log("phase 7: v2 main path, full width")
    t0 = time.perf_counter()
    vq_state, clip_state = write_v2_files(tmp)
    ckpt, conf, clip_pt = tmp / "vqgan.ckpt", tmp / "vqgan.yaml", tmp / "ViT-B-32.pt"
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


def v2_engine(vq_state, clip_state, dtype, kernels: bool, vq_kernel=None, clip_cfg=None):
    """A full-width engine sharing the given weights. ``kernels``: the
    warp through the scanline kernel and the argmin kernel, or the dense
    warp and the plain argmin; ``vq_kernel`` overrides the argmin's.
    ``clip_cfg``: the CLIP tower (None: phase 7's ViT-B/32)."""
    from imagegenerator_tpu_torch.v2.engine import GenerateEngine

    vq_cfg, vit = v2_configs()
    vq_on = kernels if vq_kernel is None else vq_kernel
    return GenerateEngine(vq_cfg, clip_cfg or vit, vq_state, clip_state, compute_dtype=dtype,
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


def phase_v2_on_off(vq_state, clip_state, gen, batch=4, side=8, dtypes=("f32", "bf16"), clip_cfg=None,
                    phase=7):
    """One step at ``batch`` on a ``side`` x ``side`` latent from the same
    state and draws, kernels on vs off, in each of ``dtypes``."""
    import torch

    log(f"phase {phase}: one v2 step at batch {batch}, {16 * side} px, kernels on vs off")
    set_tf32(False)
    for dtype, tag in ((None, "f32"), (torch.bfloat16, "bf16")):
        if tag not in dtypes:
            continue
        engines = {
            "kernels on": v2_engine(vq_state, clip_state, dtype, True, clip_cfg=clip_cfg),
            "plain argmin": v2_engine(vq_state, clip_state, dtype, True, vq_kernel=False, clip_cfg=clip_cfg),
            "dense warp": v2_engine(vq_state, clip_state, dtype, False, vq_kernel=True, clip_cfg=clip_cfg),
        }
        on = engines["kernels on"]
        z0 = on.random_token_latent(gen, batch, side, side)
        prompts = v2_prompts(on, batch)
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
    # f32 is what the CLI runs; bf16 compute with fewer windows
    for dtype, dt, windows, batch in ((None, "f32", 3, 1), (None, "f32", 3, 4),
                                      (torch.bfloat16, "bf16", 2, 1), (torch.bfloat16, "bf16", 2, 4)):
        engines = {tag: v2_engine(vq_state, clip_state, dtype, tag == "on") for tag in ("on", "off")}
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
        for i in range(windows):
            for tag in (("off", "on") if i % 2 == 0 else ("on", "off")):
                samples[tag].append(window(tag))
        for tag in ("on", "off"):
            ms = statistics.median(samples[tag])
            step_ms[dt, batch, tag] = ms
            log(f"  v2 step batch {batch} {dt} kernels {tag}: {ms:.3f} ms per step, "
                f"{1e3 / ms:.2f} steps/s, {batch * 1e3 / ms:.2f} prompt-steps/s (windows of "
                f"{V2_WINDOW}: {', '.join(f'{t:.2f}' for t in samples[tag])}) [{card}]")
        for tag in ("on", "off") if dtype is None else ("on",):
            host_ms, events = profiled(lambda: engines[tag].chain(states[tag], 5, SEED, *prompts), calls=1)
            busy = sum(e.self_device_time_total for e in events) / 1e3
            log(f"  profiled 5 steps batch {batch} {dt}, kernels {tag}: host {host_ms / 5:.3f} ms per step, "
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


def phase_v2_lanczos(tmp: Path, vq_argmin, scanline_lerp, card):
    """The v2 CLI at ``-s 256 256``: the image is larger than ViT-B/32's
    224 px, so the cutouts take the lanczos path (``random_augment``'s
    warp through the scanline kernel when it is on). Each step's codebook
    search runs over the 16 x 16 latent: N = 256."""
    import math

    import torch

    log(f"phase 7: the v2 CLI at {V2_LANCZOS} px (the lanczos cutouts), full width")
    files = ["-conf", str(tmp / "vqgan.yaml"), "-ckpt", str(tmp / "vqgan.ckpt"),
             "--clip_checkpoint", str(tmp / "ViT-B-32.pt")]
    rows = []
    kernel = vq_argmin.vq_argmin

    def recording(x, codebook):
        rows.append(x.shape[0])
        return kernel(x, codebook)

    launches = None
    vq_argmin.vq_argmin = recording
    try:
        for warp in ("1", "0"):
            out = tmp / f"lanczos_{warp}.png"
            vq_argmin.launches = scanline_lerp.launches = 0
            rows.clear()
            t0 = time.perf_counter()
            printed = run_v2_cli(V2_ARGS + ["-i", str(V2_LANCZOS_ITERS), "-s", str(V2_LANCZOS), str(V2_LANCZOS),
                                            "-o", str(out)] + files, warp_kernel=warp)
            torch.cuda.synchronize()
            counts = v2_counts(vq_argmin, scanline_lerp)
            checkins = V2_LANCZOS_ITERS // V2_EVERY + 1
            want = {"vq_argmin": V2_LANCZOS_ITERS + 2 * checkins,
                    "scanline_lerp": (2 * V2_LANCZOS_ITERS + 2 * checkins) if warp == "1" else 0}
            log(f"  warp kernel {'on' if warp == '1' else 'off'}: {time.perf_counter() - t0:.1f} s for "
                f"{V2_LANCZOS_ITERS} iterations; launches {counts}; codebook search rows {sorted(set(rows))}")
            if counts != want or set(rows) != {(V2_LANCZOS // 16) ** 2}:
                raise AssertionError(f"launches {counts} over rows {set(rows)}, expected {want} over 256")
            losses = [float(l.split("loss: ")[1].split(",")[0]) for l in printed.splitlines()
                      if l.startswith("i: ")]
            if len(losses) != checkins or not all(map(math.isfinite, losses)):
                raise AssertionError(f"losses {losses}")
            if png_size(out) != (V2_LANCZOS, V2_LANCZOS):
                raise AssertionError(f"{out}: size {png_size(out)}")
            launches = launches or counts
    finally:
        vq_argmin.vq_argmin = kernel
    log(f"  {V2_LANCZOS}x{V2_LANCZOS} PNGs with finite losses; launches match, warp kernel on and off [{card}]")
    return launches


def phase_v2_lanczos_times(vq_state, clip_state, gen, card, size=V2_LANCZOS, clip_cfg=None, what=None):
    """10-step windows at ``size`` px (256: the lanczos cutouts), batch 1,
    f32, kernels on and off in turns; the median ms a step of each."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    what = what or f"{size} px"
    engines = {tag: v2_engine(vq_state, clip_state, None, tag == "on", clip_cfg=clip_cfg) for tag in ("on", "off")}
    prompts = v2_prompts(engines["on"], 1)
    side = size // 16
    z0 = engines["on"].random_token_latent(gen, 1, side, side)
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
    for i in range(2):
        for tag in (("off", "on") if i % 2 == 0 else ("on", "off")):
            samples[tag].append(window(tag))
    step_ms = {}
    for tag in ("on", "off"):
        step_ms[tag] = ms = statistics.median(samples[tag])
        log(f"  v2 step {what} batch 1 f32 kernels {tag}: {ms:.3f} ms per step, {1e3 / ms:.2f} "
            f"steps/s (windows of {V2_WINDOW}: {', '.join(f'{t:.2f}' for t in samples[tag])}) [{card}]")
    host_ms, events = profiled(lambda: engines["on"].chain(states["on"], 5, SEED, *prompts), calls=1)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"  profiled 5 steps at {what}, kernels on: host {host_ms / 5:.3f} ms per step, device busy "
        f"{busy / 5:.3f} ms per step ({100 * busy / host_ms:.1f}%), {sum(e.count for e in events) // 5} "
        "kernels per step")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"    {e.self_device_time_total / 5e3:8.3f} ms {e.count // 5:5d}x {e.key[:90]}")
    return step_ms


def phase_v2(vq_argmin, scanline_lerp, gen, card):
    errs = phase_v2_kernels(vq_argmin, scanline_lerp, gen)
    with tempfile.TemporaryDirectory() as tmp:
        launches, vq_state, clip_state = phase_v2_path(Path(tmp), vq_argmin, scanline_lerp)
        lanczos_launches = phase_v2_lanczos(Path(tmp), vq_argmin, scanline_lerp, card)
    phase_v2_on_off(vq_state, clip_state, gen)
    phase_v2_on_off(vq_state, clip_state, gen, batch=1, side=V2_LANCZOS // 16, dtypes=("f32",))
    _, timed = phase_v2_times(vq_state, clip_state, vq_argmin, scanline_lerp, gen, card)
    log(f"phase 7: v2 times at {V2_LANCZOS} px on {card}")
    phase_v2_lanczos_times(vq_state, clip_state, gen, card)
    return launches, lanczos_launches, errs, timed


# ------------------------------------------------------- stage-2 training

TRAIN2_BATCH = 256  # the tem route's timed batch (halved, with a log line, if it does not fit)
TRAIN2_CHECK_BATCH = 32
CHAIN_BATCH, CHAIN_IMAGES, CHAIN_IMAGE_SIZE = 32, 64, (480, 640)
# kernel launches of one BERT-base forward at rate 0, and of a training
# forward with dropout and its backward (a stage-1 step)
NO_BACKWARD = {"attention": 12, "attention_mma": 12, "attention_dropout": 0, "attention_bwd": 0,
               "attention_bwd_mma": 0, "layernorm": 25, "layernorm_bwd": 0}
WITH_BACKWARD = {"attention": 12, "attention_mma": 12, "attention_dropout": 12, "attention_bwd": 12,
                 "attention_bwd_mma": 12, "layernorm": 25, "layernorm_bwd": 25}
FROZEN = ("encoder.", "projection.", "con_augment_1.", "gen_1.")
# phase 8 (c), the tiny f32 step on the card against the CPU's float64 one
# (phase 9: the card's ranks against the CPU's f32 ranks): metrics and
# BatchNorm statistics rtol = atol; an optimizer's first moment within MOMENT
# of its tensor's largest plus as much relative; a parameter within PARAM
# where its gradient is not rounding noise (its moment at least NOISE of the
# tensor's largest: Adam's first updates move an element by lr * sign(g),
# so where g is noise around 0 the two sides may step in opposite directions)
TINY_TOL = {"metric": 1e-4, "bn": 1e-4, "moment": 1e-4, "param": 1e-4, "noise": 1e-3}


def kernel_class(name: str) -> str:
    n = name.lower()
    if any(k in n for k in ("attention_", "layernorm", "vq_argmin", "lerp", "batch_norm")):
        return "hand-written kernels"
    if any(k in n for k in ("xmma", "cudnn", "cutlass", "gemm", "conv", "wgrad", "dgrad", "fprop",
                            "nhwc", "nchw")):
        return "convolutions and GEMMs (library)"
    if "reduce" in n:
        return "reductions"
    if any(k in n for k in ("elementwise", "copy", "cat", "fill")):
        return "elementwise and copies"
    return "other"


def train2_config(fused: bool, dtype):
    from imagegenerator_tpu_torch.models.bert import BertConfig
    from imagegenerator_tpu_torch.train.stage2 import Stage2Config

    return Stage2Config(compute_dtype=dtype, bert=BertConfig(fused_attention=fused, fused_ln=fused))


def train2_batch(cfg, gen, batch):
    """Seeded tokens with ragged padding and uint8 256 px images."""
    import torch

    T = cfg.seq_len
    lengths = torch.randint(8, T + 1, (batch,), generator=gen, device="cuda")
    return {
        "input_ids": torch.randint(1, cfg.bert.vocab_size, (batch, T), generator=gen, device="cuda",
                                   dtype=torch.int32),
        "attention_mask": (torch.arange(T, device="cuda")[None, :] < lengths[:, None]).int(),
        "image": torch.randint(0, 256, (batch, cfg.resolution, cfg.resolution, 3), generator=gen,
                               device="cuda", dtype=torch.uint8),
    }


def train2_noise(cfg, gen, batch, device="cuda"):
    import torch

    n = cfg.n_critic
    kw = dict(generator=gen, device=device)
    return {
        "perm": torch.randperm(batch, **kw),
        "ca1_eps": torch.randn((n, batch, cfg.c_dim), **kw),
        "z": torch.randn((n, batch, cfg.z_dim), **kw),
        "ca2_eps": torch.randn((n, batch, cfg.c_dim), **kw),
        "gp_eps": torch.rand((n, batch, 1, 1, 1), **kw),
    }


def train2_system(cfg, state):
    from imagegenerator_tpu_torch.train.stage2 import Stage2System

    system = Stage2System(cfg, device="meta")
    system.load_state_dict({k: v.clone() for k, v in state.items()}, assign=True)
    return system


def check_frozen(system, state) -> None:
    """The frozen stack (parameters and G1's BatchNorm statistics) is
    bit-equal to ``state``'s."""
    import torch

    now = system.state_dict()
    keys = [k for k in state if k.startswith(FROZEN)]
    moved = [k for k in keys if not torch.equal(now[k], state[k])]
    if len(keys) < 200 or moved:
        raise AssertionError(f"the frozen stack moved: {len(moved)} of {len(keys)} tensors, e.g. {moved[:2]}")


def bn_stats(module):
    import torch

    return torch.cat([b.flatten() for _, b in module.named_buffers()]).clone()


def watch_critic(system) -> dict:
    """Through the critic optimizer's step hooks: D2's BatchNorm
    statistics before each critic update (``bn``), its gradients at the
    first (``grads0``) and its parameters after each (``params``)."""
    rec = {"bn": [], "params": [], "grads0": None}

    def before(*_):
        rec["bn"].append(bn_stats(system.critic_2))
        if rec["grads0"] is None:
            rec["grads0"] = [p.grad.detach().clone() for p in system.critic_2.parameters()]

    def after(*_):
        rec["params"].append([p.detach().clone() for p in system.critic_2.parameters()])

    system.optimizers["critic"].register_step_pre_hook(before)
    system.optimizers["critic"].register_step_post_hook(after)
    return rec


def step_readings(system, metrics, critic) -> dict:
    """What phase 8 compares between two systems after one step: the
    metrics, G2's BatchNorm statistics, and D2's as they stood before the
    critic's first update (``critic``, a ``watch_critic`` record). D2's
    after the step are printed, not held (kind None): from the first
    update on they follow Adam's steps on small gradients (see
    ``_train2_checks``)."""
    out = {f"metric {k}": ("gp" if k == "gp" else "metric", v) for k, v in metrics.items()}
    out["gen_2 BN stats"] = ("bn", bn_stats(system.gen_2))
    out["critic_2 BN stats before its first update"] = ("bn_critic", critic["bn"][0])
    out["critic_2 BN stats after the step"] = (None, bn_stats(system.critic_2))
    return out


def rel_max(a, b) -> float:
    """Max abs difference over max(1, ``b``'s max abs), in f64."""
    a, b = a.double(), b.double()
    return (a - b).abs().max().item() / max(1.0, b.abs().max().item())


def compare_steps(tag, what, got, want, held=True) -> None:
    """``step_readings`` of two systems: ``rel_max``, held to
    ``STEP_TOL`` (a reading of kind None, or every reading where ``held``
    is False, is printed only)."""
    import torch

    for name, (kind, a) in got.items():
        b = want[name][1]
        if not bool(torch.isfinite(a).all() & torch.isfinite(b).all()):
            raise AssertionError(f"{tag} {what}, {name}: not finite")
        rel = rel_max(a, b)
        if kind is None or not held:
            log(f"  {tag} {what}, {name}: max abs diff / max(1, max abs) {rel:.3e} (printed, not held)")
            continue
        limit = STEP_TOL[tag][kind]
        ok = rel <= limit
        log(f"  {tag} {what}, {name}: max abs diff / max(1, max abs) {rel:.3e} (limit {limit:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} {what}: {name} disagrees")


def phase_train2_steps(attention, layernorm, gen, card):
    """Full-width steps on both text routes: times, the profile, the
    launch counts and the frozen stack. Returns the state after them, the
    per-step launch counts and the batch that ran."""
    import torch

    from imagegenerator_tpu_torch.train.stage2 import TRAINED, Stage2System

    set_tf32(False)
    cfg = train2_config(True, torch.bfloat16)
    t0 = time.perf_counter()
    system = Stage2System(cfg, device="cuda", generator=gen)
    init = {k: v.clone() for k, v in system.state_dict().items()}
    n_params = {name: sum(p.numel() for p in getattr(system, attr).parameters()) for name, attr in TRAINED.items()}
    log(f"  full-width random init, {sum(p.numel() for p in system.parameters()) / 1e6:.1f}M parameters "
        f"(trained: {', '.join(f'{k} {v / 1e6:.2f}M' for k, v in n_params.items())}), "
        f"{time.perf_counter() - t0:.1f} s")
    step_gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    batch_size = TRAIN2_BATCH
    while True:
        tokens = train2_batch(cfg, gen, batch_size)
        tem = {"tem": system.embed_texts(tokens["input_ids"], tokens["attention_mask"]), "image": tokens["image"]}
        torch.cuda.reset_peak_memory_stats()
        try:
            for _ in range(2):  # warm-ups
                system.train_step(tem, generator=step_gen)
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError as e:
            if batch_size <= TRAIN2_CHECK_BATCH:
                raise
            log(f"  batch {batch_size} does not fit on this card ({str(e).splitlines()[0]}); "
                f"running batch {batch_size // 2} instead")
            del tokens, tem
            system = train2_system(cfg, init)
            torch.cuda.empty_cache()
            batch_size //= 2
    log(f"  batch {batch_size} fits: the tem route runs at batch {batch_size}")

    samples = [wall_ms(lambda: system.train_step(tem, generator=step_gen), runs=1) for _ in range(5)]
    tem_ms = statistics.median(samples)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  train_step, tem route, batch {batch_size} bf16 uint8 images: {tem_ms:.3f} ms, "
        f"{batch_size / tem_ms * 1e3:.1f} img/s (steps {', '.join(f'{t:.1f}' for t in samples)}); "
        f"peak device memory {peak:.2f} GiB [{card}]")
    host_ms, events = profiled(lambda: system.train_step(tem, generator=step_gen), calls=1)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"  profiled step, tem route: host {host_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / host_ms:.1f}%), {sum(e.count for e in events)} kernels")
    classes = {}
    for e in events:
        c = classes.setdefault(kernel_class(e.key), [0.0, 0])
        c[0] += e.self_device_time_total / 1e3
        c[1] += e.count
    for name, (ms, count) in sorted(classes.items(), key=lambda kv: -kv[1][0]):
        log(f"    {ms:8.3f} ms {100 * ms / busy:5.1f}% {count:6d}x {name}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x {e.key[:90]}")

    # the tokens route: one frozen BERT-base forward per step through the kernels
    totals = dict.fromkeys(NO_BACKWARD, 0)
    samples = []
    for i in range(4):
        reset_counts(attention, layernorm)
        samples.append(wall_ms(lambda: system.train_step(tokens, generator=step_gen), runs=1))
        counts = read_counts(attention, layernorm)
        if counts != NO_BACKWARD:
            raise AssertionError(f"tokens step {i + 1}: kernel launches {counts}, expected {NO_BACKWARD}")
        for k in totals:
            totals[k] += counts[k]
    metrics = system.train_step(tokens, generator=step_gen)
    if not all(bool(torch.isfinite(v)) for v in metrics.values()):
        raise AssertionError(f"metrics not finite: {metrics}")
    tokens_ms = statistics.median(samples[1:])
    log(f"  train_step, tokens route, batch {batch_size} bf16, kernels on: {tokens_ms:.3f} ms, "
        f"{batch_size / tokens_ms * 1e3:.1f} img/s (steps {', '.join(f'{t:.1f}' for t in samples)}, the "
        f"first a warm-up); per step launches {NO_BACKWARD}; last metrics "
        + ", ".join(f"{k} {v.item():.5g}" for k, v in metrics.items()) + f" [{card}]")
    embed_ms = cuda_ms(lambda: system.embed_texts(tokens["input_ids"], tokens["attention_mask"]), inner=3)
    log(f"  embed_texts at ({batch_size}, {cfg.seq_len}), kernels on: {embed_ms:.3f} ms by CUDA events [{card}]")
    phase_caption_cache(system, attention, layernorm, card)

    # (d) the frozen stack after 13 steps, and a planted fault
    after = system.state_dict()
    check_frozen(system, init)
    for name, attr in TRAINED.items():
        if not any(not torch.equal(after[k], v) for k, v in init.items() if k.startswith(attr + ".")):
            raise AssertionError(f"{name}: no parameter changed")
    log("  (d) the frozen stack is bit-equal after 13 steps; every trained module moved")
    state = {k: v.clone() for k, v in after.items()}

    def into_training_mode(module, _):
        module.train()

    hook = system.gen_1.register_forward_pre_hook(into_training_mode)

    def frozen_in_training_mode():
        small = {k: v[:TRAIN2_CHECK_BATCH] for k, v in tem.items()}
        system.train_step(small, generator=step_gen)
        check_frozen(system, init)

    must_catch("a step that puts the frozen G1 in training mode (its BatchNorm statistics update)",
               frozen_in_training_mode)
    hook.remove()
    del system, tokens, tem, after, init
    torch.cuda.empty_cache()
    return state, totals, batch_size, {"tem_ms": tem_ms, "tokens_ms": tokens_ms}


CACHE_CAPTIONS, CACHE_BATCH = 600, 256  # three sweeps, the last one ragged


def phase_caption_cache(system, attention, layernorm, card):
    """The stage-2 caption-embedding cache (``data/text_cache.py``) on the
    frozen encoder with the kernels: one BERT forward per sweep batch (12
    attention forwards at rate 0, 25 LayerNorm forwards), the table equal
    to ``embed_texts`` on the same padded batch, and a second call served
    from the store with no launch."""
    import numpy as np
    import torch

    from imagegenerator_tpu_torch.data.storage import MemoryStore
    from imagegenerator_tpu_torch.data.text_cache import precompute_caption_embeddings
    from imagegenerator_tpu_torch.data.tokenizer import HashTokenizer

    cfg, dev = system.config, next(system.parameters()).device
    captions = [f"{CAPTIONS.split('|')[i % 4]}, take {i}" for i in range(CACHE_CAPTIONS)]
    tokenizer = HashTokenizer(cfg.bert.vocab_size, cfg.seq_len)
    store = MemoryStore()
    tables, counts = [], []
    for _ in range(2):
        reset_counts(attention, layernorm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables.append(precompute_caption_embeddings(system.embed_texts, tokenizer, captions, cfg.tem_size,
                                                    batch_size=CACHE_BATCH, store=store, device=dev))
        seconds = time.perf_counter() - t0
        counts.append(read_counts(attention, layernorm))
    sweeps = -(-CACHE_CAPTIONS // CACHE_BATCH)
    want = {k: sweeps * v for k, v in NO_BACKWARD.items()}
    toks = tokenizer(captions[:CACHE_BATCH])
    direct = system.embed_texts(torch.from_numpy(toks["input_ids"]).to(dev),
                                torch.from_numpy(toks["attention_mask"]).to(dev)).float().cpu().numpy()
    log(f"  caption cache: {CACHE_CAPTIONS} captions in {sweeps} sweeps of {CACHE_BATCH}, launches {counts[0]}; "
        f"read back from the store in {seconds * 1e3:.1f} ms, launches {counts[1]} [{card}]")
    if counts[0] != want or counts[1] != dict.fromkeys(NO_BACKWARD, 0):
        raise AssertionError(f"caption cache launches {counts}, expected {want} then none")
    if tables[0].shape != (CACHE_CAPTIONS, cfg.tem_size) or not np.array_equal(tables[0], tables[1]) \
            or not np.array_equal(tables[0][:CACHE_BATCH], direct):
        raise AssertionError("the cached table is not embed_texts' output")


def phase_train2_checks(attention, state, gen):
    """(a) kernels on vs off and (b) the tem route vs the tokens route,
    full width at batch ``TRAIN2_CHECK_BATCH``, f32 (TF32 off) and bf16,
    with cuDNN held to its deterministic algorithms (two runs of one
    computation otherwise differ by up to 1.3e-4 in gp after the five
    critic updates)."""
    import torch

    torch.backends.cudnn.deterministic = True
    try:
        _train2_checks(attention, state, gen)
    finally:
        torch.backends.cudnn.deterministic = False


def train2_check_step(cfg, state, batch, noise, route="tokens", mask_for_tem=None, tem_shift=None):
    """One step from ``state`` on ``batch`` with ``noise`` replayed:
    ``step_readings`` and the ``watch_critic`` record. The tem route feeds
    ``embed_texts(input_ids, mask_for_tem) + tem_shift``."""
    import torch

    system = train2_system(cfg, state)
    rec = watch_critic(system)
    feed = batch
    if route == "tem":
        ids, mask = batch["input_ids"], batch["attention_mask"]
        tem = system.embed_texts(ids, mask if mask_for_tem is None else mask_for_tem)
        feed = {"tem": tem if tem_shift is None else tem + tem_shift, "image": batch["image"]}
    readings = step_readings(system, system.train_step(feed, noise=noise), rec)
    torch.cuda.synchronize()
    return readings, rec


def tem_witness_shift(cfg, state, batch):
    """A move of the tem route's embeddings by 1e-9 of their largest (a
    thousandth of what the f32 kernels change), seeded."""
    import torch

    system = train2_system(cfg, state)
    tem = system.embed_texts(batch["input_ids"], batch["attention_mask"])
    g = torch.Generator(device=tem.device).manual_seed(SEED)
    return torch.randn(tem.shape, generator=g, device=tem.device) * (1e-9 * tem.abs().max())


def _train2_checks(attention, state, gen):
    """D2's BatchNorm statistics are held before the critic's first
    update. After it they part by up to 2e-2 in f32 between any two
    runs that differ at all: Adam's first update moves every element by lr
    times the sign of its gradient, small gradients of the tower change
    sign under any change of the input (a move of the embeddings by 1e-9
    of their largest parts them as far as the kernels do), and four more
    updates carry that into the statistics; ``--only d2-trace`` shows it
    on six states. Each dtype's step runs once plainly first: the
    process's first step at a shape may take other library algorithms than
    the next (a plain step against itself read 3.9e-4 that way)."""
    import torch

    B = TRAIN2_CHECK_BATCH
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        set_tf32(False)
        cfg_on, cfg_off = train2_config(True, dtype), train2_config(False, dtype)
        batch = train2_batch(cfg_on, gen, B)
        noise = train2_noise(cfg_on, gen, B)
        mask = batch["attention_mask"]

        def run(cfg, route="tokens", mask_for_tem=None, tem_shift=None):
            return train2_check_step(cfg, state, batch, noise, route, mask_for_tem, tem_shift)[0]

        run(cfg_off)  # the warm-up
        off = run(cfg_off)
        on = run(cfg_on)
        compare_steps(tag, "(a) kernels on vs off", on, off)
        compare_steps(tag, "(b) tem route vs tokens route", run(cfg_on, "tem"), on)
        if dtype is torch.float32:
            compare_steps(tag, "witness: plain, tem moved by 1e-9 of its largest, vs plain",
                          run(cfg_off, "tem", tem_shift=tem_witness_shift(cfg_off, state, batch)), off, held=False)
            fused = attention.fused_attention

            def maskless(q, k, v, mask, **kw):
                return fused(q, k, v, None, **kw)

            def kernels_ignore_the_mask():
                attention.fused_attention = maskless
                try:
                    compare_steps(tag, "(a) kernels on, the padding mask ignored, vs off", run(cfg_on), off)
                finally:
                    attention.fused_attention = fused

            must_catch("an attention kernel that ignores the padding mask", kernels_ignore_the_mask)
            must_catch("embeddings precomputed without the padding mask",
                       lambda: compare_steps(tag, "(b) tem route, embedded without the mask, vs tokens route",
                                             run(cfg_on, "tem", torch.ones_like(mask)), on))


D2_TRACE_STATES = (("fresh init 0", 0, 0, (1, 2, 3)), ("fresh init 1", 1, 0, (1,)),
                   ("init 1 after 6 bf16 steps at batch 64", 1, 6, (1, 2)))


def phase_d2_trace(card):
    """``--only d2-trace``: phase 8 (a)'s f32 step on six (state, data)
    pairs (seeded random inits, fresh and after 6 steps; data seeds), per
    critic update: D2's statistics kernels on vs off, and beside them a
    witness, the plain step with the embeddings moved by 1e-9 of their
    largest, vs the plain step; the elements that the first update parts
    by more than lr / 2, and their gradients; the plain step against
    itself; every reading of check (a), printed, none held."""
    import torch

    from imagegenerator_tpu_torch.train.stage2 import Stage2System

    log(f"d2-trace: phase 8 (a)'s f32 step per critic update, on {card}")
    set_tf32(False)
    torch.backends.cudnn.deterministic = True
    cfg, B = train2_config(True, torch.bfloat16), TRAIN2_CHECK_BATCH
    cfg_on, cfg_off = train2_config(True, torch.float32), train2_config(False, torch.float32)
    lr = cfg.lr

    def trace(what, x, y):
        for i, (bx, by) in enumerate(zip(x["bn"], y["bn"])):
            dp = max((a - b).abs().max().item() for a, b in zip(x["params"][i], y["params"][i]))
            log(f"    {what}: D2 BN before update {i} {rel_max(bx, by):.3e}; parameters after it, max abs diff "
                f"{dp:.3e}")
        parted = []
        for (n, _), a, b, g in zip(system_names, x["params"][0], y["params"][0], y["grads0"]):
            far = (a - b).abs() > 0.5 * lr
            if far.any():
                parted.append((int(far.sum()), n, g[far].abs().max().item(), g.abs().max().item()))
        parted.sort(reverse=True)
        log(f"    {what}: update 0 parts {sum(c for c, *_ in parted)} elements by > lr / 2, in "
            + ("; ".join(f"{n} {c} (|grad| <= {gm:.1e}, its largest {gM:.1e})" for c, n, gm, gM in parted[:4])
               or "none"))

    try:
        for label, init_seed, aged, seeds in D2_TRACE_STATES:
            system = Stage2System(cfg, device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(100 + init_seed))
            age = torch.Generator(device="cuda").manual_seed(7)
            for _ in range(aged):
                system.train_step(train2_batch(cfg, age, 2 * B), generator=age)
            state = {k: v.clone() for k, v in system.state_dict().items()}
            system_names = list(system.critic_2.named_parameters())
            del system
            for s in seeds:
                gen = torch.Generator(device="cuda").manual_seed(s)
                batch, noise = train2_batch(cfg_on, gen, B), train2_noise(cfg_on, gen, B)
                off, rec_off = train2_check_step(cfg_off, state, batch, noise)
                on, rec_on = train2_check_step(cfg_on, state, batch, noise)
                shift = tem_witness_shift(cfg_off, state, batch)
                wit, rec_wit = train2_check_step(cfg_off, state, batch, noise, "tem", tem_shift=shift)
                again, _ = train2_check_step(cfg_off, state, batch, noise)
                key = "critic_2 BN stats after the step"
                log(f"  {label}, data seed {s}: D2 BN after the step, on vs off {rel_max(on[key][1], off[key][1]):.3e}, "
                    f"witness vs plain {rel_max(wit[key][1], off[key][1]):.3e}, plain vs plain again "
                    f"{rel_max(again[key][1], off[key][1]):.3e} [{card}]")
                compare_steps("f32", "  (a) kernels on vs off", on, off, held=False)
                compare_steps("f32", "  witness vs plain", wit, off, held=False)
                trace("on vs off", rec_on, rec_off)
                trace("witness", rec_wit, rec_off)
    finally:
        torch.backends.cudnn.deterministic = False


def hold_tiny_step(what, cpu, m_cpu, card, m_card, trained, critic_channels, *, stage1_rules=False,
                   held_to=True) -> dict:
    """One tiny f32 step on the card against the same step on the CPU, at
    ``TINY_TOL``: the metrics, the trained modules' BatchNorm statistics,
    the optimizers' first moments (against each tensor's largest) and the
    parameters where the moment is not rounding noise (at least
    ``TINY_TOL["noise"]`` of the largest), at least half of all parameter
    elements. Gradients that are zero by structure (the critic head's
    text path and the biases after it: see
    tests/test_torch_stage1_step.py) are all rounding noise and are left
    out. ``trained``: optimizer name -> module attribute.
    ``stage1_rules`` (phase 9, whose stage-1 steps train BERT): the
    attention key bias is left out too (zero gradient by structure), and
    so is a tensor no gradient reached (embedding rows no token used); the
    half is then of the elements a gradient reached. ``held_to=False``
    prints the readings and returns them without raising. Returns the
    worst reading of each kind over its limit and ``flips``: the
    parameter elements more than one learning rate apart (Adam's first
    update moved them in opposite directions)."""
    import torch

    worst = dict.fromkeys(("metric", "bn", "moment", "param"), 0.0)
    flips = 0
    fails = []

    def hold(kind, name, got, want, atol_scale=1.0, where=None):
        got, want = got.detach().double().cpu(), want.detach().double().cpu()
        limit = TINY_TOL[kind] * atol_scale + TINY_TOL[kind] * want.abs()
        over = ((got - want).abs() / limit)
        if where is not None:
            over = over[where.cpu()]
        if over.numel():
            worst[kind] = max(worst[kind], over.max().item())
            if not bool(torch.isfinite(got).all()) or over.max().item() > 1.0:
                fails.append(f"{kind} {name}: {over.max().item():.2f}x its limit")

    for k in m_cpu:
        hold("metric", k, m_card[k], m_cpu[k])
    held = total = 0
    for name, attr in trained.items():
        for (bn, b_cpu), (_, b_card) in zip(getattr(cpu, attr).named_buffers(),
                                            getattr(card, attr).named_buffers()):
            hold("bn", f"{name}.{bn}", b_card, b_cpu)
        pairs = zip(getattr(cpu, attr).named_parameters(), getattr(card, attr).parameters())
        for (pn, p_cpu), p_card in pairs:
            m_ref = cpu.optimizers[name].state[p_cpu]["exp_avg"]
            m_got = card.optimizers[name].state[p_card]["exp_avg"]
            structural = name == "critic" and (
                pn.startswith("head.Dense_0.") or pn in ("head.Conv2d_0.bias", "head.Dense_1.bias"))
            if structural or stage1_rules and pn.endswith("attention.self.key.bias"):
                continue
            live = torch.ones_like(m_ref, dtype=torch.bool)
            if name == "critic" and pn == "head.Conv2d_0.weight":
                live[:, critic_channels[-1]:] = False  # its text input channels, likewise
            if stage1_rules and (not bool(live.any()) or m_ref[live].abs().max().item() == 0.0):
                continue
            scale = m_ref[live].abs().max().item()
            hold("moment", f"{name}.{pn}", m_got, m_ref, scale, live)
            above = live & (m_ref.abs() >= TINY_TOL["noise"] * scale)
            hold("param", f"{name}.{pn}", p_card, p_cpu, 1.0, above)
            lr = cpu.optimizers[name].param_groups[0]["lr"]
            flips += int(((p_card.detach().double().cpu() - p_cpu.detach().double().cpu()).abs()
                          > lr)[live.cpu()].sum())
            held += int(above.sum())
            total += int((live & (m_ref != 0)).sum()) if stage1_rules else m_ref.numel()
    log(f"  {what}: worst reading over its limit: "
        + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
        + f" (limits {TINY_TOL}); parameters held at {held} of "
        + (f"the {total} elements a gradient reached " if stage1_rules else f"{total} elements ")
        + f"{'ok' if not fails else 'FAIL'}; {flips} elements more than lr apart"
        + ("" if held_to else f"; {len(fails)} readings over (printed, not held)"))
    worst["flips"] = flips
    if not held_to:
        return worst
    if fails:
        raise AssertionError(f"{what}: {len(fails)} readings over their limits, e.g. {fails[:3]}")
    if held < 0.5 * total:
        raise AssertionError(f"{what}: only {held} of {total} parameter elements were held")
    return worst


def train2_tiny_inputs(seed=SEED):
    """``Stage2Config.tiny(n_critic=2)``, a seeded initial state on the
    CPU, a batch of 8 and its noise: phase 8 (c)'s inputs."""
    import torch

    from imagegenerator_tpu_torch.train.stage2 import Stage2Config, Stage2System

    cfg = Stage2Config.tiny(n_critic=2)
    B, T, r = 8, cfg.seq_len, cfg.resolution
    cpu_gen = torch.Generator().manual_seed(seed)
    init = Stage2System(cfg, device="cpu", generator=cpu_gen).state_dict()
    lengths = torch.randint(3, T + 1, (B,), generator=cpu_gen)
    batch = {"input_ids": torch.randint(1, cfg.bert.vocab_size, (B, T), generator=cpu_gen, dtype=torch.int32),
             "attention_mask": (torch.arange(T)[None, :] < lengths[:, None]).int(),
             "image": torch.randint(0, 256, (B, r, r, 3), generator=cpu_gen, dtype=torch.uint8)}
    return cfg, init, batch, train2_noise(cfg, cpu_gen, B, "cpu")


def train2_tiny_step(cfg, init, batch, noise, device):
    """One step from ``init`` on ``device``: the system and its metrics."""
    import torch

    from imagegenerator_tpu_torch.train.stage2 import Stage2System

    system = Stage2System(cfg, device="meta")
    system.load_state_dict({k: v.clone().to(device) for k, v in init.items()}, assign=True)
    metrics = system.train_step({k: v.to(device) for k, v in batch.items()},
                                noise={k: v.to(device) for k, v in noise.items()})
    if device != "cpu":
        torch.cuda.synchronize()
    return system, metrics


@contextlib.contextmanager
def float_keeps_f64():
    """``Tensor.float()`` leaves a float64 tensor as it is, so that the
    port's f32 casts (BatchNorm's and LayerNorm's statistics, the score
    heads) keep a float64 step in float64."""
    import torch

    plain = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **kw: self if self.dtype == torch.float64 else plain(self, *a, **kw)
    try:
        yield
    finally:
        torch.Tensor.float = plain


def train2_tiny_step_f64(cfg, init, batch, noise):
    """``train2_tiny_step`` in float64 on the CPU from the same state,
    batch and noise: the images normalised as the step does (``x * 2/255
    - 1``), every float tensor widened. The witness both f32 steps are
    read against."""
    import torch

    from imagegenerator_tpu_torch.train.stage2 import Stage2System

    wide = lambda t: t.double() if t.is_floating_point() else t
    system = Stage2System(cfg, device="meta")
    system.load_state_dict({k: wide(v.clone()) for k, v in init.items()}, assign=True)
    batch = dict(batch, image=batch["image"].double() * (2.0 / 255.0) - 1.0)
    with float_keeps_f64():
        metrics = system.train_step(batch, noise={k: wide(v) for k, v in noise.items()})
    if any(p.dtype != torch.float64 for p in system.parameters()):
        raise AssertionError("the float64 witness step left float64")
    return system, metrics


def phase_tiny_witness(card, repeats=4, seeds=4):
    """``--only tiny-witness``: phase 8 (c)'s check ``repeats`` times on its
    own inputs, then once on each of ``seeds - 1`` more seeds, each time
    with both f32 steps (the CPU's, the card's off cuDNN) read against the
    same step in float64 on the CPU. Which side moves when (c) fails: the
    CPU (oneDNN, threads), the card (TF32 left on, another engine), or
    both (the step itself is ill-conditioned at these limits). Prints
    every reading and the elements each side stepped more than lr from
    the float64 step; holds nothing."""
    import torch

    from imagegenerator_tpu_torch.train.stage2 import TRAINED

    log(f"tiny-witness: phase 8 (c)'s step against float64 on the CPU, on {card}")
    log(f"  host: {host_description()}")
    log(f"  TF32 before the witness: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cuDNN {torch.backends.cudnn.allow_tf32}")
    set_tf32(False)
    rows = []
    for run, seed in enumerate([SEED] * repeats + [SEED + i for i in range(1, seeds)]):
        cfg, init, batch, noise = train2_tiny_inputs(seed)
        f64 = train2_tiny_step_f64(cfg, init, batch, noise)
        cpu = train2_tiny_step(cfg, init, batch, noise, "cpu")
        with exact_f32():
            dev = train2_tiny_step(cfg, init, batch, noise, "cuda")
        cudnn = train2_tiny_step(cfg, init, batch, noise, "cuda")
        tag = f"run {run} seed {seed}"
        read = lambda what, ref, got: hold_tiny_step(f"{tag}: {what}", *ref, *got, TRAINED, cfg.d2_channels,
                                                     held_to=False)
        rows.append({
            "card_vs_cpu": read("card off cuDNN vs CPU f32 (phase 8 (c))", cpu, dev),
            "cpu_vs_f64": read("CPU f32 vs CPU float64", f64, cpu),
            "card_vs_f64": read("card off cuDNN vs CPU float64", f64, dev),
            "cudnn_vs_f64": read("card on cuDNN vs CPU float64", f64, cudnn),
        })
    for key in rows[0]:
        log(f"  {key}: worst metric reading over the runs {max(r[key]['metric'] for r in rows):.3f}, "
            f"moment {max(r[key]['moment'] for r in rows):.3f}, "
            f"elements more than lr apart {[r[key]['flips'] for r in rows]}")


def phase_tiny_trace(card):
    """``--only tiny-trace``: how far phase 8 (c)'s tiny f32 step moves
    under rounding that is not its own, on three seeds, each case read by
    ``hold_tiny_step`` against the plain CPU step (printed, none held):
    the CPU on one thread; the CPU with every convolution's backward on
    TF32-rounded operands (its forward exact: the pattern of a
    reduced-precision backward); the card off cuDNN (``exact_f32``) and on
    cuDNN with its default, deterministic and benchmarked engines."""
    import torch
    import torch.nn.functional as F

    from imagegenerator_tpu_torch.train.stage2 import TRAINED

    def tf32_rounded(x):
        bits = x.detach().contiguous().view(torch.int32)
        return x + (((bits + 0x1000) & ~0x1FFF).view(torch.float32) - x).detach()

    def backward_on_tf32(conv):
        def wrapped(x, w, b=None, *args, **kw):
            exact = conv(x, w, b, *args, **kw)
            if not exact.requires_grad:
                return exact
            rounded = conv(tf32_rounded(x), tf32_rounded(w), b, *args, **kw)
            return exact.detach() + rounded - rounded.detach()
        return wrapped

    log(f"tiny-trace: phase 8 (c)'s step under other rounding, on {card}")
    set_tf32(False)
    for seed in (SEED, SEED + 1, SEED + 2):
        cfg, init, batch, noise = train2_tiny_inputs(seed)
        ref = train2_tiny_step(cfg, init, batch, noise, "cpu")

        def read(what, device="cpu"):
            try:
                hold_tiny_step(f"seed {seed}: {what}", *ref, *train2_tiny_step(cfg, init, batch, noise, device),
                               TRAINED, cfg.d2_channels)
            except AssertionError as e:
                log(f"    {e}")

        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        read(f"CPU on 1 thread, vs {threads}")
        torch.set_num_threads(threads)
        plain = F.conv2d, F.conv_transpose2d
        F.conv2d, F.conv_transpose2d = (backward_on_tf32(c) for c in plain)
        try:
            read("CPU, convolution backward on TF32-rounded operands")
        finally:
            F.conv2d, F.conv_transpose2d = plain
        with exact_f32():
            read("card off cuDNN", "cuda")
        for flag in ("default", "deterministic", "benchmark"):
            if flag != "default":
                setattr(torch.backends.cudnn, flag, True)
            try:
                read(f"card on cuDNN, {flag}", "cuda")
            finally:
                torch.backends.cudnn.deterministic = torch.backends.cudnn.benchmark = False


def host_description() -> str:
    """The host's CPU model and count, and what sets the CPU's f32
    arithmetic: oneDNN, the fp32 precision settings and the environment
    variables oneDNN, MKL and OpenMP read. Phase 8 (c) holds the card to
    the CPU, and on one machine in three it read far off (Findings in
    ``PERF.md``, PR 8): this line tells such machines apart."""
    import os

    import torch

    model = "unknown CPU"
    try:
        with open("/proc/cpuinfo") as f:
            model = next((l.split(":", 1)[1].strip() for l in f if l.startswith("model name")), model)
    except OSError:
        pass

    def setting(path):
        obj = torch
        for part in path.split("."):
            obj = getattr(obj, part, None)
        return obj

    knobs = {p: setting(p) for p in ("backends.fp32_precision", "backends.mkldnn.conv.fp32_precision",
                                      "backends.mkldnn.matmul.fp32_precision")}
    env = {k: v for k, v in os.environ.items() if k.startswith(("ONEDNN", "DNNL", "MKL", "OMP", "KMP"))}
    return (f"{model}, {os.cpu_count()} CPUs, {torch.get_num_threads()} torch threads; oneDNN "
            f"{torch.backends.mkldnn.is_available()}; float32 matmul precision "
            f"{torch.get_float32_matmul_precision()}; {knobs}; environment {env}")


TINY_RUNS = 4  # phase 8 (c) holds the card's step this many times


def phase_train2_tiny(gen):
    """(c) one step at ``Stage2Config.tiny()`` on the card against the same
    step in float64 on the CPU, from one state with the noise replayed, f32
    on the card with TF32 off, ``TINY_RUNS`` times. This ties the card to
    the CPU, which the tests hold to JAX. The held step runs off cuDNN
    (``exact_f32``); the same step on cuDNN, and the CPU's own f32 step,
    are printed beside it against the float64 step. The reference is the
    float64 step and not the CPU's f32 one because the CPU's f32 arithmetic
    is the host's: ``--only tiny-witness`` read both f32 steps within 0.009
    (metrics) and 0.384 (moments) of their limits from the float64 step on
    seven runs, with no element stepped apart, where (c) against the CPU's
    f32 step had read 23.53x on another host (``PERF.md``, Findings)."""
    from imagegenerator_tpu_torch.train.stage2 import TRAINED

    set_tf32(False)
    cfg, init, batch, noise = train2_tiny_inputs()
    ref = train2_tiny_step_f64(cfg, init, batch, noise)

    def check(noise, what):
        with exact_f32():
            card, m_card = train2_tiny_step(cfg, init, batch, noise, "cuda")
        hold_tiny_step(what, *ref, card, m_card, TRAINED, cfg.d2_channels)

    for run in range(TINY_RUNS):
        check(noise, f"(c) tiny step, card f32 vs CPU float64, run {run + 1} of {TINY_RUNS}")
    for what, device in (("the CPU's f32 step", "cpu"), ("the card's step on cuDNN", "cuda")):
        hold_tiny_step(f"(c) {what} vs CPU float64, printed, not held", *ref,
                       *train2_tiny_step(cfg, init, batch, noise, device), TRAINED, cfg.d2_channels,
                       held_to=False)
    swapped = dict(noise, gp_eps=noise["gp_eps"].flip(0))
    must_catch("a card-side step that replays the critic iterations' GP draws in the wrong order",
               lambda: check(swapped, "(c) tiny step, card with the GP draws swapped, vs CPU float64"))


def write_chain_dataset(root: Path) -> None:
    """``CHAIN_IMAGES`` captioned photo-like PNGs and a COCO caption file."""
    import numpy as np

    from imagegenerator_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(SEED)
    (root / "imgs").mkdir(parents=True)
    (root / "ann").mkdir()
    h, w = CHAIN_IMAGE_SIZE
    yy, xx = np.mgrid[0:h, 0:w]
    images, anns = [], []
    for i in range(CHAIN_IMAGES):
        chans = [np.sin(xx / (9.0 + i + c)) * 70 + np.cos(yy / (5.0 + 2 * c)) * 50 + 128
                 + rng.integers(-20, 21, (h, w)) for c in range(3)]
        write_png(str(root / "imgs" / f"{i:012d}.png"), np.stack(chans, axis=2).clip(0, 255).astype(np.uint8))
        images.append({"id": i, "file_name": f"{i:012d}.png"})
        anns.append({"image_id": i, "caption": f"{CAPTIONS.split('|')[i % 4]}, take {i}"})
    (root / "ann" / "captions.json").write_text(json.dumps({"images": images, "annotations": anns}))


def phase_train2_chain(tmp: Path, attention, layernorm, card, samples_to: Path | None = None):
    """train.cli --stage 1 -> train.cli --stage 2 -> train.sample --ema,
    full width, as a user runs them. ``samples_to``: where the sampled
    PNGs are copied, for phase 10 to score."""
    import numpy as np
    import torch

    from imagegenerator_tpu_torch.train import cli, sample

    log(f"phase 8: the chain through the CLIs, full width, bf16, batch {CHAIN_BATCH}")
    t0 = time.perf_counter()
    write_chain_dataset(tmp / "ds")
    h, w = CHAIN_IMAGE_SIZE
    # the loader decodes with Pillow where it is installed; the route without
    # it (the standard-library PNG reader, the torch resize) is run here either
    # way and, beside Pillow, held to within 1 gray level of it
    from imagegenerator_tpu_torch.data import coco

    data = (tmp / "ds" / "imgs" / f"{0:012d}.png").read_bytes()
    pillow, coco._pillow = coco._pillow, lambda: None
    try:
        plain = {size: coco.decode_resize_u8(data, size) for size in (64, 256)}
    finally:
        coco._pillow = pillow
    if coco._pillow() is None:
        decoder = "the standard-library PNG reader and the torch resize (no Pillow here)"
    else:
        worst = max(int(np.abs(plain[size].astype(np.int64) - coco.decode_resize_u8(data, size)).max())
                    for size in plain)
        decoder = f"Pillow; the route without Pillow is within {worst} gray level(s) of it (limit 1)"
        if worst > 1:
            raise AssertionError(f"the decode without Pillow is {worst} gray levels off Pillow's")
    log(f"  {CHAIN_IMAGES} captioned {w} x {h} PNGs written in {time.perf_counter() - t0:.1f} s; "
        f"decoded by {decoder}; the loader's routes here: {coco.describe_routes()}")

    ckpt = tmp / "ckpt"
    common = ["--data", str(tmp / "ds"), "--root", "imgs", "--ann_file", "ann/captions.json",
              "--batch_size", str(CHAIN_BATCH), "--num_epochs", "1", "--checkpoint_dir", str(ckpt),
              "--fused_attn", "--fused_ln", "--ema", "0.999", "--seed", str(SEED)]
    steps = CHAIN_IMAGES // CHAIN_BATCH
    with_backward = {k: steps * v for k, v in WITH_BACKWARD.items()}
    forward_only = {k: steps * v for k, v in NO_BACKWARD.items()}
    nothing = dict.fromkeys(NO_BACKWARD, 0)
    runs = [
        ("train.cli --stage 1", ["--stage", "1"], with_backward, steps),
        ("train.cli --stage 1 again", ["--stage", "1"], nothing, 0),
        ("train.cli --stage 2", ["--stage", "2", "--stage1_checkpoint", str(ckpt / "Stage1")], forward_only, steps),
        ("train.cli --stage 2 again", ["--stage", "2", "--stage1_checkpoint", str(ckpt / "Stage1")], nothing, 0),
    ]
    launches = {}
    for name, argv, want, want_steps in runs:
        reset_counts(attention, layernorm)
        t0 = time.perf_counter()
        printed = run_cli(cli.main, argv + common)
        torch.cuda.synchronize()
        counts = read_counts(attention, layernorm)
        launches[name] = counts
        log(f"  {name}: {time.perf_counter() - t0:.1f} s; launches {counts} [{card}]")
        if counts != want:
            raise AssertionError(f"{name}: kernel launches {counts}, expected {want}")
        lines = printed.splitlines()
        step_lines = [l for l in lines if l.startswith("step ")]
        if len(step_lines) != want_steps:
            raise AssertionError(f"{name}: {len(step_lines)} steps logged, expected {want_steps}")
        values = [float(v) for l in step_lines for v in re.findall(r": (-?[\d.]+|nan|inf|-inf)(?:,|$)", l)]
        if len(values) != 4 * want_steps or not all(map(np.isfinite, values)):
            raise AssertionError(f"{name}: metrics {values}")
        resumed = "Loaded checkpoint at epoch 0" in lines
        if resumed != (want_steps == 0):
            raise AssertionError(f"{name}: resume line {'missing' if not resumed else 'unexpected'}")
    for stage in (1, 2):
        root = ckpt / f"Stage{stage}"
        found = sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
        want = ["LATEST_EPOCH", "epochs/checkpoint_epoch_0/state.npz", "latest/state.npz"]
        if found != want or (root / "LATEST_EPOCH").read_text() != "0":
            raise AssertionError(f"Stage{stage} checkpoint layout {found}")
        size = (root / "latest" / "state.npz").stat().st_size / 2**20
        with np.load(root / "latest" / "state.npz") as f:
            keys = f.files
            ema = sum(k.startswith("aux/ema/") for k in keys)
            step = int(f["state/step"])
        if step != steps or not ema or not all(k.startswith(("state/", "aux/ema/")) for k in keys):
            raise AssertionError(f"Stage{stage} checkpoint: step {step}, {ema} EMA tensors")
        log(f"  Stage{stage}: {want}, {size:.0f} MiB each, step {step}, {len(keys) - ema} state and "
            f"{ema} EMA tensors")

    out = tmp / "samples"
    reset_counts(attention, layernorm)
    t0 = time.perf_counter()
    printed = run_cli(sample.main, ["--stage", "2", "--checkpoint_dir", str(ckpt), "--caption", CAPTIONS,
                                    "-n", str(SAMPLES_PER_CAPTION), "-o", str(out), "--seed", str(SEED),
                                    "--ema", "--fused_attn", "--fused_ln"])
    torch.cuda.synchronize()
    counts = read_counts(attention, layernorm)
    log(f"  train.sample --stage 2 --ema: {time.perf_counter() - t0:.1f} s; launches {counts}")
    if counts != NO_BACKWARD or not printed.startswith("Loaded checkpoint at epoch 0\n"):
        raise AssertionError(f"sampling: launches {counts}, expected {NO_BACKWARD}; or no resume line")
    pngs = sorted(out.glob("sample_*.png"))
    sizes = {png_size(p) for p in pngs}
    comments = [png_comment(p) for p in pngs]
    want = [c for c in CAPTIONS.split("|") for _ in range(SAMPLES_PER_CAPTION)]
    if len(pngs) != BATCH or sizes != {(256, 256)} or comments != want:
        raise AssertionError(f"expected {BATCH} PNGs of 256x256 with their captions, got {len(pngs)} {sizes} {comments}")
    log(f"  {len(pngs)} PNGs at 256x256 from the EMA weights, comment chunks match the captions")
    if samples_to is not None:
        import shutil

        shutil.copytree(out, samples_to)
    return launches


def phase_train2(attention, layernorm, gen, card, samples_to: Path | None = None):
    log(f"phase 8: stage-2 training path, full width, bf16, n_critic 5, on {card}")
    state, totals, batch_size, times = phase_train2_steps(attention, layernorm, gen, card)
    log(f"phase 8: one step at batch {TRAIN2_CHECK_BATCH}, kernels on vs off, tem route vs tokens route")
    phase_train2_checks(attention, state, gen)
    del state
    log("phase 8: one tiny step, card vs CPU")
    phase_train2_tiny(gen)
    with tempfile.TemporaryDirectory() as tmp:
        phase_train2_chain(Path(tmp), attention, layernorm, card, samples_to)
    return totals, batch_size, times


# ------------------------------------------------------- data parallelism

DP_WORLD = 2
DP_TINY_BATCH = 8  # global; 4 a rank
DP_TINY_STEPS = 2
DP_TIMED_STEPS = 2  # after one warm-up
DP_STAGE2_BATCH = 256  # a rank
DP_CLI_BATCH = 32  # a rank
DP_TIMEOUT = 600  # seconds, for each group of rank processes
# the DP worker's ranks on the card against the same ranks over gloo on the
# CPU: phase 8 (c)'s limits (TINY_TOL)


def dp_state_hash(system) -> str:
    """A digest of everything the ranks must hold bit-equal: parameters
    and optimizer state (BatchNorm statistics stay per rank)."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name, p in system.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    for opt in system.optimizers.values():
        for state in opt.state.values():
            for v in state.values():
                if torch.is_tensor(v):
                    h.update(v.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def dp_bn(system):
    import torch

    return torch.cat([b.detach().float().cpu().flatten() for n, b in system.named_buffers()
                      if not n.startswith(FROZEN) and b.is_floating_point()])


def dp_tiny_inputs(stage, rank):
    """A tiny stage-``stage`` config, its seeded initial state, this
    rank's half of a seeded global batch and each step's noise at the
    local batch, the same on every rank (the JAX step hands its one key
    to every shard)."""
    import torch

    from imagegenerator_tpu_torch.train import stage1, stage2

    gen = torch.Generator().manual_seed(SEED + stage)
    if stage == 1:
        cfg = stage1.Stage1Config.tiny(n_critic=2, text_dropout=False)
        init = stage1.Stage1System(cfg, device="cpu", generator=gen).state_dict()
    else:
        cfg = stage2.Stage2Config.tiny(n_critic=2)
        init = stage2.Stage2System(cfg, device="cpu", generator=gen).state_dict()
    B, T, r = DP_TINY_BATCH, cfg.seq_len, cfg.resolution
    lengths = torch.randint(3, T + 1, (B,), generator=gen)
    batch = {"input_ids": torch.randint(1, cfg.bert.vocab_size, (B, T), generator=gen, dtype=torch.int32),
             "attention_mask": (torch.arange(T)[None, :] < lengths[:, None]).int(),
             "image": torch.randint(0, 256, (B, r, r, 3), generator=gen, dtype=torch.uint8)}
    local = B // DP_WORLD
    batch = {k: v[rank * local:(rank + 1) * local] for k, v in batch.items()}
    noises = []
    for _ in range(DP_TINY_STEPS):
        n, kw = cfg.n_critic, dict(generator=gen)
        noise = {"perm": torch.randperm(local, **kw), "z": torch.randn((n, local, cfg.z_dim), **kw),
                 "gp_eps": torch.rand((n, local, 1, 1, 1), **kw)}
        if stage == 1:
            noise["ca_eps"] = torch.randn((n, local, cfg.c_dim), **kw)
        else:
            noise["ca1_eps"] = torch.randn((n, local, cfg.c_dim), **kw)
            noise["ca2_eps"] = torch.randn((n, local, cfg.c_dim), **kw)
        noises.append(noise)
    return cfg, init, batch, noises


def dp_tiny(rank, device):
    """Check 1 and the planted faults of check 2, on this rank, with the
    card off cuDNN (``exact_f32``, as phase 8 (c))."""
    with exact_f32():
        for stage in (1, 2):
            dp_tiny_stage(rank, device, stage)


def dp_tiny_stage(rank, device, stage):
    import torch
    import torch.distributed as dist

    from imagegenerator_tpu_torch.parallel import dp
    from imagegenerator_tpu_torch.train import stage1, stage2

    def summed(tensors):  # planted: the reduce sums instead of averaging
        if tensors:
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.all_reduce(flat)
            at = 0
            for t in tensors:
                t.copy_(flat[at:at + t.numel()].view_as(t))
                at += t.numel()

    cfg, init, batch, noises = dp_tiny_inputs(stage, rank)
    cls = stage1.Stage1System if stage == 1 else stage2.Stage2System
    trained = {m: m for m in stage1.MODULES} if stage == 1 else stage2.TRAINED
    channels = cfg.disc_channels if stage == 1 else cfg.d2_channels

    def build(dev):
        system = cls(cfg, device="meta")
        system.load_state_dict({k: v.clone().to(dev) for k, v in init.items()}, assign=True)
        return system

    def step(system, i, dev, reduce):
        return system.train_step({k: v.to(dev) for k, v in batch.items()},
                                 noise={k: v.to(dev) for k, v in noises[i].items()}, reduce=reduce)

    def ranks_agree(system, what):
        digests = [None] * DP_WORLD
        dist.all_gather_object(digests, dp_state_hash(system))
        bns = [None] * DP_WORLD
        dist.all_gather_object(bns, dp_bn(system))
        spread = (bns[0] - bns[1]).abs().max().item()
        same = len(set(digests)) == 1
        log(f"  [rank {rank}] {what}: parameters and optimizer state "
            f"{'bit-equal' if same else 'DIFFER'} across ranks; BatchNorm statistics differ by up to "
            f"{spread:.3e}")
        if not same:
            raise AssertionError(f"{what}: the ranks' parameters parted")
        if spread == 0.0:
            raise AssertionError(f"{what}: the ranks' BatchNorm statistics are equal (one batch twice?)")

    cpu, card = build("cpu"), build(device)
    for i in range(DP_TINY_STEPS):
        m_cpu = step(cpu, i, "cpu", dp.all_reduce_mean)
        m_card = step(card, i, device, dp.all_reduce_mean)
        torch.cuda.synchronize()
        hold_tiny_step(f"[rank {rank}] stage {stage} step {i + 1}, card vs CPU (gloo)", cpu, m_cpu, card,
                       m_card, trained, channels, stage1_rules=True)
        ranks_agree(card, f"stage {stage} step {i + 1}")
    # the planted faults, each over the first step from the same state
    cpu = build("cpu")
    m_cpu = step(cpu, 0, "cpu", dp.all_reduce_mean)
    faulty = build(device)
    m_sum = step(faulty, 0, device, summed)
    torch.cuda.synchronize()
    must_catch(f"[rank {rank}] stage {stage}: a reduce that sums instead of averaging",
               lambda: hold_tiny_step(f"[rank {rank}] stage {stage}, summed reduce, card vs CPU", cpu, m_cpu,
                                      faulty, m_sum, trained, channels, stage1_rules=True))
    n_critic_params = len(list(getattr(cpu, trained["critic"]).parameters()))

    def rank1_skips_the_critic_reduce(tensors):
        if rank == 1 and len(tensors) == n_critic_params:
            dp.all_reduce_mean([t.clone() for t in tensors])  # in the collective, result dropped
        else:
            dp.all_reduce_mean(tensors)

    parted = build(device)
    step(parted, 0, device, rank1_skips_the_critic_reduce)
    torch.cuda.synchronize()
    must_catch(f"[rank {rank}] stage {stage}: rank 1 skips the critic's reduce",
               lambda: ranks_agree(parted, f"stage {stage}, rank 1 without the critic's reduce"))


def dp_collectives(events, step_ms):
    """From a profiler table of one step whose reduces ran inside
    ``dp.all_reduce_mean`` regions entered after the rank's own kernels
    had finished: the host time in those regions (for gloo: the copies
    through host memory, the transfer, and the wait for the other rank)
    and the device time of collective kernels (NCCL's)."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    region = [e for e in events if e.key == "dp.all_reduce_mean" and e.device_type == cpu]
    kernels = [e for e in events if "nccl" in e.key.lower() and e.self_device_time_total > 0]
    host = sum(e.cpu_time_total for e in region) / 1e3
    calls = sum(e.count for e in region)
    dev = sum(e.self_device_time_total for e in kernels) / 1e3
    return f"{calls} reduces, {host:.3f} ms in them ({100 * host / step_ms:.1f}% of the step); " \
           f"collective kernels {dev:.3f} ms on the device"


def dp_full(rank, device, attention, layernorm, card):
    """Check 3: the full-width steps, one rank's share each."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from imagegenerator_tpu_torch.parallel import dp
    from imagegenerator_tpu_torch.train.stage1 import Stage1System
    from imagegenerator_tpu_torch.train.stage2 import Stage2System
    from imagegenerator_tpu_torch.utils.rng import mixed_generator

    profiling = []

    def reduce(tensors):
        if not profiling:
            return dp.all_reduce_mean(tensors)
        # the profiled step: the rank's own kernels first, so that the
        # region holds the collective (and the wait for the other rank)
        torch.cuda.synchronize(device)
        with record_function("dp.all_reduce_mean"):
            dp.all_reduce_mean(tensors)
            torch.cuda.synchronize(device)

    set_tf32(False)
    out = {}
    for stage in (1, 2):
        init = torch.Generator(device=device).manual_seed(SEED)  # the same init on both ranks
        data = torch.Generator(device=device).manual_seed(SEED + 1 + rank)  # each rank its own batch
        if stage == 1:
            cfg = train_config(True, True, torch.bfloat16)
            system = Stage1System(cfg, device=device, generator=init)
            batch, size = train_batch(cfg, data), TRAIN_BATCH

            def run(i):
                return system.train_step(batch, generator=mixed_generator(SEED, i, device),
                                         host_generator=mixed_generator(SEED, i, "cpu"), reduce=reduce)
        else:
            cfg = train2_config(True, torch.bfloat16)
            system = Stage2System(cfg, device=device, generator=init)
            tokens = train2_batch(cfg, data, DP_STAGE2_BATCH)
            batch = {"tem": system.embed_texts(tokens["input_ids"], tokens["attention_mask"]),
                     "image": tokens["image"]}
            size = DP_STAGE2_BATCH
            del tokens

            def run(i):
                return system.train_step(batch, generator=mixed_generator(SEED, i, device), reduce=reduce)
        dp.broadcast_state([system])
        times = []
        for i in range(1 + DP_TIMED_STEPS):
            reset_counts(attention, layernorm)
            dp.barrier()
            times.append(wall_ms(lambda: run(i), runs=1))
            counts = read_counts(attention, layernorm)
            want = WITH_BACKWARD if stage == 1 else dict.fromkeys(NO_BACKWARD, 0)
            if counts != want:
                raise AssertionError(f"rank {rank} stage {stage} step {i + 1}: launches {counts}, expected {want}")
        step_ms = statistics.median(times[1:])
        dp.barrier()
        torch.cuda.synchronize()
        profiling.append(True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            metrics = run(1 + DP_TIMED_STEPS)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        profiling.clear()
        if not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise AssertionError(f"rank {rank} stage {stage}: metrics {metrics}")
        route = "stage-1 step" if stage == 1 else "stage-2 step, tem route"
        log(f"  [rank {rank}] {route}, {size} a rank, bf16: {step_ms:.3f} ms (steps "
            f"{', '.join(f'{t:.1f}' for t in times)}, the first a warm-up), {DP_WORLD * size / step_ms * 1e3:.1f} "
            f"img/s over {DP_WORLD} ranks; launches a step {counts}; profiled step {prof_ms:.1f} ms: "
            f"{dp_collectives(prof.key_averages(), prof_ms)}; peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} "
            f"GiB [{card}]")
        out[stage] = {"step_ms": step_ms, "launches": counts}
        del system, batch, prof
        torch.cuda.empty_cache()
    return out


def dp_worker(rank: int, port: int, nccl: bool) -> int:
    """One rank of phase 9 (``chip_smoke.py --dp-worker RANK``)."""
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from imagegenerator_tpu_torch.ops.kernels import attention, layernorm

    device = torch.device("cuda", rank if nccl else 0)
    torch.cuda.set_device(device)
    card = os.environ["DP_CARD"]
    # CPU tensors (the CPU half of check 1) go over gloo either way
    backend = "cpu:gloo,cuda:nccl" if nccl else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=DP_WORLD, rank=rank)
    try:
        log(f"  [rank {rank}] on {device}, backend {backend}")
        dp_tiny(rank, device)
        dp_full(rank, device, attention, layernorm, card)
    finally:
        dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_dp_workers(tmp: Path, nccl: bool, card: str) -> None:
    """Checks 1-3 in two processes, one per rank; each prints its log
    lines, which are shown here."""
    import os

    logs = [tmp / f"dp_rank{r}.log" for r in range(DP_WORLD)]
    port = free_port()
    env = dict(os.environ, DP_CARD=card, PYTHONPATH=str(ROOT))
    procs = []
    try:
        for r, path in enumerate(logs):
            with open(path, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--dp-worker", str(r), "--dp-port", str(port)]
                    + (["--dp-nccl"] if nccl else []), stdout=f, stderr=subprocess.STDOUT, cwd=ROOT, env=env))
        for p in procs:
            p.wait(timeout=DP_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for r, path in enumerate(logs):
            failed = procs[r].returncode != 0
            for line in path.read_text().splitlines():
                # each rank's own log lines, and everything of a rank that failed
                if f"[rank {r}]" in line or failed:
                    log(line if line.startswith("  ") else f"  [rank {r} output] {line}")
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"phase 9: rank(s) {bad} failed")


def phase_dp_cli(tmp: Path, nccl: bool, card: str) -> None:
    """Check 4: ``torchrun --standalone --nproc_per_node 2 -m
    imagegenerator_tpu_torch.train.cli --multihost --stage 2`` at full
    width, then the same command again, which must resume on both ranks."""
    import os

    log(f"phase 9: torchrun, 2 ranks, train.cli --multihost --stage 2, full width, bf16, batch "
        f"{DP_CLI_BATCH} a rank")
    write_chain_dataset(tmp / "ds")
    ckpt, prof = tmp / "ckpt", tmp / "prof"
    argv = ["--multihost", "--stage", "2", "--data", str(tmp / "ds"), "--root", "imgs",
            "--ann_file", "ann/captions.json", "--batch_size", str(DP_CLI_BATCH), "--num_epochs", "1",
            "--checkpoint_dir", str(ckpt), "--fused_attn", "--fused_ln", "--seed", str(SEED),
            "--profile_dir", str(prof)] + ([] if nccl else ["--device", "cuda:0"])
    steps = CHAIN_IMAGES // DP_WORLD // DP_CLI_BATCH
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for run in (1, 2):
        logs = tmp / f"torchrun{run}"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(DP_WORLD),
               "--log_dir", str(logs), "--redirects", "3", "-m", "imagegenerator_tpu_torch.train.cli", *argv]
        t0 = time.perf_counter()
        done = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=DP_TIMEOUT)
        seconds = time.perf_counter() - t0
        outs = {int(p.parent.name): p.read_text() for p in logs.rglob("stdout.log")}
        if done.returncode or sorted(outs) != list(range(DP_WORLD)):
            for line in (done.stdout + done.stderr).splitlines()[-30:]:
                log(f"    | {line}")
            for p in logs.rglob("stderr.log"):
                for line in p.read_text().splitlines()[-15:]:
                    log(f"    | {p.parent.name}: {line}")
            raise AssertionError(f"torchrun run {run}: exit {done.returncode}, rank logs {sorted(outs)}")
        for r, out in sorted(outs.items()):
            lines = out.splitlines()
            step_lines = [l for l in lines if l.startswith("step ")]
            resumed = "Loaded checkpoint at epoch 0" in lines
            for line in lines:
                if line.startswith(("[dp]", "step ", "Loaded", "[profile]")):
                    log(f"    | rank {r}: {line}")
            want_steps = steps if (run == 1 and r == 0) else 0
            if len(step_lines) != want_steps or resumed != (run == 2) or f"[dp] rank {r} of {DP_WORLD}" not in out:
                raise AssertionError(f"torchrun run {run}, rank {r}: {len(step_lines)} step lines, resumed "
                                     f"{resumed}")
        log(f"  run {run}: {seconds:.1f} s, both ranks {'resumed' if run == 2 else 'trained'} [{card}]")
    root = ckpt / "Stage2"
    found = sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
    want = ["LATEST_EPOCH", "epochs/checkpoint_epoch_0/state.npz", "latest/state.npz"]
    traces = sorted(p.name for p in prof.iterdir())
    if found != want or traces != [f"trace_rank{r}.json" for r in range(DP_WORLD)]:
        raise AssertionError(f"checkpoint files {found}, traces {traces}")
    log(f"  only rank 0 wrote the checkpoint: {found}; --profile_dir left {traces}")


def phase_dp(card) -> None:
    import torch

    n = torch.cuda.device_count()
    nccl = n >= DP_WORLD
    how = "one card per rank over NCCL" if nccl else "both ranks on cuda:0 over gloo"
    log(f"phase 9: data parallelism, {DP_WORLD} ranks on {n} card(s): {how}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run_dp_workers(Path(tmp), nccl, card)
        log(f"phase 9: checks 1-3 in {time.perf_counter() - t0:.1f} s")
        phase_dp_cli(Path(tmp), nccl, card)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s in all")


# ------------------------------------------------ CLIP family and evaluation

RN_BATCH = 4
# RN50 on the card (f32, off TF32 and cuDNN) against the CPU: max abs
# difference over the largest output, image and text towers
RN_TOL = 1e-4
V2_RN_ITERS = 3
EVAL_IMAGES, EVAL_SIZE, EVAL_BATCH = 512, 256, 64
# the eval CLI's numbers against the same embeddings' numbers recomputed
# in numpy: relative, plus half a unit of the last digit the JSON line
# keeps (4 decimals for the score, 6 for the distance)
EVAL_RECOMPUTE_TOL = 1e-6
EVAL_ROUNDING = {"clip_score": 0.5e-4, "frechet_clip_distance": 0.5e-6}
EVAL_DP_TOL = 1e-5  # eval over two ranks against one process, f32, TF32 off: relative
V2_RANKS_TOL = {"losses": 1e-4, "pixels": 1}  # v2 over two ranks against one process: relative; of 255
# both sides of phase 10 (4): TF32 off in cuBLAS and cuDNN, the warp kernel on
RANKS_ENV = {"NVIDIA_TF32_OVERRIDE": "0", "IMAGEGEN_WARP_KERNEL": "1"}
RANKS_PROMPTS = ["a watercolor fox|stormy sea:0.5", "a red bus on a street", "two dogs on a beach:1:0.2|blurry:-0.5",
                 "a bowl of fruit"]


def seeded_clip_state(cfg, seed: int) -> dict:
    """A full-width CLIP ``state_dict`` under OpenAI's names, on the CPU,
    from a seed: the port's init with each convolution scaled to He's
    variance and each frozen BatchNorm given statistics and an affine
    away from the identity, the last of each bottleneck (``bn3``) scaled
    to 0.2-0.3, where OpenAI's initialisation zeroes it (as
    ``tests/test_torch_clip_resnet.py`` draws its tiny ones). With every
    residual branch at full scale the tower's features grow to a std of
    about 200 and it amplifies a relative input change 6.7 times; so
    scaled, 0.6 and 0.28 (RN50 at 224 px on the CPU)."""
    import torch

    from imagegenerator_tpu_torch.v2.clip import CLIP

    gen = torch.Generator().manual_seed(seed)
    sd = CLIP(cfg, device="cpu", generator=gen).state_dict()
    with torch.no_grad():
        for k, v in sd.items():
            if v.ndim == 4 and cfg.is_resnet:
                v.mul_(6 ** 0.5)
            elif k.endswith("running_mean"):
                v.normal_(0.0, 0.05, generator=gen)
            elif k.endswith("running_var"):
                v.uniform_(0.8, 1.2, generator=gen)
            elif ".bn" in k or ".downsample.1." in k:
                if k.endswith("weight"):
                    v.uniform_(0.8, 1.2, generator=gen).mul_(0.25 if ".layer" in k and ".bn3." in k else 1.0)
                else:
                    v.normal_(0.0, 0.1, generator=gen)
    return sd


def save_published(sd: dict, path: Path) -> None:
    """``sd`` as OpenAI ships a checkpoint: with ``logit_scale`` and, for
    a ResNet, BatchNorm's ``num_batches_tracked`` counters."""
    import torch

    extra = {k.replace("running_var", "num_batches_tracked"): torch.tensor(0)
             for k in sd if k.endswith("running_var")}
    torch.save({**sd, **extra, "logit_scale": torch.tensor(4.6052)}, path)


def pool_without_mean(pool):
    """A planted fault: the attention pool with its mean token left out
    (the first grid token is the query)."""
    import math

    import torch

    def forward(x):
        B, C, H, W = x.shape
        t = x.permute(0, 2, 3, 1).reshape(B, H * W, C) + pool.positional_embedding[1:].to(x.dtype)
        q = pool.q_proj(t[:, :1]).reshape(B, 1, pool.heads, -1).transpose(1, 2)
        k, v = (p(t).reshape(B, H * W, pool.heads, -1).transpose(1, 2) for p in (pool.k_proj, pool.v_proj))
        attn = torch.softmax(q.float() @ k.float().transpose(-1, -2) / math.sqrt(C // pool.heads), dim=-1)
        return pool.c_proj((attn.to(v.dtype) @ v).reshape(B, C))

    return forward


def phase_rn50_towers(rn_sd) -> None:
    """(1): RN50's towers on the card against the CPU."""
    import torch

    from imagegenerator_tpu_torch.v2.clip import CLIP, CLIPConfig
    from imagegenerator_tpu_torch.v2.engine import frozen
    from imagegenerator_tpu_torch.v2.tokenizer import open_tokenizer

    cfg = CLIPConfig.rn50()
    log(f"phase 10: RN50 on the card against the CPU, batch {RN_BATCH}, f32 off TF32 and cuDNN")
    t0 = time.perf_counter()
    images = torch.randn((RN_BATCH, cfg.image_resolution, cfg.image_resolution, 3),
                         generator=torch.Generator().manual_seed(SEED))
    tokens = torch.as_tensor(open_tokenizer(None, cfg.context_length, cfg.vocab_size)(CAPTIONS.split("|")))
    models = {dev: frozen(CLIP, cfg, rn_sd, device=dev) for dev in ("cpu", "cuda")}
    with torch.no_grad():
        want = {"image": models["cpu"].encode_image(images), "text": models["cpu"].encode_text(tokens)}

    def hold(quiet=False):
        with torch.no_grad(), exact_f32():
            got = {"image": models["cuda"].encode_image(images.cuda()).cpu(),
                   "text": models["cuda"].encode_text(tokens.cuda()).cpu()}
        for tower, w in want.items():
            err = ((got[tower] - w).abs().max() / w.abs().max()).item()
            ok = bool(torch.isfinite(got[tower]).all()) and got[tower].shape == w.shape and err <= RN_TOL
            if not (ok and quiet):
                log(f"  {tower} tower {tuple(w.shape)}: max abs difference / largest {err:.3e} "
                    f"(limit {RN_TOL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"RN50's {tower} tower on the card disagrees with the CPU")

    hold()
    pool = models["cuda"].visual.attnpool
    pool.forward = pool_without_mean(pool)
    try:
        must_catch("the attention pool without its mean token", lambda: hold(quiet=True))
    finally:
        del pool.forward
    log(f"  {sum(v.numel() for v in rn_sd.values()) / 1e6:.1f}M parameters; {time.perf_counter() - t0:.1f} s")


def phase_rn50_v2(tmp: Path, rn_sd, vq_argmin, scanline_lerp, gen, card):
    """(2): the v2 CLI with ``-m RN50`` at full width, one step's
    launches, a batch-4 step kernels on vs off, 10-step windows. Returns
    the launches of one step and the VQGAN's ``state_dict``."""
    import math

    import torch

    from imagegenerator_tpu_torch.v2.clip import CLIPConfig
    from imagegenerator_tpu_torch.v2.engine import iteration_generator

    log(f"phase 10: the v2 CLI with -m RN50, full width, {V2_IMAGE} px, warp kernel on")
    rn50 = CLIPConfig.rn50()
    vq_state = write_vqgan(tmp, gen)
    out = tmp / "rn50.png"
    files = ["-conf", str(tmp / "vqgan.yaml"), "-ckpt", str(tmp / "vqgan.ckpt"), "-m", "RN50",
             "--clip_checkpoint", str(tmp / "RN50.pt"), "-o", str(out)]
    vq_argmin.launches = scanline_lerp.launches = 0
    t0 = time.perf_counter()
    printed = run_v2_cli(V2_ARGS + ["-i", str(V2_RN_ITERS)] + files)
    torch.cuda.synchronize()
    counts = v2_counts(vq_argmin, scanline_lerp)
    checkins = V2_RN_ITERS // V2_EVERY + 1  # each: one synth and one loss evaluation
    want = {"vq_argmin": V2_RN_ITERS + 2 * checkins, "scanline_lerp": 2 * V2_RN_ITERS + 2 * checkins}
    log(f"  {V2_RN_ITERS} iterations: {time.perf_counter() - t0:.1f} s; launches {counts} [{card}]")
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    losses = [float(l.split("loss: ")[1].split(",")[0]) for l in printed.splitlines()
              if l.startswith(("i: ", "progress: "))]
    if len(losses) != checkins + V2_RN_ITERS // V2_EVERY or not all(map(math.isfinite, losses)):
        raise AssertionError(f"losses {losses}")
    comment = png_comment(out)
    if png_size(out) != (V2_IMAGE, V2_IMAGE) or comment != str(V2_ARGS[1].split("|")):
        raise AssertionError(f"{out}: size {png_size(out)}, comment {comment!r}")
    log(f"  {V2_IMAGE}x{V2_IMAGE} PNG, comment {comment!r}; {len(losses)} finite losses; launches match {want}")

    engine = v2_engine(vq_state, rn_sd, None, True, clip_cfg=rn50)
    if engine.make_cutouts.cut_size != rn50.image_resolution:
        raise AssertionError(f"cutouts at {engine.make_cutouts.cut_size} px for a {rn50.image_resolution} px tower")
    state = engine.init_state(engine.random_token_latent(gen, 1, V2_IMAGE // 16, V2_IMAGE // 16))
    prompts = v2_prompts(engine, 1)
    vq_argmin.launches = scanline_lerp.launches = 0
    engine.step(state, iteration_generator(SEED, 0, "cuda"), *prompts)
    torch.cuda.synchronize()
    step_launches = v2_counts(vq_argmin, scanline_lerp)
    if step_launches != {"vq_argmin": 1, "scanline_lerp": 2}:
        raise AssertionError(f"one RN50 step launched {step_launches}")
    log(f"  one RN50 step at batch 1 launches {step_launches}")
    del engine, state
    phase_v2_on_off(vq_state, rn_sd, gen, dtypes=("f32",), clip_cfg=rn50, phase=10)
    phase_v2_lanczos_times(vq_state, rn_sd, gen, card, size=V2_IMAGE, clip_cfg=rn50, what=f"RN50 {V2_IMAGE} px")
    return step_launches, vq_state


def write_eval_sets(root: Path) -> None:
    """``EVAL_IMAGES`` generated images as ``generated.npz`` (uint8) and as
    many reference PNGs in ``ref/``, all ``EVAL_SIZE`` px, blocky colour
    fields with noise, and ``captions.txt`` (``CAPTIONS`` in turn, one a
    line). The two sets are drawn from different laws (8 x 8 blocks over
    the whole range against 4 x 4 blocks over its middle), as a generated
    set and a real one differ: two sets of one law would put the distance
    at its sampling noise, a small difference of large traces."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from imagegenerator_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(SEED)

    def images(grid, lo, hi):
        base = rng.integers(lo, hi, (EVAL_IMAGES, grid, grid, 3), dtype=np.int16)
        base = base.repeat(EVAL_SIZE // grid, 1).repeat(EVAL_SIZE // grid, 2)
        return (base + rng.integers(-12, 13, base.shape, dtype=np.int16)).clip(0, 255).astype(np.uint8)

    np.savez(root / "generated.npz", images=images(8, 0, 256))
    (root / "ref").mkdir()
    with ThreadPoolExecutor(8) as pool:  # zlib, which takes most of the time, releases the GIL
        list(pool.map(lambda i, image: write_png(str(root / "ref" / f"{i:04d}.png"), image),
                      *zip(*enumerate(images(4, 64, 192)))))
    (root / "captions.txt").write_text("".join(f"{CAPTIONS.split('|')[i % 4]}\n" for i in range(EVAL_IMAGES)))


def numpy_metrics(gen_emb, ref_emb, text_emb, caption_rows) -> dict:
    """CLIPScore and the Fréchet distance of the embeddings in numpy
    float64, with the usual eps on both diagonals where a covariance is
    near singular; ``regularised`` says whether it was."""
    import numpy as np

    g, r = np.asarray(gen_emb, np.float64), np.asarray(ref_emb, np.float64)
    t = np.asarray(text_emb, np.float64)[caption_rows]
    cos = (g * t).sum(-1) / np.linalg.norm(g, axis=-1) / np.linalg.norm(t, axis=-1)
    c1, c2 = np.cov(g, rowvar=False), np.cov(r, rowvar=False)
    eps = 1e-6
    regularised = min(np.linalg.eigvalsh(c1)[0], np.linalg.eigvalsh(c2)[0]) < eps
    if regularised:
        c1, c2 = c1 + eps * np.eye(len(c1)), c2 + eps * np.eye(len(c2))
    w, v = np.linalg.eigh(c1)
    root1 = (v * np.sqrt(w.clip(0.0))) @ v.T
    inner = root1 @ c2 @ root1
    tr_sqrt = np.sqrt(np.linalg.eigvalsh((inner + inner.T) / 2).clip(0.0)).sum()
    diff = g.mean(0) - r.mean(0)
    return {"clip_score": 100.0 * np.maximum(cos, 0.0).mean(), "regularised": regularised,
            "frechet_clip_distance": max(diff @ diff + np.trace(c1) + np.trace(c2) - 2 * tr_sqrt, 0.0)}


def phase_eval_cli(tmp: Path, samples: Path | None, card):
    """(3): the evaluation CLI on both towers in f32 and bf16, its numbers
    held to a numpy recomputation from the card's embeddings; then the
    chain sample -> evaluate on phase 8's PNGs. Returns the two sets as
    read, the distinct captions and each sample's caption row."""
    import numpy as np
    import torch

    from imagegenerator_tpu_torch.eval import cli, clip_eval
    from imagegenerator_tpu_torch.v2.clip import CLIP
    from imagegenerator_tpu_torch.v2.engine import frozen
    from imagegenerator_tpu_torch.v2.generate import load_clip
    from imagegenerator_tpu_torch.v2.tokenizer import open_tokenizer

    log(f"phase 10: the evaluation CLI, full width, {EVAL_IMAGES} generated images (.npz) against "
        f"{EVAL_IMAGES} reference PNGs, {EVAL_SIZE} px, --batch {EVAL_BATCH}")
    t0 = time.perf_counter()
    write_eval_sets(tmp)
    generated, ref = cli.load_image_set(str(tmp / "generated.npz")), cli.load_image_set(str(tmp / "ref"))
    captions = (tmp / "captions.txt").read_text().split("\n")[:-1]
    unique = list(dict.fromkeys(captions))
    rows = np.array([unique.index(c) for c in captions])
    log(f"  sets written and read back in {time.perf_counter() - t0:.1f} s")
    # the CLI's defaults in a fresh process: TF32 off in products, on in cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    keys = {"n_samples", "clip_model", "real_weights", "clip_score", "n_ref", "frechet_clip_distance"}
    for name, pt in (("ViT-B/32", "ViT-B-32.pt"), ("RN50", "RN50.pt")):
        for dtype in ("f32", "bf16"):
            argv = ["--samples", str(tmp / "generated.npz"), "--ref", str(tmp / "ref"), "--captions",
                    f"@{tmp / 'captions.txt'}", "-m", name, "--clip_checkpoint", str(tmp / pt),
                    "--batch", str(EVAL_BATCH), "--dtype", dtype]
            t0 = time.perf_counter()
            result = json.loads(run_cli(cli.main, argv).strip().splitlines()[-1])
            seconds = time.perf_counter() - t0
            numbers = [result["clip_score"], result["frechet_clip_distance"]]
            if (set(result) != keys or result["n_samples"] != EVAL_IMAGES or result["n_ref"] != EVAL_IMAGES
                    or result["clip_model"] != name or result["real_weights"] is not True
                    or not all(map(np.isfinite, numbers)) or not 0.0 <= result["clip_score"] <= 100.0):
                raise AssertionError(f"{name} {dtype}: {result}")
            cfg, state = load_clip(name, str(tmp / pt))
            model = frozen(CLIP, cfg, state, torch.bfloat16 if dtype == "bf16" else None, device="cuda")
            tokens = open_tokenizer(None, cfg.context_length, cfg.vocab_size)(unique)
            want = numpy_metrics(clip_eval.image_embeddings(model, generated, EVAL_BATCH),
                                 clip_eval.image_embeddings(model, ref, EVAL_BATCH),
                                 clip_eval.text_embeddings(model, tokens, EVAL_BATCH), rows)
            del model
            for key, limit in EVAL_ROUNDING.items():
                err = abs(result[key] - want[key])
                ok = err <= EVAL_RECOMPUTE_TOL * abs(want[key]) + limit
                log(f"  {name} {dtype}: {key} {result[key]} against numpy's {want[key]:.9g} from the card's "
                    f"embeddings: {err:.3e} (limit {EVAL_RECOMPUTE_TOL:g} relative + {limit:g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} {dtype}: the CLI's {key} is not its embeddings'")
            # n samples span at most n - 1 dimensions: a covariance of no more
            # samples than dimensions is singular and takes the eps
            if EVAL_IMAGES <= cfg.embed_dim and not want["regularised"]:
                raise AssertionError(f"{name}: no eps regularisation with {EVAL_IMAGES} samples in "
                                     f"{cfg.embed_dim} dimensions")
            log(f"  {name} {dtype}: the CLI in {seconds:.1f} s wall [{card}]; {cfg.embed_dim} dimensions, "
                f"{EVAL_IMAGES} samples: eps regularisation {'taken' if want['regularised'] else 'not needed'}")
    if samples is None:
        log("  phase 8's samples are not here (--only eval): the chain sample -> evaluate is left out")
        return generated, ref, unique, rows
    pngs = sorted(samples.glob("*.png"))
    (tmp / "sample_captions.txt").write_text("".join(png_comment(p) + "\n" for p in pngs))
    result = json.loads(run_cli(cli.main, [
        "--samples", str(samples), "--captions", f"@{tmp / 'sample_captions.txt'}",
        "--clip_checkpoint", str(tmp / "ViT-B-32.pt")]).strip().splitlines()[-1])
    if result["n_samples"] != len(pngs) or not 0.0 <= result["clip_score"] <= 100.0:
        raise AssertionError(f"scoring phase 8's samples: {result}")
    log(f"  the chain sample -> evaluate: phase 8's {len(pngs)} EMA samples against their captions, "
        f"CLIPScore {result['clip_score']} (ViT-B/32, random weights)")
    return generated, ref, unique, rows


def run_one_and_ranks(tmp: Path, module: str, one_argv, rank_argv, what: str):
    """``python -m module one_argv`` and ``torchrun --standalone
    --nproc_per_node 2 -m module rank_argv``, both under ``RANKS_ENV``:
    the one process's stdout, each rank's and the two wall times."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT), **RANKS_ENV)
    t0 = time.perf_counter()
    one = subprocess.run([sys.executable, "-m", module, *one_argv], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=DP_TIMEOUT)
    one_s = time.perf_counter() - t0
    if one.returncode:
        for line in (one.stdout + one.stderr).splitlines()[-30:]:
            log(f"    | {line}")
        raise AssertionError(f"{what}, one process: exit {one.returncode}")
    logs = tmp / f"torchrun_{what.replace(' ', '_')}"
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                           str(DP_WORLD), "--log_dir", str(logs), "--redirects", "3", "-m", module, *rank_argv],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=DP_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    outs = {int(p.parent.name): p.read_text() for p in logs.rglob("stdout.log")}
    if done.returncode or sorted(outs) != list(range(DP_WORLD)):
        for line in (done.stdout + done.stderr).splitlines()[-30:]:
            log(f"    | {line}")
        for p in logs.rglob("stderr.log"):
            for line in p.read_text().splitlines()[-15:]:
                log(f"    | {p.parent.name}: {line}")
        raise AssertionError(f"{what}, torchrun: exit {done.returncode}, rank logs {sorted(outs)}")
    for r, out in sorted(outs.items()):
        if f"[dp] rank {r} of {DP_WORLD}" not in out:
            raise AssertionError(f"{what}: rank {r} did not join the group")
        log(f"    | rank {r}: {next(l for l in out.splitlines() if l.startswith('[dp]'))}")
    return one.stdout, outs, one_s, ranks_s


def loss_lines(text: str) -> list:
    """(what the line is, its numbers) of each loss and progress line of
    the v2 CLI."""
    out = []
    for line in text.splitlines():
        if " loss: " in line:
            head, rest = line.split(" loss: ")
            out.append((head, [float(v) for v in re.findall(r"-?[\d.]+(?:e[-+]?\d+)?|nan|inf", rest)]))
    return out


def batch_split_witness(tmp: Path, sets) -> None:
    """How far the batch size alone moves the eval numbers: RN50's
    embeddings at ``EVAL_BATCH`` and at each rank's share of it, in this
    process with TF32 off, through ``numpy_metrics``. Printed, not held."""
    import torch

    from imagegenerator_tpu_torch.eval import clip_eval
    from imagegenerator_tpu_torch.v2.clip import CLIP
    from imagegenerator_tpu_torch.v2.engine import frozen
    from imagegenerator_tpu_torch.v2.generate import load_clip
    from imagegenerator_tpu_torch.v2.tokenizer import open_tokenizer

    generated, ref, unique, rows = sets
    set_tf32(False)
    cfg, state = load_clip("RN50", str(tmp / "RN50.pt"))
    model = frozen(CLIP, cfg, state, device="cuda")
    text = clip_eval.text_embeddings(model, open_tokenizer(None, cfg.context_length, cfg.vocab_size)(unique))
    got = {b: numpy_metrics(clip_eval.image_embeddings(model, generated, b),
                            clip_eval.image_embeddings(model, ref, b), text, rows)
           for b in (EVAL_BATCH, EVAL_BATCH // DP_WORLD)}
    a, b = got[EVAL_BATCH], got[EVAL_BATCH // DP_WORLD]
    log("  witness, one process, TF32 off, RN50 embedded at batch "
        f"{EVAL_BATCH} against {EVAL_BATCH // DP_WORLD}: " + ", ".join(
            f"{k} {a[k]:.9g} against {b[k]:.9g} ({abs(a[k] - b[k]) / abs(a[k]):.3e} relative)"
            for k in ("clip_score", "frechet_clip_distance")))


def v2_split_witness(vq_state, rn_sd, gen) -> None:
    """How far the batch size alone moves the v2 losses: one process, TF32
    off, the batch-4 engine against two ``shard=(rank, 2)`` engines over
    phase (4)'s 3 iterations, from the same latent and seeds. Printed,
    not held."""
    import torch

    from imagegenerator_tpu_torch.v2.clip import CLIPConfig
    from imagegenerator_tpu_torch.v2.engine import GenerateEngine

    set_tf32(False)
    vq_cfg, _ = v2_configs()

    def engine(shard=(0, 1)):
        return GenerateEngine(vq_cfg, CLIPConfig.rn50(), vq_state, rn_sd, warp_kernel=True, shard=shard,
                              device="cuda")

    whole = engine()
    batch = len(RANKS_PROMPTS)
    z0 = whole.random_token_latent(gen, batch, V2_IMAGE // 16, V2_IMAGE // 16)
    prompts = v2_prompts(whole, batch)
    _, want = whole.chain(whole.init_state(z0), V2_RN_ITERS, SEED, *prompts)
    del whole
    got = []
    for r in range(DP_WORLD):
        rows = slice(r * batch // DP_WORLD, (r + 1) * batch // DP_WORLD)
        half = engine((r, DP_WORLD))
        got.append(half.chain(half.init_state(z0[rows]), V2_RN_ITERS, SEED, *(p[rows] for p in prompts))[1])
        del half
    got = torch.cat(got, dim=1)
    live = want.abs() > 0  # padded prompts carry no loss
    rel = [((got[i] - want[i]).abs()[live[i]] / want[i].abs()[live[i]]).max().item() for i in range(V2_RN_ITERS)]
    log(f"  witness, one process, TF32 off: the v2 losses of {DP_WORLD} engines of batch {batch // DP_WORLD} "
        f"against one of batch {batch}, largest relative difference by iteration "
        f"{', '.join(f'{v:.3e}' for v in rel)}")


def phase_ranks(tmp: Path, card) -> None:
    """(4): the evaluation CLI with ``--dp 2`` and the v2 CLI at batch 4
    over two ranks, each against one process."""
    import numpy as np
    import torch

    from imagegenerator_tpu_torch.utils.png import decode_png

    n = torch.cuda.device_count()
    nccl = n >= DP_WORLD
    log(f"phase 10: two ranks ({'a card each over NCCL' if nccl else 'both on cuda:0 over gloo'}) against one "
        "process, TF32 off")
    shared = [] if nccl else ["--device", "cuda:0"]
    argv = ["--samples", str(tmp / "generated.npz"), "--ref", str(tmp / "ref"), "--captions",
            f"@{tmp / 'captions.txt'}", "-m", "RN50", "--clip_checkpoint", str(tmp / "RN50.pt"),
            "--batch", str(EVAL_BATCH)]
    one, outs, one_s, ranks_s = run_one_and_ranks(tmp, "imagegenerator_tpu_torch.eval.cli", argv,
                                                  argv + ["--dp", str(DP_WORLD)] + shared, "eval")
    want = json.loads(one.strip().splitlines()[-1])
    got = json.loads(outs[0].strip().splitlines()[-1])
    if any(l.startswith("{") for l in outs[1].splitlines()) or set(got) != set(want):
        raise AssertionError(f"eval over ranks printed {got}; rank 1 {outs[1][-300:]!r}")
    for key, value in want.items():
        ok = (abs(got[key] - value) <= EVAL_DP_TOL * abs(value)) if isinstance(value, float) else got[key] == value
        if not ok:
            raise AssertionError(f"eval --dp {DP_WORLD}: {key} {got[key]}, one process {value}")
    log(f"  eval --dp {DP_WORLD}: {got} equals one process's (floats to {EVAL_DP_TOL:g} relative); "
        f"{ranks_s:.1f} s against {one_s:.1f} s [{card}]")

    (tmp / "prompts.txt").write_text("\n".join(RANKS_PROMPTS) + "\n")
    dirs = {side: tmp / f"v2_{side}" for side in ("one", "ranks")}
    common = ["--prompts_file", str(tmp / "prompts.txt"), "-i", str(V2_RN_ITERS), "-se", str(V2_EVERY),
              "-sd", str(SEED), "-m", "RN50", "--clip_checkpoint", str(tmp / "RN50.pt"),
              "-conf", str(tmp / "vqgan.yaml"), "-ckpt", str(tmp / "vqgan.ckpt")]
    for d in dirs.values():
        d.mkdir()
    one, outs, one_s, ranks_s = run_one_and_ranks(
        tmp, "imagegenerator_tpu_torch.v2.generate", common + ["-o", str(dirs["one"] / "o.png")],
        common + ["-o", str(dirs["ranks"] / "o.png")] + (["-cd", "cuda:0"] if not nccl else []), "v2")
    want, got = loss_lines(one), loss_lines(outs[0])
    worst = 0.0
    if [w[0] for w in want] != [g[0] for g in got] or len(want) != 4 * (V2_RN_ITERS // V2_EVERY + 1) + 1:
        raise AssertionError(f"loss lines: one process {[w[0] for w in want]}, rank 0 {[g[0] for g in got]}")
    for (_, a), (_, b) in zip(got, want):
        worst = max(worst, max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b)))
    if worst > V2_RANKS_TOL["losses"] or loss_lines(outs[1]):
        for (head, a), (_, b) in zip(got, want):
            log(f"    {head} rank 0 {a} one process {b}")
        raise AssertionError(f"v2 over ranks: losses {worst:.3e} relative from one process's, or rank 1 printed")
    pixels = 0
    for b in range(len(RANKS_PROMPTS)):
        a, c = (decode_png((dirs[side] / f"o_{b}.png").read_bytes()).astype(np.int16) for side in ("ranks", "one"))
        pixels = max(pixels, int(np.abs(a - c).max()))
    if pixels > V2_RANKS_TOL["pixels"]:
        raise AssertionError(f"v2 over ranks: PNG pixels {pixels} of 255 from one process's")
    log(f"  v2 at batch {len(RANKS_PROMPTS)} over {DP_WORLD} ranks: {len(got)} loss lines within {worst:.3e} "
        f"relative of one process's (limit {V2_RANKS_TOL['losses']:g}), PNG pixels within {pixels} of 255 "
        f"(limit {V2_RANKS_TOL['pixels']}); {ranks_s:.1f} s against {one_s:.1f} s [{card}]")


def phase_eval_times(vit_sd, rn_sd, card) -> None:
    """(5): the towers' embedding rate at ``EVAL_BATCH`` from
    ``EVAL_SIZE`` px images on the card (the resize included), under the
    CLI's defaults, and the device's busy share over one batch."""
    import torch

    from imagegenerator_tpu_torch.eval.clip_eval import prepare_images
    from imagegenerator_tpu_torch.v2.clip import CLIP, CLIPConfig
    from imagegenerator_tpu_torch.v2.engine import frozen

    log(f"phase 10: eval embedding times on {card}, batch {EVAL_BATCH} from {EVAL_SIZE} px")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    x = torch.rand((EVAL_BATCH, EVAL_SIZE, EVAL_SIZE, 3), generator=torch.Generator().manual_seed(SEED)).cuda()
    for name, cfg, sd in (("ViT-B/32", CLIPConfig.vit_b32(), vit_sd), ("RN50", CLIPConfig.rn50(), rn_sd)):
        for dtype, tag in ((None, "f32"), (torch.bfloat16, "bf16")):
            model = frozen(CLIP, cfg, sd, dtype, device="cuda")

            @torch.no_grad()
            def embed():
                return model.encode_image(prepare_images(x, cfg.image_resolution, dtype))

            embed()
            ms = wall_ms(embed)
            host_ms, events = profiled(embed, calls=1)
            busy = sum(e.self_device_time_total for e in events) / 1e3
            log(f"  {name} {tag}: {ms:.3f} ms a batch, {EVAL_BATCH * 1e3 / ms:.1f} images/s; one profiled batch: "
                f"device busy {busy:.3f} of {host_ms:.3f} ms ({100 * busy / host_ms:.1f}%), "
                f"{sum(e.count for e in events)} kernels [{card}]")
            del model


def phase_clip_eval(vq_argmin, scanline_lerp, gen, card, samples: Path | None = None):
    """Phase 10: the CLIP family and evaluation. Returns the launches of
    one RN50 v2 step."""
    import torch

    from imagegenerator_tpu_torch.v2.clip import CLIPConfig

    log(f"phase 10: the CLIP family and evaluation, full width, on {card}")
    t0 = time.perf_counter()
    rn_sd = seeded_clip_state(CLIPConfig.rn50(), SEED)
    vit_sd = seeded_clip_state(CLIPConfig.vit_b32(), SEED)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_published(rn_sd, tmp / "RN50.pt")
        save_published(vit_sd, tmp / "ViT-B-32.pt")
        phase_rn50_towers(rn_sd)
        step_launches, vq_state = phase_rn50_v2(tmp, rn_sd, vq_argmin, scanline_lerp, gen, card)
        torch.cuda.empty_cache()
        sets = phase_eval_cli(tmp, samples, card)
        batch_split_witness(tmp, sets)
        del sets
        v2_split_witness(vq_state, rn_sd, gen)
        del vq_state
        torch.cuda.empty_cache()  # the rank processes share the card
        phase_ranks(tmp, card)
    phase_eval_times(vit_sd, rn_sd, card)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s in all")
    return step_launches


# ------------------------------------------------------------------ TP

TP = 2  # the model axis of phase 11's grids
TP_GRIDS = ((1, 2), (2, 2))  # (data, model)
TP_ATTN = (2 * TRAIN_BATCH, 128, 384, 6)  # a model rank's attention at (1, 2): 6 of 12 heads
TP_SEED = SEED + 40
TP_TIMEOUT = 400  # seconds, for each group of rank processes
TP_CLIP_BATCH = 4
TP_CLIP_TOL = 1e-5  # of the largest output, f32 with TF32 off
TP_CLI_BATCH = 32  # a data index
REMAT_TOL = 1e-5  # metrics, relative, f32 (the JAX package's remat test)
REMAT_STAGE2_BATCH = 32


def tp_step_inputs(cfg, device):
    """Phase 11 (a)'s seeded state (a full-width ``Stage1System``), its
    global batch and its generators, built alike in every process."""
    import torch

    from imagegenerator_tpu_torch.train.stage1 import Stage1System

    system = Stage1System(cfg, device=device, generator=torch.Generator(device=device).manual_seed(TP_SEED))
    batch = train_batch(cfg, torch.Generator(device=device).manual_seed(TP_SEED + 1))
    gens = (torch.Generator(device=device).manual_seed(TP_SEED + 2), torch.Generator().manual_seed(TP_SEED + 3))
    return system, batch, gens


def tp_text_grads(system, batch, grid=None):
    """The encoder's gradients of ``sum(tem * cot)`` over the doubled
    caption batch (dropout off), from the state before the step, flattened
    in parameter order (``text_grads`` of phase 6, on a grid: each data
    index encodes its share, the shares' gradients are summed over the
    data group and the slices gathered over the model group)."""
    import torch

    from imagegenerator_tpu_torch.parallel import dp, tp

    B = batch["input_ids"].shape[0]
    gen = torch.Generator(device="cuda").manual_seed(TP_SEED + 4)
    perm = torch.randperm(B, generator=gen, device="cuda")
    cot = torch.randn((2 * B, system.config.tem_size), generator=gen, device="cuda")
    ids, mask = (torch.cat([t, t[perm]]) for t in (batch["input_ids"], batch["attention_mask"]))
    data, d = (grid.data, grid.data_index) if grid is not None else (1, 0)
    share = slice(d * 2 * B // data, (d + 1) * 2 * B // data)
    tem = system.encode_text(ids[share], mask[share])
    names, params = zip(*system.encoder.named_parameters())
    grads = list(torch.autograd.grad((tem.float() * cot[share]).sum(), params))
    if grid is not None and grid.data_group is not None:
        dp.all_reduce_mean(grads, grid.data_group)
        grads = [g * data for g in grads]
    sliced = tp.sharded_keys(system.encoder)
    return torch.cat([tp.gather(g, *sliced.get(n, (None, None))).flatten().double() for n, g in zip(names, grads)])


def tp_readings(system, metrics) -> dict:
    """What (a) holds: the four metrics and the generator's BatchNorm
    statistics after the step; printed beside them, the first layer's
    query weight (whole)."""
    import torch

    from imagegenerator_tpu_torch.parallel import tp

    key = "encoder.encoder.layer.0.attention.self.query.weight"
    dim, shard = tp.sharded_keys(system).get(key, (None, None))
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "bn": torch.cat([b.detach().float().flatten() for b in system.generator.buffers()]).cpu(),
            "query": tp.gather(system.state_dict()[key], dim, shard).float().cpu()}


def tp_clip_inputs(device):
    import torch

    from imagegenerator_tpu_torch.v2.clip import CLIP, CLIPConfig

    cfg = CLIPConfig.vit_b32()
    model = CLIP(cfg, device="meta")
    model.load_state_dict({k: v.to(device) for k, v in seeded_clip_state(cfg, TP_SEED).items()}, assign=True)
    gen = torch.Generator(device=device).manual_seed(TP_SEED + 5)
    images = torch.randn((TP_CLIP_BATCH, cfg.image_resolution, cfg.image_resolution, 3), generator=gen,
                         device=device)
    tokens = torch.randint(1, cfg.vocab_size, (TP_CLIP_BATCH, cfg.context_length), generator=gen, device=device)
    return model.eval(), images, tokens


def tp_clip_outputs(model, images, tokens):
    import torch

    with torch.no_grad():
        out = model.encode_image(images), model.encode_text(tokens)
    torch.cuda.synchronize()
    return [t.float().cpu() for t in out]


def tp_worker(rank: int, world: int, port: int, nccl: bool, out: str) -> int:
    """One rank of phase 11 (``chip_smoke.py --tp-worker RANK``): the
    full-width stage-1 step on a ``(world / 2, 2)`` grid, its launches and
    readings, a second step timed; at world 2 on one card, CLIP ViT-B/32
    split over the two ranks."""
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from imagegenerator_tpu_torch.ops.kernels import attention, layernorm
    from imagegenerator_tpu_torch.parallel import mesh, tp

    device = torch.device("cuda", rank if nccl else 0)
    torch.cuda.set_device(device)
    card = os.environ["TP_CARD"]
    backend = "cpu:gloo,cuda:nccl" if nccl else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:
        set_tf32(False)
        grid = mesh.make_grid(TP)
        where = f"({grid.data}, {grid.model}) {'NCCL, a card each' if nccl else 'gloo, one card'}"
        log(f"  [rank {rank}] data index {grid.data_index}, model index {grid.model_index} of {where}, "
            f"on {device}")
        cfg = train_config(True, True, torch.bfloat16)
        system, batch, (gen, host) = tp_step_inputs(cfg, "cuda")
        system.shard(grid)
        grads = tp_text_grads(system, batch, grid).cpu()
        b = TRAIN_BATCH // grid.data
        mine = {k: v[grid.data_index * b:(grid.data_index + 1) * b] for k, v in batch.items()}
        shapes = []
        plain = attention.attention_fwd, attention.attention_bwd

        def record(fn):
            def wrapped(q, *args):
                shapes.append((fn.__name__, tuple(q.shape)))
                return fn(q, *args)
            return wrapped

        attention.attention_fwd, attention.attention_bwd = record(plain[0]), record(plain[1])
        reset_counts(attention, layernorm)
        try:
            t0 = time.perf_counter()
            metrics = system.train_step(mine, generator=gen, host_generator=host, reduce=mesh.data_mean(grid))
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
        finally:
            attention.attention_fwd, attention.attention_bwd = plain
        counts = read_counts(attention, layernorm)
        widths = sorted(set(shapes))
        want_shape = (2 * b, cfg.seq_len, cfg.bert.hidden_size // TP)
        log(f"  [rank {rank}] step 1: {first_ms:.1f} ms, launches {counts}, attention calls {widths}")
        if counts != WITH_BACKWARD or any(s != want_shape for _, s in widths):
            raise AssertionError(f"rank {rank}: launches {counts}, attention shapes {widths}; expected "
                                 f"{WITH_BACKWARD} at {want_shape}")
        readings = dict(tp_readings(system, metrics), grads=grads)
        step_ms = None
        if nccl:  # over gloo the reduces cross the host: a time of no use
            t0 = time.perf_counter()
            system.train_step(mine, generator=gen, host_generator=host, reduce=mesh.data_mean(grid))
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            log(f"  [rank {rank}] step 2: {step_ms:.1f} ms a rank, {TRAIN_BATCH / step_ms * 1e3:.1f} img/s over "
                f"the grid [{card}]")
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        tag = f"{grid.data}x{grid.model}{'_nccl' if nccl else ''}"
        if rank == 0:
            torch.save({**readings, "counts": counts, "step_ms": step_ms, "first_ms": first_ms, "peak_gib": peak},
                       os.path.join(out, f"tp_{tag}.pt"))
        del system
        if world == TP and not nccl:
            model, images, tokens = tp_clip_inputs("cuda")
            model.shard_model(tp.ModelShard(grid.model_index, grid.model, grid.model_group))
            got = tp_clip_outputs(model, images, tokens)
            if rank == 0:
                torch.save(got, os.path.join(out, "tp_clip.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def run_tp_workers(tmp: Path, world: int, nccl: bool, card: str) -> None:
    """The ranks of one grid, one process each; their log lines shown here."""
    import os

    logs = [tmp / f"tp{world}_rank{r}.log" for r in range(world)]
    port = free_port()
    env = dict(os.environ, TP_CARD=card, PYTHONPATH=str(ROOT))
    procs = []
    try:
        for r, path in enumerate(logs):
            with open(path, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-worker", str(r), "--tp-world", str(world),
                     "--tp-port", str(port), "--tp-out", str(tmp)] + (["--tp-nccl"] if nccl else []),
                    stdout=f, stderr=subprocess.STDOUT, cwd=ROOT, env=env))
        for p in procs:
            p.wait(timeout=TP_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for r, path in enumerate(logs):
            failed = procs[r].returncode != 0
            for line in path.read_text().splitlines():
                if f"[rank {r}]" in line or failed:
                    log(line if line.startswith("  ") else f"  [rank {r} output] {line}")
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"phase 11: rank(s) {bad} of world {world} failed")


def hold_tp_step(tag: str, got: dict, want: dict, cfg) -> None:
    """(a): the grid step's readings against the one-process step's, at
    ``STEP_TOL['bf16']``: metrics (gp by its own limit), the generator's
    BatchNorm statistics and the encoder's gradients under a fixed
    cotangent of tem (phase 6's well-conditioned witness of the backward,
    here through the model group's reduces); the query weight after the
    step printed, in learning rates (Adam's first update moves each
    element by lr x sign(g), which a gradient within rounding of 0 flips:
    the generator step's gradient is ill-conditioned through the KL
    term)."""
    limits = STEP_TOL["bf16"]
    grads = ((got["grads"] - want["grads"]).norm() / want["grads"].norm()).item()
    worst = [(grads / limits["grads"], f"encoder grads under a fixed tem cotangent, relative L2 {grads:.3e} "
                                        f"(limit {limits['grads']:g})")]
    for k, w in want["metrics"].items():
        rel = abs(got["metrics"][k] - w) / max(1.0, abs(w))
        limit = limits["gp" if k == "gp" else "metric"]
        worst.append((rel / limit, f"{k} {rel:.3e} (limit {limit:g})"))
    rel = (got["bn"] - want["bn"]).abs().max().item() / max(1.0, want["bn"].abs().max().item())
    worst.append((rel / limits["bn"], f"generator BN stats {rel:.3e} (limit {limits['bn']:g})"))
    q = (got["query"] - want["query"]).abs()
    log(f"  {tag} vs one process: " + ", ".join(w for _, w in worst)
        + f"; query weight max abs {q.max().item():.3e} = {q.max().item() / cfg.encoder_lr:.2f} encoder lr, "
          f"{(q > cfg.encoder_lr).float().mean().item() * 100:.3f}% of it more than one lr apart (printed)")
    bad = [w for r, w in worst if not r <= 1.0]
    if bad:
        raise AssertionError(f"{tag}: {bad}")


def phase_tp_kernels(attention, gen, card) -> dict:
    """(a) the attention pair on a model rank's head group: (256, 128,
    384), 6 of BERT-base's 12 heads, bf16, the tensor-core kernels with the
    shard's seed folded (head offset 6) against the plain version of the
    whole width's heads 6-11, rate 0.1 and 0; a planted fault each (the
    seed without the head offset; a backward that ignores the mask); then
    times beside the bound and SDPA."""
    import torch
    import torch.nn.functional as F

    from imagegenerator_tpu_torch.models.bert import _fold_seed

    B, T, H, nh = TP_ATTN
    log(f"phase 11 (a): attention on a head group, bf16 {TP_ATTN[:3]}, {nh} heads, against the whole width's "
        f"heads {nh}-{2 * nh - 1}")
    set_tf32(False)
    q, k, v, mask = attention_inputs(B, T, 2 * H, torch.bfloat16, gen)
    do = torch.randn((B, T, 2 * H), generator=gen, device="cuda").bfloat16()
    half = lambda t: t[..., H:].contiguous()
    qs, ks, vs, dos = map(half, (q, k, v, do))
    errs = {}

    def check(rate, fold=True, bwd_mask=True):
        seed = SEED + 11
        local = _fold_seed(seed, 0, nh) if fold else seed
        o, m, l = attention.attention_fwd(qs, ks, vs, mask, nh, rate, local)
        ro, rm, rl = attention.attention_reference(q, k, v, mask, 2 * nh, rate, seed)
        torch.cuda.synchronize()
        e_o = compare("head-group o", o, ro[..., H:], *TOL["attn_o_bf16"], quiet=True)
        compare("head-group m", m, rm[:, nh:], *TOL["attn_m_mma"], quiet=True)
        compare("head-group l", l, rl[:, nh:], *TOL["attn_ml"], quiet=True)
        got = attention.attention_bwd(qs, ks, vs, dos, mask if bwd_mask else None, rm[:, nh:].contiguous(),
                                      rl[:, nh:].contiguous(), nh, rate, local)
        want = attention.attention_bwd_reference(q, k, v, do, mask, rm, rl, 2 * nh, rate, seed)
        torch.cuda.synchronize()
        e_g = max(compare(f"head-group {n}", g, w[..., H:], *TOL["attn_grad_bf16"], quiet=True)
                  for n, g, w in zip(("dq", "dk", "dv"), got, want))
        log(f"  rate {rate}: max abs o {e_o:.3e}, dq/dk/dv {e_g:.3e} ok")
        return e_o, e_g

    before = (attention.mma_launches, attention.mma_bwd_launches)
    for rate in (0.1, 0.0):
        errs[rate] = check(rate)
    if (attention.mma_launches - before[0], attention.mma_bwd_launches - before[1]) != (2, 2):
        raise AssertionError("phase 11: the head-group attention left the tensor-core kernels")
    must_catch("a head group's forward whose seed misses the head offset", lambda: check(0.1, fold=False))
    must_catch("a head group's backward that ignores the key mask", lambda: check(0.1, bwd_mask=False))
    del q, k, v, do
    at = attention_times(attention, TP_ATTN, gen, card, fma=False)
    q, k, v, mask = attention_inputs(B, T, H, torch.bfloat16, gen)
    do = torch.randn((B, T, H), generator=gen, device="cuda").bfloat16()
    (qh, kh, vh), keep = sdpa_inputs(q, k, v, mask, nh)
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep), inner=5)
    leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
    o = F.scaled_dot_product_attention(*leaves, attn_mask=keep)
    doh = do.reshape(B, T, nh, -1).transpose(1, 2)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(o, leaves, doh, retain_graph=True), inner=5)
    log(f"  at rate 0, bf16 {TP_ATTN[:3]}, {nh} heads: attention_fwd {at['fwd', 0.0]['ms']:.4f} ms (device "
        f"{at['fwd', 0.0]['device_ms']:.4f}), F.scaled_dot_product_attention {sdpa_fwd:.4f} ms; attention_bwd "
        f"{at['bwd', 0.0]['ms']:.4f} ms (device {at['bwd', 0.0]['device_ms']:.4f}), its autograd backward "
        f"{sdpa_bwd:.4f} ms [{card}]")
    return {"fwd": {**kernel_entry(at["fwd", 0.1]), "device_ms": at["fwd", 0.1]["device_ms"],
                    "ms_rate0": at["fwd", 0.0]["ms"], "device_ms_rate0": at["fwd", 0.0]["device_ms"],
                    "library_ms": sdpa_fwd, "max_abs_err": errs[0.1][0]},
            "bwd": {**kernel_entry(at["bwd", 0.1]), "device_ms": at["bwd", 0.1]["device_ms"],
                    "ms_rate0": at["bwd", 0.0]["ms"], "device_ms_rate0": at["bwd", 0.0]["device_ms"],
                    "library_ms": sdpa_bwd, "max_abs_err": errs[0.1][1]}}


def phase_tp_steps(tmp: Path, card: str) -> dict:
    """(a) the full-width stage-1 step on the grids against one process,
    and (d) CLIP ViT-B/32 over two model ranks against one process."""
    import torch

    set_tf32(False)
    cfg = train_config(True, True, torch.bfloat16)
    log(f"phase 11 (a): the full-width stage-1 step on (data, model) grids, batch {TRAIN_BATCH}, bf16, "
        f"--fused_attn --fused_ln, text dropout on, against one process")
    system, batch, (gen, host) = tp_step_inputs(cfg, "cuda")
    grads = tp_text_grads(system, batch).cpu()
    want = dict(tp_readings(system, system.train_step(batch, generator=gen, host_generator=host)), grads=grads)
    # the second step timed, as a rank's is over NCCL
    one_ms = wall_ms(lambda: system.train_step(batch, generator=gen, host_generator=host), runs=1)
    log(f"  one process: step 2 {one_ms:.1f} ms, {TRAIN_BATCH / one_ms * 1e3:.1f} img/s [{card}]")
    del system, batch
    model, images, tokens = tp_clip_inputs("cuda")
    clip_want = tp_clip_outputs(model, images, tokens)
    del model
    torch.cuda.empty_cache()  # the rank processes share the card
    runs = [(d * m, False) for d, m in TP_GRIDS]
    runs += [(d * m, True) for d, m in TP_GRIDS if d * m <= torch.cuda.device_count()]
    counts = None
    for world, nccl in runs:
        t0 = time.perf_counter()
        run_tp_workers(tmp, world, nccl, card)
        tag = f"{world // TP}x{TP}{'_nccl' if nccl else ''}"
        got = torch.load(tmp / f"tp_{tag}.pt")
        hold_tp_step(f"({world // TP}, {TP}) {'NCCL' if nccl else 'gloo'}", got, want, cfg)
        timed = (f"step {got['step_ms']:.1f} ms a rank ({got['step_ms'] / one_ms:.2f}x one process), "
                 if got["step_ms"] is not None else "")
        log(f"  ({world // TP}, {TP}) over {'NCCL, a card each' if nccl else 'gloo on one card'}: {timed}first step "
            f"{got['first_ms']:.1f} ms, peak {got['peak_gib']:.2f} GiB a rank, {time.perf_counter() - t0:.1f} s "
            f"with the processes [{card}]")
        counts = counts or got["counts"]
    if len(runs) == len(TP_GRIDS):
        log(f"  one card here: the grids ran over gloo only (a card each needs {max(d * m for d, m in TP_GRIDS)})")
    clip_got = torch.load(tmp / "tp_clip.pt")
    err = max((g - w).abs().max().item() / w.abs().max().item() for g, w in zip(clip_got, clip_want))
    log(f"phase 11 (d): CLIP ViT-B/32 split over 2 model ranks vs one process, f32, batch {TP_CLIP_BATCH}: "
        f"{err:.3e} of the largest output (limit {TP_CLIP_TOL:g}) {'ok' if err <= TP_CLIP_TOL else 'FAIL'}")
    if not err <= TP_CLIP_TOL:
        raise AssertionError(f"phase 11 (d): CLIP under TP {err:.3e} from one process")
    return counts


TP_CLI_BERT = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=512,
                   max_position_embeddings=64)  # head dim 64
TP_CLI_SEQ = 32


def phase_tp_cli(tmp: Path, card: str) -> None:
    """(b) ``torchrun --nproc_per_node 2 -m imagegenerator_tpu_torch.train.cli
    --multihost --tp 2 --stage 1 --fused_attn --fused_ln`` with ``--tiny``
    GAN nets over a seeded 2-layer, 2-head encoder of head dim 64
    (``--bert_checkpoint``: each model rank runs one head through the
    kernels), the same command again (the resume), then the checkpoint in
    one process. (a) runs the full width; this run checks the CLI's grid,
    its per-data-index loader, the gathered save and the sliced resume."""
    import os

    import torch

    from imagegenerator_tpu_torch import convert
    from imagegenerator_tpu_torch.checkpoint import CheckpointManager
    from imagegenerator_tpu_torch.models.bert import BertConfig, BertEncoder
    from imagegenerator_tpu_torch.train.stage1 import Stage1Config

    own = torch.cuda.device_count() >= TP
    log(f"phase 11 (b): torchrun, 2 ranks, train.cli --multihost --tp 2 --stage 1 --fused_attn --fused_ln, tiny "
        f"GAN nets over a {TP_CLI_BERT['num_layers']}-layer encoder of width {TP_CLI_BERT['hidden_size']}, batch "
        f"{TP_CLI_BATCH}, {'a card each (NCCL)' if own else 'one card (gloo)'}")
    write_chain_dataset(tmp / "ds")
    bert_cfg = BertConfig(**TP_CLI_BERT)
    torch.save(BertEncoder(bert_cfg, device="cpu", generator=torch.Generator().manual_seed(TP_SEED)).state_dict(),
               tmp / "bert.pt")
    ckpt = tmp / "ckpt"
    argv = ["--multihost", "--tp", str(TP), "--stage", "1", "--tiny", "--bert_checkpoint", str(tmp / "bert.pt"),
            "--seq_len", str(TP_CLI_SEQ), "--data", str(tmp / "ds"), "--root", "imgs",
            "--ann_file", "ann/captions.json", "--batch_size", str(TP_CLI_BATCH), "--num_epochs", "1",
            "--checkpoint_dir", str(ckpt), "--fused_attn", "--fused_ln", "--seed", str(SEED)]
    argv += [] if own else ["--device", "cuda:0"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for run in (1, 2):
        logs = tmp / f"tp_torchrun{run}"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(TP),
               "--log_dir", str(logs), "--redirects", "3", "-m", "imagegenerator_tpu_torch.train.cli", *argv]
        t0 = time.perf_counter()
        done = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=TP_TIMEOUT)
        seconds = time.perf_counter() - t0
        outs = {int(p.parent.name): p.read_text() for p in logs.rglob("stdout.log")}
        if done.returncode or sorted(outs) != list(range(TP)):
            for line in (done.stdout + done.stderr).splitlines()[-30:]:
                log(f"    | {line}")
            for p in logs.rglob("stderr.log"):
                for line in p.read_text().splitlines()[-15:]:
                    log(f"    | {p.parent.name}: {line}")
            raise AssertionError(f"torchrun --tp run {run}: exit {done.returncode}, rank logs {sorted(outs)}")
        for r, out in sorted(outs.items()):
            lines = out.splitlines()
            for line in lines:
                if line.startswith(("[dp]", "[tp]", "step ", "Loaded")):
                    log(f"    | rank {r}: {line}")
            steps = len([l for l in lines if l.startswith("step ")])
            resumed = "Loaded checkpoint at epoch 0" in lines
            want_steps = CHAIN_IMAGES // TP_CLI_BATCH if (run == 1 and r == 0) else 0
            if steps != want_steps or resumed != (run == 2) or f"[tp] rank {r} of {TP}" not in out:
                raise AssertionError(f"torchrun --tp run {run}, rank {r}: {steps} step lines, resumed {resumed}")
        log(f"  run {run}: {seconds:.1f} s, both ranks {'resumed' if run == 2 else 'trained'} [{card}]")
    flat, start = CheckpointManager(str(ckpt / "Stage1")).restore_latest()
    one = convert.stage1_from_numpy(flat, Stage1Config.tiny(bert=bert_cfg, seq_len=TP_CLI_SEQ), "cuda")
    key = "params/encoder/layer_0/attention/query/kernel"
    width = TP_CLI_BERT["hidden_size"]
    if start != 1 or one.step != CHAIN_IMAGES // TP_CLI_BATCH or flat[key].shape != (width, width):
        raise AssertionError(f"the --tp 2 checkpoint: start {start}, step {one.step}, {key} {flat[key].shape}")
    log(f"  the checkpoint is the whole state ({key} {flat[key].shape}) and loads in one process at step "
        f"{one.step}")


def phase_tp_remat(gen, card) -> None:
    """(c) remat: the full-width stage-1 step (batch 128) and the stage-2
    step (batch 32), f32 with TF32 off and cuDNN deterministic, with remat
    against without from one state and one set of generators: the first
    step's metrics at ``REMAT_TOL`` and its peak memory, then two more
    steps of each timed in turns."""
    import dataclasses

    import torch

    from imagegenerator_tpu_torch.train.stage1 import Stage1System
    from imagegenerator_tpu_torch.train.stage2 import Stage2System

    log(f"phase 11 (c): remat against no remat, f32, TF32 off, cuDNN deterministic (metrics rtol {REMAT_TOL:g})")
    set_tf32(False)
    torch.backends.cudnn.deterministic = True
    try:
        cfg1 = train_config(True, True, None)
        cfg2 = train2_config(True, None)
        state1 = Stage1System(cfg1, device="cuda", generator=torch.Generator("cuda").manual_seed(TP_SEED)).state_dict()
        state2 = Stage2System(cfg2, device="cuda", generator=torch.Generator("cuda").manual_seed(TP_SEED)).state_dict()
        batch1 = train_batch(cfg1, torch.Generator("cuda").manual_seed(TP_SEED + 1))
        batch2 = train2_batch(cfg2, torch.Generator("cuda").manual_seed(TP_SEED + 1), REMAT_STAGE2_BATCH)
        for stage, cfg, state, batch, build in ((1, cfg1, state1, batch1, train_system),
                                                (2, cfg2, state2, batch2, train2_system)):
            systems = {remat: build(dataclasses.replace(cfg, remat=remat), state) for remat in (False, True)}
            gens = {remat: (torch.Generator("cuda").manual_seed(TP_SEED + 2), torch.Generator().manual_seed(TP_SEED + 3))
                    for remat in systems}

            def step(remat):
                gen, host = gens[remat]
                kw = dict(host_generator=host) if stage == 1 else {}
                return systems[remat].train_step(batch, generator=gen, **kw)

            runs, peaks = {}, {}
            for remat in (False, True):  # the first step of each: metrics and peak memory
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                runs[remat] = {k: v.item() for k, v in step(remat).items()}
                peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 2**30
                log(f"  stage {stage}, remat {remat}: first step's peak {peaks[remat]:.3f} GiB over the "
                    f"{base / 2**30:.3f} GiB held before it, metrics {runs[remat]} [{card}]")
            log(f"  stage {stage}: remat takes the peak from {peaks[False]:.3f} to {peaks[True]:.3f} GiB "
                f"({peaks[True] - peaks[False]:+.3f}) [{card}]")
            # stage 1's peak is BERT's activations, which remat recomputes a
            # layer at a time; stage 2's is G2's forward, no remat site
            # (tools/probe_torch_memory.py)
            if stage == 1 and not peaks[True] < peaks[False]:
                raise AssertionError(f"stage 1: remat did not lower the peak ({peaks[True]:.3f} GiB)")
            times = {False: [], True: []}
            for remat in (False, True, True, False):  # later steps, in turns
                times[remat].append(wall_ms(lambda: step(remat), runs=1))
            log(f"  stage {stage}: step {statistics.mean(times[False]):.1f} ms without remat (turns "
                f"{', '.join(f'{t:.1f}' for t in times[False])}), {statistics.mean(times[True]):.1f} ms with "
                f"(turns {', '.join(f'{t:.1f}' for t in times[True])}) [{card}]")
            del systems
            torch.cuda.empty_cache()
            rel = max(abs(runs[True][k] - w) / max(abs(w), 1e-30) for k, w in runs[False].items())
            log(f"  stage {stage}: remat vs none, first step's metrics max relative difference {rel:.3e} "
                f"(limit {REMAT_TOL:g}) {'ok' if rel <= REMAT_TOL else 'FAIL'}")
            if not rel <= REMAT_TOL:
                raise AssertionError(f"stage {stage}: remat changed the metrics by {rel:.3e}")
    finally:
        torch.backends.cudnn.deterministic = False


def phase_tp_dryrun(card) -> None:
    """(e) ``dryrun.dryrun_multichip(2)`` on the card."""
    from imagegenerator_tpu_torch import dryrun

    log("phase 11 (e): dryrun.dryrun_multichip(2) on the card")
    t0 = time.perf_counter()
    report = dryrun.dryrun_multichip(2)
    log(f"  {time.perf_counter() - t0:.1f} s: ranks on {report['device']} over {report['backend']}; CLIP TP "
        f"{report['clip_tp']['rel_err']:.3e} from the unsplit model; stage-2 DP {report['stage2_dp']['images_per_s_n']:.1f} "
        f"img/s over 2 ranks (tiny widths) [{card}]")


def phase_tp(attention, gen, card):
    """Phase 11: tensor parallelism, remat and the dry run."""
    with tempfile.TemporaryDirectory() as tmp:
        timed = phase_tp_kernels(attention, gen, card)
        counts = phase_tp_steps(Path(tmp), card)
        phase_tp_cli(Path(tmp), card)
    phase_tp_remat(gen, card)
    phase_tp_dryrun(card)
    return counts, timed


# ---------------------------------------------------------------- the bench

# the orchestrated bench over all ten targets, at full width, with short
# windows (the defaults: 5 or 3 windows of 8 steps, chains of 20, 768
# host images, 4 e2e batches)
BENCH_SHORT = {"BENCH_REPS": "1", "BENCH_STEPS": "2", "BENCH_CHAIN": "5", "BENCH_V2_CHAINS": "1",
               "BENCH_HOST_IMAGES": "128", "BENCH_E2E_BATCHES": "2"}
BENCH_TIMEOUT = 600  # seconds, for the whole orchestrated run
BENCH_NAMES = {
    "stage2": "stage2_256px_train_images_per_sec_per_chip",
    "stage1": "stage1_64px_train_images_per_sec_per_chip",
    "v2": "vqgan_clip_latent_opt_steps_per_sec",
    "stage1_golden": "stage1_64px_train_golden_images_per_sec_per_chip",
    "stage2_golden": "stage2_256px_train_golden_images_per_sec_per_chip",
    "stage1_fast": "stage1_64px_fastpath_images_per_sec_per_chip",
    "stage1_fast_reuse": "stage1_64px_fastpath_reuse_images_per_sec_per_chip",
    "v2_batched": "vqgan_clip_batched_steps_per_sec",
    "host": "host_pipeline_images_per_sec",
    "e2e": "stage2_e2e_from_loader_images_per_sec",
}
# each line's kernel launches per step under the bench's defaults (none
# named: 0): the stage-1 headline and fast variants run the fused
# attention with dropout on the tensor-core kernels, LayerNorm on the
# plain route (BENCH_LN=xla); golden and the stage-2 tem route launch no
# hand kernel; v2 one codebook argmin a step (warp kernel off)
ATTENTION_STEP = {"attention_fwd": 12, "attention_fwd_dropout": 12, "attention_fwd_mma": 12,
                  "attention_bwd": 12, "attention_bwd_mma": 12}
BENCH_LAUNCHES = {"stage1": ATTENTION_STEP, "stage1_fast": ATTENTION_STEP, "stage1_fast_reuse": ATTENTION_STEP,
                  "v2": {"vq_argmin": 1}, "v2_batched": {"vq_argmin": 1}}
BENCH_FLOPS_RTOL = 1e-3  # stage 1's count, kernel route against the plain route
BENCH_STEP_RTOL = 0.15  # the bench's stage-2 step against phase 8's


def stage2_step_ms(gen) -> float:
    """Phase 8's timing of the stage-2 tem route at batch 256 (uint8
    images, 2 warm-ups, median of 5), for ``--only bench``."""
    import torch

    from imagegenerator_tpu_torch.train.stage2 import Stage2System

    cfg = train2_config(True, torch.bfloat16)
    system = Stage2System(cfg, device="cuda", generator=gen)
    tokens = train2_batch(cfg, gen, TRAIN2_BATCH)
    tem = {"tem": system.embed_texts(tokens["input_ids"], tokens["attention_mask"]), "image": tokens["image"]}
    step_gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for _ in range(2):
        system.train_step(tem, generator=step_gen)
    return statistics.median(wall_ms(lambda: system.train_step(tem, generator=step_gen), runs=1) for _ in range(5))


def run_bench() -> tuple[list, float]:
    """The orchestrated bench as a process: its JSON lines and wall s."""
    import os

    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_SHORT)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "imagegenerator_tpu_torch.bench"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if "[bench hb" in line and ("launch" in line or "retry" in line or "timeout" in line):
            log(f"    {line.strip()}")
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        raise AssertionError(f"the bench exited {proc.returncode}")
    return [json.loads(line) for line in proc.stdout.splitlines() if line.strip()], wall


def check_bench_lines(lines, peak_tflops) -> dict:
    """One metric line per target, no error or skip line, the roofline,
    each mfu and each line's launches per step; the lines by target."""
    bad = [r for r in lines if "error" in r]
    if bad:
        raise AssertionError(f"error or skip lines: {bad}")
    if lines[-1].get("metric") != BENCH_NAMES["stage2"] or not lines[-1].get("reemitted_headline"):
        raise AssertionError(f"the last line is not the re-emitted stage-2 line: {lines[-1]}")
    roof = [r for r in lines if r["metric"] == "session_gemm_roofline_tflops"]
    if len(roof) != 1 or not 0 < roof[0]["value"] <= 1.05 * peak_tflops:
        raise AssertionError(f"roofline line(s) {roof}, card peak {peak_tflops} TFLOP/s")
    by_target = {}
    for target, name in BENCH_NAMES.items():
        found = [r for r in lines[:-1] if r["metric"] == name]
        if len(found) != 1:
            raise AssertionError(f"{target}: {len(found)} lines named {name}")
        r = by_target[target] = found[0]
        if r["backend"] != "torch" or "vs_baseline" in r or not r["value"] > 0:
            raise AssertionError(f"{target}: {r}")
        if target not in ("host", "e2e") and not 0 < r.get("mfu", 0) < 1.05:
            raise AssertionError(f"{target}: mfu {r.get('mfu')} outside (0, 1.05)")
        if target != "host":
            want = {k: BENCH_LAUNCHES.get(target, {}).get(k, 0) for k in r["kernel_launches_per_step"]}
            if r["kernel_launches_per_step"] != want:
                raise AssertionError(f"{target}: launches per step {r['kernel_launches_per_step']}, "
                                     f"expected {want}")
    log(f"  roofline {roof[0]['value']:.2f} TFLOP/s ({roof[0].get('pct_of_paper_peak')}% of {peak_tflops})")
    return by_target


def phase_bench(gen, card, train2_ms=None) -> None:
    """Phase 12: ``python -m imagegenerator_tpu_torch.bench`` over all ten
    targets with short windows; the stage-1 FLOP count on the kernel route
    against the plain route; the bench's stage-2 step against phase 8's;
    ``profile_opclass --workload stage1``."""
    import dataclasses

    import torch

    from imagegenerator_tpu_torch import bench

    log(f"phase 12: the bench, all ten targets, windows {BENCH_SHORT}, on {card}")
    torch.cuda.empty_cache()  # the bench's children share the card
    t_phase = time.perf_counter()
    lines, wall = run_bench()
    by_target = check_bench_lines(lines, bench._peak_flops() / 1e12)
    for target, r in by_target.items():
        log(f"  {target}: {r['value']:.3f} {r['unit']}, per step {r['spread_per_step_ms']} ms"
            + (f", mfu {r['mfu']}" if "mfu" in r else "")
            + f" [{r['device']}, {r['power_limit_w']} W]")
    log(f"  {len(by_target)} metric lines and the roofline, no error or skip line, the stage-2 line last; "
        f"launches per step as expected; bench wall {wall:.1f} s")

    # the same stage-1 step counted on the plain route: the kernel wrappers'
    # formulas must stand in exactly for the products FlopCounterMode sees
    cfg = bench._stage1_config()
    plain = dataclasses.replace(cfg, bert=dataclasses.replace(cfg.bert, fused_attention=False, fused_ln=False))
    _, _, step = bench._stage1_setup(TRAIN_BATCH, config=plain)
    step()
    plain_flops = bench._count_flops(step)
    del step
    torch.cuda.empty_cache()
    kernel_flops = by_target["stage1"]["flops_per_step"]
    rel = abs(kernel_flops - plain_flops) / plain_flops
    log(f"  stage1 flops_per_step: kernel route {kernel_flops:.6g} (the bench's line), plain route "
        f"{plain_flops:.6g}, relative difference {rel:.3e} (limit {BENCH_FLOPS_RTOL:g})")
    if rel > BENCH_FLOPS_RTOL:
        raise AssertionError("the stage-1 FLOP count differs between the kernel and the plain route")

    bench_ms = 1e3 * 256 / by_target["stage2"]["value"]
    if train2_ms is None:
        train2_ms = stage2_step_ms(gen)
        torch.cuda.empty_cache()
        how = "timed here as phase 8 times it"
    else:
        how = "phase 8's median in this run"
    rel = bench_ms / train2_ms - 1
    log(f"  stage-2 step: the bench {bench_ms:.3f} ms (f32 images), {how} {train2_ms:.3f} ms (uint8 "
        f"images): {100 * rel:+.1f}% (limit +-{100 * BENCH_STEP_RTOL:.0f}%) [{card}]")
    if abs(rel) > BENCH_STEP_RTOL:
        raise AssertionError("the bench's stage-2 step is not the step phase 8 times")

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "imagegenerator_tpu_torch.tools.profile_opclass",
                           "--workload", "stage1"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        raise AssertionError(f"profile_opclass exited {proc.returncode}")
    out = proc.stdout.strip().splitlines()
    for line in out[:-1]:
        if line.strip() and not line.startswith("traced"):
            log(f"    {line[:150]}")
    report = json.loads(out[-1])
    classes = {c["class"]: c for c in report["classes"]}
    share = sum(c["pct"] for c in report["classes"])
    log(f"  profile_opclass --workload stage1: {report['ms_per_step']:.3f} ms of device time a step, hand "
        f"kernels {classes['hand kernels']['ms_per_step']:.3f} ms; shares sum to {share:.3f}% "
        f"({time.perf_counter() - t0:.1f} s) [{card}]")
    if not classes["hand kernels"]["ms"] > 0 or abs(share - 100) > 0.5:
        raise AssertionError("profile_opclass: no hand-kernel time, or the shares do not sum to 100%")
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------- the weights day

WD_ITERS = 4  # v2 iterations of the playbook's generation
# card (f32, TF32 off) vs CPU for the playbook's goldens: VQGAN z_q and the
# decoded image by relative L2 at phase 7's f32 limit; CLIP's embeddings
# and BERT's CLS by max abs over max(1, the CPU's max abs) at phase 4's f32
# limit
WD_TOL = {"vqgan": V2_STEP_TOL["f32"], "embeds": HIDDEN_TOL["f32"]}


def write_bert(path: Path) -> None:
    """A seeded BERT-base under HF's names (``bert.`` prefix, as a
    ``pytorch_model.bin`` holds them)."""
    import torch

    from imagegenerator_tpu_torch.models.bert import BertConfig, BertEncoder

    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    state = BertEncoder(BertConfig(), device="cuda", generator=gen).state_dict()
    torch.save({f"bert.{k}": v.cpu() for k, v in state.items()}, path)


def write_bpe(path: Path) -> None:
    """A merges file in the published format and length (49152 merges:
    CLIP's 49408 ids), of made-up pairs."""
    import gzip

    merges = ["#version: 0.2", "a </w>", "c a", "ca t</w>"]
    merges += [f"q{'x' * (i % 3)} z{i}" for i in range(49152 - 256 - 2 - 3)]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(merges))


def hold(what: str, err: float, limit: float) -> None:
    log(f"  {what}: {err:.3e} (limit {limit:g}) {'ok' if err <= limit else 'FAIL'}")
    if not err <= limit:
        raise AssertionError(f"{what}: {err:.3e} over {limit:g}")


def phase_weights_day(vq_argmin, attention, layernorm, card) -> None:
    """Phase 13: the weights-day playbook
    (``imagegenerator_tpu_torch/tools/validate_real_weights.py``) on the
    card over phase 7's seeded full-width VQGAN and CLIP ViT-B/32, a
    seeded BERT-base under HF names and a merges file of the published
    length: every section, the generation through the v2 CLI; then its
    VQGAN, CLIP and BERT sections again on the CPU, whose goldens the
    card's must equal (indices) or match (``WD_TOL``); then BERT's CLS with
    the attention and LayerNorm kernels on against off. Prints the
    generation's ``vq_argmin`` launches and the phase's seconds."""
    import dataclasses
    import io

    import numpy as np
    import torch

    from imagegenerator_tpu_torch.models.bert import BertEncoder, load_bert_checkpoint
    from imagegenerator_tpu_torch.tools import validate_real_weights as tool
    from imagegenerator_tpu_torch.v2.engine import frozen

    t0 = time.perf_counter()
    log(f"phase 13: the weights-day playbook on the card, full width, f32 (TF32 off), {WD_ITERS} v2 iterations")
    set_tf32(False)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_v2_files(tmp)
        write_bert(tmp / "pytorch_model.bin")
        write_bpe(tmp / "bpe.txt.gz")
        argv = ["--vqgan_config", str(tmp / "vqgan.yaml"), "--vqgan_checkpoint", str(tmp / "vqgan.ckpt"),
                "--clip_checkpoint", str(tmp / "ViT-B-32.pt"), "--bert_checkpoint", str(tmp / "pytorch_model.bin"),
                "--bpe_vocab", str(tmp / "bpe.txt.gz"), "--iterations", str(WD_ITERS)]
        torch.cuda.empty_cache()
        vq_argmin.launches = 0
        reset_counts(attention, layernorm)
        t_tool = time.perf_counter()
        run_cli(tool.main, argv + ["--out", str(tmp / "card")])
        torch.cuda.synchronize()
        t_tool = time.perf_counter() - t_tool
        launches = {"vq_argmin": vq_argmin.launches, **read_counts(attention, layernorm)}
        # the VQGAN section's encode, then per iteration one, and at each
        # of the two checkins (iterations 0 and WD_ITERS) a synth and a
        # loss evaluation; the tool's BERT config takes no kernel
        want = {"vq_argmin": 1 + WD_ITERS + 2 * 2, **{k: 0 for k in read_counts(attention, layernorm)}}
        if launches != want:
            raise AssertionError(f"phase 13: kernel launches {launches}, expected {want}")
        manifest = json.loads((tmp / "card" / "MANIFEST.json").read_text())
        if manifest != {"validated": ["vqgan", "clip", "bert", "generation", "eval"]}:
            raise AssertionError(f"phase 13: manifest {manifest}")
        if png_size(tmp / "card" / "weights_day_sample.png") != (V2_IMAGE, V2_IMAGE):
            raise AssertionError("phase 13: the sample is not 128 x 128")
        log(f"  the tool on the card: {t_tool:.1f} s, every section; vq_argmin launches {launches['vq_argmin']} "
            f"(the generation {launches['vq_argmin'] - 1}), no BERT kernel [{card}]")

        cpu = torch.device("cpu")
        t_cpu = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            tool.validate_vqgan(argv[1], argv[3], str(tmp / "cpu"), cpu)
            tool.validate_clip(argv[5], argv[9], str(tmp / "cpu"), cpu)
            tool.validate_bert(argv[7], str(tmp / "cpu"), cpu)
        log(f"  the VQGAN, CLIP and BERT sections on the CPU: {time.perf_counter() - t_cpu:.1f} s")
        golden = {side: {name: dict(np.load(tmp / side / f"{name}.npz"))
                         for name in ("vqgan_roundtrip", "clip_embeds", "bert_cls")} for side in ("card", "cpu")}
        card_vq, cpu_vq = golden["card"]["vqgan_roundtrip"], golden["cpu"]["vqgan_roundtrip"]
        moved = int((card_vq["indices"] != cpu_vq["indices"]).sum())
        log(f"  VQGAN indices, card vs CPU: {moved} of {cpu_vq['indices'].size} differ "
            f"({len(np.unique(cpu_vq['indices']))} codes used) {'ok' if moved == 0 else 'FAIL'}")
        if moved:
            raise AssertionError(f"phase 13: {moved} VQGAN indices differ between the card and the CPU")
        for k in ("z_q", "decoded"):
            hold(f"VQGAN {k}, card vs CPU, relative L2",
                 rel_l2(torch.from_numpy(card_vq[k]), torch.from_numpy(cpu_vq[k])), WD_TOL["vqgan"])
        for name, keys in (("clip_embeds", ("text_embeds", "image_embeds")), ("bert_cls", ("cls",))):
            for k in keys:
                a, b = golden["card"][name][k], golden["cpu"][name][k]
                hold(f"{name} {k}, card vs CPU, max abs / max(1, max |CPU|)",
                     float(np.abs(a - b).max() / max(1.0, np.abs(b).max())), WD_TOL["embeds"])

        state, cfg = load_bert_checkpoint(argv[7])
        ids = torch.from_numpy(golden["cpu"]["bert_cls"]["input_ids"]).cuda()
        mask = torch.ones(ids.shape, dtype=torch.int32, device="cuda")
        cls = {}
        for fused in (False, True):
            enc = frozen(BertEncoder, dataclasses.replace(cfg, fused_attention=fused, fused_ln=fused), state,
                         device="cuda")
            reset_counts(attention, layernorm)
            with torch.no_grad():
                cls[fused] = enc(ids, mask)[:, 0, :].float()
            torch.cuda.synchronize()
            counts = read_counts(attention, layernorm)
        want = {"attention": 12, "attention_mma": 0, "attention_dropout": 0, "attention_bwd": 0,
                "attention_bwd_mma": 0, "layernorm": 25, "layernorm_bwd": 0}
        if counts != want:  # f32 at T = 16: the FMA attention kernel
            raise AssertionError(f"phase 13: BERT kernel launches {counts}, expected {want}")
        hold("BERT CLS, fused attention and LayerNorm kernels vs plain, max abs",
             (cls[True] - cls[False]).abs().max().item(), HIDDEN_TOL["f32"])
    log(f"phase 13: {time.perf_counter() - t0:.1f} s [{card}]")


# ------------------------------------------ attention over every shape

# the covering grid: bf16 and f32, head dims from BertConfig.tiny's 8 to
# past the tensor cores' 256, lengths from 1 to twice BERT's positions
SHAPES_DIMS = (8, 16, 40, 64, 128, 256, 320)
SHAPES_LENGTHS = (1, 77, 128, 136, 256, 512, 1024)
SHAPES_MASKS = (None, "ragged", "fully_masked_row")
SHAPES_B, SHAPES_HEADS = 3, 2
# the timed shapes (B, T, H, heads), bf16: the stage-1 attention at
# seq_len 256 and 512, at 128 (the whole-head kernels) and at 128 with
# head dims 32 and 128
SHAPES_TIMED = {"t256": (256, 256, 768, 12), "t512": (256, 512, 768, 12), "t128": TRAIN_ATTN,
                "d32": (256, 128, 768, 24), "d128": (256, 128, 768, 6), "d48": (256, 128, 768, 16)}
# the step configurations of phase 14 (c) at seq_len 128 beside the
# default 12 heads: heads -> head dim (32 and 128 on the Hopper kernels, 48
# on the mma.sync tiled ones)
SHAPES_STEP_HEADS = {24: "d32", 6: "d128", 16: "d48"}
# the planted fault of the Hopper route: the keep-mask hash read at the
# query one row on. The hash is h(r * 0x9E3779B9 + c * 0x85EBCA6B + salt *
# 0xC2B2AE35), so a seed this much higher gives every (r, c) the bits of
# (r + 1, c).
ROW_SHIFT_SEED = (0x9E3779B9 * pow(0xC2B2AE35, -1, 2**32)) % 2**32
# the full-width stage-1 step at these lengths, batch 128 with remat (the
# text forward's activations at T = 512 do not fit the card without it);
# kernels on vs off at batch 32, where phase 6's check (its text forward
# without remat) fits
SHAPES_STEP_LENGTHS = (256, 512)
SHAPES_CHECK_BATCH = 32
# the whole-head kernels' device times at (256, 128, 768) bf16, rate 0.1,
# in PERF.md's kernel table (an H100 at 700 W): forward, backward
WHOLE_HEAD_MS = {"fwd": 0.1485, "bwd": 0.3229}


def shapes_mask(kind, B, T):
    """None, ragged rows (row 0 full, each row keeps at least one key), or
    the same with the last row fully masked."""
    import torch

    if kind is None:
        return None
    mask = torch.ones((B, T), dtype=torch.int32, device="cuda")
    for b in range(1, B):
        mask[b, max(1, T - (b * T) // (B + 1)):] = 0
    if kind == "fully_masked_row":
        mask[-1] = 0
    return mask


def keep_bits_read_back(attention, B, nh, T, d, dtype, rate, seed):
    """The keep-mask bits as the kernels drew them: with q = k = 0 every p
    is 1; v's key j < d a one-hot in head dim j makes o[i, j] the kept p of
    (query i, key j) over l, and dO's query i < d a one-hot makes dv[j, i]
    that of (query i, key j). Returns the forward's bits for keys < min(T,
    d) and the backward's for queries < min(T, d), [row, head, query,
    key]."""
    import torch

    n = min(T, d)
    zeros = torch.zeros((B, T, nh * d), dtype=dtype, device="cuda")
    eye = torch.zeros((B, T, nh, d), dtype=dtype, device="cuda")
    eye[:, torch.arange(n), :, torch.arange(n)] = 1
    eye = eye.reshape(B, T, nh * d)
    o, m, l = attention.attention_fwd(zeros, zeros, eye, None, nh, rate, seed)
    _, _, dv = attention.attention_bwd(zeros, zeros, eye, eye, None, m, l, nh, rate, seed)
    fwd = o.reshape(B, T, nh, d)[..., :n].permute(0, 2, 1, 3) > 0
    bwd = dv.reshape(B, T, nh, d)[..., :n].permute(0, 2, 3, 1) > 0
    return fwd, bwd


def check_shape_case(attention, dtype, tag, q, k, v, do, mask, nh, rate, seed, where) -> tuple:
    """One case of the grid through the wrappers against the plain
    versions at the phase-2 limits (m at atol 1e-5 on either route: the
    FMA kernels' sums over d run in 64-wide pieces, in another order than
    the plain version's GEMM). Returns the max abs errors of o and of the
    gradients."""
    import torch

    o, m, l = attention.attention_fwd(q, k, v, mask, nh, rate, seed)
    grads = attention.attention_bwd(q, k, v, do, mask, m, l, nh, rate, seed)
    torch.cuda.synchronize()
    ro, rm, rl = attention.attention_reference(q, k, v, mask, nh, rate, seed)
    err_o = compare(f"{where} o", o, ro, *TOL[f"attn_o_{tag}"], quiet=True)
    compare(f"{where} m", m, rm, *TOL["attn_m_mma"], quiet=True)
    compare(f"{where} l", l, rl, *TOL["attn_ml"], quiet=True)
    want = attention.attention_bwd_reference(q, k, v, do, mask, m, l, nh, rate, seed)
    err_g = max(compare(f"{where} {name}", g, w, *TOL[f"attn_grad_{tag}"], quiet=True)
                for name, g, w in zip(("dq", "dk", "dv"), grads, want))
    return err_o, err_g


def phase_shapes_grid(attention, layernorm, gen):
    """Phase 14 (a): the attention pair over the covering grid, each case
    on the route ``kernel_route`` names (its counter read), against the
    plain versions; the keep bits read back; one planted fault."""
    import torch

    log(f"phase 14 (a): attention over the grid: f32 and bf16 x head dims {SHAPES_DIMS} x T "
        f"{SHAPES_LENGTHS} x masks (none, ragged, fully masked row) x rates 0, 0.1; B {SHAPES_B}, "
        f"{SHAPES_HEADS} heads")
    set_tf32(False)
    t0 = time.perf_counter()
    cases = 0
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for d in SHAPES_DIMS:
            routes = {}
            worst = [0.0, 0.0]
            for T in SHAPES_LENGTHS:
                B, nh = SHAPES_B, SHAPES_HEADS
                route = attention.kernel_route(dtype, d, T)
                routes.setdefault(route, []).append(T)
                want = {"attention_mma": int(route != "fma"), "attention_bwd_mma": int(route != "fma"),
                        "attention_wgmma": int(route == "wgmma"), "attention_bwd_wgmma": int(route == "wgmma")}
                q, k, v, do = (torch.randn((B, T, nh * d), generator=gen, device="cuda").to(dtype)
                               for _ in range(4))
                for kind in SHAPES_MASKS:
                    mask = shapes_mask(kind, B, T)
                    for rate in (0.0, 0.1):
                        reset_counts(attention, layernorm)
                        errs = check_shape_case(attention, dtype, tag, q, k, v, do, mask, nh, rate, SEED + 14,
                                                f"attention {tag} d {d} T {T} mask {kind} rate {rate}")
                        counts = {**read_counts(attention, layernorm), **read_wgmma(attention)}
                        if (counts["attention"], counts["attention_bwd"]) != (1, 1) or \
                                any(counts[key] != n for key, n in want.items()):
                            raise AssertionError(f"attention {tag} d {d} T {T}: launches {counts}, "
                                                 f"route {route}")
                        worst = [max(a, b) for a, b in zip(worst, errs)]
                        cases += 1
                reset_counts(attention, layernorm)
                fwd, bwd = keep_bits_read_back(attention, B, nh, T, d, dtype, 0.1, SEED + 15)
                if (attention.wgmma_launches, attention.wgmma_bwd_launches) != (want["attention_wgmma"],) * 2:
                    raise AssertionError(f"attention {tag} d {d} T {T}: the keep bits were read back off "
                                         f"the {route} route")
                keep = attention.keep_mask(B, nh, T, SEED + 15, 0.1, "cuda")
                n = min(T, d)
                if not (torch.equal(fwd, keep[..., :n]) and torch.equal(bwd, keep[..., :n, :])):
                    raise AssertionError(f"attention {tag} d {d} T {T}: the kernels' keep bits differ "
                                         f"from the plain version's")
                if route == "wgmma":  # no atomics: the backward twice, the same bits
                    mask = shapes_mask("ragged", B, T)
                    _, m, l = attention.attention_fwd(q, k, v, mask, nh, 0.1, SEED + 16)
                    first = attention.attention_bwd(q, k, v, do, mask, m, l, nh, 0.1, SEED + 16)
                    again = attention.attention_bwd(q, k, v, do, mask, m, l, nh, 0.1, SEED + 16)
                    if not all(torch.equal(a, b) for a, b in zip(first, again)):
                        raise AssertionError(f"attention {tag} d {d} T {T}: two backward runs differ")
            where = "; ".join(f"{r} at T {ts}" for r, ts in routes.items())
            log(f"  {tag} d {d}: {where}: max abs o {worst[0]:.3e}, dq/dk/dv {worst[1]:.3e}; keep bits "
                f"equal forward and backward{', two backward runs bit-equal' if 'wgmma' in routes else ''} ok")
    log(f"  {cases} cases, each on its route, {time.perf_counter() - t0:.1f} s")

    # planted: the scale left at 1 / sqrt(64) = 1/8 whatever the head dim;
    # the keep-mask hash read at the query one row on (both on the Hopper
    # route at this shape)
    B, T, d, nh = SHAPES_B, 136, 32, SHAPES_HEADS
    assert attention.kernel_route(torch.bfloat16, d, T) == "wgmma"
    q, k, v, do = (torch.randn((B, T, nh * d), generator=gen, device="cuda").bfloat16() for _ in range(4))
    mask = shapes_mask("ragged", B, T)
    right = attention._scale
    attention._scale = lambda hidden, heads: 0.125
    try:
        must_catch("kernels whose scale stays 1/8 at head dim 32",
                   lambda: check_shape_case(attention, torch.bfloat16, "bf16", q, k, v, do, mask, nh, 0.1,
                                            SEED + 14, f"attention bf16 d {d} T {T}, scale 1/8"))
    finally:
        attention._scale = right
    right = attention._dropout_args
    attention._dropout_args = lambda rate, seed: right(rate, seed + ROW_SHIFT_SEED)
    try:
        must_catch("Hopper kernels whose keep-mask hash reads the query one row on",
                   lambda: check_shape_case(attention, torch.bfloat16, "bf16", q, k, v, do, mask, nh, 0.1,
                                            SEED + 14, f"attention bf16 d {d} T {T}, hash row + 1"))
    finally:
        attention._dropout_args = right


def shapes_times(attention, name, shape, gen, card) -> dict:
    """Phase 14 (b): the pair at ``shape`` (bf16, the phase-2 mask): the
    wrappers by CUDA events back to back in turns with the plain versions
    (kernel, plain, kernel) and by profiler device time, at rate 0.1 and
    0; where the wrappers take the Hopper kernels, the mma.sync tiled
    kernels at the same shape through the C entry points' route argument
    (device time, after the Hopper kernels' second turn); SDPA and its
    autograd backward at rate 0 (used nowhere in the port); the bound; the
    max abs error against the plain version."""
    import torch
    import torch.nn.functional as F

    B, T, H, nh = shape
    q, k, v, mask = attention_inputs(B, T, H, torch.bfloat16, gen)
    do = torch.randn((B, T, H), generator=gen, device="cuda").bfloat16()
    route = attention.kernel_route(torch.bfloat16, H // nh, T)
    out = {}
    for rate in (0.1, 0.0):
        _, m, l = attention.attention_fwd(q, k, v, mask, nh, rate, SEED)
        drop = attention._dropout_args(rate, SEED)
        fns = {"fwd": (lambda: attention.attention_fwd(q, k, v, mask, nh, rate, SEED),
                       lambda: attention.attention_reference(q, k, v, mask, nh, rate, SEED),
                       lambda: attention._launch_fwd(q, k, v, mask, nh, drop, "mma")),
               "bwd": (lambda: attention.attention_bwd(q, k, v, do, mask, m, l, nh, rate, SEED),
                       lambda: attention.attention_bwd_reference(q, k, v, do, mask, m, l, nh, rate, SEED),
                       lambda: attention._launch_bwd(q, k, v, do, mask, m, l, nh, drop, "mma"))}
        for which, (kernel, plain, tiled) in fns.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            del got, want
            turns = [cuda_ms(kernel, warmup=1, runs=3, inner=5)]
            plain_ms = cuda_ms(plain, warmup=1, runs=1, inner=2)
            turns.append(cuda_ms(kernel, warmup=1, runs=3, inner=5))
            t = {"ms": statistics.mean(turns), "device_ms": device_ms(kernel, calls=5), "plain_ms": plain_ms,
                 "max_abs_err": err, **attention_bound(shape, 2, which == "bwd")}
            if route == "wgmma":
                t["tiled_device_ms"] = device_ms(tiled, calls=5)
            out[which, rate] = t
            log(f"  attention {which} bf16 {shape[:3]} {nh} heads (d {H // nh}) rate {rate}, {route} route: "
                f"kernel {t['ms']:.4f} ms back to back (turns {turns[0]:.4f}, {turns[1]:.4f}), device "
                f"{t['device_ms']:.4f} ms; plain {plain_ms:.4f} ms; bound {t['bound_ms']:.5f} ms by "
                f"{t['bound_by']}, device / bound {t['device_ms'] / t['bound_ms']:.2f}; max abs err "
                f"{err:.3e}" + (f"; the mma.sync tiled kernels at this shape: device {t['tiled_device_ms']:.4f} ms"
                                if "tiled_device_ms" in t else "") + f" [{card}]")
    (qh, kh, vh), keep = sdpa_inputs(q, k, v, mask, nh)
    sdpa = {"fwd": cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep), inner=5)}
    leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
    o = F.scaled_dot_product_attention(*leaves, attn_mask=keep)
    doh = do.reshape(B, T, nh, -1).transpose(1, 2)
    sdpa["bwd"] = cuda_ms(lambda: torch.autograd.grad(o, leaves, doh, retain_graph=True), inner=5)
    rows = {}
    for which in ("fwd", "bwd"):
        t, t0 = out[which, 0.1], out[which, 0.0]
        rows[which] = {"shape": list(shape[:3]), "heads": nh, "rate": 0.1, **kernel_entry(t),
                       "device_ms": t["device_ms"], "max_abs_err": t["max_abs_err"], "ms_rate0": t0["ms"],
                       "device_ms_rate0": t0["device_ms"], "plain_ms_rate0": t0["plain_ms"],
                       "library_ms": sdpa[which]}
        if route == "wgmma":
            rows[which].update(mma_tiled_device_ms=t["tiled_device_ms"],
                               mma_tiled_device_ms_rate0=t0["tiled_device_ms"])
        log(f"  {name} {which} at rate 0: kernel {t0['ms']:.4f} ms (device {t0['device_ms']:.4f}), "
            f"{'F.scaled_dot_product_attention' if which == 'fwd' else 'its autograd backward'} "
            f"{sdpa[which]:.4f} ms [{card}]")
    return rows


def shapes_step_config(T, heads, fused, text_dropout=True, remat=False):
    import dataclasses

    import torch

    cfg = train_config(fused, text_dropout, torch.bfloat16)
    return dataclasses.replace(cfg, seq_len=T, remat=remat,
                               bert=dataclasses.replace(cfg.bert, num_heads=heads))


def shapes_step_launches(attention, layernorm, cfg, gen, batch) -> tuple:
    """One stage-1 step of ``cfg`` from a seeded init: its launch counts,
    which must be 12 + 12 attention on the tensor-core kernels and 25 + 25
    LayerNorm, with finite metrics, and of those attention launches 12 +
    12 on the Hopper kernels where ``kernel_route`` names them for the
    step's shape, else none."""
    import torch

    from imagegenerator_tpu_torch.train.stage1 import Stage1System

    system = Stage1System(cfg, device="cuda", generator=gen)
    data = train_batch(cfg, gen, batch)
    reset_counts(attention, layernorm)
    metrics = system.train_step(data, generator=gen, host_generator=torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    counts = read_counts(attention, layernorm)
    if counts != WITH_BACKWARD:
        raise AssertionError(f"stage-1 step T {cfg.seq_len}, {cfg.bert.num_heads} heads: launches {counts}, "
                             f"expected {WITH_BACKWARD}")
    hopper = attention.kernel_route(torch.bfloat16, cfg.bert.hidden_size // cfg.bert.num_heads,
                                    cfg.seq_len) == "wgmma"
    wgmma = read_wgmma(attention)
    if wgmma != {"attention_wgmma": 12 * hopper, "attention_bwd_wgmma": 12 * hopper}:
        raise AssertionError(f"stage-1 step T {cfg.seq_len}, {cfg.bert.num_heads} heads: Hopper launches "
                             f"{wgmma}, expected {12 * hopper} each")
    if not all(map(torch.isfinite, metrics.values())):
        raise AssertionError(f"stage-1 step T {cfg.seq_len}: metrics not finite")
    return system, data, {**counts, **wgmma}


def phase_shapes_steps(attention, layernorm, gen, card) -> dict:
    """Phase 14 (c): the full-width stage-1 step at seq_len 256 and 512
    (bf16, ``--fused_attn`` with 16-bit dropout masks and ``--fused_ln``,
    text dropout on): one step at batch 32 without remat for its launches;
    then at batch 128 with remat (else the largest batch of 64, 32 that
    fits, with a log line) the step with the kernels and with the plain
    attention and LayerNorm, in turns; at 512 phase 6's kernels-on-vs-off
    check at batch 32. Then one step each with 24 heads of 32 and 6 heads
    of 128 (the Hopper kernels) and 16 heads of 48 (the mma.sync tiled
    kernels) at seq_len 128 (batch 32), for their launches. Returns each
    run's launch counts, the Hopper kernels' among them."""
    import torch

    launches = {}
    for T in SHAPES_STEP_LENGTHS:
        log(f"phase 14 (c): the full-width stage-1 step at seq_len {T}, bf16")
        torch.cuda.empty_cache()
        system, _, counts = shapes_step_launches(attention, layernorm, shapes_step_config(T, 12, True), gen,
                                                 SHAPES_CHECK_BATCH)
        launches[f"t{T}"] = counts
        log(f"  launches in one step (batch {SHAPES_CHECK_BATCH}, no remat): {counts}")
        state = {k: v.clone() for k, v in system.state_dict().items()}
        del system
        for batch_size in (TRAIN_BATCH, TRAIN_BATCH // 2, TRAIN_BATCH // 4):
            torch.cuda.empty_cache()
            try:
                shapes_step_times(state, T, batch_size, gen, card)
                break
            except torch.cuda.OutOfMemoryError:
                log(f"  batch {batch_size} with remat does not fit the card at seq_len {T}; halving it")
        else:
            raise AssertionError(f"seq_len {T}: no batch of 32 or more fits the card with remat")
        del state
        torch.cuda.empty_cache()
        if T == max(SHAPES_STEP_LENGTHS):
            shapes_on_off(gen, T)
    for heads, key in SHAPES_STEP_HEADS.items():
        d = 768 // heads
        log(f"phase 14 (c): one stage-1 step with {heads} heads of {d}, seq_len 128, batch {SHAPES_CHECK_BATCH}")
        system, _, counts = shapes_step_launches(attention, layernorm, shapes_step_config(128, heads, True), gen,
                                                 SHAPES_CHECK_BATCH)
        launches[key] = counts
        log(f"  launches in one step: {counts}")
        del system
        torch.cuda.empty_cache()
    return launches


def shapes_step_times(state, T, batch_size, gen, card) -> None:
    """The step at seq_len ``T`` and ``batch_size`` with remat from
    ``state``, kernels on and off: one warm-up each, then 3 each in turns
    (host clock around a synchronised step)."""
    import torch

    cfg = {tag: shapes_step_config(T, 12, tag == "on", remat=True) for tag in ("on", "off")}
    systems = {tag: train_system(cfg[tag], state) for tag in cfg}
    batch = train_batch(cfg["on"], gen, batch_size)
    gens = {k: (torch.Generator(device="cuda").manual_seed(1), torch.Generator().manual_seed(2)) for k in systems}

    def step(tag):
        return systems[tag].train_step(batch, generator=gens[tag][0], host_generator=gens[tag][1])

    try:
        torch.cuda.reset_peak_memory_stats()
        step("on")
        step("off")
        samples = {"on": [], "off": []}
        for i in range(3):
            for tag in (("off", "on") if i % 2 == 0 else ("on", "off")):
                samples[tag].append(wall_ms(lambda: step(tag), runs=1))
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        del systems
    for tag in ("on", "off"):
        ms = statistics.median(samples[tag])
        log(f"  train_step seq_len {T} batch {batch_size} bf16 remat, kernels {tag}: {ms:.3f} ms, "
            f"{batch_size / ms * 1e3:.1f} img/s (steps {', '.join(f'{t:.1f}' for t in samples[tag])}) [{card}]")
    log(f"  peak allocated over the two sides' steps: {peak:.3f} GiB")


def shapes_on_off(gen, T):
    """Phase 6's kernels-on-vs-off check on the step at seq_len ``T``, batch
    ``SHAPES_CHECK_BATCH``, text dropout off, bf16: the 4 metrics, the
    generator's BatchNorm statistics, the encoder's and projection's
    gradients under a fixed cotangent of tem, at ``STEP_TOL['bf16']``."""
    import torch

    from imagegenerator_tpu_torch.train.stage1 import Stage1System

    log(f"phase 14 (c): one step at seq_len {T}, batch {SHAPES_CHECK_BATCH}, kernels on vs off (text dropout off)")
    on_cfg = shapes_step_config(T, 12, True, text_dropout=False)
    state = Stage1System(on_cfg, device="cuda", generator=gen).state_dict()
    batch = train_batch(on_cfg, gen, SHAPES_CHECK_BATCH)
    noise = train_noise(on_cfg, gen, SHAPES_CHECK_BATCH)
    cot = torch.randn((2 * SHAPES_CHECK_BATCH, on_cfg.tem_size), generator=gen, device="cuda")
    on = train_system(on_cfg, state)
    off = train_system(shapes_step_config(T, 12, False, text_dropout=False), state)
    readings = on_off_readings(on, off, batch, noise, cot)
    hold_on_off("bf16", readings)


def shapes_tiny_step(attention, layernorm):
    """Phase 14 (d): the stage-1 step at ``Stage1Config.tiny`` with
    ``fused_attention`` (BertConfig.tiny: 2 heads of 8, T = 8), text
    dropout on, f32, on the card (off cuDNN) against the same step on the
    CPU, the dropout masks and attention seeds drawn once on the CPU and
    replayed on both, at phase 8 (c)'s limits; the card's attention runs
    on the FMA kernels (f32), the CPU's on the plain versions."""
    import dataclasses

    import torch

    from imagegenerator_tpu_torch.train import stage1

    log("phase 14 (d): the tiny stage-1 step (BertConfig.tiny, head dim 8) with fused attention, f32, "
        "card vs CPU")
    gen = torch.Generator().manual_seed(SEED + 14)
    cfg = stage1.Stage1Config.tiny(n_critic=2)
    cfg = dataclasses.replace(cfg, bert=dataclasses.replace(cfg.bert, fused_attention=True, fused_ln=True))
    init = stage1.Stage1System(cfg, device="cpu", generator=gen).state_dict()
    B, T, r = DP_TINY_BATCH, cfg.seq_len, cfg.resolution
    lengths = torch.randint(3, T + 1, (B,), generator=gen)
    batch = {"input_ids": torch.randint(1, cfg.bert.vocab_size, (B, T), generator=gen, dtype=torch.int32),
             "attention_mask": (torch.arange(T)[None, :] < lengths[:, None]).int(),
             "image": torch.randint(0, 256, (B, r, r, 3), generator=gen, dtype=torch.uint8)}
    n = cfg.n_critic
    noise = {"perm": torch.randperm(B, generator=gen), "ca_eps": torch.randn((n, B, cfg.c_dim), generator=gen),
             "z": torch.randn((n, B, cfg.z_dim), generator=gen), "gp_eps": torch.rand((n, B, 1, 1, 1), generator=gen)}

    def build(dev):
        system = stage1.Stage1System(cfg, device="meta")
        system.load_state_dict({k: v.clone().to(dev) for k, v in init.items()}, assign=True)
        return system

    cpu, card = build("cpu"), build("cuda")
    drawn = cpu.encoder.draw(2 * B, T, "cpu", generator=gen, host_generator=torch.Generator().manual_seed(SEED))
    noise["text_masks"], noise["attn_seeds"] = drawn.masks, drawn.seeds
    m_cpu = cpu.train_step(batch, noise=noise)
    with exact_f32():
        reset_counts(attention, layernorm)
        m_card = card.train_step({k: v.cuda() for k, v in batch.items()},
                                 noise={k: [t.cuda() if torch.is_tensor(t) else t for t in v]
                                        if isinstance(v, list) else v.cuda() for k, v in noise.items()})
        torch.cuda.synchronize()
    counts = read_counts(attention, layernorm)
    log(f"  launches on the card: {counts}")
    if (counts["attention"], counts["attention_dropout"], counts["attention_bwd"]) != (1, 1, 1) or \
            counts["attention_mma"] or counts["attention_bwd_mma"]:
        raise AssertionError(f"phase 14 (d): attention launches {counts}, expected one of each on the FMA kernels")
    hold_tiny_step("tiny stage-1 step with fused attention, card vs CPU", cpu, m_cpu, card, m_card,
                   {m: m for m in stage1.MODULES}, cfg.disc_channels, stage1_rules=True)


def phase_shapes(attention, layernorm, gen, card) -> tuple:
    """Phase 14: the attention kernels over every shape the JAX fused path
    takes. Returns the kernels line's rows and the step launches."""
    t0 = time.perf_counter()
    phase_shapes_grid(attention, layernorm, gen)
    log(f"phase 14 (b): times on {card}")
    import torch

    rows = {}
    for name, shape in SHAPES_TIMED.items():
        rows[name] = shapes_times(attention, name, shape, gen, card)
        torch.cuda.empty_cache()
    for which in ("fwd", "bwd"):
        dev = rows["t128"][which]["device_ms"]
        log(f"  the whole-head kernels at {TRAIN_ATTN[:3]} rate 0.1, {which}: device {dev:.4f} ms against "
            f"PERF.md's {WHOLE_HEAD_MS[which]} ({100 * (dev / WHOLE_HEAD_MS[which] - 1):+.1f}%) [{card}]")
    launches = phase_shapes_steps(attention, layernorm, gen, card)
    shapes_tiny_step(attention, layernorm)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s [{card}]")
    return rows, launches


BN_PROBED = "80x128,640x16,32x64"  # G2's largest map and its residual width, D2's first DownBlock
BN_STEP_BATCH = 32


def phase_batchnorm(card) -> list:
    """Phase 15: the BatchNorm kernels. Returns the kernels line's rows."""
    import torch

    from imagegenerator_tpu_torch.ops.kernels import batchnorm as bn
    from imagegenerator_tpu_torch.train.stage2 import Stage2System

    t0 = time.perf_counter()
    log("phase 15 (a): tests/test_torch_kernels_cuda.py -k batch_norm")
    tests = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q", "-m",
                            "cuda", "tests/test_torch_kernels_cuda.py", "-k", "batch_norm"],
                           cwd=ROOT, capture_output=True, text=True)
    log(f"  {tests.stdout.strip().splitlines()[-1]}")
    if tests.returncode != 0:
        raise AssertionError(f"phase 15: the BatchNorm card tests failed:\n{tests.stdout[-4000:]}")

    log("phase 15 (b): 256 x 128 x 128 x 80 bf16, each pass against its plain version, one planted fault")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    C, H, B = 80, 128, 256
    shape = (B, C, H, H)
    cl = lambda t: bn.rows(t.contiguous(memory_format=torch.channels_last))
    x, g, gg = (cl(torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)) for _ in range(3))
    w = 1.0 + 0.2 * torch.randn(C, generator=gen, device="cuda")
    b = 0.2 * torch.randn(C, generator=gen, device="cuda")
    n, inv = x.shape[0], 1.0 / x.shape[0]
    kw = dict(count=n, training=True, update=False, eps=1e-5, momentum=0.1, out_dtype=torch.bfloat16)
    stats_rm = torch.zeros(C, device="cuda"), torch.ones(C, device="cuda")
    sums = bn.batch_norm_sums(bn.FWD, x)
    y, stats = bn.batch_norm_fwd(x, sums, w, b, *stats_rm, **kw)
    errs = {"fwd": compare("forward y", y, bn.batch_norm_fwd_reference(x, sums, w, b, *stats_rm, **kw)[0],
                           1e-2, 1e-2)}
    bsums = bn.batch_norm_sums(bn.BWD, g, x, stats=stats)
    errs["bwd"] = compare("backward dx", bn.batch_norm_bwd(g, x, stats, w, bsums, inv),
                          bn.batch_norm_bwd_reference(g, x, stats, w, bsums, inv), 1e-2, 1e-2)
    dsums = bn.batch_norm_sums(bn.DBL, gg, x, g, stats)
    got = bn.batch_norm_double_bwd(gg, x, g, stats, w, dsums, dsums, bsums, bsums, None, None, inv)
    want = bn.batch_norm_double_bwd_reference(gg, x, g, stats, w, dsums, dsums, bsums, bsums, None, None, inv)
    errs["double_bwd"] = max(compare("double backward d/dg", got[0], want[0], 1e-2, 1e-2),
                             compare("double backward d/dx", got[1], want[1], 1e-2, 1e-2 * want[1].abs().max().item()))
    planted = bn.batch_norm_fwd(x, sums, w, b, *stats_rm, **dict(kw, eps=0.25))[0]
    try:
        compare("planted: the forward's eps at 0.25", planted, y, 1e-2, 1e-2)
    except AssertionError:
        log("  planted fault caught")
    else:
        raise AssertionError("phase 15: the planted fault was not caught")
    del x, g, gg, y, got, want, planted

    log(f"phase 15 (c): full-width stage-2 step, bf16, tokens route, batch {BN_STEP_BATCH}")
    cfg = train2_config(True, torch.bfloat16)
    system = Stage2System(cfg, device="cuda", generator=gen)
    res = cfg.resolution
    batch = {"input_ids": torch.randint(1, cfg.bert.vocab_size, (BN_STEP_BATCH, cfg.seq_len), generator=gen,
                                        device="cuda", dtype=torch.int32),
             "attention_mask": torch.ones((BN_STEP_BATCH, cfg.seq_len), dtype=torch.int32, device="cuda"),
             "image": torch.randint(0, 256, (BN_STEP_BATCH, res, res, 3), generator=gen, device="cuda",
                                    dtype=torch.uint8)}
    system.train_step(batch, generator=gen)  # warm-up
    bn.fwd_launches = bn.bwd_launches = bn.double_bwd_launches = 0
    system.train_step(batch, generator=gen)
    torch.cuda.synchronize()
    step = {"fwd": bn.fwd_launches, "bwd": bn.bwd_launches, "double_bwd": bn.double_bwd_launches}
    log(f"  BatchNorm kernel launches a step: {step}")
    if min(step.values()) < 1:
        raise AssertionError(f"phase 15: a BatchNorm route ran off the kernels in the stage-2 step: {step}")
    del system, batch
    torch.cuda.empty_cache()

    log(f"phase 15 (d): tools/probe_torch_batchnorm.py --shapes {BN_PROBED}")
    probe = subprocess.run([sys.executable, "tools/probe_torch_batchnorm.py", "--shapes", BN_PROBED], cwd=ROOT,
                           capture_output=True, text=True)
    if probe.returncode != 0:
        raise AssertionError(f"phase 15: the probe failed:\n{probe.stderr[-4000:]}")
    for line in probe.stdout.strip().splitlines()[1:-1]:
        if "kernel fwd" in line:  # the rows, not ptxas's report
            log(f"  {line}")
    probed = {r["shape"]: r for r in json.loads(probe.stdout.strip().splitlines()[-1])["batch_norm_probe"]}
    rows = []
    for which in ("fwd", "bwd", "double_bwd"):
        rows.append({"name": f"batch_norm_{which}", "route": "cuda",
                     "source": "imagegenerator_tpu_torch/csrc/batch_norm_nhwc.cu",
                     "replaces": "none: the JAX package leaves BatchNorm to XLA",
                     "launches": step[which], "stage2_step_launches": step[which],
                     "max_abs_err": errs[which],
                     "ms": {shape: r["kernel_ms"][which] for shape, r in probed.items()},
                     "device_ms": {shape: r["device_ms"][which] for shape, r in probed.items()},
                     "plain_ms": {shape: r["plain_ms"][which] for shape, r in probed.items()},
                     "bound_ms": {shape: r["bound_ms"][which] for shape, r in probed.items()},
                     "library_ms": {shape: r["library_ms"] for shape, r in probed.items()}})
    log(f"phase 15: {time.perf_counter() - t0:.1f} s [{card}]")
    return rows


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=["train", "train2", "v2", "dp", "eval", "tp", "bench", "weights-day",
                                           "attention-shapes", "d2-trace", "tiny-trace", "tiny-witness",
                                           "batchnorm"],
                        default=None,
                        help="build, then run one slice's phases alone (no result line)")
    # phase 9 starts this script once per rank with these
    parser.add_argument("--dp-worker", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--dp-port", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--dp-nccl", action="store_true", help=argparse.SUPPRESS)
    # and phase 11 once per rank of each grid with these
    parser.add_argument("--tp-worker", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--tp-world", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--tp-port", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--tp-nccl", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--tp-out", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    if args.dp_worker is not None:
        return dp_worker(args.dp_worker, args.dp_port, args.dp_nccl)
    if args.tp_worker is not None:
        return tp_worker(args.tp_worker, args.tp_world, args.tp_port, args.tp_nccl, args.tp_out)
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
    log(f"  host: {host_description()}")

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
    if args.only == "train2":
        phase_train2(attention, layernorm, gen, card)
    if args.only == "v2":
        phase_v2(vq_argmin, scanline_lerp, gen, card)
    if args.only == "dp":
        phase_dp(card)
    if args.only == "eval":
        phase_clip_eval(vq_argmin, scanline_lerp, gen, card)
    if args.only == "tp":
        phase_tp(attention, gen, card)
    if args.only == "bench":
        phase_bench(gen, card)
    if args.only == "weights-day":
        phase_weights_day(vq_argmin, attention, layernorm, card)
    if args.only == "attention-shapes":
        phase_shapes(attention, layernorm, gen, card)
    if args.only == "d2-trace":
        phase_d2_trace(card)
    if args.only == "tiny-trace":
        phase_tiny_trace(card)
    if args.only == "tiny-witness":
        phase_tiny_witness(card)
    if args.only == "batchnorm":
        print(json.dumps({"kernels": phase_batchnorm(card)}))
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
    v2_launches, lanczos_launches, v2_errs, v2_t = phase_v2(vq_argmin, scanline_lerp, gen, card)
    with tempfile.TemporaryDirectory() as kept:
        samples = Path(kept) / "samples"  # phase 8's, which phase 10 scores
        train2_launches, train2_size, train2_times = phase_train2(attention, layernorm, gen, card,
                                                                  samples_to=samples)
        torch.cuda.empty_cache()  # the rank processes share the card
        phase_dp(card)
        rn50_launches = phase_clip_eval(vq_argmin, scanline_lerp, gen, card, samples)
    torch.cuda.empty_cache()  # phase 11's rank processes share the card
    tp_launches, tp_t = phase_tp(attention, gen, card)
    torch.cuda.empty_cache()  # phase 12's bench processes share the card
    phase_bench(gen, card, train2_times["tem_ms"] if train2_size == TRAIN2_BATCH else None)
    torch.cuda.empty_cache()
    phase_weights_day(vq_argmin, attention, layernorm, card)
    torch.cuda.empty_cache()
    shape_rows, shape_launches = phase_shapes(attention, layernorm, gen, card)
    torch.cuda.empty_cache()
    bn_rows = phase_batchnorm(card)
    B = TRAIN_ATTN[0]

    # launches: on the kernel's own main path (the sampling CLI's run, the
    # stage-1 steps, the v2 CLI's first run); errors, times and bounds at
    # that path's shape. stage2_step_launches: the same count over phase 8's
    # four counted tokens-route steps, which run the two forward kernels;
    # rn50_step_launches: one v2 step with the RN50 tower (phase 10);
    # tp_step_launches: one rank's launches in one step of phase 11's (1, 2)
    # grid, where its attention runs 6 heads at width 384 (the rows
    # attention_*_tp384: that shape's errors and times)
    kernels = [
        {"name": "attention_fwd", "route": "cuda",
         "source": "imagegenerator_tpu_torch/csrc/attention_fwd.cu",
         "replaces": "imagegenerator_tpu/ops/pallas/attention.py:277",
         "launches": launches["attention"], "stage2_step_launches": train2_launches["attention"],
         "max_abs_err": errs["attention", "bf16"], **attn_t},
        {"name": "attention_fwd_dropout", "route": "cuda",
         "source": "imagegenerator_tpu_torch/csrc/attention_fwd.cu",
         "replaces": "imagegenerator_tpu/ops/pallas/attention.py:277",
         "launches": train_launches["attention_dropout"], "tp_step_launches": tp_launches["attention_dropout"],
         "max_abs_err": errs["attention_dropout", "bf16", 0.1], **train_t["attention_fwd_dropout"]},
        {"name": "attention_fwd_dropout_tp384", "route": "cuda",
         "source": "imagegenerator_tpu_torch/csrc/attention_fwd.cu",
         "replaces": "imagegenerator_tpu/ops/pallas/attention.py:277",
         "launches": tp_launches["attention_dropout"], **tp_t["fwd"]},
        {"name": "attention_bwd", "route": "cuda",
         "source": "imagegenerator_tpu_torch/csrc/attention_bwd.cu",
         "replaces": "imagegenerator_tpu/ops/pallas/attention.py:308",
         "launches": train_launches["attention_bwd"], "tp_step_launches": tp_launches["attention_bwd"],
         "max_abs_err": errs["attention_bwd", "bf16", B, True, 0.1], **train_t["attention_bwd"]},
        {"name": "attention_bwd_tp384", "route": "cuda",
         "source": "imagegenerator_tpu_torch/csrc/attention_bwd.cu",
         "replaces": "imagegenerator_tpu/ops/pallas/attention.py:308",
         "launches": tp_launches["attention_bwd"], **tp_t["bwd"]},
    ]
    # phase 14: the pair at the stage-1 step's shapes at seq_len 256 and 512
    # and at head dims 32 and 128 (the Hopper kernels, each row with the
    # mma.sync tiled kernels' device time at its shape), at head dim 48
    # (the mma.sync tiled kernels) and at the whole-head shape (t128: the
    # whole-head kernels timed again beside the new rows); launches from
    # one step of that configuration, those of the row's own kernels
    for key, what, kind in (("t256", "seq_len 256", "wgmma"), ("t512", "seq_len 512", "wgmma"),
                            ("d32", "24 heads of 32", "wgmma"), ("d128", "6 heads of 128", "wgmma"),
                            ("d48", "16 heads of 48", "tiled"), ("t128", "seq_len 128", "whole_head")):
        counted = shape_launches.get(key, train_launches)
        for which, replaces in (("fwd_dropout", 277), ("bwd", 308)):
            row = shape_rows[key]["fwd" if which == "fwd_dropout" else "bwd"]
            count = "attention_dropout" if which == "fwd_dropout" else "attention_bwd"
            if kind == "wgmma":
                count = "attention_wgmma" if which == "fwd_dropout" else "attention_bwd_wgmma"
            name = f"attention_{which}_{key}" if kind == "whole_head" else f"attention_{which}_{kind}_{key}"
            kernels.append({"name": name, "route": "cuda",
                            "source": f"imagegenerator_tpu_torch/csrc/attention_{which[:3]}.cu",
                            "replaces": f"imagegenerator_tpu/ops/pallas/attention.py:{replaces}",
                            "launches": counted[count], "launches_on": what, **row})
    kernels += [
        {"name": "layernorm_fwd", "route": "cuda",
         "source": "imagegenerator_tpu_torch/csrc/layernorm_fwd.cu",
         "replaces": "imagegenerator_tpu/ops/pallas/layernorm.py:99",
         "launches": launches["layernorm"], "stage2_step_launches": train2_launches["layernorm"],
         "tp_step_launches": tp_launches["layernorm"],
         "max_abs_err": errs["layernorm", "f32"], **ln_t},
        {"name": "layernorm_bwd", "route": "triton",
         "source": "imagegenerator_tpu_torch/ops/kernels/layernorm.py",
         "replaces": "imagegenerator_tpu/ops/pallas/layernorm.py:145",
         "launches": train_launches["layernorm_bwd"], "tp_step_launches": tp_launches["layernorm_bwd"],
         "max_abs_err": errs["layernorm_bwd", "f32"],
         **train_t["layernorm_bwd"]},
        # max_abs_err: the largest score gap, as a share of the row's score
        # range, between the kernel's code and the plain version's (0 when
        # every index is equal)
        {"name": "vq_argmin", "route": "cuda",
         "source": "imagegenerator_tpu_torch/csrc/vq_argmin.cu",
         "replaces": "imagegenerator_tpu/ops/pallas/vq_kernel.py:81",
         "launches": v2_launches["vq_argmin"], "lanczos_256px_launches": lanczos_launches["vq_argmin"],
         "rn50_step_launches": rn50_launches["vq_argmin"], "max_abs_err": v2_errs["vq", VQ_SHAPE[0], "taming", "f32"][0], **v2_t["vq_argmin"]},
        {"name": "scanline_lerp", "route": "triton",
         "source": "imagegenerator_tpu_torch/ops/kernels/scanline_lerp.py",
         "replaces": "imagegenerator_tpu/ops/pallas/scanline_lerp.py:105",
         "launches": v2_launches["scanline_lerp"],
         "lanczos_256px_launches": lanczos_launches["scanline_lerp"],
         "rn50_step_launches": rn50_launches["scanline_lerp"], "max_abs_err": v2_errs["lerp"],
         **v2_t["scanline_lerp"]},
    ]
    kernels += bn_rows
    for kernel in kernels:
        counts = [kernel[k] for k in ("launches", "stage2_step_launches", "lanczos_256px_launches",
                                      "rn50_step_launches", "tp_step_launches") if k in kernel]
        if min(counts) < 1:
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
