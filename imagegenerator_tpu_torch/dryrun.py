"""Two health checks: a one-card compile-and-run of the flagship forward
and a dry run of every parallel path over several ranks — counterpart of
``__graft_entry__.py`` (``entry``, ``dryrun_multichip``).

    python -c "from imagegenerator_tpu_torch import dryrun; fn, args = dryrun.entry(); print(fn(*args).shape)"
    python -c "from imagegenerator_tpu_torch import dryrun; dryrun.dryrun_multichip(4)"

Both run on the card unless the caller names another device
(``device="cpu"``); without a card the default raises.

``dryrun_multichip(n)`` starts ``n`` ranks (processes joined by
``torch.distributed``: a card each over NCCL where there are ``n`` cards,
else all on the one named card, or on the CPU, over gloo) and runs, at
tiny widths:

1. the stage-2 training step, data-parallel over the ``n`` ranks, three
   steps, with a 1-rank against ``n``-rank readout of images/s (of the
   mechanics only at this size);
2. batched v2 generation split over the ranks
   (``GenerateEngine(shard=...)``): three ``chain`` iterations;
3. CLIP's forward under tensor parallelism on a ``(n / 2, 2)`` grid
   (``CLIP.shard_model``), against the unsplit model on the same rows;
4. the stage-1 training step on that grid with BERT split over the
   model group (``Stage1System.shard``), then a checkpoint save (slices
   gathered whole on rank 0) and a restore (each rank takes its slices
   again), checked slice for slice;
5. the stage-1 data-parallel step with the fused attention and
   LayerNorm kernels (a BERT of head dim 64) over the ``n`` ranks.

Where JAX needs ``n >= 4`` for steps 3 and 4, the port runs them at any
even ``n`` (``(1, 2)`` at ``n = 2``). Rank 0 prints a line per step and
``dryrun_multichip`` returns its report.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import tempfile
import time

import numpy as np
import torch

from imagegenerator_tpu_torch.utils.device import entry_device


def entry(device=None):
    """The flagship model's forward: the stage-2 256 px generator in bf16
    at batch 8, seeded random weights. Returns ``(fn, args)``;
    ``fn(*args)`` is ``(8, 256, 256, 3)`` bf16."""
    from imagegenerator_tpu_torch.models.stackgan import StageIIGenerator

    dev = entry_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(0)
    g2 = StageIIGenerator(num_residual=4, dtype=torch.bfloat16, device=dev, generator=gen).eval()
    img64 = torch.zeros((8, 64, 64, 3), device=dev)
    c_hat = torch.zeros((8, 128), device=dev)

    @torch.no_grad()
    def fwd(img64, c_hat):
        return g2(img64, c_hat)

    return fwd, (img64, c_hat)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Start ``n_devices`` ranks and run the five steps above; returns
    rank 0's report (each step's metrics and checks). Any rank's failure
    raises."""
    import torch.multiprocessing as mp

    dev = entry_device(device)
    with tempfile.TemporaryDirectory() as out:
        mp.start_processes(_rank_main, args=(n_devices, _free_port(), str(dev), out), nprocs=n_devices,
                           start_method="spawn", join=True)
        with open(os.path.join(out, "report.json")) as f:
            return json.load(f)


def _rank_device(rank: int, n: int, device: str):
    from imagegenerator_tpu_torch.parallel import dp

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev, "gloo"
    own = torch.cuda.device_count() >= n
    dev = torch.device("cuda", rank if own else (dev.index or 0))
    torch.cuda.set_device(dev)
    return dev, dp.backend_for("cuda", n, torch.cuda.device_count() if own else 1)


def _rank_main(rank: int, n: int, port: int, device: str, out: str) -> None:
    import torch.distributed as dist

    from imagegenerator_tpu_torch.parallel import dp

    if device == "cpu":
        torch.set_num_threads(1)
    dev, backend = _rank_device(rank, n, device)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=n, rank=rank)
    report = {"ranks": n, "device": str(dev), "backend": backend}
    try:
        report["stage2_dp"] = _stage2_dp(dev, n)
        report["v2_sharded"] = _v2_sharded(dev, n)
        if n % 2 == 0:
            report["clip_tp"] = _clip_tp(dev)
            report["stage1_grid"] = _stage1_grid(dev, out)
        report["stage1_dp_fused"] = _stage1_dp_fused(dev)
        dp.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(out, "report.json"), "w") as f:
            json.dump(report, f)


def _say(msg: str) -> None:
    from imagegenerator_tpu_torch.parallel import dp

    if dp.is_main():
        print(msg, flush=True)


def _finite(metrics: dict) -> dict:
    out = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in out.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite metrics {bad}: {out}")
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _stage2_dp(dev, n: int, per_shard: int = 2, steps: int = 2) -> dict:
    """Step 1: the stage-2 step over the ranks, then rank 0 alone."""
    from imagegenerator_tpu_torch.parallel import dp
    from imagegenerator_tpu_torch.train.stage2 import Stage2Config, Stage2System
    from imagegenerator_tpu_torch.utils.rng import mixed_generator

    cfg = Stage2Config.tiny(n_critic=1)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"input_ids": torch.randint(1, cfg.bert.vocab_size, (per_shard, cfg.seq_len), generator=gen,
                                        device=dev, dtype=torch.int32),
             "attention_mask": torch.ones((per_shard, cfg.seq_len), dtype=torch.int32, device=dev),
             "image": torch.randint(0, 256, (per_shard, cfg.resolution, cfg.resolution, 3), generator=gen,
                                    device=dev, dtype=torch.uint8)}

    def run(reduce, together):
        system = Stage2System(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
        if together:
            dp.broadcast_state([system])
        metrics = system.train_step(batch, generator=mixed_generator(2, 0, dev), reduce=reduce)
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(steps):
            metrics = system.train_step(batch, generator=mixed_generator(2, i + 1, dev), reduce=reduce)
        _sync(dev)
        if system.step != steps + 1:
            raise AssertionError(f"stage 2: {system.step} steps taken, {steps + 1} asked")
        return _finite(metrics), (time.perf_counter() - t0) / steps

    metrics, dt_n = run(dp.all_reduce_mean, True)
    rate_n = per_shard * n / dt_n
    rate_1 = float("nan")  # rank 0's reading
    if dp.is_main():
        _, dt_1 = run(lambda tensors: None, False)
        rate_1 = per_shard / dt_1
    dp.barrier()
    _say(f"stage2 DP over {n} ranks: {metrics}")
    _say(f"stage2 DP scaling (tiny widths, mechanics only): 1 rank = {rate_1:.1f} img/s, "
         f"{n} ranks = {rate_n:.1f} img/s")
    return {"metrics": metrics, "images_per_s_1": rate_1, "images_per_s_n": rate_n}


def _v2_sharded(dev, n: int, steps: int = 3) -> dict:
    """Step 2: the v2 chain with the batch split over the ranks."""
    from imagegenerator_tpu_torch.parallel import dp
    from imagegenerator_tpu_torch.v2.clip import CLIPConfig
    from imagegenerator_tpu_torch.v2.engine import GenerateEngine
    from imagegenerator_tpu_torch.v2.vqgan import VQGANConfig

    engine = GenerateEngine(VQGANConfig.tiny(), CLIPConfig.tiny(), cutn=2, shard=(dp.rank(), n), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(2))
    # every rank draws the whole batch's latent and keeps its row
    z = engine.random_token_latent(torch.Generator(device=dev).manual_seed(4), n, 2, 2)[dp.rank():dp.rank() + 1]
    state = engine.init_state(z)
    embeds = torch.randn((n, 1, engine.clip_config.embed_dim), generator=torch.Generator(device=dev).manual_seed(5),
                         device=dev)[dp.rank():dp.rank() + 1]
    weights, stops = torch.ones((1, 1), device=dev), torch.full((1, 1), -float("inf"), device=dev)
    state, losses = engine.chain(state, steps, 5, embeds, weights, stops)
    if losses.shape != (steps, 1, 1) or state.step != steps:
        raise AssertionError(f"v2: losses {tuple(losses.shape)}, {state.step} steps")
    last = dp.gather_rows(losses[-1].reshape(1))
    if not np.isfinite(last).all():
        raise AssertionError(f"v2: non-finite losses {last}")
    _say(f"v2 sharded gen (chain n={steps}, batch {n} over {n} ranks): last-iteration losses {last.tolist()}")
    return {"last_losses": last.tolist()}


def _clip_tp(dev) -> dict:
    """Step 3: CLIP's forward on the (n / 2, 2) grid against the unsplit
    model on the same rows."""
    from imagegenerator_tpu_torch.parallel import mesh, tp
    from imagegenerator_tpu_torch.v2.clip import CLIP, CLIPConfig

    grid = mesh.make_grid(2)
    cfg = CLIPConfig.tiny()
    whole = CLIP(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(6)).eval()
    split = CLIP(cfg, device=dev).eval()
    split.load_state_dict(whole.state_dict())
    split.shard_model(tp.ModelShard(grid.model_index, grid.model, grid.model_group))
    gen = torch.Generator(device=dev).manual_seed(7)
    images = torch.randn((2 * grid.data, cfg.image_resolution, cfg.image_resolution, 3), generator=gen, device=dev)
    tokens = torch.randint(1, cfg.vocab_size, (2 * grid.data, cfg.context_length), generator=gen, device=dev)
    rows = slice(2 * grid.data_index, 2 * grid.data_index + 2)
    with torch.no_grad():
        got = split.encode_image(images[rows]), split.encode_text(tokens[rows])
        want = whole.encode_image(images[rows]), whole.encode_text(tokens[rows])
    err = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
    if err > 1e-5:
        raise AssertionError(f"CLIP under TP: {err:.3e} of the largest output from the unsplit model")
    _say(f"CLIP TP on a ({grid.data}, {grid.model}) grid: image {tuple(got[0].shape)}, "
         f"text {tuple(got[1].shape)} a data index; {err:.3e} from the unsplit model")
    return {"grid": [grid.data, grid.model], "rel_err": err}


def _stage1_grid(dev, out: str) -> dict:
    """Step 4: the stage-1 step on the grid, then a checkpoint round trip."""
    from imagegenerator_tpu_torch import convert
    from imagegenerator_tpu_torch.checkpoint import CheckpointManager
    from imagegenerator_tpu_torch.parallel import dp, mesh, tp
    from imagegenerator_tpu_torch.train.stage1 import Stage1Config, Stage1System
    from imagegenerator_tpu_torch.utils.rng import mixed_generator

    grid = mesh.make_grid(2)
    cfg = Stage1Config.tiny(n_critic=1)
    system = Stage1System(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(8))
    system.shard(grid)
    b = 2
    gen = torch.Generator(device=dev).manual_seed(9 + grid.data_index)
    batch = {"input_ids": torch.randint(1, cfg.bert.vocab_size, (b, cfg.seq_len), generator=gen, device=dev,
                                        dtype=torch.int32),
             "attention_mask": torch.ones((b, cfg.seq_len), dtype=torch.int32, device=dev),
             "image": torch.rand((b, cfg.resolution, cfg.resolution, 3), generator=gen, device=dev) * 2 - 1}
    metrics = _finite(system.train_step(batch, generator=mixed_generator(3, 0, dev),
                                        host_generator=mixed_generator(3, 0, "cpu"),
                                        reduce=mesh.data_mean(grid)))
    _say(f"stage1 on a ({grid.data}, {grid.model}) grid, BERT split over the model group: {metrics}")

    ckpt = CheckpointManager(os.path.join(out, "stage1_grid"), save_every_epochs=1)
    flat = convert.to_numpy(system)  # every rank gathers; rank 0 writes
    ckpt.save(0, flat if dp.is_main() else {})
    restored, start = ckpt.restore_latest()
    again = convert.stage1_from_numpy(restored, cfg, dev)
    again.shard(grid)
    live, back = system.state_dict(), again.state_dict()
    sliced = tp.sharded_keys(system)
    differ = [k for k in live if not torch.equal(live[k], back[k])]
    if start != 1 or again.step != system.step or differ or not sliced:
        raise AssertionError(f"checkpoint under the grid: start {start}, step {again.step}, differ {differ[:3]}")
    key = "encoder.encoder.layer.0.attention.self.query.weight"
    _say(f"checkpoint round trip under the grid: {len(sliced)} split tensors restored slice for slice "
         f"(query weight {tuple(live[key].shape)} a rank of {tuple(flat['params/encoder/layer_0/attention/query/kernel'].shape[::-1])})")
    return {"metrics": metrics, "split_tensors": len(sliced)}


def _stage1_dp_fused(dev) -> dict:
    """Step 5: the stage-1 step with the fused attention and LayerNorm
    (their kernels on the card), data-parallel over every rank."""
    from imagegenerator_tpu_torch.models.bert import BertConfig
    from imagegenerator_tpu_torch.parallel import dp
    from imagegenerator_tpu_torch.train.stage1 import Stage1Config, Stage1System
    from imagegenerator_tpu_torch.utils.rng import mixed_generator

    bert = dataclasses.replace(BertConfig.tiny(), hidden_size=128, num_heads=2, intermediate_size=256,
                               fused_attention=True, fused_ln=True)
    cfg = Stage1Config.tiny(n_critic=1, bert=bert)
    system = Stage1System(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(10))
    dp.broadcast_state([system])
    gen = torch.Generator(device=dev).manual_seed(11 + dp.rank())
    batch = {"input_ids": torch.randint(1, bert.vocab_size, (2, cfg.seq_len), generator=gen, device=dev,
                                        dtype=torch.int32),
             "attention_mask": torch.ones((2, cfg.seq_len), dtype=torch.int32, device=dev),
             "image": torch.rand((2, cfg.resolution, cfg.resolution, 3), generator=gen, device=dev) * 2 - 1}
    metrics = _finite(system.train_step(batch, generator=mixed_generator(4, 0, dev),
                                        host_generator=mixed_generator(4, 0, "cpu"),
                                        reduce=dp.all_reduce_mean))
    _say(f"stage1 DP x fused attention and LayerNorm ({dp.world()} ranks): {metrics}")
    return {"metrics": metrics}
