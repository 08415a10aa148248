"""Epoch-loop trainers wiring data loader + train step + checkpointing +
metrics for both stages — counterpart of
``imagegenerator_tpu/train/trainer.py``.

The state lives on the system (modules, optimizers, step count), so
``init_state`` restores into it and returns the epoch to start from, and
``fit`` trains it in place. All of a step's noise comes from a generator
seeded from ``(seed, global step)`` (``utils/rng.py``), so a resumed run draws what an
uninterrupted one would have drawn.

Under data parallelism (``parallel/dp.py``, one process per card) every
rank builds or restores the same state and then takes rank 0's
(``broadcast_state``); every rank seeds each step from the same ``(seed,
global step)``, as the JAX step hands its one replicated key to every
shard, so the replicas draw the same permutation over their own local
batch and the same noise and dropout seeds; the steps average gradients
and metrics over the ranks. Each rank keeps its EMA (they agree, since the
parameters do); rank 0 writes checkpoints, metrics and images.

Under tensor parallelism (stage 1, a ``grid`` from ``parallel/mesh.py``)
every rank restores the whole state, takes its slices
(``Stage1System.shard``, ``ema.shard``) and then rank 0's replicated
tensors and its data index 0's slices (``broadcast_state``); the step
averages over the data group; a checkpoint gathers the slices whole
(every rank takes part), so it is the same flat dict as one process's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.checkpoint import CheckpointManager
from imagegenerator_tpu_torch.parallel import dp, mesh
from imagegenerator_tpu_torch.train import ema as ema_lib
from imagegenerator_tpu_torch.utils.metrics import MetricsWriter
from imagegenerator_tpu_torch.utils.profiling import span
from imagegenerator_tpu_torch.utils.rng import mixed_generator

SAMPLE_SEED = 456  # the fixed-noise sample grids of stage 2


@dataclasses.dataclass
class TrainerOptions:
    num_epochs: int = 500
    save_every_epochs: int = 10
    log_every_steps: int = 1
    sample_every_steps: int = 100  # stage-2 image grids
    seed: int = 42
    checkpoint_dir: str | None = None
    logdir: str | None = None
    # EMA decay for the generator-side parameters (None = off). The
    # average lives on the trainer (train/ema.py) and checkpoints grow an
    # ``aux/ema/`` side dict (save_with_aux). Sample from it with
    # ``train.sample --ema``.
    ema_decay: float | None = None


class _Trainer:
    """What both stages share: the resume, the EMA, the epoch loop."""

    stage: int

    def __init__(self, system, loader, options: TrainerOptions, grid=None):
        self.system = system
        self.loader = loader
        self.opt = options
        self.grid = grid
        self.writer = MetricsWriter(options.logdir)
        self.ckpt = (
            CheckpointManager(options.checkpoint_dir, options.save_every_epochs)
            if options.checkpoint_dir
            else None
        )
        self.ema = None
        self._ema_modules = ema_lib.modules_for_stage(self.stage)

    @property
    def device(self):
        return next(self.system.parameters()).device

    def _restore(self) -> int:
        """Load the latest checkpoint into the system (and the EMA, when
        on); the epoch to start from, 0 with no checkpoint."""
        if self.ckpt is None:
            return 0
        flat, aux, start_epoch = self.ckpt.restore_latest_with_aux()
        if flat is None:
            return 0
        convert.load_numpy(self.system, flat, self.device)
        if self.opt.ema_decay is not None and aux is not None:
            ema = {k[len("ema/"):]: v for k, v in aux.items() if k.startswith("ema/")}
            self.ema = ema_lib.from_numpy(ema, self.system, self.device)
        print(f"Loaded checkpoint at epoch {start_epoch - 1}")
        return start_epoch

    def _sync_ranks(self) -> None:
        """Every rank takes rank 0's parameters, statistics and optimizer
        state (a no-op in one process); on a grid each slice comes from
        its data index 0."""
        dp.broadcast_state([self.system], self.system.optimizers.values(), grid=self.grid)

    def _seed_ema(self) -> None:
        # a fresh run, or a checkpoint of a run without EMA: the average
        # starts from the parameters as they are
        if self.opt.ema_decay is not None and self.ema is None:
            self.ema = ema_lib.init_ema(self.system, self._ema_modules)

    def _save(self, epoch: int) -> None:
        # rank 0 writes; the others pass an empty state to the manager's
        # barrier. Split tensors are gathered whole, by every rank.
        gather = self.grid is not None and self.grid.model > 1
        flat = convert.to_numpy(self.system) if dp.is_main() or gather else {}
        ema = ema_lib.to_numpy(self.ema, self.system) if self.ema is not None and flat else None
        if ema is None or not dp.is_main():
            self.ckpt.save(epoch, flat if dp.is_main() else {})
        else:
            self.ckpt.save_with_aux(epoch, flat, {f"ema/{k}": v for k, v in ema.items()})

    def _train_step(self, batch, gstep: int) -> dict:
        raise NotImplementedError

    def _after_step(self, batch, gstep: int) -> None:
        pass

    def fit(self, start_epoch: int = 0):
        self._seed_ema()
        gstep = self.system.step
        for epoch in range(start_epoch, self.opt.num_epochs):
            batches = iter(self.loader)
            while True:
                with span("data"):  # the wait for the loader, in a profiler's trace
                    batch = next(batches, None)
                if batch is None:
                    break
                metrics = self._train_step(batch, gstep)
                if self.ema is not None:
                    ema_lib.update(self.ema, self.system, self.opt.ema_decay)
                if gstep % self.opt.log_every_steps == 0:
                    # in the names' order, as the JAX package's lines are
                    self.writer.scalars(
                        gstep, {f"stage{self.stage}/{k}": float(metrics[k]) for k in sorted(metrics)}
                    )
                self._after_step(batch, gstep)
                gstep += 1
            if self.ckpt is not None and self.ckpt.should_save(epoch):
                self._save(epoch)
        return self.system


class Stage1Trainer(_Trainer):
    stage = 1

    def init_state(self) -> int:
        """Resume where a checkpoint exists; returns the start epoch. On a
        grid, the whole state restored is then cut to this rank's slices."""
        start_epoch = self._restore()
        if self.grid is not None:
            self.system.shard(self.grid)
            if self.ema is not None:
                self.ema = ema_lib.shard(self.ema, self.system)
        self._sync_ranks()
        self._seed_ema()
        return start_epoch

    def _train_step(self, batch, gstep):
        # the fused attention's dropout seeds are drawn on the host
        return self.system.train_step(
            batch,
            generator=mixed_generator(self.opt.seed, gstep, self.device),
            host_generator=mixed_generator(self.opt.seed, gstep, "cpu"),
            reduce=dp.all_reduce_mean if self.grid is None else mesh.data_mean(self.grid),
        )


class Stage2Trainer(_Trainer):
    stage = 2

    def init_state(self, stage1_system=None) -> int:
        """Take the frozen stack from ``stage1_system`` where one is
        given, then resume where a checkpoint exists (which carries its
        own frozen stack); returns the start epoch."""
        if stage1_system is not None:
            self.system.load_stage1(stage1_system)
        start_epoch = self._restore()
        self._sync_ranks()
        self._seed_ema()
        return start_epoch

    def _train_step(self, batch, gstep):
        return self.system.train_step(
            batch, generator=mixed_generator(self.opt.seed, gstep, self.device),
            reduce=dp.all_reduce_mean,
        )

    def _after_step(self, batch, gstep):
        every = self.opt.sample_every_steps
        if not (every and gstep % every == 0 and gstep > 0) or not dp.is_main():
            return
        gen = torch.Generator(device=self.device).manual_seed(SAMPLE_SEED)
        fake = self.system.sample(batch, generator=gen)
        self.writer.images(gstep, "fake_256", fake.float().cpu().numpy())
        real = batch["image"].cpu().numpy()
        if real.dtype == np.uint8:
            # normalise for display as the step does on the device
            real = real.astype(np.float32) * (2 / 255) - 1
        self.writer.images(gstep, "real_256", real)
