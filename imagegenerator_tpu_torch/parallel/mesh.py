"""A data x model grid of ranks over ``torch.distributed`` — counterpart of
``imagegenerator_tpu/parallel/mesh.py`` and of ``make_tp_mesh`` in
``imagegenerator_tpu/parallel/tp.py``.

JAX lays the devices out as ``devices.reshape(-1, tp)`` under the axes
``('data', 'model')``; here rank ``r`` sits at data index ``r // tp`` and
model index ``r % tp``, which is the same layout. A rank takes part in
two process groups: its *data group* (the ranks of its model index, one
per data index: gradients, BatchNorm statistics and metrics are averaged
there) and its *model group* (the ``tp`` ranks of its data index, which
hold one batch between them and split BERT's heads and MLP columns).
Every rank makes every group with ``new_group``, in the same order, as
``torch.distributed`` requires.

At world size 1 the grid is ``(1, 1)`` and has no groups; every
collective of ``parallel/tp.py`` is then the identity.
"""

from __future__ import annotations

import dataclasses
import functools

import torch.distributed as dist

from imagegenerator_tpu_torch.parallel import dp


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place on a ``data x model`` grid and its two groups
    (None where the axis has size 1: nothing to reduce over)."""

    data: int
    model: int
    rank: int
    data_group: object = None
    model_group: object = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def make_grid(tp: int) -> Grid:
    """The ``(world // tp, tp)`` grid over the initialised process group
    (or ``(1, 1)`` in one process). ``tp`` must divide the world size."""
    world, rank = dp.world(), dp.rank()
    if tp < 1 or world % tp:
        raise ValueError(f"--tp {tp} does not divide {world} devices")
    data = world // tp
    groups = {"data": None, "model": None}
    if world > 1:
        if not dist.is_initialized():
            raise RuntimeError("a grid over several ranks needs an initialised process group")
        # every rank makes every group, in one order
        for d in range(data):
            ranks = [d * tp + m for m in range(tp)]
            group = dist.new_group(ranks)
            if rank in ranks and tp > 1:
                groups["model"] = group
        for m in range(tp):
            ranks = [d * tp + m for d in range(data)]
            group = dist.new_group(ranks)
            if rank in ranks and data > 1:
                groups["data"] = group
    return Grid(data, tp, rank, groups["data"], groups["model"])


def local_batch_size(global_batch: int, grid: Grid) -> int:
    """A global batch's rows per data index (the model group shares them)."""
    if global_batch % grid.data:
        raise ValueError(f"global batch {global_batch} not divisible by {grid.data} data shards")
    return global_batch // grid.data


def data_mean(grid: Grid):
    """The grid step's ``reduce``: the mean over the data group, in place
    (nothing at data size 1, where the model peers hold different slices
    and must not be averaged)."""
    if grid.data_group is None:
        return lambda tensors: None
    return functools.partial(dp.all_reduce_mean, group=grid.data_group)
