"""Exponential moving average of the generator-side parameters —
counterpart of ``imagegenerator_tpu/train/ema.py``.

``ema = d * ema + (1 - d) * params`` per step over the trained modules
the sampling path reads; sampling from the average gives smoother, more
stable images. The average lives outside the system, on the trainer: the
train step is untouched, and a checkpoint of a run with EMA on stores it
as a side dict (``CheckpointManager.save_with_aux``).

An EMA is a dict ``{"<module>/<flax path>": tensor}`` in the parameters'
torch layout, over the JAX state's module names (stage 2:
``con_augment_2``, ``generator``). ``to_numpy`` / ``from_numpy`` carry it
to and from the JAX package's layout, the checkpoint's.
"""

from __future__ import annotations

import torch

from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.parallel import tp

# the trained modules each stage's ``sample`` reads (stage 2 samples
# through the frozen stack, of which nothing trains)
STAGE1_MODULES = ("encoder", "projection", "con_augment", "generator")
STAGE2_MODULES = ("con_augment_2", "generator")


def modules_for_stage(stage: int) -> tuple:
    return STAGE1_MODULES if stage == 1 else STAGE2_MODULES


def tracked(system, modules) -> dict:
    """``{"<module>/<path>": (parameter, layout)}`` of the parameters of
    ``modules``."""
    return {f"{m}/{path}": (p, layout) for m, p, path, layout in convert.param_entries(system)
            if m in modules}


def init_ema(system, modules) -> dict:
    """A fresh EMA: a copy of the tracked parameters (a real copy, the
    optimizers update the parameters in place)."""
    return {k: p.detach().clone() for k, (p, _) in tracked(system, modules).items()}


@torch.no_grad()
def update(ema: dict, system, decay: float) -> None:
    """``e = e * decay + p * (1 - decay)``, in place, in the EMA's dtype."""
    live = tracked(system, {k.split("/", 1)[0] for k in ema})
    es = list(ema.values())
    ps = [live[k][0].detach().to(e.dtype) for k, e in ema.items()]
    torch._foreach_mul_(es, decay)
    torch._foreach_add_(es, ps, alpha=1.0 - decay)


@torch.no_grad()
def swap_in(system, ema: dict) -> None:
    """Put the averages in place of the tracked parameters (for sampling;
    the system must not be trained further)."""
    live = tracked(system, {k.split("/", 1)[0] for k in ema})
    for k, e in ema.items():
        live[k][0].copy_(e)


def to_numpy(ema: dict, system) -> dict:
    """The EMA in the JAX package's layout, keyed as it is. The averages
    of a system split over a model group are gathered whole (every rank of
    the group calls it)."""
    live = tracked(system, {k.split("/", 1)[0] for k in ema})
    sliced = tp.sharded_params(system)
    out = {}
    for k, e in ema.items():
        p, layout = live[k]
        out[k] = convert.to_flax(tp.gather(e, *sliced.get(id(p), (None, None))), layout)
    return out


def shard(ema: dict, system) -> dict:
    """A whole EMA (of the system before ``Stage1System.shard``) cut to the
    slices the sharded ``system`` holds."""
    live = tracked(system, {k.split("/", 1)[0] for k in ema})
    sliced = tp.sharded_params(system)
    return {k: tp.shard_tensor(e, *sliced.get(id(live[k][0]), (None, None))).clone()
            for k, e in ema.items()}


def from_numpy(flat: dict, system, device=None) -> dict:
    """The inverse of ``to_numpy``; every key must name a parameter of
    ``system``."""
    live = tracked(system, {k.split("/", 1)[0] for k in flat})
    return {k: convert.to_torch(v, live[k][1], device) for k, v in flat.items()}
