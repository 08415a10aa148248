"""Data parallelism over ``torch.distributed`` — counterpart of
``imagegenerator_tpu/parallel/mesh.py``, written the torch way: one
process per card (``torchrun --nproc_per_node N``), each holding a whole
replica of the model and its own share of every batch.

Where the JAX package runs its step under ``shard_map`` over a ``data``
mesh and averages with ``lax.pmean``, the port's step takes a ``reduce``
callable and calls it at the same places (``all_reduce_mean``): the
critic's gradients before each critic update, the generator side's
gradients before its update, and the four metrics. The collectives are
explicit rather than ``DistributedDataParallel``'s hooks, which fit
neither the gradient penalty's double backward nor the several forwards
of one step. Nothing else is reduced: BatchNorm statistics stay per
replica, as in the JAX step (no SyncBatchNorm), and rank 0's are the ones
a checkpoint keeps.

The v2 CLI and the evaluation CLI split a batch over the ranks instead
(``torchrun`` with ``WORLD_SIZE`` > 1): ``gather_rows`` brings every
rank's rows to every rank for the one that writes the outputs, and
``all_reduce_sum`` adds float64 sums (the Fréchet moments, the score
sums) without falling to f32.

Without an initialised process group every function here is the single
process's: ``world() == 1``, ``rank() == 0``, ``all_reduce_mean``,
``all_reduce_sum``, ``gather_rows`` and ``barrier`` do nothing that
touches ``torch.distributed``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from imagegenerator_tpu_torch.utils.device import entry_device

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def backend_for(device_type: str, local_world_size: int, device_count: int) -> str:
    """The collective backend for ranks on ``device_type``: ``gloo`` on
    the CPU; on CUDA ``nccl`` when each of the host's ``local_world_size``
    ranks has a card of its own (``device_count`` cards to share out),
    else ``gloo``, since NCCL refuses two ranks on one device."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if local_world_size <= device_count else "gloo"


def init_from_env(device=None) -> torch.device:
    """Join the process group that ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and return this
    rank's device: ``cuda:LOCAL_RANK`` for None or ``"cuda"`` (one card
    per rank; a missing card raises), else ``device`` as named, which the
    host's ranks are taken to share (``--device cuda:0`` puts them all on
    one card). Prints the rank, the device and the backend chosen."""
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"data parallelism needs torchrun's environment; missing {missing}")
    r, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank, local_world = int(os.environ["LOCAL_RANK"]), int(os.environ["LOCAL_WORLD_SIZE"])
    own_card = device is None or str(device) == "cuda"
    dev = entry_device(f"cuda:{local_rank}" if own_card else device)
    count = 0
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {r}: {dev} asked for, {torch.cuda.device_count()} card(s) here")
        torch.cuda.set_device(dev)
        count = torch.cuda.device_count() if own_card else 1
    backend = backend_for(dev.type, local_world, count)
    why = {"gloo": "the CPU" if dev.type != "cuda" else f"{local_world} ranks share {count} card(s)",
           "nccl": "one card per rank"}[backend]
    print(f"[dp] rank {r} of {n} (local {local_rank} of {local_world}) on {dev}: backend {backend} ({why})",
          flush=True)
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        world_size=n, rank=r,
    )
    return dev


def _buckets(tensors):
    """The tensors grouped by (device, dtype), in order."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    return groups.values()


def _flat(group):
    return torch.cat([t.reshape(-1) for t in group])


def _unflatten_into(flat, group) -> None:
    at = 0
    for t in group:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()


def all_reduce_mean(tensors, group=None) -> None:
    """Average ``tensors`` over the ranks (of ``group``, where given: a
    grid's data group), in place: one flat bucket per (device, dtype), one
    ``all_reduce`` per bucket, then a division by the group's size. Every
    rank ends with the same bits. At world size 1 it returns at once."""
    n = world() if group is None else dist.get_world_size(group)
    if n == 1:
        return
    for bucket in _buckets(tensors):
        flat = _flat(bucket)
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        _unflatten_into(flat, bucket)


def broadcast_state(modules, optimizers=(), src: int = 0, grid=None) -> None:
    """Copy rank ``src``'s parameters and buffers of ``modules``, and the
    state tensors of ``optimizers`` (Adam's moments and counts), to every
    rank, one bucket per (device, dtype). Optimizer state that is not made
    yet (before the first step) is left alone; the ranks hold the same
    structure, since they take the same steps. On a ``grid``
    (``parallel/mesh.py``) whose model axis splits tensors, a slice and its
    moments go within the data group, from its data index 0, and only the
    whole tensors from ``src``. At world size 1 it returns at once."""
    if world() == 1:
        return
    from imagegenerator_tpu_torch.parallel import tp

    sliced = set()
    if grid is not None and grid.model > 1:
        for m in modules:
            sliced |= set(tp.sharded_params(m))
    whole, parts = [], []
    for m in modules:
        for t in (*m.parameters(), *m.buffers()):
            (parts if id(t) in sliced else whole).append(t)
    for opt in optimizers:
        for p, state in opt.state.items():
            for v in state.values():
                if torch.is_tensor(v):
                    (parts if id(p) in sliced and v.dim() else whole).append(v)
    _broadcast(whole, src, None)
    if parts and grid.data_group is not None:
        _broadcast(parts, grid.model_index, grid.data_group)


def _broadcast(tensors, src, group) -> None:
    with torch.no_grad():
        for bucket in _buckets(tensors):
            flat = _flat(bucket)
            if flat.device.type == "cpu" and dist.get_backend() == "nccl":
                # Adam's step counts live on the CPU, which NCCL cannot reach:
                # they travel through this rank's card
                on_card = flat.to(torch.cuda.current_device())
                dist.broadcast(on_card, src, group=group)
                flat = on_card.cpu()
            else:
                dist.broadcast(flat, src, group=group)
            _unflatten_into(flat, bucket)


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def _collective_device() -> torch.device:
    """Where this rank's collectives run: its card under NCCL, which
    cannot reach host memory, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_rows(a) -> np.ndarray:
    """Every rank's ``a`` (a tensor or an array of the same shape on each
    rank) concatenated along its first axis in rank order, as a numpy
    array on every rank. At world size 1, ``a`` as numpy."""
    t = a.detach() if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
    if world() == 1:
        return t.cpu().numpy()
    t = t.to(_collective_device()).contiguous()
    parts = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(parts, t)
    return torch.cat(parts).cpu().numpy()


def all_reduce_sum(*arrays) -> list:
    """The element-wise sums over the ranks of float64 ``arrays`` (numpy,
    any shapes), in one ``all_reduce`` of one float64 buffer. At world
    size 1, copies of ``arrays``."""
    flat = np.concatenate([np.asarray(a, np.float64).reshape(-1) for a in arrays])
    if world() > 1:
        t = torch.from_numpy(flat).to(_collective_device())
        dist.all_reduce(t)
        flat = t.cpu().numpy()
    out, at = [], 0
    for a in arrays:
        shape = np.shape(a)
        n = int(np.prod(shape, dtype=np.int64))
        out.append(flat[at:at + n].reshape(shape).copy())
        at += n
    return out


def check_same_on_all_ranks(value: int, what: str) -> None:
    """Raise on every rank unless each holds the same ``value`` (a step
    count: a rank that took one step more than another would hang in a
    collective)."""
    if world() == 1:
        return
    t = torch.tensor([value, -value], dtype=torch.int64, device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    high, low = int(t[0]), -int(t[1])
    if high != low:
        raise RuntimeError(f"rank {rank()}: {what} differ across ranks ({low} to {high}, this rank {value})")


def local_batch_size(global_batch: int, n: int | None = None) -> int:
    """A global batch's share per rank; it must divide evenly."""
    n = world() if n is None else n
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} ranks")
    return global_batch // n
