"""Megatron tensor parallelism over a model group — counterpart of
``imagegenerator_tpu/parallel/tp.py``.

JAX writes TP as sharding annotations and lets GSPMD insert the
collectives; the port holds each rank's slice explicitly and calls the
collectives itself, with the same rules (``shard_dim``):

  * qkv / first-MLP weights (column-parallel): the output features are
    split, torch weight ``(out, in)`` along dim 0, their biases too;
  * attention-out / second-MLP weights (row-parallel): the input features
    are split, dim 1; their biases are added after the reduce and stay
    whole;
  * everything else (embeddings, LayerNorms, convolutions, small heads)
    is replicated.

Two autograd operators join the pieces (Megatron's *f* and *g*):
``copy_to_model`` is the identity forward and an all-reduce of the
gradient backward (before a column-parallel layer, whose input every rank
holds whole); ``reduce_from_model`` is an all-reduce forward and the
identity backward (after a row-parallel layer, whose partial products
sum to the whole). ``torch.distributed.nn.functional.all_reduce`` is not
*g*: its backward all-reduces as well. ``all_reduce_sum`` is a third,
self-adjoint one (an all-reduce both ways, built from itself, so a double
backward works): BatchNorm's moments over the data group, under the
gradient penalty's second-order term.

``ColumnDense`` and ``RowDense`` hold their rank's slice of a ``Dense``
under the same parameter names, so a ``state_dict`` keeps its keys.
``full_state_dict`` and ``gather`` put the slices back together (for a
checkpoint), ``shard_tensor`` takes a rank's slice of a whole tensor (on
resume).

With no group (a model axis of size 1) every operator is the identity.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# the JAX rule's parent names, as they appear in the port's parameter names
_COLUMN = ("attention.self.query", "attention.self.key", "attention.self.value", "intermediate.dense",
           "mlp.c_fc", "attn.in_proj")
_ROW = ("attention.output.dense", "output.dense", "attn.out_proj", "mlp.c_proj")


def shard_dim(name: str):
    """The dim of a port parameter (torch layout, by its ``state_dict``
    name) that tensor parallelism splits, or None where it is replicated:
    the Megatron rules of ``imagegenerator_tpu/parallel/tp.py:29-62``.
    CLIP's packed ``in_proj_weight`` / ``in_proj_bias`` count as the
    column-parallel ``in_proj``: dim 0, cut by head group within each of
    q, k and v (``v2/clip.py``), not into contiguous pieces."""
    parent, _, leaf = name.rpartition(".")
    if leaf in ("in_proj_weight", "in_proj_bias"):
        parent, leaf = f"{parent}.in_proj", leaf[len("in_proj_"):]
    if parent.endswith(_COLUMN) and leaf in ("weight", "bias"):
        return 0
    if parent.endswith(_ROW) and leaf == "weight":
        return 1
    return None


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's place in its model group: ``index`` of ``size``."""

    index: int
    size: int
    group: object = None

    def part(self, n: int) -> slice:
        if n % self.size:
            raise ValueError(f"{n} does not split over {self.size} model ranks")
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)


def _all_reduce(t, group):
    """The sum over ``group``, added in f32 for a narrower float (one
    rounding to its dtype, and no 16-bit sums asked of gloo)."""
    wide = (t.float() if t.dtype in (torch.bfloat16, torch.float16) else t.clone()).contiguous()
    if group is not None:
        dist.all_reduce(wide, group=group)
    return wide.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def copy_to_model(x, group):
    """*f*: identity forward, gradient all-reduced over ``group``."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """*g*: all-reduce over ``group`` forward, identity backward."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def all_reduce_sum(x, group):
    """The sum over ``group``, differentiable to any order (its backward
    is itself)."""
    return x if group is None else _AllReduceSum.apply(x, group)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.group, ctx.index, ctx.rows = group, index, x.shape[0]
        # a narrow float travels as f32 (exact), as the reduces do
        wide = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
        parts = [torch.empty_like(wide) for _ in range(size)]
        dist.all_gather(parts, wide.contiguous(), group=group)
        return torch.cat(parts).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        # every rank's loss reached every rank's rows: the rows' gradient
        # is the sum over the group
        grad = _all_reduce(grad, ctx.group)
        return grad[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], None, None, None


def all_gather_rows(x, group, index: int, size: int):
    """Every rank's ``x`` of the group concatenated along dim 0 in group
    order, differentiable: the gradient of a rank's rows is summed over
    the group's losses."""
    return x if group is None else _AllGatherRows.apply(x, group, index, size)


class ColumnDense(nn.Module):
    """A column-parallel ``Dense``: this rank's ``out / size`` output
    features (weight rows and bias). Computes in ``dtype or x.dtype``."""

    def __init__(self, dense, shard: ModelShard):
        super().__init__()
        self.dtype, self.shard = dense.dtype, shard
        part = shard.part(dense.weight.shape[0])
        self.weight = nn.Parameter(dense.weight.detach()[part].clone())
        self.bias = None if dense.bias is None else nn.Parameter(dense.bias.detach()[part].clone())

    def forward(self, x):
        dtype = self.dtype or x.dtype
        b = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), b)


class RowDense(nn.Module):
    """A row-parallel ``Dense``: this rank's ``in / size`` input features
    (weight columns); the partial products are summed over the model
    group (*g*) and then the whole bias is added."""

    def __init__(self, dense, shard: ModelShard):
        super().__init__()
        self.dtype, self.shard = dense.dtype, shard
        part = shard.part(dense.weight.shape[1])
        self.weight = nn.Parameter(dense.weight.detach()[:, part].clone())
        self.bias = None if dense.bias is None else nn.Parameter(dense.bias.detach().clone())

    def forward(self, x):
        dtype = self.dtype or x.dtype
        y = reduce_from_model(F.linear(x.to(dtype), self.weight.to(dtype)), self.shard.group)
        return y if self.bias is None else y + self.bias.to(dtype)


def shard_dense_layers(module, shard: ModelShard) -> int:
    """Replace, in place, each ``Dense`` of ``module`` that ``shard_dim``
    splits by a ``ColumnDense`` (dim 0) or a ``RowDense`` (dim 1) holding
    this rank's slice; returns how many were replaced."""
    from imagegenerator_tpu_torch.ops.layers import Dense

    found = [(name, sub) for name, sub in module.named_modules() if isinstance(sub, Dense)]
    replaced = 0
    for name, dense in found:
        dim = shard_dim(f"{name}.weight")
        if dim is not None:
            parent, _, leaf = name.rpartition(".")
            setattr(module.get_submodule(parent), leaf, (ColumnDense if dim == 0 else RowDense)(dense, shard))
            replaced += 1
    return replaced


def shard_tensor(t, dim, shard: ModelShard):
    """This rank's slice of a whole tensor along ``dim`` (None: all of it)."""
    if dim is None:
        return t
    index = [slice(None)] * t.dim()
    index[dim] = shard.part(t.shape[dim])
    return t[tuple(index)]


def gather(t, dim, shard: ModelShard):
    """The whole tensor from every model rank's slice along ``dim`` (a
    collective over the model group)."""
    if dim is None or shard.group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    dist.all_gather(parts, t.detach().contiguous(), group=shard.group)
    return torch.cat(parts, dim)


def sharded_keys(module) -> dict:
    """``state_dict`` key -> (dim, shard) of every sliced tensor of
    ``module``."""
    out = {}
    for name, sub in module.named_modules():
        if isinstance(sub, (ColumnDense, RowDense)):
            for leaf, t in (("weight", sub.weight), ("bias", sub.bias)):
                dim = 0 if isinstance(sub, ColumnDense) else (1 if leaf == "weight" else None)
                if t is not None and dim is not None:
                    out[f"{name}.{leaf}" if name else leaf] = (dim, sub.shard)
    return out


def sharded_params(module) -> dict:
    """``id(parameter)`` -> (dim, shard) of every sliced parameter of
    ``module`` (to find a parameter's optimizer moments or average)."""
    params = dict(module.named_parameters())
    return {id(params[k]): v for k, v in sharded_keys(module).items()}


def full_state_dict(module) -> dict:
    """``module.state_dict()`` with every slice gathered whole (a
    collective over each model group when ``module`` is sharded)."""
    sd = module.state_dict()
    for key, (dim, shard) in sharded_keys(module).items():
        sd[key] = gather(sd[key], dim, shard)
    return sd
