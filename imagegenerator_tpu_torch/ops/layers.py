"""Layers with torch shapes and default inits and the JAX package's dtype
rules — counterpart of ``imagegenerator_tpu/ops/layers.py``.

Conv layers and blocks take NCHW tensors in either memory format. A
conv whose input is channels-last takes its weight channels-last too, in
the copy that casts it, and returns channels-last; BatchNorm normalises
the ``(N*H*W, C)`` rows of its input, a view of a channels-last one, and
returns channels-last. Each layer holds f32 parameters and computes in its
``dtype``, or in the input's dtype when ``dtype`` is None, as the JAX
layers do. Parameters are drawn with torch's default laws, which
``imagegenerator_tpu/ops/init.py`` reproduces in JAX:
``U(+-1/sqrt(fan_in))`` for weights and biases, where a transposed
conv's fan-in is ``out * kh * kw``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from imagegenerator_tpu_torch.ops import conv as conv_ops
from imagegenerator_tpu_torch.ops.kernels import batchnorm
from imagegenerator_tpu_torch.parallel import tp as tp_ops

class statistics_frozen:
    """Training-mode BatchNorm layers normalise as usual but leave their
    running statistics alone: a forward that remat recomputes must not
    apply the momentum a second time. Reusable: a checkpointed forward
    under the gradient penalty's double backward is recomputed more than
    once."""

    writes = True

    def __enter__(self):
        self.before, statistics_frozen.writes = statistics_frozen.writes, False

    def __exit__(self, *exc):
        statistics_frozen.writes = self.before


def _uniform(shape, fan_in, *, device=None, generator=None) -> nn.Parameter:
    bound = 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.Parameter(t.uniform_(-bound, bound, generator=generator))


def _conv_operands(layer, x):
    """``(x, weight, bias)`` of a conv layer in its compute dtype. The
    weight takes the input's memory format: channels-last for a
    channels-last input (the cast's one copy lays it out; cuDNN would
    otherwise re-lay it on every call), as stored for any other."""
    dtype = layer.dtype or x.dtype
    cl = x.is_contiguous(memory_format=torch.channels_last)
    fmt = torch.channels_last if cl else torch.preserve_format
    b = None if layer.bias is None else layer.bias.to(dtype)
    return x.to(dtype), layer.weight.to(dtype, memory_format=fmt), b


class Conv2d(nn.Module):
    """torch ``nn.Conv2d(in, out, k, s, p)``; weight ``(out, in, k, k)``."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0,
                 use_bias=True, dtype=None, *, device=None, generator=None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        fan_in = in_ch * kernel_size * kernel_size
        kw = dict(device=device, generator=generator)
        self.weight = _uniform((out_ch, in_ch, kernel_size, kernel_size), fan_in, **kw)
        self.bias = _uniform((out_ch,), fan_in, **kw) if use_bias else None

    def forward(self, x):
        return conv_ops.conv2d(
            *_conv_operands(self, x), stride=self.stride, padding=self.padding,
        )


class ConvTranspose2d(nn.Module):
    """torch ``nn.ConvTranspose2d(in, out, k, s, p)``; weight
    ``(in, out, k, k)``."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0,
                 use_bias=True, dtype=None, *, device=None, generator=None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        fan_in = out_ch * kernel_size * kernel_size
        kw = dict(device=device, generator=generator)
        self.weight = _uniform((in_ch, out_ch, kernel_size, kernel_size), fan_in, **kw)
        self.bias = _uniform((out_ch,), fan_in, **kw) if use_bias else None

    def forward(self, x):
        return conv_ops.conv_transpose2d(
            *_conv_operands(self, x), stride=self.stride, padding=self.padding,
        )


class Dense(nn.Module):
    """torch ``nn.Linear``; weight ``(out, in)``. Computes in
    ``dtype or x.dtype``."""

    def __init__(self, in_features, out_features, use_bias=True, dtype=None,
                 *, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        self.weight = _uniform((out_features, in_features), in_features, **kw)
        self.bias = _uniform((out_features,), in_features, **kw) if use_bias else None

    def forward(self, x):
        dtype = self.dtype or x.dtype
        b = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), b)


class BatchNorm(nn.Module):
    """torch ``nn.BatchNorm2d`` semantics over NCHW channels, with a
    channels-last output whatever the input's layout: eps 1e-5,
    momentum 0.1 (flax's 0.9). As in flax's ``nn.BatchNorm``, training
    mode takes the biased batch variance by flax's fast formula,
    ``max(E[x^2] - E[x]^2, 0)`` in f32 over (N, H, W), normalises with it
    and folds it into ``running_var`` as ``0.9 * old + 0.1 * batch``.
    Output dtype is ``dtype``, or ``promote(x, f32)``.

    A CUDA tensor takes ``ops/kernels/batchnorm.py::batch_norm``: the
    hand-written kernels on the ``(N*H*W, C)`` rows, forward, backward and
    the gradient penalty's double backward. Any other tensor takes
    ``composition``, the same function as eager PyTorch ops differentiated
    by autograd, whose rounding the CPU parity tests and the benchmark's
    tiny cells hold to the JAX package and to the harness's reference;
    ``tests/test_torch_batchnorm.py`` holds the kernels' plain route to it.

    ``sync``, where set, is a process group (a grid's data group): the
    batch moments are then those of every rank's rows together, summed
    over the group by ``parallel/tp.py::all_reduce_sum`` (differentiable
    to the second order, which the gradient penalty takes; the kernels'
    route sums its backward's and double backward's moments the same way),
    as JAX's GSPMD step computes them over its one logical batch. Every
    rank holds ``x``'s number of rows and the same weight and bias."""

    eps = 1e-5
    momentum = 0.1

    def __init__(self, num_features, dtype=None, *, device=None):
        super().__init__()
        self.dtype = dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.ones(num_features, **f32))
        self.bias = nn.Parameter(torch.zeros(num_features, **f32))
        self.register_buffer("running_mean", torch.zeros(num_features, **f32))
        self.register_buffer("running_var", torch.ones(num_features, **f32))
        self.sync = None
        self.sync_size = 1

    def forward(self, x):
        if not x.is_cuda:
            return self.composition(x)
        return batchnorm.batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            training=self.training, update=self.training and statistics_frozen.writes,
            momentum=self.momentum, eps=self.eps,
            out_dtype=self.dtype or torch.promote_types(x.dtype, torch.float32),
            sync=self.sync, sync_size=self.sync_size,
        )

    def _moments(self, rows):
        """``(E[x], E[x^2])`` over the ``(N*H*W, C)`` rows, over the
        ``sync`` group's rows where set."""
        if self.sync is None:
            return rows.mean(dim=0), (rows * rows).mean(dim=0)
        sums = torch.stack([rows.sum(dim=0), (rows * rows).sum(dim=0)])
        sums = tp_ops.all_reduce_sum(sums, self.sync) / (rows.shape[0] * self.sync_size)
        return sums[0], sums[1]

    def composition(self, x):
        """The forward as eager PyTorch ops on f32 rows (float64 stays
        float64), differentiated by autograd (twice for the penalty)."""
        out_dtype = self.dtype or torch.promote_types(x.dtype, torch.float32)
        B, C, H, W = x.shape
        # the (N*H*W, C) rows are a view of a channels-last x, and every
        # tensor the backward and the penalty's double backward make of the
        # per-channel broadcasts is channels-last too: broadcast over NCHW
        # axes, they would come out NCHW, for autograd to add into the
        # channels-last gradients an element at a time
        rows = x.to(torch.promote_types(x.dtype, torch.float32)).permute(0, 2, 3, 1).reshape(-1, C)
        if self.training:
            mean, mean_sq = self._moments(rows)
            var = torch.clamp_min(mean_sq - mean * mean, 0.0)
        if self.training and statistics_frozen.writes:
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
                self.running_var.copy_(keep * self.running_var + self.momentum * var)
        if not self.training:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (rows - mean) * mul + self.bias
        return y.to(out_dtype).reshape(B, H, W, C).permute(0, 3, 1, 2)


class UpBlock(nn.Module):
    """ConvTranspose(k4) + BN + ReLU, the StackGAN upsampling block."""

    def __init__(self, in_ch, out_ch, kernel_size=4, stride=2, padding=1,
                 dtype=None, *, device=None, generator=None):
        super().__init__()
        self.ConvTranspose2d_0 = ConvTranspose2d(
            in_ch, out_ch, kernel_size, stride, padding, use_bias=False,
            dtype=dtype, device=device, generator=generator,
        )
        self.BatchNorm_0 = BatchNorm(out_ch, dtype=dtype, device=device)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.ConvTranspose2d_0(x)))


class DownBlock(nn.Module):
    """Conv(k4 s2 p1) + BN + LeakyReLU(0.1), the StackGAN downsampling
    block (slope 0.1, not torch's default 0.01)."""

    negative_slope = 0.1

    def __init__(self, in_ch, out_ch, kernel_size=4, stride=2, padding=1,
                 dtype=None, *, device=None, generator=None):
        super().__init__()
        self.Conv2d_0 = Conv2d(
            in_ch, out_ch, kernel_size, stride, padding, use_bias=False,
            dtype=dtype, device=device, generator=generator,
        )
        self.BatchNorm_0 = BatchNorm(out_ch, dtype=dtype, device=device)

    def forward(self, x):
        return F.leaky_relu(self.BatchNorm_0(self.Conv2d_0(x)), self.negative_slope)
