"""Layers with torch shapes and default inits and the JAX package's dtype
rules — counterpart of ``imagegenerator_tpu/ops/layers.py``.

Conv layers and blocks take NCHW tensors (``channels_last`` strides work
unchanged). Each layer holds f32 parameters and computes in its
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


def _uniform(shape, fan_in, *, device=None, generator=None) -> nn.Parameter:
    bound = 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.Parameter(t.uniform_(-bound, bound, generator=generator))


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
        dtype = self.dtype or x.dtype
        b = None if self.bias is None else self.bias.to(dtype)
        return conv_ops.conv2d(
            x.to(dtype), self.weight.to(dtype), b,
            stride=self.stride, padding=self.padding,
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
        dtype = self.dtype or x.dtype
        b = None if self.bias is None else self.bias.to(dtype)
        return conv_ops.conv_transpose2d(
            x.to(dtype), self.weight.to(dtype), b,
            stride=self.stride, padding=self.padding,
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
    """torch ``nn.BatchNorm2d`` semantics over NCHW channels: eps 1e-5,
    momentum 0.1 (flax's 0.9). As in flax, training mode normalises with
    the biased batch variance and also folds that biased variance into
    ``running_var``. Output dtype is ``dtype``, or ``promote(x, f32)``."""

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

    def forward(self, x):
        out_dtype = self.dtype or torch.promote_types(x.dtype, torch.float32)
        xf = x.float()
        if self.training:
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(out_dtype)


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
