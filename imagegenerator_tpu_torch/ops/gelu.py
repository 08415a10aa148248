"""Exact-erf GELU whose backward recovers the normal CDF from the saved
output — counterpart of ``imagegenerator_tpu/ops/gelu.py``.

The forward is erf GELU, ``h = y * Phi(y)``. The backward needs
``Phi(y) + y * phi(y)``; it takes ``Phi = h / y`` from the saved output
instead of evaluating erf again, with the series ``Phi ~ 0.5 + phi(0) y``
for ``|y| < 1/32`` (no 0/0), and computes in f32 before casting to y's
dtype. This is elementwise work for PyTorch's own ops, not a kernel of
the TPU package, so no hand kernel stands behind it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_INV_SQRT_2PI = 0.3989422804014327  # phi(0) = 1 / sqrt(2 pi)


class _GeluOutputBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        h = F.gelu(y)
        ctx.save_for_backward(y, h)
        return h

    @staticmethod
    def backward(ctx, g):
        y, h = ctx.saved_tensors
        yf, hf = y.float(), h.float()
        phi = torch.exp(yf * yf * -0.5) * _INV_SQRT_2PI
        small = yf.abs() < 0.03125
        cdf = torch.where(small, 0.5 + _INV_SQRT_2PI * yf, hf / torch.where(small, 1.0, yf))
        return (g.float() * (cdf + yf * phi)).to(y.dtype)


def gelu_exact_output_bwd(y):
    """Exact-erf GELU; the backward recovers Phi from the saved output."""
    return _GeluOutputBwd.apply(y)
