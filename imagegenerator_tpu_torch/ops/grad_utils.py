"""Gradient utilities of the v2 latent-optimization path — counterpart of
``imagegenerator_tpu/ops/grad_utils.py``.

* ``replace_grad(x_forward, x_backward)`` returns ``x_forward``; the
  backward routes the whole cotangent to ``x_backward``, summed down to
  its shape, and none to ``x_forward``.
* ``clamp_with_grad(x, lo, hi)`` clamps in the forward; the backward keeps
  a gradient component only where it does not push the value further out
  of range: ``g * (x - clamp(x)) >= 0``.
* ``clip(x, lo, hi)`` — a clamp with the gradient ``jnp.clip`` has: 1
  inside the range, 0 outside, and one half where ``x`` sits exactly on
  a bound (JAX splits a tie of ``maximum``/``minimum`` evenly;
  ``torch.clamp`` passes the whole gradient there). The images of the v2
  path are clamped to [0, 1] upstream, so saturated pixels sit exactly
  on a bound and the difference is not a corner case.
"""

from __future__ import annotations

import torch


def _sum_to_shape(x, shape):
    """Reduce ``x`` to ``shape`` by summing its broadcast axes."""
    ndiff = x.ndim - len(shape)
    if ndiff > 0:
        x = x.sum(dim=tuple(range(ndiff)))
    axes = tuple(i for i, s in enumerate(shape) if s == 1 and x.shape[i] != 1)
    if axes:
        x = x.sum(dim=axes, keepdim=True)
    return x.reshape(shape)


class _ReplaceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_forward, x_backward):
        ctx.shape = x_backward.shape
        ctx.dtype = x_backward.dtype
        return x_forward.view_as(x_forward)

    @staticmethod
    def backward(ctx, g):
        return None, _sum_to_shape(g, ctx.shape).to(ctx.dtype)


def replace_grad(x_forward, x_backward):
    return _ReplaceGrad.apply(x_forward, x_backward)


class _ClampWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        keep = g * (x - x.clamp(*ctx.bounds)) >= 0
        return g * keep.to(g.dtype), None, None


def clamp_with_grad(x, lo: float, hi: float):
    return _ClampWithGrad.apply(x, lo, hi)


class _Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = ((x >= lo) & (x <= hi)).to(g.dtype)
        on_bound = ((x == lo) | (x == hi)).to(g.dtype)
        return g * (inside - 0.5 * on_bound), None, None


def clip(x, lo: float, hi: float):
    return _Clip.apply(x, lo, hi)
