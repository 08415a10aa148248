"""2-D convolutions with PyTorch padding semantics, on NCHW tensors.

Counterpart of ``imagegenerator_tpu/ops/conv.py``. The JAX package kept
torch's shape rules on NHWC/HWIO layouts; here the layouts are torch's
own, so the ops are ``F.conv2d``/``F.conv_transpose2d``. The JAX package
left its convs to XLA rather than to a kernel of its own, and the port
leaves them to cuDNN.

``conv2d`` runs through two ``autograd.Function``s where autograd records
it, so that the WGAN-GP penalty's second order is written out. Its
forward is ``F.conv2d``; its backward is ``aten.convolution_backward``
for the gradients the engine will use (what ``F.conv2d``'s autograd node
calls, so the first order is ``F.conv2d``'s bit for bit), under
``create_graph`` through ``_Conv2dGrad``, whose own backward is the
second order: the gradient of ``gy`` is ``conv2d(ggx, w)``, those of
``w`` and ``x`` cuDNN's wgrad and dgrad. aten's
``_convolution_double_backward`` forms the weight term as a convolution
whose filter is the whole gradient map, which cuDNN runs on generic
Ampere kernels: in a stage-2 step at batch 256 that took about 140 ms of
the critics' first layers. The Functions save what aten's nodes save (x
and w; then gy, x and w) and allocate nothing but their outputs. A call
autograd does not record is ``F.conv2d`` itself, and a backward without
``create_graph`` calls aten directly: each Python Function costs the host
tens of microseconds a call, which the launch-bound stage-1 step feels.

Kernel layouts and the mapping from the JAX package's:
  * ``conv2d``:           ``(out, in, kh, kw)`` = HWIO ``.transpose(3, 2, 0, 1)``
  * ``conv_transpose2d``: ``(in, out, kh, kw)`` = JAX ``(kh, kw, out, in)``
    ``.transpose(3, 2, 0, 1)``
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable


_CONVOLUTION_BACKWARD = torch.ops.aten.convolution_backward.default


def _mask(ctx) -> list:
    """Which of ``(x, w, b)``'s gradients the running backward needs:
    those that require grad and whose node the engine will run (as aten's
    own nodes ask, so that the penalty's ``autograd.grad`` in the input
    alone computes no weight gradient). A leaf's gradient counts as
    wanted: the engine cannot say during ``autograd.grad``, so where the
    weight is the parameter itself (no cast: compute dtype = parameter
    dtype, not channels-last) the penalty's first pass forms a weight
    gradient it does not use. ``torch._C._will_engine_execute_node`` is
    private (written against torch 2.11 and 2.13, where it raises on a
    leaf that ``autograd.grad`` was asked for);
    ``tests/test_torch_conv.py`` holds both cases."""
    wanted = ctx.needs_input_grad
    nodes = ctx.next_functions
    mask = [False, False, False]
    for i in range(2 + ctx.has_bias):
        node = nodes[i][0]
        if wanted[i] and node is not None:
            mask[i] = hasattr(node, "variable") or torch._C._will_engine_execute_node(node)
    return mask


def _backward(gy, x, w, stride, padding, mask):
    """``(gx, gw, gb)`` of ``aten.convolution_backward`` (cuDNN's dgrad and
    wgrad on the card), None where ``mask`` says no."""
    gx, gw, gb = _CONVOLUTION_BACKWARD(gy, x, w, [w.shape[0]] if mask[2] else None, [stride, stride],
                                       [padding, padding], [1, 1], False, [0, 0], 1, mask)
    return gx if mask[0] else None, gw if mask[1] else None, gb if mask[2] else None


class _Conv2d(torch.autograd.Function):
    """``y = F.conv2d(x, w, b)``; backward by ``_Conv2dGrad`` where the
    engine records it (``create_graph``), else by ``_backward`` itself."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding, ctx.has_bias = stride, padding, b is not None
        return F.conv2d(x, w, b, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        if torch.is_grad_enabled():
            gx, gw, gb = _Conv2dGrad.apply(gy, x, w, ctx.stride, ctx.padding, _mask(ctx))
        else:
            gx, gw, gb = _backward(gy, x, w, ctx.stride, ctx.padding, _mask(ctx))
        return gx, gw, gb, None, None


class _Conv2dGrad(torch.autograd.Function):
    """``(gx, gw, gb)`` of ``_Conv2d`` from ``gy``, and its own backward,
    the gradient penalty's second order: with ``ggx``, ``ggw``, ``ggb`` the
    upstream gradients of ``gx``, ``gw``, ``gb``,

    * ``d/dgy = conv2d(ggx, w) + conv2d(x, ggw) + ggb`` (forward
      convolutions of the layer's geometry),
    * ``d/dx = dgrad(gy, ggw)``, ``d/dw = wgrad(gy, ggx)``
      (``aten.convolution_backward``),

    the terms of aten's ``_convolution_double_backward``, which forms the
    weight term as a convolution whose filter is the whole map."""

    @staticmethod
    def forward(ctx, gy, x, w, stride, padding, mask):
        ctx.save_for_backward(gy, x, w)
        ctx.stride, ctx.padding = stride, padding
        ctx.set_materialize_grads(False)
        return _backward(gy, x, w, stride, padding, mask)

    @staticmethod
    @once_differentiable
    def backward(ctx, ggx, ggw, ggb):
        gy, x, w = ctx.saved_tensors
        s, p = ctx.stride, ctx.padding
        dgy = dx = dw = None
        if ctx.needs_input_grad[0]:
            terms = []
            if ggx is not None:
                terms.append(F.conv2d(ggx.to(x.dtype), w, None, stride=s, padding=p))
            if ggw is not None:
                terms.append(F.conv2d(x, ggw.to(w.dtype), None, stride=s, padding=p))
            if ggb is not None:
                terms.append(ggb.to(gy.dtype)[None, :, None, None].expand(gy.shape))
            if terms:
                dgy = terms[0]
                for t in terms[1:]:
                    dgy = dgy + t
        if ctx.needs_input_grad[1] and ggw is not None:
            dx = _backward(gy, x, ggw.to(w.dtype), s, p, [True, False, False])[0]
        if ctx.needs_input_grad[2] and ggx is not None:
            dw = _backward(gy, ggx.to(x.dtype), w, s, p, [False, True, False])[1]
        return dgy, dx, dw, None, None, None


def conv2d(x, w, b=None, *, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Output spatial size ``(in + 2p - k) // s + 1``; ``F.conv2d`` through
    ``_Conv2d``, differentiable twice (the module's head), where autograd
    records the call; ``F.conv2d`` itself where it does not."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or (b is not None and b.requires_grad)):
        return _Conv2d.apply(x, w, b, stride, padding)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def conv_transpose2d(x, w, b=None, *, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Output spatial size ``(in - 1) * s - 2p + k`` (no output padding or
    dilation; the models never use them)."""
    return F.conv_transpose2d(x, w, b, stride=stride, padding=padding)
