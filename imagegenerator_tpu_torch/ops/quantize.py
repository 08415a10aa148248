"""Straight-through vector quantization (the VQGAN codebook lookup) —
counterpart of ``imagegenerator_tpu/ops/quantize.py``.

Nearest-codebook lookup in the forward pass, identity gradient to the
continuous latent in the backward pass. Layout: channel-last ``(..., d)``.
"""

from __future__ import annotations

import torch

from imagegenerator_tpu_torch.ops.grad_utils import replace_grad
from imagegenerator_tpu_torch.ops.kernels import vq_argmin


def nearest_codebook_indices(x, codebook, *, use_kernel: bool | None = None):
    """``argmin_j ||x_i - c_j||^2`` over the last axis of ``x``: x
    ``(..., d)`` f32 or bf16, codebook ``(n, d)`` -> indices ``(...,)``
    int32, no gradient.

    ``use_kernel=None`` takes ``vq_argmin``: the hand-written kernel for
    a CUDA tensor, its plain version for a CPU tensor. ``False`` forces
    the plain version on either device. The JAX package's rule (its
    kernel only for 512 rows or more and d a multiple of 128) came from
    its own chip and is not carried."""
    with torch.no_grad():
        flat = x.detach().reshape(-1, x.shape[-1]).contiguous()
        cb = codebook.detach().float().contiguous()
        if use_kernel is False:
            idx = vq_argmin.vq_argmin_reference(flat, cb)
        else:
            idx = vq_argmin.vq_argmin(flat, cb)
    return idx.reshape(x.shape[:-1])


def vector_quantize(x, codebook, *, use_kernel: bool | None = None):
    """Value: the nearest codebook entry of each ``x[..., :]``, in x's
    dtype; gradient: identity with respect to ``x``, none to the
    codebook."""
    indices = nearest_codebook_indices(x, codebook, use_kernel=use_kernel)
    x_q = codebook.detach()[indices.long()].to(x.dtype)
    return replace_grad(x_q, x)
