"""Row LayerNorm forward with f32 statistics.

Replaces ``imagegenerator_tpu/ops/pallas/layernorm.py::_call_fwd``
(kernel ``_fwd_kernel``), which BERT reaches through ``fused_layernorm``
when ``BertConfig.fused_ln`` is set. On a CUDA tensor the wrapper
launches a Triton kernel (``_layernorm_fwd_kernel``); on a CPU tensor it
runs ``layernorm_reference``, the plain PyTorch version of the same
function.

What bounds it on the card: bytes. Each row is read once and written
once, with one reduction for the mean and one for the variance, and no
product for the tensor cores. The kernel gives each row one program
holding the whole row (``BLOCK_D = next_pow2(D)``, masked), so x is read
from device memory once and both reductions run on registers; the plain
version makes a separate pass over device memory for each elementwise
step and reduction.

Numerics follow the TPU kernel: statistics in f32 whatever x's dtype, the
two-pass variance ``mean((x - mean)^2)``, output in
``promote(x.dtype, scale.dtype)`` and ``mean, rstd (N, 1)`` in f32. The
TPU's ``D % 128`` rule does not apply here.
"""

from __future__ import annotations

import functools

import torch

# Kernel launches so far; the wrapper adds one per launch and nothing else
# does. Set it to 0 to count a run.
launches = 0

_IN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def layernorm_reference(x2, scale, bias, eps: float):
    """Plain PyTorch version on a 2-D ``x2 (N, D)``: returns
    ``(y, mean, rstd)``."""
    xf = x2.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * scale.float() + bias.float()
    return y.to(torch.promote_types(x2.dtype, scale.dtype)), mean, rstd


def _layernorm_fwd_kernel(x_ptr, w_ptr, b_ptr, y_ptr, mean_ptr, rstd_ptr,
                          d, eps, BLOCK_D: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK_D)
    keep = cols < d
    x = tl.load(x_ptr + row * d + cols, mask=keep, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=0) / d
    xc = tl.where(keep, x - mean, 0.0)
    var = tl.sum(xc * xc, axis=0) / d
    rstd = 1.0 / tl.sqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=keep, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + cols, mask=keep, other=0.0).to(tl.float32)
    tl.store(y_ptr + row * d + cols, xc * rstd * w + b, mask=keep)
    tl.store(mean_ptr + row, mean)
    tl.store(rstd_ptr + row, rstd)


@functools.cache
def _kernel():
    """The jitted kernel. Triton is imported, and the kernel decorated,
    here at first launch, so this module imports where Triton is absent;
    the kernel's ``tl`` is this module's global, bound by the import."""
    global tl
    import triton
    import triton.language as tl

    return triton.jit(_layernorm_fwd_kernel)


def _check_cuda(x2, scale, bias):
    n, d = x2.shape
    if x2.dtype not in _IN_DTYPES or not x2.is_contiguous():
        raise ValueError(
            f"layernorm: x must be contiguous {_IN_DTYPES}, got {x2.dtype}"
        )
    for name, t in (("scale", scale), ("bias", bias)):
        if (
            t.shape != (d,) or t.device != x2.device or not t.is_contiguous()
            or t.dtype not in _IN_DTYPES
        ):
            raise ValueError(
                f"layernorm: {name} must be a contiguous float ({d},) "
                f"tensor on {x2.device}"
            )
    if n * d >= 2**31 or d > 65536:
        raise ValueError(f"layernorm: ({n}, {d}) is too large for the kernel")


def layernorm_fwd(x2, scale, bias, eps: float):
    """``(y, mean, rstd)`` of the forward on ``x2 (N, D)``, the outputs of
    ``_call_fwd``: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if x2.device.type == "cpu":
        return layernorm_reference(x2, scale, bias, eps)
    if x2.device.type != "cuda":
        raise ValueError(f"layernorm: no kernel for device {x2.device}")
    _check_cuda(x2, scale, bias)
    global launches
    n, d = x2.shape
    y = torch.empty(
        (n, d), dtype=torch.promote_types(x2.dtype, scale.dtype), device=x2.device
    )
    mean = torch.empty((n, 1), dtype=torch.float32, device=x2.device)
    rstd = torch.empty_like(mean)
    block = 1 << max(d - 1, 0).bit_length()
    with torch.cuda.device(x2.device):
        _kernel()[(n,)](
            x2, scale, bias, y, mean, rstd, d, eps,
            BLOCK_D=block, num_warps=4 if block <= 2048 else 8,
        )
    launches += 1
    return y, mean, rstd


def fused_layernorm(x, scale, bias, eps: float = 1e-12):
    """LayerNorm over the last axis of ``x`` (any leading shape) with
    ``(D,)`` scale and bias. Output dtype is ``promote(x, scale)``."""
    shape = x.shape
    y, _, _ = layernorm_fwd(x.reshape(-1, shape[-1]).contiguous(), scale, bias, eps)
    return y.reshape(shape)
