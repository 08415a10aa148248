"""Row LayerNorm with f32 statistics, forward and backward.

Replaces ``imagegenerator_tpu/ops/pallas/layernorm.py``: ``_call_fwd``
(kernel ``_fwd_kernel``) and ``_bwd`` (kernel ``_bwd_kernel``), which BERT
reaches through ``fused_layernorm`` when ``BertConfig.fused_ln`` is set.
On a CUDA tensor the wrappers launch Triton kernels
(``_layernorm_fwd_kernel``; ``_layernorm_bwd_kernel`` then
``_layernorm_bwd_reduce_kernel``); on a CPU tensor they run
``layernorm_reference`` and ``layernorm_bwd_reference``, the plain
PyTorch versions of the same functions. ``fused_layernorm`` is a
``torch.autograd.Function`` whose forward saves what the TPU custom VJP
saves (x, mean, rstd, scale, bias).

What bounds them on the card: bytes. There is no product for the tensor
cores: a row reduction or two and elementwise terms. The forward gives
each row one program holding the whole row (``BLOCK_D = next_pow2(D)``,
masked), so x is read from device memory once and both reductions run on
registers. The backward reads (dy, x, mean, rstd) once and writes dx: a
program walks ``ROWS`` rows, computing dx row by row and summing its
rows' ``dy * xhat`` and ``dy`` in registers into one partial (dgamma,
dbeta) row in an ``(n_blocks, D)`` f32 buffer; a second small kernel sums
the partials over the blocks. On the TPU the sequential grid carried the
sum in VMEM; blocks on Hopper run in no order, hence the second pass.
The plain versions make a separate pass over device memory for each
elementwise step and reduction.

Numerics follow the TPU kernels: statistics in f32 whatever x's dtype,
the two-pass variance ``mean((x - mean)^2)``, output in
``promote(x.dtype, scale.dtype)`` and ``mean, rstd (N, 1)`` in f32;
``dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))`` in x's
dtype, dgamma and dbeta summed in f32 and cast to the dtypes of scale and
bias. The TPU's ``D % 128`` rule does not apply here.
"""

from __future__ import annotations

import functools

import torch

# Kernel launches so far; the wrappers add one per launch and nothing else
# does (``bwd_launches``: one per backward, its two Triton kernels
# together). Set them to 0 to count a run.
launches = 0
bwd_launches = 0

_IN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
BWD_ROWS = 64  # rows per backward program: one partial (dgamma, dbeta) row each


def layernorm_reference(x2, scale, bias, eps: float):
    """Plain PyTorch forward on a 2-D ``x2 (N, D)``: returns
    ``(y, mean, rstd)``."""
    xf = x2.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * scale.float() + bias.float()
    return y.to(torch.promote_types(x2.dtype, scale.dtype)), mean, rstd


def layernorm_bwd_reference(dy2, x2, mean, rstd, scale, bias):
    """Plain PyTorch backward, ``_bwd_kernel``'s math, on 2-D ``dy2, x2
    (N, D)``: returns ``(dx, dgamma, dbeta)``."""
    dy = dy2.float()
    xhat = (x2.float() - mean) * rstd
    dxhat = dy * scale.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    return (
        dx.to(x2.dtype),
        (dy * xhat).sum(dim=0).to(scale.dtype),
        dy.sum(dim=0).to(bias.dtype),
    )


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


def _layernorm_bwd_kernel(dy_ptr, x_ptr, mean_ptr, rstd_ptr, w_ptr, dx_ptr,
                          pw_ptr, pb_ptr, n, d, ROWS: tl.constexpr,
                          BLOCK_D: tl.constexpr):
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_D)
    keep = cols < d
    w = tl.load(w_ptr + cols, mask=keep, other=0.0).to(tl.float32)
    dw = tl.zeros((BLOCK_D,), dtype=tl.float32)
    db = tl.zeros((BLOCK_D,), dtype=tl.float32)
    for r in range(ROWS):
        row = pid * ROWS + r
        ok = row < n
        live = keep & ok
        dy = tl.load(dy_ptr + row * d + cols, mask=live, other=0.0).to(tl.float32)
        x = tl.load(x_ptr + row * d + cols, mask=live, other=0.0).to(tl.float32)
        mean = tl.load(mean_ptr + row, mask=ok, other=0.0)
        rstd = tl.load(rstd_ptr + row, mask=ok, other=0.0)
        xhat = tl.where(live, (x - mean) * rstd, 0.0)
        dxhat = dy * w
        m1 = tl.sum(dxhat, axis=0) / d
        m2 = tl.sum(dxhat * xhat, axis=0) / d
        tl.store(dx_ptr + row * d + cols, rstd * (dxhat - m1 - xhat * m2), mask=live)
        dw += dy * xhat
        db += dy
    tl.store(pw_ptr + pid * d + cols, dw, mask=keep)
    tl.store(pb_ptr + pid * d + cols, db, mask=keep)


def _layernorm_bwd_reduce_kernel(pw_ptr, pb_ptr, dw_ptr, db_ptr, n_blocks, d,
                                 BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
    keep = cols < d
    acc_w = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
    acc_b = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
    for r0 in range(0, n_blocks, BLOCK_R):
        rows = r0 + tl.arange(0, BLOCK_R)
        live = (rows[:, None] < n_blocks) & keep[None, :]
        offs = rows[:, None] * d + cols[None, :]
        acc_w += tl.load(pw_ptr + offs, mask=live, other=0.0)
        acc_b += tl.load(pb_ptr + offs, mask=live, other=0.0)
    tl.store(dw_ptr + cols, tl.sum(acc_w, axis=0), mask=keep)
    tl.store(db_ptr + cols, tl.sum(acc_b, axis=0), mask=keep)


@functools.cache
def _kernels():
    """The jitted kernels ``(fwd, bwd, bwd_reduce)``. Triton is imported,
    and the kernels decorated, here at first launch, so this module
    imports where Triton is absent; the kernels' ``tl`` is this module's
    global, bound by the import."""
    global tl
    import triton
    import triton.language as tl

    return tuple(triton.jit(f) for f in (
        _layernorm_fwd_kernel, _layernorm_bwd_kernel, _layernorm_bwd_reduce_kernel,
    ))


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


def _device(x2):
    if x2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"layernorm: no kernel for device {x2.device}")
    return x2.device.type


def _block(d):
    block = 1 << max(d - 1, 0).bit_length()
    return block, 4 if block <= 2048 else 8


def layernorm_fwd(x2, scale, bias, eps: float):
    """``(y, mean, rstd)`` of the forward on ``x2 (N, D)``, the outputs of
    ``_call_fwd``: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if _device(x2) == "cpu":
        return layernorm_reference(x2, scale, bias, eps)
    _check_cuda(x2, scale, bias)
    global launches
    n, d = x2.shape
    y = torch.empty(
        (n, d), dtype=torch.promote_types(x2.dtype, scale.dtype), device=x2.device
    )
    mean = torch.empty((n, 1), dtype=torch.float32, device=x2.device)
    rstd = torch.empty_like(mean)
    block, warps = _block(d)
    with torch.cuda.device(x2.device):
        _kernels()[0][(n,)](
            x2, scale, bias, y, mean, rstd, d, eps, BLOCK_D=block, num_warps=warps,
        )
    launches += 1
    return y, mean, rstd


def layernorm_bwd(dy2, x2, mean, rstd, scale, bias):
    """``(dx, dgamma, dbeta)`` of the backward on ``dy2, x2 (N, D)`` with
    the forward's ``mean, rstd (N, 1)``, the outputs of ``_bwd``: the
    kernels on a CUDA tensor, the plain version on a CPU tensor."""
    if _device(x2) == "cpu":
        return layernorm_bwd_reference(dy2, x2, mean, rstd, scale, bias)
    _check_cuda(x2, scale, bias)
    n, d = x2.shape
    if dy2.shape != (n, d) or dy2.dtype not in _IN_DTYPES or dy2.device != x2.device \
            or not dy2.is_contiguous():
        raise ValueError(f"layernorm: dy must be a contiguous float ({n}, {d}) tensor")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.shape != (n, 1) or t.dtype != torch.float32 or t.device != x2.device \
                or not t.is_contiguous():
            raise ValueError(f"layernorm: {name} must be contiguous f32 ({n}, 1)")
    global bwd_launches
    n_blocks = -(-n // BWD_ROWS)
    dx = torch.empty_like(x2)
    partial_w = torch.empty((n_blocks, d), dtype=torch.float32, device=x2.device)
    partial_b = torch.empty_like(partial_w)
    dgamma = torch.empty((d,), dtype=torch.float32, device=x2.device)
    dbeta = torch.empty_like(dgamma)
    block, warps = _block(d)
    _, bwd, reduce = _kernels()
    with torch.cuda.device(x2.device):
        bwd[(n_blocks,)](
            dy2, x2, mean, rstd, scale, dx, partial_w, partial_b, n, d,
            ROWS=BWD_ROWS, BLOCK_D=block, num_warps=warps,
        )
        reduce[(-(-d // 64),)](
            partial_w, partial_b, dgamma, dbeta, n_blocks, d,
            BLOCK_R=32, BLOCK_C=64, num_warps=4,
        )
    bwd_launches += 1
    return dx, dgamma.to(scale.dtype), dbeta.to(bias.dtype)


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y, mean, rstd = layernorm_fwd(x2, scale, bias, eps)
        ctx.save_for_backward(x2, mean, rstd, scale, bias)
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, mean, rstd, scale, bias = ctx.saved_tensors
        dy2 = dy.reshape(x2.shape).contiguous()
        dx, dgamma, dbeta = layernorm_bwd(dy2, x2, mean, rstd, scale, bias)
        return dx.reshape(dy.shape), dgamma, dbeta, None


def fused_layernorm(x, scale, bias, eps: float = 1e-12):
    """LayerNorm over the last axis of ``x`` (any leading shape) with
    ``(D,)`` scale and bias, differentiable in all three. Output dtype is
    ``promote(x, scale)``."""
    return _FusedLayerNorm.apply(x, scale, bias, eps)
