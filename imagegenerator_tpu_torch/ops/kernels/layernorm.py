"""Row LayerNorm with f32 statistics, forward and backward.

Replaces ``imagegenerator_tpu/ops/pallas/layernorm.py``: ``_call_fwd``
(kernel ``_fwd_kernel``) and ``_bwd`` (kernel ``_bwd_kernel``), which BERT
reaches through ``fused_layernorm`` when ``BertConfig.fused_ln`` is set.
On a CUDA tensor ``layernorm_fwd`` launches the hand-written kernel in
``csrc/layernorm_fwd.cu`` (CUDA C++ for ``sm_90a``, built by ``_build``
and called through ``ctypes``) and ``layernorm_bwd`` two Triton kernels
(``_layernorm_bwd_kernel`` then ``_layernorm_bwd_reduce_kernel``); on a
CPU tensor they run ``layernorm_reference`` and
``layernorm_bwd_reference``, the plain PyTorch versions of the same
functions. ``fused_layernorm`` is a ``torch.autograd.Function`` whose
forward saves what the TPU custom VJP saves (x, mean, rstd, scale, bias).

What bounds them on the card: bytes. There is no product for the tensor
cores: a row reduction or two and elementwise terms. The forward reads x
once and writes y once. ``fwd_route`` names its kernel: ``"warp"`` (one
warp per row, the row in registers, both reductions by shuffles) for
D <= 1024 in whole 16-byte pieces with f32 scale and bias, ``"block"``
(one block per row) for every other width and type. At BERT's shapes the
forward is a few microseconds on the card, so its cost to a caller is
the launch, and ``layernorm_fwd`` keeps the host's share small: one C
entry point bound once, the stream read as a raw handle, ``mean`` and
``rstd`` cut from one allocation, and no device context unless the
tensor lies on another card than the current one. The backward reads
(dy, x, mean, rstd) once and writes dx: a program walks ``ROWS`` rows,
computing dx row by row and summing its rows' ``dy * xhat`` and ``dy``
in registers into one partial (dgamma, dbeta) row in an ``(n_blocks,
D)`` f32 buffer; a second small kernel sums the partials over the
blocks. On the TPU the sequential grid carried the sum in VMEM; blocks
on Hopper run in no order, hence the second pass. The plain versions
make a separate pass over device memory for each elementwise step and
reduction.

Numerics follow the TPU kernels: statistics in f32 whatever x's dtype,
the two-pass variance ``mean((x - mean)^2)``, output in
``promote(x.dtype, scale.dtype)`` and ``mean, rstd (N, 1)`` in f32;
``dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))`` in x's
dtype, dgamma and dbeta summed in f32 and cast to the dtypes of scale and
bias. The TPU's ``D % 128`` rule does not apply here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from imagegenerator_tpu_torch.ops.kernels import _build

# Kernel launches so far; the wrappers add one per launch and nothing else
# does (``bwd_launches``: one per backward, its two Triton kernels
# together). Set them to 0 to count a run.
launches = 0
bwd_launches = 0

# the C entry point's dtype codes
_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_OUT_DTYPE = {(a, b): torch.promote_types(a, b) for a in _IN_DTYPES for b in _IN_DTYPES}
WARP_MAX_D = 1024  # the warp route holds a row in 32 lanes x 32 registers
WARP_ROWS = 4  # rows, one warp each, per block of the warp route
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
    """The jitted backward kernels ``(bwd, bwd_reduce)``. Triton is
    imported, and the kernels decorated, here at first launch, so this
    module imports where Triton is absent; the kernels' ``tl`` is this
    module's global, bound by the import."""
    global tl
    import triton
    import triton.language as tl

    return triton.jit(_layernorm_bwd_kernel), triton.jit(_layernorm_bwd_reduce_kernel)


@functools.cache
def _fwd_entry():
    """``(fn, raw_stream)``: the C entry point of ``csrc/layernorm_fwd.cu``,
    built at first use and bound once, and ``_build.raw_stream()``."""
    fn = _build.library("layernorm_fwd").layernorm_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn, _build.raw_stream()


@functools.cache
def fwd_route(d: int, x_dtype, scale_dtype, bias_dtype, aligned: bool = True) -> str:
    """Which forward kernel a CUDA call takes: ``"warp"`` for a row that
    32 lanes hold in registers as whole 16-byte pieces (``d <= 1024``, a
    multiple of 4 for f32 x and of 8 for bf16 or f16 x) with f32 scale and
    bias (so y is f32) and 16-byte ``aligned`` x, scale and bias; else
    ``"block"``."""
    piece = 4 if x_dtype == torch.float32 else 8
    if (
        aligned and d <= WARP_MAX_D and d % piece == 0
        and scale_dtype == torch.float32 and bias_dtype == torch.float32
    ):
        return "warp"
    return "block"


def _check_cuda(x2, scale, bias):
    """Raise on what the kernels do not take. Every launch pays for this,
    so it reads attributes and compares integers: no ``torch.Size`` or
    ``torch.device`` is made unless a check fails."""
    n, d = x2.shape
    if x2.dtype not in _IN_DTYPES or not x2.is_contiguous():
        raise ValueError(
            f"layernorm: x must be contiguous {tuple(_IN_DTYPES)}, got {x2.dtype}"
        )
    index = x2.get_device()
    for t in (scale, bias):
        if not (
            t.dim() == 1 and t.numel() == d and t.is_cuda and t.get_device() == index
            and t.is_contiguous() and t.dtype in _IN_DTYPES
        ):
            name = "scale" if t is scale else "bias"
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


@functools.cache
def fwd_codes(x_dtype, scale_dtype, bias_dtype, route: str) -> int:
    """The C entry point's ``codes`` argument: two bits each, from the
    lowest, for the dtype codes of x, scale, bias and y and for the route
    (1 for ``"warp"``)."""
    y_dtype = _OUT_DTYPE[x_dtype, scale_dtype]
    fields = (_IN_DTYPES[x_dtype], _IN_DTYPES[scale_dtype], _IN_DTYPES[bias_dtype],
              _IN_DTYPES[y_dtype], 1 if route == "warp" else 0)
    return sum(field << (2 * i) for i, field in enumerate(fields))


@functools.cache
def _fwd_plan(d: int, x_dtype, scale_dtype, bias_dtype, aligned: bool) -> int:
    """``fwd_codes`` of ``fwd_route``, one cached lookup a launch."""
    route = fwd_route(d, x_dtype, scale_dtype, bias_dtype, aligned)
    return fwd_codes(x_dtype, scale_dtype, bias_dtype, route)


def _new_empty(shape, dtype, x2, scale):
    """An uninitialised ``shape`` tensor of ``dtype`` on x2's device.
    ``new_empty`` of a tensor that already has the dtype costs the host
    about half of ``torch.empty`` with its ``dtype`` and ``device``
    keywords, and x2 or scale (on x2's device, checked) nearly always
    has it."""
    if x2.dtype == dtype:
        return x2.new_empty(shape)
    if scale.dtype == dtype:
        return scale.new_empty(shape)
    return torch.empty(shape, dtype=dtype, device=x2.device)


def _fwd_outputs(x2, scale):
    """``(y, mean, rstd)`` to be written: y like x2 in ``promote(x,
    scale)``; mean and rstd the two contiguous ``(n, 1)`` f32 halves of
    one ``(2, n, 1)`` allocation, the means first."""
    dtype = _OUT_DTYPE[x2.dtype, scale.dtype]
    y = torch.empty_like(x2) if dtype == x2.dtype else _new_empty(x2.shape, dtype, x2, scale)
    mean, rstd = _new_empty((2, x2.shape[0], 1), torch.float32, x2, scale).unbind(0)
    return y, mean, rstd


def layernorm_fwd(x2, scale, bias, eps: float):
    """``(y, mean, rstd)`` of the forward on ``x2 (N, D)``, the outputs of
    ``_call_fwd``: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if not x2.is_cuda and _device(x2) == "cpu":
        return layernorm_reference(x2, scale, bias, eps)
    _check_cuda(x2, scale, bias)
    global launches
    n, d = x2.shape
    y, mean, rstd = _fwd_outputs(x2, scale)
    if n == 0:
        return y, mean, rstd
    fn, raw_stream = _fwd_entry()
    px, pw, pb = x2.data_ptr(), scale.data_ptr(), bias.data_ptr()
    codes = _fwd_plan(d, x2.dtype, scale.dtype, bias.dtype, (px | pw | pb) % 16 == 0)
    index = x2.get_device()
    args = (px, pw, pb, y.data_ptr(), mean.data_ptr(), n, d, eps, codes)  # rstd follows mean
    if index == torch.cuda.current_device():
        rc = fn(*args, raw_stream(index))
    else:  # a launch goes to the current device: make it the tensor's
        with torch.cuda.device(index):
            rc = fn(*args, raw_stream(index))
    if rc:
        _build.check(rc, "layernorm_fwd")
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
    bwd, reduce = _kernels()
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
