"""BatchNorm over the ``(N*H*W, C)`` rows of a channels-last map:
forward (training and eval mode), backward and double backward.

``ops/layers.py::BatchNorm`` reaches it through ``batch_norm``, whose
``torch.autograd.Function``s are ``_BatchNorm`` (``(x, weight, bias) ->
y``; it saves x in its own dtype and the per-channel ``(mean, rstd,
mask)``) and ``_BatchNormBackward`` (``(g, x, weight) -> (dx, dweight,
dbias)``), whose own backward is the double backward: given the upstream
gradients of ``(dx, dweight, dbias)`` it returns those of ``g``, ``x``
and ``weight``, the quantity aten's ``batchnorm_double_backward``
computes. So the gradient penalty's ``create_graph=True`` pass and the
critic's second-order term run through it too.

Each pass is a per-channel reduction (``batch_norm_sums``) and then one
elementwise pass (``batch_norm_fwd``, ``batch_norm_bwd``,
``batch_norm_double_bwd``). On a CUDA tensor they launch the hand-written
kernels of ``csrc/batch_norm_nhwc.cu`` (CUDA C++ for ``sm_90a``, built by
``_build`` and called through ``ctypes``; what bounds them and their
design: the head of that file); on any other tensor they run the
``*_reference`` functions, the plain PyTorch versions of the same
arithmetic. With ``sync`` (a process group, the TP grid's data group)
each pass's per-channel sums go through ``parallel/tp.py::all_reduce_sum``
between the two halves, in the forward, the backward and the double
backward alike; in eval mode no pass reads a group sum, and none runs.

The mathematics is the layer's: flax's fast variance ``max(E[x^2] -
E[x]^2, 0)`` over the rows (over the group's rows with ``sync``) in f32
(float64 stays float64 on the plain route), eps 1e-5, the running
statistics folded in as ``keep * old + momentum * batch`` in training
mode when asked (``update``), output in the caller's dtype. ``mask`` is
1 where ``E[x^2] - E[x]^2 >= 0`` and 0 where the clamp engages, where
the variance passes no gradient, as ``torch.clamp_min``'s backward has
it. Eval mode normalises with the running statistics: the elementwise
pass alone, and its gradients are the training formulas with every
``1 / M`` term and the mask at 0 (``inv = 0``).

With ``g`` the upstream gradient, ``x^ = (x - mean) * rstd``, ``u =
rstd * w``, ``M`` the rows over the group and ``m`` the mask:

* backward: ``dx = u * (g - S g / M - x^ * m * S(g x^) / M)``, ``dw =
  S g x^``, ``db = S g`` (``dw`` and ``db`` this rank's own sums);
* double backward, with ``gg``, ``ggw``, ``ggb`` the upstream gradients
  of ``dx``, ``dw``, ``db``: ``d/dg = u * gg + x^ * (ggw - u * m * S(gg
  x^) / M) + ggb - u * S gg / M``, ``d/dw = rstd * (S gg g - db * S gg /
  M - m * dw * S(gg x^) / M)``, and ``d/dx`` an affine form in ``(g,
  gg, x^)`` whose per-channel constants ``double_bwd_constants`` gives.

Dtypes: x and the output in bf16 or f32 on the card (any other dtype on
a CUDA tensor raises); weight, bias, running statistics, sums and
statistics in f32. ``fwd_launches``, ``bwd_launches`` and
``double_bwd_launches`` count the kernels each route launched: three a
training-mode pass (reduce, finalize, apply), one an eval-mode forward.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from imagegenerator_tpu_torch.ops.kernels import _build
from imagegenerator_tpu_torch.parallel import tp as tp_ops

# Kernel launches so far of the forward, backward and double backward
# routes: the reduction adds two (its blocks, then their sum), the
# elementwise pass one. Set them to 0 to count a run.
fwd_launches = 0
bwd_launches = 0
double_bwd_launches = 0

FWD, BWD, DBL = 0, 1, 2
SUMS = {FWD: 2, BWD: 2, DBL: 3}  # per-channel sums of each pass's reduction
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256  # a block of csrc/batch_norm_nhwc.cu
REDUCE_BLOCKS_PER_SM = 4
APPLY_BLOCKS_PER_SM = 8
ROWS_PER_REDUCE_BLOCK = 4  # row tiles a reduction block takes at the least


def rows(t):
    """The ``(N*H*W, C)`` rows of an NCHW map ``t``: a view of a
    channels-last one, else a contiguous copy."""
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1]).contiguous()


def _nchw(r, shape):
    """Rows ``(N*H*W, C)`` back to a channels-last NCHW view of ``shape``."""
    B, C, H, W = shape
    return r.view(B, H, W, C).permute(0, 3, 1, 2)


def _cdt(*ts):
    """The plain route's compute dtype: f32, or float64 for float64."""
    dtype = torch.float32
    for t in ts:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


# ---------------------------------------------------------------- plain versions
def batch_norm_sums_reference(mode, a, x=None, g=None, stats=None):
    """The per-channel sums of a pass over the rows, ``(K, C)``: FWD ``(S
    x, S x^2)`` of ``a = x``; BWD ``(S g, S g x^)`` of ``a = g``; DBL ``(S
    gg, S gg x^, S gg g)`` of ``a = gg``; ``stats`` the forward's."""
    if mode == FWD:
        r = a.to(_cdt(a))
        return torch.stack([r.sum(dim=0), (r * r).sum(dim=0)])
    dt = _cdt(a, x)
    av = a.to(dt)
    xh = (x.to(dt) - stats[0]) * stats[1]
    if mode == BWD:
        return torch.stack([av.sum(dim=0), (av * xh).sum(dim=0)])
    return torch.stack([av.sum(dim=0), (av * xh).sum(dim=0), (av * g.to(dt)).sum(dim=0)])


def batch_norm_fwd_reference(x, sums, weight, bias, running_mean, running_var, *, count, training,
                             update, eps, momentum, out_dtype):
    """``(y, stats)``: the forward's elementwise pass on rows x, in
    training mode from ``sums = (S x, S x^2)`` over ``count`` rows (with
    the running statistics' update when ``update``), else from the running
    statistics; ``stats (3, C) = (mean, rstd, mask)``."""
    r = x.to(_cdt(x))
    if training:
        mean, mean_sq = sums[0] / count, sums[1] / count
        diff = mean_sq - mean * mean
        var = torch.clamp_min(diff, 0.0)
        mask = (diff >= 0).to(diff.dtype)
        if update:
            with torch.no_grad():
                keep = 1.0 - momentum
                running_mean.copy_(keep * running_mean + momentum * mean)
                running_var.copy_(keep * running_var + momentum * var)
    else:
        mean, var = running_mean, running_var
        mask = torch.zeros_like(var)
    rstd = torch.rsqrt(var + eps)
    mul = rstd * weight
    y = (r - mean) * mul + bias
    return y.to(out_dtype), torch.stack([mean, rstd, mask])


def batch_norm_bwd_reference(g, x, stats, weight, sums, inv):
    """dx of the backward on rows ``g, x`` from ``sums = (S g, S g x^)``
    over the group; ``inv`` is ``1 / M`` in training, 0 in eval."""
    dt = _cdt(g, x)
    mean, rstd, mask = stats
    xh = (x.to(dt) - mean) * rstd
    dx = (rstd * weight) * (g.to(dt) - sums[0] * inv - xh * (mask * sums[1] * inv))
    return dx.to(x.dtype)


def double_bwd_constants(stats, weight, sums, bsums, ggw, ggb, inv):
    """The per-channel constants of the double backward's elementwise
    pass, ``(u, c1, c0, alpha, beta, gamma, delta)``: ``d/dg = u * gg + x^ *
    c1 + c0`` and ``d/dx = alpha * g + beta * gg + gamma * x^ + delta``.
    ``sums`` are ``(S gg, S gg x^, S gg g)`` over the group, and with
    ``ggw`` two more rows ``(S ggw g, S ggw g x^)``; ``bsums`` the
    backward's ``(S g, S g x^)`` over the group."""
    _, r, m = stats
    G, Gx, Ggg = sums[0], sums[1], sums[2]
    Sg, Sgx = bsums[0], bsums[1]
    zero = torch.zeros_like(r)
    gw = zero if ggw is None else ggw
    gb = zero if ggb is None else ggb
    Wg, Wgx = (zero, zero) if ggw is None else (sums[3], sums[4])
    u = r * weight
    c1 = gw - u * (m * Gx * inv)
    c0 = gb - u * (G * inv)
    k = m * weight * r * r * inv
    p3 = G * Sg * inv - Ggg + 3.0 * Sgx * Gx * inv
    alpha = -k * Gx + r * gw
    beta = -k * Sgx
    gamma = k * p3 - r * m * Wgx * inv
    delta = k * (Gx * Sg * inv + Sgx * G * inv) - r * Wg * inv
    return u, c1, c0, alpha, beta, gamma, delta


def batch_norm_double_bwd_reference(gg, x, g, stats, weight, sums, local, bsums, blocal, ggw, ggb,
                                    inv):
    """``(d/dg, d/dx, d/dw)`` of the double backward on rows ``gg, x, g``.
    ``local`` and ``blocal`` are this rank's own sums (equal to ``sums``'
    first three rows and to ``bsums`` without a group)."""
    dt = _cdt(gg, x, g)
    mean, r, m = stats
    u, c1, c0, alpha, beta, gamma, delta = double_bwd_constants(stats, weight, sums, bsums, ggw, ggb, inv)
    ggv, gv = gg.to(dt), g.to(dt)
    xh = (x.to(dt) - mean) * r
    ggo = u * ggv + xh * c1 + c0
    gi = alpha * gv + beta * ggv + gamma * xh + delta
    gw = r * (local[2] - blocal[0] * sums[0] * inv - m * blocal[1] * sums[1] * inv)
    return ggo.to(g.dtype), gi.to(x.dtype), gw


# ---------------------------------------------------------------- kernels
@functools.cache
def _entries():
    """The C entry points of ``csrc/batch_norm_nhwc.cu``, built at first
    use and bound once, and ``_build.raw_stream()``."""
    lib = _build.library("batch_norm_nhwc")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sums, fwd, bwd, dbl = lib.batch_norm_sums, lib.batch_norm_fwd, lib.batch_norm_bwd, lib.batch_norm_double_bwd
    sums.argtypes = [i] + [p] * 6 + [i] * 4 + [p]
    fwd.argtypes = [p] * 8 + [i] * 2 + [f] * 4 + [i] * 4 + [p]
    bwd.argtypes = [p] * 6 + [i] * 2 + [f] + [i] * 2 + [p]
    dbl.argtypes = [p] * 14 + [i] * 2 + [f] + [i] * 2 + [p]
    for fn in (sums, fwd, bwd, dbl):
        fn.restype = i
    return sums, fwd, bwd, dbl, _build.raw_stream()


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _geometry(n: int, c: int, vec: int, index: int):
    """``(reduce blocks, apply blocks)`` of a pass, by the kernel's rule
    (``csrc/batch_norm_nhwc.cu::geometry``): a block is ``min(c / vec,
    256)`` pieces across a row by ``256 // that`` rows, ``tiles`` blocks
    across the row; blocks stride over the row tiles."""
    pieces = c // vec
    bx = min(pieces, THREADS)
    by, tiles = THREADS // bx, -(-pieces // bx)
    row_tiles = max(1, -(-n // by))
    sms = _sm_count(index)
    reduce = min(-(-row_tiles // ROWS_PER_REDUCE_BLOCK), max(1, REDUCE_BLOCKS_PER_SM * sms // tiles))
    apply = min(row_tiles, max(1, APPLY_BLOCKS_PER_SM * sms // tiles))
    return reduce, apply


def _codes(x_dtype, y_dtype, c, ptrs):
    """The entry points' ``codes`` and the vector width: bit 0 x in bf16,
    bit 1 y (and g) in bf16, bits 2-3 the width (8 values for bf16 alone,
    else 4; 1 where c or a row's address is not a whole number of
    pieces)."""
    vec = 8 if x_dtype == y_dtype == torch.bfloat16 else 4
    if c % vec or any(ptr % 16 for ptr in ptrs):
        vec = 1
    return _DTYPES[x_dtype] | (_DTYPES[y_dtype] << 1) | ({1: 0, 4: 1, 8: 2}[vec] << 2), vec


def _check_rows(index, *ts):
    """Raise on rows the kernels do not take: 2-D, contiguous, f32 or bf16,
    the same shape, on card ``index``. Every pass pays for this, so it
    compares integers and reads attributes: no ``torch.device`` is made
    unless a check fails."""
    shape = ts[0].shape
    for t in ts:
        if t.dim() != 2 or t.shape != shape or t.dtype not in _DTYPES or not t.is_contiguous() \
                or t.get_device() != index:
            raise ValueError(
                f"batch_norm: rows must be contiguous {tuple(_DTYPES)} ({tuple(shape)}) tensors on "
                f"cuda:{index}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if shape[0] >= 2**31 or shape[1] >= 2**20:
        raise ValueError(f"batch_norm: {tuple(shape)} is too large for the kernels")


def _check_channels(c, index, *ts):
    """Raise unless each per-channel tensor (None allowed) is contiguous
    f32 with ``c`` values a row on card ``index``."""
    for t in ts:
        if t is not None and not (t.dtype == torch.float32 and t.is_contiguous() and t.get_device() == index
                                  and t.shape[-1] == c):
            raise ValueError(f"batch_norm: per-channel tensors must be contiguous f32 (..., {c}) on "
                             f"cuda:{index}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launch(fn, args, index, what):
    if index == torch.cuda.current_device():
        rc = fn(*args, _entries()[4](index))
    else:  # a launch goes to the current device: make it the tensor's
        with torch.cuda.device(index):
            rc = fn(*args, _entries()[4](index))
    _build.check(rc, what)


def batch_norm_sums(mode, a, x=None, g=None, stats=None):
    """The per-channel sums of a pass (``batch_norm_sums_reference``): the
    kernels on a CUDA tensor, the plain version otherwise. f32 on the
    card."""
    if not a.is_cuda:
        return batch_norm_sums_reference(mode, a, x, g, stats)
    ts = [t for t in (a, x, g) if t is not None]
    index = a.get_device()
    _check_rows(index, *ts)
    n, c = a.shape
    _check_channels(c, index, stats)
    x_dtype = a.dtype if mode == FWD else x.dtype
    y_dtype = a.dtype if mode == BWD else (g.dtype if mode == DBL else x_dtype)
    codes, vec = _codes(x_dtype, y_dtype, c, [t.data_ptr() for t in ts])
    blocks, _ = _geometry(n, c, vec, index)
    k = SUMS[mode]
    # one allocation: the blocks' partial sums, then the sums
    work = a.new_empty(((blocks + 1) * k, c), dtype=torch.float32)
    partial = work.data_ptr()
    _launch(_entries()[0], (mode, a.data_ptr(), _ptr(x), _ptr(g), _ptr(stats), partial,
                            partial + blocks * k * c * 4, n, c, codes, blocks), index, "batch_norm_sums")
    _count(mode, 2)
    return work[blocks * k:]


def _count(mode, launches):
    global fwd_launches, bwd_launches, double_bwd_launches
    if mode == FWD:
        fwd_launches += launches
    elif mode == BWD:
        bwd_launches += launches
    else:
        double_bwd_launches += launches


def batch_norm_fwd(x, sums, weight, bias, running_mean, running_var, *, count, training, update,
                   eps, momentum, out_dtype):
    """``(y, stats)`` of the forward's elementwise pass
    (``batch_norm_fwd_reference``): the kernel on a CUDA tensor, the plain
    version otherwise."""
    if not x.is_cuda:
        return batch_norm_fwd_reference(x, sums, weight, bias, running_mean, running_var,
                                        count=count, training=training, update=update, eps=eps,
                                        momentum=momentum, out_dtype=out_dtype)
    index = x.get_device()
    _check_rows(index, x)
    if out_dtype not in _DTYPES:
        raise ValueError(f"batch_norm: no kernel writes {out_dtype}")
    n, c = x.shape
    _check_channels(c, index, weight, bias, running_mean, running_var, sums)
    y = x.new_empty((n, c), dtype=out_dtype)
    stats = weight.new_empty((3, c))
    codes, vec = _codes(x.dtype, out_dtype, c, (x.data_ptr(), y.data_ptr()))
    _, blocks = _geometry(n, c, vec, index)
    keep = 1.0 - momentum
    _launch(_entries()[1], (x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(), _ptr(sums),
                            stats.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(), n, c,
                            float(count), eps, keep, momentum, int(training), int(update), codes,
                            blocks), index, "batch_norm_fwd")
    _count(FWD, 1)
    return y, stats


def batch_norm_bwd(g, x, stats, weight, sums, inv):
    """dx of the backward's elementwise pass (``batch_norm_bwd_reference``):
    the kernel on a CUDA tensor, the plain version otherwise."""
    if not x.is_cuda:
        return batch_norm_bwd_reference(g, x, stats, weight, sums, inv)
    index = x.get_device()
    _check_rows(index, x)
    _check_rows(index, g)
    n, c = x.shape
    if g.shape != x.shape:
        raise ValueError("batch_norm: g and x must be rows of one shape")
    _check_channels(c, index, stats, weight, sums)
    dx = torch.empty_like(x)
    codes, vec = _codes(x.dtype, g.dtype, c, (g.data_ptr(), x.data_ptr(), dx.data_ptr()))
    _, blocks = _geometry(n, c, vec, index)
    _launch(_entries()[2], (g.data_ptr(), x.data_ptr(), dx.data_ptr(), weight.data_ptr(), stats.data_ptr(),
                            sums.data_ptr(), n, c, inv, codes, blocks), index, "batch_norm_bwd")
    _count(BWD, 1)
    return dx


def batch_norm_double_bwd(gg, x, g, stats, weight, sums, local, bsums, blocal, ggw, ggb, inv):
    """``(d/dg, d/dx, d/dw)`` of the double backward's elementwise pass
    (``batch_norm_double_bwd_reference``): the kernel on a CUDA tensor, the
    plain version otherwise."""
    if not x.is_cuda:
        return batch_norm_double_bwd_reference(gg, x, g, stats, weight, sums, local, bsums, blocal,
                                               ggw, ggb, inv)
    index = x.get_device()
    _check_rows(index, gg, x)
    _check_rows(index, g)
    if gg.dtype != x.dtype:
        raise ValueError("batch_norm: gg must have x's dtype")
    n, c = x.shape
    if g.shape != x.shape:
        raise ValueError("batch_norm: g and x must be rows of one shape")
    _check_channels(c, index, stats, weight, sums, local, bsums, blocal, ggw, ggb)
    ggo, gi = torch.empty_like(g), torch.empty_like(x)
    gw = weight.new_empty((c,))
    ptrs = (gg.data_ptr(), x.data_ptr(), g.data_ptr(), ggo.data_ptr(), gi.data_ptr())
    codes, vec = _codes(x.dtype, g.dtype, c, ptrs)
    _, blocks = _geometry(n, c, vec, index)
    _launch(_entries()[3], (*ptrs, gw.data_ptr(), weight.data_ptr(), stats.data_ptr(), sums.data_ptr(),
                            local.data_ptr(), bsums.data_ptr(), blocal.data_ptr(), _ptr(ggw), _ptr(ggb),
                            n, c, inv, codes, blocks), index, "batch_norm_double_bwd")
    _count(DBL, 1)
    return ggo, gi, gw


# ---------------------------------------------------------------- autograd
class _BatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, training, update, momentum, eps,
                out_dtype, sync, sync_size):
        xr = rows(x)
        count = xr.shape[0] * sync_size
        sums = tp_ops.all_reduce_sum(batch_norm_sums(FWD, xr), sync) if training else None
        y, stats = batch_norm_fwd(xr, sums, weight, bias, running_mean, running_var, count=count,
                                  training=training, update=update, eps=eps, momentum=momentum,
                                  out_dtype=out_dtype)
        ctx.save_for_backward(x, weight)
        ctx.stats, ctx.sync = stats, sync
        ctx.inv = 1.0 / count if training and count else 0.0
        return _nchw(y, x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw, db = _BatchNormBackward.apply(rows(dy), rows(x), weight, ctx.stats, ctx.inv, ctx.sync)
        return _nchw(dx, x.shape), dw, db, *([None] * 9)


class _BatchNormBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, xr, weight, stats, inv, sync):
        local = batch_norm_sums(BWD, g, xr, stats=stats)  # (S g, S g x^) = (db, dw)
        # eval mode (inv 0) reads no group sum: no collective
        total = tp_ops.all_reduce_sum(local, sync) if inv else local
        dx = batch_norm_bwd(g, xr, stats, weight, total, inv)
        ctx.save_for_backward(g, xr, weight)
        ctx.stats, ctx.inv, ctx.sync, ctx.local, ctx.total = stats, inv, sync, local, total
        ctx.set_materialize_grads(False)
        db, dw = local.unbind(0)
        return dx, dw, db

    @staticmethod
    @once_differentiable
    def backward(ctx, ggx, ggw, ggb):
        g, xr, weight = ctx.saved_tensors
        ggx = torch.zeros_like(xr) if ggx is None else ggx.to(xr.dtype).contiguous()
        ggw = None if ggw is None else ggw.to(ctx.local.dtype).contiguous()
        ggb = None if ggb is None else ggb.to(ctx.local.dtype).contiguous()
        local = batch_norm_sums(DBL, ggx, xr, g, ctx.stats)
        sums = local if ggw is None else torch.cat([local, ggw * ctx.local])
        sums = tp_ops.all_reduce_sum(sums, ctx.sync) if ctx.inv else sums
        ggo, gi, gw = batch_norm_double_bwd(ggx, xr, g, ctx.stats, weight, sums, local, ctx.total,
                                            ctx.local, ggw, ggb, ctx.inv)
        return ggo, gi, gw, None, None, None


def batch_norm(x, weight, bias, running_mean, running_var, *, training: bool, update: bool,
               momentum: float, eps: float, out_dtype, sync=None, sync_size: int = 1):
    """BatchNorm of an NCHW map ``x`` over its channels (``(N*H*W, C)``
    rows), differentiable twice in x, weight and bias; returns a
    channels-last NCHW map in ``out_dtype``. ``training`` takes the batch's
    moments (over ``sync``'s ``sync_size`` ranks where set, each holding
    x's number of rows) and, with ``update``, folds them into the running
    statistics in place; otherwise the running statistics normalise."""
    return _BatchNorm.apply(x, weight, bias, running_mean, running_var, training, update, momentum,
                            eps, out_dtype, sync, sync_size)
