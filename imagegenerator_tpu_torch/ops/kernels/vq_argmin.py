"""Nearest-codebook search: ``argmin_k ||x_i - c_k||^2`` without the
(N, K) distance matrix.

Replaces ``imagegenerator_tpu/ops/pallas/vq_kernel.py``:
``nearest_codebook_indices_pallas`` (kernel ``_vq_kernel``), which the
VQGAN's ``vector_quantize`` reaches on every step of the v2 latent
optimization. On a CUDA tensor ``vq_argmin`` launches the hand-written
kernel in ``csrc/vq_argmin.cu`` (CUDA C++ for ``sm_90a``, built by
``_build``); on a CPU tensor it runs ``vq_argmin_reference``, the plain
PyTorch version of the same function.

Both compute ``argmin_k (||c_k||^2 - 2 x_i . c_k)`` in f32 (x widened
from bf16 where needed; the row-constant ``||x_i||^2`` is left out) and
give ties to the lowest index. Kernel and plain version sum in different
orders, so on inputs whose two best scores differ by rounding alone they
may name different codes; on inputs whose sums are exact in f32 they
agree exactly. Inputs must be finite.

What bounds the kernel on the card, and its design: see the head of
``csrc/vq_argmin.cu``. Operations bound it, so the product runs on the
tensor cores in TF32 with each f32 operand split in two (``hi =
tf32(v)``, ``lo = v - hi`` read to TF32's width) and three products
summed, small terms first; ``split_tf32`` and
``vq_argmin_reference_3xtf32`` are that arithmetic in plain PyTorch, for
the tests. K is split over blocks and the partial results are joined by a
64-bit ``atomicMin`` on packed (score, index) keys. The TPU kernel's limits do not apply: any d, N and K, no
padding by the wrapper.

A call is one launch. The keys and one ticket per row tile live in a
scratch buffer that the kernel finds at its initial values and leaves so
(the last block to arrive for a row tile writes the indices and resets
them). Two calls may share a scratch buffer only if the card runs them
in order, so the wrapper keeps one buffer for each (device, stream): a
call on another stream gets a buffer of its own, made and initialised on
that stream at its first call there, and a buffer grows (a new one is
made) when N outgrows it. A launch that fails drops its buffer.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from imagegenerator_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # rows of x per block of the kernel
CODE_TILE = 128  # codes per tile of the kernel
TARGET_BLOCKS = 1056  # 8 blocks for each of the card's 132 SMs

# Kernel launches so far (one per call); the wrapper adds one per launch
# and nothing else does.
launches = 0

# (device index, stream handle) -> (keys (capacity,) int64 of all ones,
# tickets (ceil(capacity / TILE),) int32 of zeros)
_scratch: dict = {}


def vq_argmin_reference(x, codebook):
    """Plain PyTorch version: x ``(N, d)``, codebook ``(K, d)`` ->
    ``(N,)`` int32 indices of the nearest code, the lowest index on ties
    (taken as the least index that attains the row's minimum, which does
    not rest on which of several minima a device's ``argmin`` names)."""
    cb = codebook.float()
    scores = (cb * cb).sum(dim=1)[None, :] - 2.0 * (x.float() @ cb.t())
    k = torch.arange(cb.shape[0], dtype=torch.int32, device=scores.device)
    at_min = scores == scores.amin(dim=1, keepdim=True)
    return torch.where(at_min, k, cb.shape[0]).amin(dim=1)


def split_tf32(t):
    """``(hi, lo)`` of an f32 tensor as the kernel's products see it:
    ``hi`` is t rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to
    nearest, ties away from zero: add ``0x1000`` to the bit pattern and
    clear the low 13 bits); ``lo`` is ``t - hi`` (exact in f32) as the
    tensor core reads an f32 register (the low 13 bits ignored)."""

    def bits(v):
        return v.contiguous().view(torch.int32)

    hi = ((bits(t) + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, (bits(t - hi) & ~0x1FFF).view(torch.float32)


def vq_argmin_reference_3xtf32(x, codebook):
    """The kernel's arithmetic in plain PyTorch: the plain version with
    ``x . c`` as the three TF32 products of the split operands, summed
    small terms first (``lo * hi``, ``hi * lo``, ``hi * hi``) in f32. On a
    card the matrix products must run in full f32
    (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    cb = codebook.float()
    x_hi, x_lo = split_tf32(x.float())
    c_hi, c_lo = split_tf32(cb)
    dot = (x_lo @ c_hi.t() + x_hi @ c_lo.t()) + x_hi @ c_hi.t()
    scores = (cb * cb).sum(dim=1)[None, :] - 2.0 * dot
    k = torch.arange(cb.shape[0], dtype=torch.int32, device=scores.device)
    at_min = scores == scores.amin(dim=1, keepdim=True)
    return torch.where(at_min, k, cb.shape[0]).amin(dim=1)


@functools.cache
def _entry():
    """``(fn, raw_stream)``: the C entry point, built at first use and
    bound once, and ``_build.raw_stream()``."""
    fn = _build.library("vq_argmin").vq_argmin
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, _build.raw_stream()


def k_splits(n: int, k: int) -> int:
    """Blocks along K: enough that the grid covers the card when there
    are few row tiles, never more than there are code tiles."""
    row_tiles = -(-n // TILE)
    return max(1, min(-(-k // CODE_TILE), TARGET_BLOCKS // row_tiles))


def _new_scratch(capacity: int, device):
    keys = torch.full((capacity,), -1, dtype=torch.int64, device=device)
    tickets = torch.zeros((-(-capacity // TILE),), dtype=torch.int32, device=device)
    return keys, tickets


def scratch_for(index: int, stream: int, n: int, make=_new_scratch):
    """The ``(keys, tickets)`` scratch of device ``index`` and stream
    handle ``stream`` for a call of ``n`` rows: the buffer that stream
    used last if it holds ``n`` rows, else a new one of ``make(capacity,
    device)`` with room for ``n`` rows rounded up to whole row tiles (made
    while ``stream`` is current, so initialised in its order). No two
    streams share a buffer."""
    held = _scratch.get((index, stream))
    if held is None or held[0].shape[0] < n:
        held = make(-(-n // TILE) * TILE, torch.device("cuda", index))
        _scratch[index, stream] = held
    return held


def _check_cuda(x, codebook):
    if x.ndim != 2 or codebook.ndim != 2 or x.shape[1] != codebook.shape[1]:
        raise ValueError(
            f"vq_argmin: x {tuple(x.shape)} and codebook {tuple(codebook.shape)} "
            "must be (N, d) and (K, d)"
        )
    if x.dtype not in _DTYPES:
        raise TypeError(f"vq_argmin: x dtype {x.dtype} (kernel takes f32, bf16)")
    if codebook.dtype != torch.float32:
        raise TypeError(f"vq_argmin: codebook dtype {codebook.dtype} (kernel takes f32)")
    if codebook.device != x.device:
        raise ValueError(f"vq_argmin: x on {x.device}, codebook on {codebook.device}")
    if not x.is_contiguous() or not codebook.is_contiguous():
        raise ValueError("vq_argmin: x and codebook must be contiguous")
    n, d = x.shape
    k = codebook.shape[0]
    if min(n, k, d) < 1 or n * d >= 2**31 or k * d >= 2**31:
        raise ValueError(f"vq_argmin: N={n}, K={k}, d={d} outside what the kernel takes")


def vq_argmin(x, codebook):
    """``(N,)`` int32 indices of the nearest code of each row of x
    ``(N, d)`` in codebook ``(K, d)``: the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return vq_argmin_reference(x, codebook)
    if x.device.type != "cuda":
        raise ValueError(f"vq_argmin: no kernel for device {x.device}")
    _check_cuda(x, codebook)
    global launches
    n, d = x.shape
    k = codebook.shape[0]
    index = x.device.index
    fn, raw_stream = _entry()

    def launch():
        stream = raw_stream(index)
        keys, tickets = scratch_for(index, stream, n)
        out = torch.empty((n,), dtype=torch.int32, device=x.device)
        rc = fn(
            x.data_ptr(), codebook.data_ptr(), keys.data_ptr(), tickets.data_ptr(),
            out.data_ptr(), n, k, d, _DTYPES[x.dtype], k_splits(n, k), stream,
        )
        if rc != 0:  # the buffer may be left half written
            _scratch.pop((index, stream), None)
        return out, rc

    if index == torch.cuda.current_device():
        out, rc = launch()
    else:  # a launch goes to the current device: make it the tensor's
        with torch.cuda.device(index):
            out, rc = launch()
    _build.check(rc, "vq_argmin")
    launches += 1
    return out
