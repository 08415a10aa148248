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
``csrc/vq_argmin.cu`` (operations on the FMA units; K split over blocks
and the partial results joined by a 64-bit ``atomicMin`` on packed
(score, index) keys). The TPU kernel's limits do not apply: any d, N and
K, no padding by the wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from imagegenerator_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # rows of x and codes per tile of the kernel
TARGET_BLOCKS = 1056  # 8 blocks for each of the card's 132 SMs

# Kernel launches so far (one per call, its two CUDA kernels together);
# the wrapper adds one per launch and nothing else does.
launches = 0


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


@functools.cache
def _entry():
    fn = _build.library("vq_argmin").vq_argmin
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def k_splits(n: int, k: int) -> int:
    """Blocks along K: enough that the grid covers the card when there
    are few row tiles, never more than there are code tiles."""
    row_tiles = -(-n // TILE)
    return max(1, min(-(-k // TILE), TARGET_BLOCKS // row_tiles))


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
    best = torch.empty((n,), dtype=torch.int64, device=x.device)
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _entry()(
            x.data_ptr(), codebook.data_ptr(), best.data_ptr(), out.data_ptr(),
            n, k, d, _DTYPES[x.dtype], k_splits(n, k),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "vq_argmin")
    launches += 1
    return out
