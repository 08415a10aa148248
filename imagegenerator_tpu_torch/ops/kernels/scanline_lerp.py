"""Scanline linear resample: two gathered taps and a lerp per output.

Replaces ``imagegenerator_tpu/ops/pallas/scanline_lerp.py``: ``_fwd_call``
(kernel ``_fwd_kernel``), which the two-pass homography warp of the v2
cutouts reaches twice per step when the warp kernel is on. For source
scanlines ``src (S, C, K)`` and source positions ``coords (S, O)``

    s  = clip(coords, 0, K - 1),  k0 = min(int(s), K - 2),  f = s - k0
    out[s, c, o] = src[s, c, k0] + f * (src[s, c, k0 + 1] - src[s, c, k0])

in f32: the tent weights ``max(0, 1 - |s - k|)`` of the dense warp, of
which each row has two nonzeros. On a CUDA tensor the forward launches a
Triton kernel (``_scanline_lerp_kernel``); on a CPU tensor it runs
``scanline_lerp_reference``, the plain PyTorch version.

The backward is not a hand kernel in the JAX package either
(``_bwd_call``): it is the dense transposed contraction
``d_src[s, c, k] = sum_o w[s, o, k] g[s, c, o]`` with the tent weights
and the cotangent rounded to bf16 and the sum in f32. ``scanline_lerp_bwd``
does the same in PyTorch ops on either device: both operands are rounded
to bf16, widened back to f32 and contracted by an f32 ``bmm``, so every
product is exact and the sum is f32 (a bf16 ``bmm`` would round its
result to bf16 as well). ``coords`` gets no gradient.

What bounds the forward on the card: bytes. There is no product and no
reduction; each output element costs two 4-byte gathers, which hit the
same or neighbouring cache lines for neighbouring outputs, and one
store. One program takes one scanline and ``BLOCK_O`` outputs and loops
over the channels, which share the positions. The TPU kernel's limits
(K at most 128 for a one-register lane gather, O cut into K-wide pieces,
the channel-major copy) do not apply: K >= 2 is all it needs, and the
source may be any strided view, with the scanline axis split in two
(``(S1, S2, C, K)``), so that the warp's transposes between its two
passes are views and not copies.
"""

from __future__ import annotations

import functools

import torch

BLOCK_O = 128

# Forward kernel launches so far; the wrapper adds one per launch and
# nothing else does.
launches = 0


def _positions(coords, K):
    s = coords.float().clamp(0.0, K - 1.0)
    k0 = s.to(torch.int64).clamp_max(K - 2)
    return k0, s - k0.float()


def scanline_lerp_reference(src, coords):
    """Plain PyTorch forward: src ``(S, C, K)``, coords ``(S, O)`` ->
    ``(S, C, O)`` f32."""
    S, C, K = src.shape
    k0, f = _positions(coords, K)
    idx = k0[:, None, :].expand(S, C, coords.shape[1])
    src = src.float()
    g0, g1 = torch.gather(src, 2, idx), torch.gather(src, 2, idx + 1)
    return g0 + f[:, None, :] * (g1 - g0)


def tent_weights(coords, K):
    """``max(0, 1 - |clip(coords, 0, K - 1) - k|)``: ``(S, O, K)`` f32."""
    s = coords.float().clamp(0.0, K - 1.0)
    k = torch.arange(K, dtype=torch.float32, device=coords.device)
    return (1.0 - (s[..., None] - k).abs()).clamp_min(0.0)


def _round_bf16(t):
    return t.to(torch.bfloat16).float()


def scanline_lerp_bwd(g, coords, K):
    """``d_src (S, C, K)`` f32 from the cotangent ``g (S, C, O)`` and the
    forward's coords: the transposed dense contraction with bf16-rounded
    operands and an f32 sum."""
    return torch.bmm(_round_bf16(g), _round_bf16(tent_weights(coords, K)))


def _scanline_lerp_kernel(src_ptr, coords_ptr, out_ptr, S2, C, K, O, k_max,
                          src_s1, src_s2, src_c, src_k, BLOCK: tl.constexpr):
    s = tl.program_id(0).to(tl.int64)
    o = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
    keep = o < O
    pos = tl.load(coords_ptr + s * O + o, mask=keep, other=0.0)
    pos = tl.minimum(tl.maximum(pos, 0.0), k_max)
    k0 = tl.minimum(pos.to(tl.int32), K - 2)
    f = pos - k0.to(tl.float32)
    base = src_ptr + (s // S2) * src_s1 + (s % S2) * src_s2
    tap = k0.to(tl.int64) * src_k
    for c in range(C):
        g0 = tl.load(base + c * src_c + tap, mask=keep, other=0.0)
        g1 = tl.load(base + c * src_c + tap + src_k, mask=keep, other=0.0)
        tl.store(out_ptr + (s * C + c) * O + o, g0 + f * (g1 - g0), mask=keep)


@functools.cache
def _kernel():
    """The jitted kernel. Triton is imported, and the kernel decorated,
    here at first launch, so this module imports where Triton is absent;
    the kernel's ``tl`` is this module's global, bound by the import."""
    global tl
    import triton
    import triton.language as tl

    return triton.jit(_scanline_lerp_kernel)


def _check(src4, coords):
    S1, S2, C, K = src4.shape
    if coords.ndim != 2 or coords.shape[0] != S1 * S2:
        raise ValueError(
            f"scanline_lerp: coords {tuple(coords.shape)} for {S1 * S2} scanlines"
        )
    if K < 2:
        raise ValueError(f"scanline_lerp: K={K}; need at least two source samples")
    if min(S1 * S2, C, coords.shape[1]) < 1:
        raise ValueError("scanline_lerp: empty input")


def scanline_lerp_fwd(src4, coords):
    """The forward on a 4-D view ``src4 (S1, S2, C, K)`` f32 of any
    strides and coords ``(S1 * S2, O)``: ``(S1, S2, C, O)`` f32,
    contiguous. The kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    _check(src4, coords)
    S1, S2, C, K = src4.shape
    S, O = coords.shape
    if src4.device.type == "cpu":
        return scanline_lerp_reference(src4.reshape(S, C, K), coords).reshape(S1, S2, C, O)
    if src4.device.type != "cuda":
        raise ValueError(f"scanline_lerp: no kernel for device {src4.device}")
    if src4.dtype != torch.float32 or coords.device != src4.device:
        raise ValueError(
            f"scanline_lerp: src must be f32 (got {src4.dtype}) and coords on {src4.device}"
        )
    coords = coords.float().contiguous()
    extent = 1 + sum((n - 1) * abs(st) for n, st in zip(src4.shape, src4.stride()))
    if extent >= 2**31 or S * C * O >= 2**31 or S > 2**31 - 1 or -(-O // BLOCK_O) > 65535:
        raise ValueError(f"scanline_lerp: {tuple(src4.shape)} -> {O} is too large for the kernel")
    global launches
    out = torch.empty((S1, S2, C, O), dtype=torch.float32, device=src4.device)
    with torch.cuda.device(src4.device):
        _kernel()[(S, -(-O // BLOCK_O))](
            src4, coords, out, S2, C, K, O, float(K - 1), *src4.stride(),
            BLOCK=BLOCK_O, num_warps=4,
        )
    launches += 1
    return out


class _ScanlineLerp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src4, coords):
        ctx.save_for_backward(coords)
        ctx.shape = src4.shape
        return scanline_lerp_fwd(src4, coords)

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        S1, S2, C, K = ctx.shape
        d_src = scanline_lerp_bwd(g.reshape(S1 * S2, C, -1), coords, K)
        return d_src.reshape(ctx.shape), None


def scanline_lerp(src, coords):
    """Linear resample along the last axis under border clamp,
    differentiable in ``src``.

    src:    ``(S, C, K)`` source scanlines, or a 4-D ``(S1, S2, C, K)``
            with the scanline axis split in two; any strides
    coords: ``(S, O)`` source position of each output sample (``S = S1 *
            S2``); no gradient
    returns ``(S, C, O)`` or ``(S1, S2, C, O)`` f32, contiguous."""
    src4 = src[None] if src.ndim == 3 else src
    if src4.ndim != 4:
        raise ValueError(f"scanline_lerp: src {tuple(src.shape)} must be 3-D or 4-D")
    out = _ScanlineLerp.apply(src4.float(), coords)
    return out[0] if src.ndim == 3 else out
