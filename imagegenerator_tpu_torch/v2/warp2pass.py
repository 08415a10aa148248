"""Two-pass scanline homography warp (Catmull-Smith decomposition) —
counterpart of ``imagegenerator_tpu/v2/warp2pass.py``.

An inverse-map homography is decomposed into two scanline resampling
passes:

  pass 1 (horizontal): I1[y, j] = S[y, hx(y, j)]   for source rows y
  pass 2 (vertical):   T[i, j]  = I1[sy(i, j), j]

For a homography M (output (i, j, 1) -> source (sy, sx, w)):
  sy(i, j) = (m00 i + m01 j + m02) / (m20 i + m21 j + m22),
and for fixed j, sy is a Moebius function of i with coefficients
a = m00, b = m01 j + m02, c = m20, d = m21 j + m22; inverting gives
i(y | j) = (d y - b) / (a - c y), and substituting into sx yields

  hx(y, j) = (m10 (d y - b) + (m11 j + m12)(a - c y))
           / (m20 (d y - b) + (m21 j + m22)(a - c y)).

Two forms of each pass:

* dense (``warp_homography_2pass`` by default, ``resize_axis_aligned``):
  per-scanline linear-interpolation weight matrices contracted with the
  image by a batched matrix product, so the backward is the transposed
  product. As in the JAX package the weights and the image are rounded
  to bf16 and the sums are f32. Here that is: both operands rounded to
  bf16, widened back to f32 and multiplied by an f32 ``bmm``, so every
  product is exact and the sum is f32 (a bf16 ``bmm`` would round its
  result to bf16 too).
* the scanline kernel (``warp_kernel=True``): each weight row has two
  nonzeros, so the forward is a gather and a lerp per output in f32
  (``ops/kernels/scanline_lerp.py``). Its results differ from the dense
  form's by the dense form's bf16 rounding.

Accuracy: linear interpolation per pass; agrees with one-pass bilinear
sampling exactly for axis-aligned maps and to sub-pixel interpolation
error for the rotations (<= 30 deg) and mild perspectives (distortion
0.2) of the augmentation pipeline. The block-banded form of the JAX
package is not ported.
"""

from __future__ import annotations

import os

import torch

from imagegenerator_tpu_torch.ops.kernels.scanline_lerp import scanline_lerp


def _safe_div(num, den, eps=1e-8):
    guard = torch.where(den < 0, -eps, eps)
    return num / torch.where(den.abs() < eps, guard, den)


def use_warp_kernel(warp_kernel: bool | None = None) -> bool:
    """The explicit choice, or, for None, ``IMAGEGEN_WARP_KERNEL=1`` in
    the environment (off by default)."""
    if warp_kernel is not None:
        return warp_kernel
    return os.environ.get("IMAGEGEN_WARP_KERNEL") == "1"


def _bf16(t):
    """Rounded to bf16, as f32."""
    return t.to(torch.bfloat16).float()


def _line_weights(coords, in_size):
    """coords ``(..., out)`` source positions -> ``(..., out, in_size)``
    linear-interpolation weights with border clamp, rounded to bf16 and
    held as f32: the tent ``max(0, 1 - |s - k|)``."""
    s = coords.clamp(0.0, in_size - 1.0)
    k = torch.arange(in_size, dtype=s.dtype, device=s.device)
    return _bf16((1.0 - (s[..., None] - k).abs()).clamp_min(0.0))


def _homography_scanline_coords(m, H, Ho, Wo):
    """Per-scanline source coordinates of both passes, vectorised:
    ``hx (N, H, Wo)``, the pass-1 source x per (image, source row, out
    col), and ``sy (N, Wo, Ho)``, the pass-2 source y per (image, out
    col, out row)."""
    dev = dict(dtype=torch.float32, device=m.device)
    y = torch.arange(H, **dev)
    i = torch.arange(Ho, **dev)
    j = torch.arange(Wo, **dev)

    def mc(r, c):  # (N, 1) homography coefficient columns
        return m[:, r, c][:, None]

    # pass 1: hx(y, j) is linear-fractional in j with per-(image, source
    # row) coefficients
    acy = mc(0, 0) - mc(2, 0) * y[None, :]  # (N, H)
    a1 = mc(1, 0) * (mc(2, 1) * y[None, :] - mc(0, 1)) + mc(1, 1) * acy
    b1 = mc(1, 0) * (mc(2, 2) * y[None, :] - mc(0, 2)) + mc(1, 2) * acy
    a2 = mc(2, 0) * (mc(2, 1) * y[None, :] - mc(0, 1)) + mc(2, 1) * acy
    b2 = mc(2, 0) * (mc(2, 2) * y[None, :] - mc(0, 2)) + mc(2, 2) * acy
    hx = _safe_div(a1[..., None] * j + b1[..., None], a2[..., None] * j + b2[..., None])

    # pass 2: sy(i, j) per output column j
    bj = mc(0, 1) * j + mc(0, 2)  # (N, Wo)
    dj = mc(2, 1) * j + mc(2, 2)
    sy = _safe_div(
        mc(0, 0)[..., None] * i + bj[..., None],
        mc(2, 0)[..., None] * i + dj[..., None],
    )
    return hx, sy


def _warp_kernel_path(images, m, Ho, Wo):
    """Both passes through ``scanline_lerp``. Its source may be any
    strided view with the scanline axis split in two, so the
    channel-major layouts the two passes need are views of the NHWC
    image and of pass 1's result: no transpose is copied."""
    N, H, W, C = images.shape
    hx, sy = _homography_scanline_coords(m, H, Ho, Wo)
    src1 = images.float().permute(0, 1, 3, 2)  # (N, H, C, W)
    i1 = scanline_lerp(src1, hx.reshape(N * H, Wo))  # (N, H, C, Wo)
    src2 = i1.permute(0, 3, 2, 1)  # (N, Wo, C, H)
    out2 = scanline_lerp(src2, sy.reshape(N * Wo, Ho))  # (N, Wo, C, Ho)
    return out2.permute(0, 3, 1, 2)  # (N, Ho, Wo, C)


def resize_axis_aligned(images, scale, offset, out_shape):
    """Per-image separable axis-aligned resample: ``src = scale * out +
    offset`` per axis (inverse map); scale, offset ``(N, 2)`` as (y, x).
    An axis-aligned map's weights do not depend on the scanline, so they
    are ``(N, O, K)`` and each pass is one matrix product against all
    rows and channels at once."""
    N, H, W, C = images.shape
    Ho, Wo = out_shape
    dev = dict(dtype=torch.float32, device=images.device)
    sx = scale[:, 1:2] * torch.arange(Wo, **dev)[None, :] + offset[:, 1:2]  # (N, Wo)
    sy = scale[:, 0:1] * torch.arange(Ho, **dev)[None, :] + offset[:, 0:1]  # (N, Ho)
    wx = _line_weights(sx, W)  # (N, Wo, W)
    wy = _line_weights(sy, H)  # (N, Ho, H)
    cols = _bf16(images).permute(0, 2, 1, 3).reshape(N, W, H * C)
    x1 = torch.bmm(wx, cols).reshape(N, Wo, H, C).permute(0, 2, 1, 3)  # (N, H, Wo, C)
    out = torch.bmm(wy, _bf16(x1).reshape(N, H, Wo * C)).reshape(N, Ho, Wo, C)
    return out.to(images.dtype)


def warp_homography_2pass(images, Ms, out_shape=None, *, warp_kernel: bool | None = None):
    """images ``(N, H, W, C)``; Ms ``(N, 3, 3)`` inverse-map homographies
    in (y, x, 1) coordinates, mapping output pixel coordinates to source
    pixel coordinates. Returns the warped batch of spatial shape
    ``out_shape`` (default: the input's). ``warp_kernel``: True takes the
    scanline kernel, False the dense form, None the environment's
    choice (``use_warp_kernel``)."""
    N, H, W, C = images.shape
    Ho, Wo = out_shape if out_shape is not None else (H, W)
    m = Ms.float()
    if use_warp_kernel(warp_kernel):
        return _warp_kernel_path(images, m, Ho, Wo).to(images.dtype)
    dev = dict(dtype=torch.float32, device=images.device)
    y = torch.arange(H, **dev)[None, :, None]  # source rows (pass 1)
    i = torch.arange(Ho, **dev)[None, :, None]  # output rows (pass 2)
    j = torch.arange(Wo, **dev)[None, None, :]  # output columns

    def mc(r, c):
        return m[:, r, c][:, None, None]

    # pass 1: horizontal map hx(y, j), (N, H, Wo)
    b = mc(0, 1) * j + mc(0, 2)
    d = mc(2, 1) * j + mc(2, 2)
    acy = mc(0, 0) - mc(2, 0) * y
    num = mc(1, 0) * (d * y - b) + (mc(1, 1) * j + mc(1, 2)) * acy
    den = mc(2, 0) * (d * y - b) + (mc(2, 1) * j + mc(2, 2)) * acy
    w1 = _line_weights(_safe_div(num, den), W)  # (N, H, Wo, W)
    i1 = torch.bmm(w1.reshape(N * H, Wo, W), _bf16(images).reshape(N * H, W, C))
    i1 = i1.reshape(N, H, Wo, C)

    # pass 2: vertical map sy(i, j), (N, Ho, Wo)
    sy = _safe_div(mc(0, 0) * i + b, mc(2, 0) * i + d)
    w2 = _line_weights(sy.transpose(1, 2), H)  # (N, Wo, Ho, H)
    cols = _bf16(i1).permute(0, 2, 1, 3).reshape(N * Wo, H, C)
    out = torch.bmm(w2.reshape(N * Wo, Ho, H), cols).reshape(N, Wo, Ho, C)
    return out.permute(0, 2, 1, 3).to(images.dtype)
