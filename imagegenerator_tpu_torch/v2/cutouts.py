"""Random-cutout sampler — counterpart of
``imagegenerator_tpu/v2/cutouts.py``.

``cutn`` random square crops per step (size ``u ** cut_pow * (max - min)
+ min``, random offset), each resampled to the CLIP resolution,
augmented, and given scaled normal noise. All crops of a step are made
at once as batched tensor ops. Two paths:

* the composed fast path, taken when augmentation is on and the image's
  short side is at most ``cut_size`` (every crop is then a pure
  magnification, so antialiasing is a no-op): colour augmentations on
  source-resolution copies, then crop + rescale + flip + affine +
  perspective as two-pass warps, split (the default) into the
  augmentation warp at source resolution and an axis-aligned resize, or
  composed into one homography warp;
* the lanczos path otherwise (``force_lanczos``, augmentation off, or an
  image larger than ``cut_size``): each crop is resampled by the
  antialiased lanczos3 weights of ``jax.image.scale_and_translate``
  (``scale_weights``, one ``(cut_size, in)`` matrix per crop and axis,
  applied as two f32 products), clipped to [0, 1], then, with
  augmentation on, given the whole stack of ``augment.random_augment``.

The random draws are made apart from their use: ``draw`` makes all
draws of one call from a ``torch.Generator``; ``apply`` computes the
cutouts from given draws, so a caller can replay them.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from imagegenerator_tpu_torch.ops.grad_utils import clip
from imagegenerator_tpu_torch.v2.augment import (
    draw_augment,
    draw_color,
    draw_geometry,
    random_augment,
    random_color_augment,
    random_geometry,
)
from imagegenerator_tpu_torch.v2.warp2pass import resize_axis_aligned, warp_homography_2pass


_EPS32 = float(torch.finfo(torch.float32).eps)


def lanczos3(x):
    """The lanczos kernel of radius 3 at ``x >= 0``, as
    ``jax.image``'s ``_fill_lanczos_kernel`` computes it."""
    y = 3.0 * torch.sin(math.pi * x) * torch.sin(math.pi * x / 3.0)
    out = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi ** 2 * x ** 2, 1.0), 1.0)
    return torch.where(x > 3.0, 0.0, out)


def scale_weights(in_size: int, out_size: int, scale, translation):
    """Per-crop resampling weights ``(n, out_size, in_size)`` of the map
    ``out = in * scale + translation`` (half-pixel centres), as
    ``jax.image.scale_and_translate(..., method="lanczos3")`` with its
    default ``antialias=True`` builds them (``compute_weight_mat``): the
    kernel widened by ``max(1 / scale, 1)`` when downsampling, each output
    normalised by its weight sum (zeroed where that sum is under 1000 eps),
    and zeroed where the sample falls outside ``[-0.5, in_size - 0.5]``.
    ``scale``, ``translation``: ``(n,)`` f32."""
    inv_scale = 1.0 / scale
    kernel_scale = inv_scale.clamp_min(1.0)
    dev = dict(dtype=torch.float32, device=scale.device)
    sample_f = ((torch.arange(out_size, **dev) + 0.5) * inv_scale[:, None]
                - (translation * inv_scale)[:, None] - 0.5)  # (n, out)
    x = (sample_f[..., None] - torch.arange(in_size, **dev)).abs() / kernel_scale[:, None, None]
    weights = lanczos3(x)
    total = weights.sum(dim=-1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * _EPS32,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[..., None], weights, 0.0)


@dataclasses.dataclass(frozen=True)
class MakeCutouts:
    cut_size: int
    cutn: int = 32
    cut_pow: float = 1.0
    noise_fac: float = 0.1
    augment: bool = True
    force_lanczos: bool = False
    # Split the fast-path warp into (augmentation warp at source
    # resolution) + (axis-aligned resize) instead of one composed
    # homography warp. None = env IMAGEGEN_WARP_SPLIT (default on).
    warp_split: bool | None = None
    # The homography warp through the scanline kernel instead of the
    # dense form. None = env IMAGEGEN_WARP_KERNEL (default off).
    warp_kernel: bool | None = None

    def _use_split(self) -> bool:
        if self.warp_split is not None:
            return self.warp_split
        return os.environ.get("IMAGEGEN_WARP_SPLIT", "1") == "1"

    def _fast_path(self, H, W) -> bool:
        return self.augment and not self.force_lanczos and min(H, W) <= self.cut_size

    def draw(self, generator, shape, device=None) -> dict:
        """All draws of one call on images of ``shape (B, H, W, C)``: the
        crop sizes' ``u (cutn,)`` and offsets ``offs (cutn, 2)``; for the
        ``B * cutn`` cutouts the colour and geometry draws
        (``augment.draw_color``, ``augment.draw_geometry``) on the fast
        path, or the stack's (``augment.draw_augment``) on the lanczos
        path with augmentation on; the noise factors ``facs (B * cutn, 1,
        1, 1)`` and the normal ``noise (B * cutn, cut_size, cut_size,
        C)``."""
        B, H, W, C = shape
        N = B * self.cutn
        kw = dict(generator=generator, device=device)
        draws = {
            "u": torch.rand((self.cutn,), **kw),
            "offs": torch.rand((self.cutn, 2), **kw),
        }
        if self._fast_path(H, W):
            draws["color"] = draw_color(generator, N, device)
            draws["geometry"] = draw_geometry(generator, N, self.cut_size, self.cut_size, device)
        elif self.augment:
            draws["augment"] = draw_augment(generator, N, self.cut_size, self.cut_size, device)
        if self.noise_fac:
            draws["facs"] = torch.rand((N, 1, 1, 1), **kw) * self.noise_fac
            draws["noise"] = torch.randn((N, self.cut_size, self.cut_size, C), **kw)
        return draws

    def take_images(self, draws: dict, start: int, stop: int) -> dict:
        """The draws of images ``start .. stop - 1`` of the batch ``draws``
        were made for: the crops (``u``, ``offs``) are every image's; every
        other draw has a row per cutout, ``cutn`` rows an image."""

        def rows(v):
            if isinstance(v, dict):
                return {k: rows(x) for k, x in v.items()}
            return v[start * self.cutn:stop * self.cutn]

        return {k: v if k in ("u", "offs") else rows(v) for k, v in draws.items()}

    def apply(self, draws: dict, images):
        """images ``(B, H, W, C)`` in [0, 1] -> ``(B * cutn, cut_size,
        cut_size, C)`` with the given draws. Cutout i of every batch
        image shares its crop; sample ``n = b * cutn + i``."""
        B, H, W, C = images.shape
        max_size = float(min(W, H))
        min_size = float(min(W, H, self.cut_size))
        sizes = draws["u"] ** self.cut_pow * (max_size - min_size) + min_size
        off_y = draws["offs"][:, 0] * (H - sizes)
        off_x = draws["offs"][:, 1] * (W - sizes)
        if self._fast_path(H, W):
            cuts = self._fast_cutouts(draws, images, sizes, off_y, off_x)
        else:
            cuts = self._lanczos_cutouts(draws, images, sizes, off_y, off_x)
        if self.noise_fac:
            cuts = cuts + draws["facs"] * draws["noise"]
        return cuts

    def _lanczos_cutouts(self, draws, images, sizes, off_y, off_x):
        """Each crop window ``[o, o + size)`` mapped onto ``[0, cut_size)``
        by the lanczos3 weights of ``scale_weights``, in f32 (a bf16 image
        is widened first: a bf16 product would round its result), then
        clipped and, with augmentation on, ``random_augment``."""
        B, H, W, C = images.shape
        s = self.cut_size
        scale = s / sizes  # (cutn,)
        wy = scale_weights(H, s, scale, -off_y * scale)  # (cutn, s, H)
        wx = scale_weights(W, s, scale, -off_x * scale)  # (cutn, s, W)
        n = self.cutn
        x = images.float().permute(1, 0, 2, 3).reshape(H, B * W * C)
        rows = (wy.reshape(n * s, H) @ x).reshape(n, s, B, W, C)  # over H
        rows = rows.permute(0, 3, 1, 2, 4).reshape(n, W, s * B * C)
        cuts = torch.bmm(wx, rows).reshape(n, s, s, B, C)  # over W: (cutn, j, i, B, C)
        cuts = cuts.permute(3, 0, 2, 1, 4).reshape(B * n, s, s, C)
        cuts = clip(cuts, 0.0, 1.0).to(images.dtype)
        if self.augment:
            cuts = random_augment(draws["augment"], cuts, warp_kernel=self.warp_kernel)
        return cuts

    def _fast_cutouts(self, draws, images, sizes, off_y, off_x):
        B, H, W, C = images.shape
        N = B * self.cutn
        copies = images[:, None].expand(B, self.cutn, H, W, C).reshape(N, H, W, C)
        colored = random_color_augment(draws["color"], clip(copies, 0.0, 1.0))
        Ms_aug = random_geometry(draws["geometry"], self.cut_size, self.cut_size)
        # crop map: out (cut_size) -> source window [o, o + size), with
        # pixel-centre alignment: src = (out + 0.5) s - 0.5 + o
        #                             = s out + o + (s - 1) / 2
        s = (sizes / self.cut_size).repeat(B)  # (N,), cutout index fastest
        t_y = (off_y + (sizes / self.cut_size - 1.0) / 2.0).repeat(B)
        t_x = (off_x + (sizes / self.cut_size - 1.0) / 2.0).repeat(B)
        zeros, ones = torch.zeros_like(s), torch.ones_like(s)

        def rows(r0, r1):
            return torch.stack([torch.stack(r0, -1), torch.stack(r1, -1),
                                torch.stack([zeros, zeros, ones], -1)], dim=-2)

        M_crop = rows([s, zeros, t_y], [zeros, s, t_x])  # (N, 3, 3)
        if self._use_split():
            # G = M_crop @ M_aug = M_aug_src @ M_crop with M_aug_src =
            # M_crop M_aug M_crop^-1, the augmentation homography
            # conjugated into source coordinates: the augmentation warp
            # runs at source resolution and the crop + rescale becomes an
            # axis-aligned resize whose weights are shared across
            # scanlines. One more lerp stage when affine or perspective
            # fire; flip-only and unaugmented cutouts stay exact.
            inv_crop = rows([1.0 / s, zeros, -t_y / s], [zeros, 1.0 / s, -t_x / s])
            M_aug_src = M_crop @ Ms_aug @ inv_crop
            auged = warp_homography_2pass(
                colored, M_aug_src, out_shape=(H, W), warp_kernel=self.warp_kernel
            )
            cuts = resize_axis_aligned(
                auged,
                scale=torch.stack([s, s], -1),
                offset=torch.stack([t_y, t_x], -1),
                out_shape=(self.cut_size, self.cut_size),
            )
        else:
            cuts = warp_homography_2pass(
                colored, M_crop @ Ms_aug, out_shape=(self.cut_size, self.cut_size),
                warp_kernel=self.warp_kernel,
            )
        return clip(cuts, 0.0, 1.0)

    def __call__(self, generator, images):
        """Draws from ``generator`` (on the images' device), then the
        cutouts."""
        return self.apply(self.draw(generator, images.shape, images.device), images)
