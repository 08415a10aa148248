"""Random-cutout sampler — counterpart of
``imagegenerator_tpu/v2/cutouts.py``.

``cutn`` random square crops per step (size ``u ** cut_pow * (max - min)
+ min``, random offset), each resampled to the CLIP resolution,
augmented, and given scaled normal noise. All crops of a step are made
at once as batched tensor ops.

Ported: the composed fast path, taken when augmentation is on and the
image's short side is at most ``cut_size`` (every crop is then a pure
magnification, so antialiasing is a no-op): colour augmentations on
source-resolution copies, then crop + rescale + flip + affine +
perspective as two-pass warps, split (the default) into the augmentation
warp at source resolution and an axis-aligned resize, or composed into
one homography warp. The lanczos path (``force_lanczos``, augmentation
off, or an image larger than ``cut_size``) is not ported and raises
``NotImplementedError``.

The random draws are made apart from their use: ``draw`` makes all
draws of one call from a ``torch.Generator``; ``apply`` computes the
cutouts from given draws, so a caller can replay them.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from imagegenerator_tpu_torch.ops.grad_utils import clip
from imagegenerator_tpu_torch.v2.augment import (
    draw_color,
    draw_geometry,
    random_color_augment,
    random_geometry,
)
from imagegenerator_tpu_torch.v2.warp2pass import resize_axis_aligned, warp_homography_2pass


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
        crop sizes' ``u (cutn,)`` and offsets ``offs (cutn, 2)``, the
        colour and geometry draws (``augment.draw_color``,
        ``augment.draw_geometry``) for the ``B * cutn`` cutouts, the
        noise factors ``facs (B * cutn, 1, 1, 1)`` and the normal
        ``noise (B * cutn, cut_size, cut_size, C)``."""
        B, H, W, C = shape
        N = B * self.cutn
        kw = dict(generator=generator, device=device)
        draws = {
            "u": torch.rand((self.cutn,), **kw),
            "offs": torch.rand((self.cutn, 2), **kw),
            "color": draw_color(generator, N, device),
            "geometry": draw_geometry(generator, N, self.cut_size, self.cut_size, device),
        }
        if self.noise_fac:
            draws["facs"] = torch.rand((N, 1, 1, 1), **kw) * self.noise_fac
            draws["noise"] = torch.randn((N, self.cut_size, self.cut_size, C), **kw)
        return draws

    def apply(self, draws: dict, images):
        """images ``(B, H, W, C)`` in [0, 1] -> ``(B * cutn, cut_size,
        cut_size, C)`` with the given draws. Cutout i of every batch
        image shares its crop; sample ``n = b * cutn + i``."""
        B, H, W, C = images.shape
        if not self._fast_path(H, W):
            raise NotImplementedError(
                "MakeCutouts: only the composed fast path is ported (augment on, "
                f"image short side <= cut_size {self.cut_size}); the lanczos "
                f"path needed for a {H}x{W} image is not"
            )
        max_size = float(min(W, H))
        min_size = float(min(W, H, self.cut_size))
        sizes = draws["u"] ** self.cut_pow * (max_size - min_size) + min_size
        off_y = draws["offs"][:, 0] * (H - sizes)
        off_x = draws["offs"][:, 1] * (W - sizes)

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
        cuts = clip(cuts, 0.0, 1.0)
        if self.noise_fac:
            cuts = cuts + draws["facs"] * draws["noise"]
        return cuts

    def __call__(self, generator, images):
        """Draws from ``generator`` (on the images' device), then the
        cutouts."""
        return self.apply(self.draw(generator, images.shape, images.device), images)
