"""Image augmentations of the v2 cutout sampler — counterpart of
``imagegenerator_tpu/v2/augment.py``: the colour half (hue/saturation
jitter, sharpness) and the geometry (flip, rotation + translation,
perspective, as inverse-map homographies) of

  RandomHorizontalFlip(p=.5) -> ColorJitter(hue=.01, saturation=.01,
  p=.7) -> RandomSharpness(.3, p=.4) -> RandomAffine(30deg, translate
  .1, p=.8, border padding) -> RandomPerspective(.2, p=.4)

Every function is batched over leading axes where the JAX package maps a
per-image function with ``vmap``. The random draws are made apart from
their use: ``draw_color`` and ``draw_geometry`` draw from a
``torch.Generator`` what ``random_color_augment`` and ``random_geometry``
then apply, so that a caller can replay given draws. ``random_augment``
and ``bilinear_sample``, which serve only the lanczos cutout path, are
not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from imagegenerator_tpu_torch.ops.grad_utils import clip


# ---------------------------------------------------------------- color
def rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    deltac = maxc - minc
    s = torch.where(maxc > 0, deltac / maxc.clamp_min(1e-8), 0.0)
    deltac_safe = torch.where(deltac > 0, deltac, 1.0)
    rc = (maxc - r) / deltac_safe
    gc = (maxc - g) / deltac_safe
    bc = (maxc - b) / deltac_safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(deltac > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv):
    """Branchless: ``r, g, b = v - v s clip(min(k, 4 - k), 0, 1)`` with
    ``k = (n + 6 h) mod 6`` for n = 5, 3, 1."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]

    def channel(n):
        k = torch.remainder(n + h * 6.0, 6.0)
        return v - v * s * clip(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([channel(5.0), channel(3.0), channel(1.0)], dim=-1)


def _per_image(t, ndim):
    """A per-image factor ``(N,)`` (or a scalar) shaped to broadcast over
    an ``ndim``-axis batch."""
    t = torch.as_tensor(t)
    return t.reshape(t.shape + (1,) * (ndim - t.ndim)) if t.ndim else t


def color_jitter(img, hue_shift, sat_factor):
    """img ``(..., H, W, 3)`` in [0, 1]; hue_shift in turns;
    multiplicative saturation; both per image or scalar."""
    hsv = rgb_to_hsv(clip(img, 0.0, 1.0))
    h = torch.remainder(hsv[..., 0] + _per_image(hue_shift, img.ndim - 1), 1.0)
    s = clip(hsv[..., 1] * _per_image(sat_factor, img.ndim - 1), 0.0, 1.0)
    return hsv_to_rgb(torch.stack([h, s, hsv[..., 2]], dim=-1))


def sharpness(img, factor):
    """torchvision-style: blend the image with a fixed 3x3 smoothing of
    its interior; the 1-px border stays as it is. factor 1 = identity,
    > 1 = sharper. img ``(H, W, C)`` or ``(N, H, W, C)``; factor scalar
    or ``(N,)``."""
    batched = img.ndim == 4
    x = img if batched else img[None]
    N, H, W, C = x.shape
    kernel = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]],
                          dtype=x.dtype, device=x.device) / 13.0
    planes = x.permute(0, 3, 1, 2).reshape(N * C, 1, H, W)
    blurred = F.conv2d(planes, kernel[None, None], padding=1)
    blurred = blurred.reshape(N, C, H, W).permute(0, 2, 3, 1)
    yy = torch.arange(H, device=x.device)[:, None]
    xx = torch.arange(W, device=x.device)[None, :]
    interior = ((yy > 0) & (yy < H - 1) & (xx > 0) & (xx < W - 1))[..., None]
    blended = x + (_per_image(factor, 4) - 1.0) * (x - blurred)
    out = torch.where(interior, clip(blended, 0.0, 1.0), x)
    return out if batched else out[0]


# ------------------------------------------------------------ geometric
def affine_homography(H, W, angle_deg, translate, scale=1.0):
    """Inverse-map homography ``(..., 3, 3)`` in (y, x, 1) coordinates of
    a rotation + translation about the image centre; angle_deg ``(...)``,
    translate ``(..., 2)``."""
    angle_deg = torch.as_tensor(angle_deg, dtype=torch.float32)
    translate = torch.as_tensor(translate, dtype=torch.float32, device=angle_deg.device)
    theta = angle_deg * (math.pi / 180.0)
    cos, sin = torch.cos(theta) / scale, torch.sin(theta) / scale
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    oy = cy + translate[..., 0]
    ox = cx + translate[..., 1]
    zero, one = torch.zeros_like(cos), torch.ones_like(cos)
    return torch.stack([
        torch.stack([cos, sin, -cos * oy - sin * ox + cy], dim=-1),
        torch.stack([-sin, cos, sin * oy - cos * ox + cx], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


def perspective_homography(H, W, src_corners):
    """Inverse-map homography ``(..., 3, 3)`` sending the output
    rectangle's corners to ``src_corners`` ``(..., 4, 2)`` (order: tl, tr,
    br, bl, as (y, x)): Heckbert's unit-square-to-quad construction
    composed with the rectangle-to-unit-square scaling, in closed form."""
    q = src_corners[..., [0, 3, 2, 1], :]  # tl, bl, br, tr
    x0, x1, x2, x3 = q[..., 0, 0], q[..., 1, 0], q[..., 2, 0], q[..., 3, 0]  # sy at corners
    y0, y1, y2, y3 = q[..., 0, 1], q[..., 1, 1], q[..., 2, 1], q[..., 3, 1]  # sx at corners
    sx_, sy_ = x0 - x1 + x2 - x3, y0 - y1 + y2 - y3
    dx1, dx2 = x1 - x2, x3 - x2
    dy1, dy2 = y1 - y2, y3 - y2
    den = dx1 * dy2 - dx2 * dy1
    g = (sx_ * dy2 - dx2 * sy_) / den
    h = (dx1 * sy_ - sx_ * dy1) / den
    a = x1 - x0 + g * x1
    b = x3 - x0 + h * x3
    d = y1 - y0 + g * y1
    e = y3 - y0 + h * y3
    iu, iv = 1.0 / (H - 1.0), 1.0 / (W - 1.0)
    return torch.stack([
        torch.stack([a * iu, b * iv, x0], dim=-1),
        torch.stack([d * iu, e * iv, y0], dim=-1),
        torch.stack([g * iu, h * iv, torch.ones_like(x0)], dim=-1),
    ], dim=-2)


# ------------------------------------------------------------- pipeline
def _uniform(shape, lo, hi, generator, device):
    return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo


def _bernoulli(shape, p, generator, device):
    return torch.rand(shape, generator=generator, device=device) < p


def draw_color(generator, n, device=None, *, hue=0.01, sat=0.01, sharp=0.3,
               p_jitter=0.7, p_sharp=0.4) -> dict:
    """The draws of ``random_color_augment`` for ``n`` images."""
    return {
        "do_jit": _bernoulli((n,), p_jitter, generator, device),
        "hue_shift": _uniform((n,), -hue, hue, generator, device),
        "sat_fac": _uniform((n,), 1 - sat, 1 + sat, generator, device),
        "do_sharp": _bernoulli((n,), p_sharp, generator, device),
        "sharp_fac": _uniform((n,), 1.0, 1.0 + sharp, generator, device),
    }


def random_color_augment(draws: dict, batch):
    """The colour half of the stack (jitter, then sharpness) on
    ``batch (N, H, W, 3)`` with the draws of ``draw_color``."""
    jittered = color_jitter(batch, draws["hue_shift"], draws["sat_fac"])
    batch = torch.where(draws["do_jit"][:, None, None, None], jittered, batch)
    sharped = sharpness(batch, draws["sharp_fac"])
    return torch.where(draws["do_sharp"][:, None, None, None], sharped, batch)


def draw_geometry(generator, n, H, W, device=None, *, degrees=30.0, translate=0.1,
                  p_flip=0.5, p_affine=0.8, p_persp=0.4) -> dict:
    """The draws of ``random_geometry`` for ``n`` images of ``(H, W)``:
    ``trans`` in pixels, ``corner_u`` the unit draws of the perspective
    corners' displacements."""
    hw = torch.tensor([H, W], dtype=torch.float32, device=device)
    return {
        "do_flip": _bernoulli((n,), p_flip, generator, device),
        "do_aff": _bernoulli((n,), p_affine, generator, device),
        "angles": _uniform((n,), -degrees, degrees, generator, device),
        "trans": _uniform((n, 2), -translate, translate, generator, device) * hw,
        "do_persp": _bernoulli((n,), p_persp, generator, device),
        "corner_u": torch.rand((n, 4, 2), generator=generator, device=device),
    }


def random_geometry(draws: dict, H, W, *, distortion=0.2):
    """Per-image inverse-map homographies ``(n, 3, 3)`` at ``(H, W)``
    output coordinates from the draws of ``draw_geometry``: horizontal
    flip, rotation + translation, perspective, identity where an
    augmentation does not fire, composed as ``M = F @ A @ P``."""
    device = draws["angles"].device
    eye = torch.eye(3, device=device)
    flip = torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, W - 1.0], [0.0, 0.0, 1.0]], device=device)
    base = torch.tensor([[0.0, 0.0], [0.0, W - 1.0], [H - 1.0, W - 1.0], [H - 1.0, 0.0]],
                        device=device)
    sign = torch.tensor([[1.0, 1.0], [1.0, -1.0], [-1.0, -1.0], [-1.0, 1.0]], device=device)
    reach = torch.tensor([distortion * H / 2.0, distortion * W / 2.0], device=device)
    corners = base + draws["corner_u"] * reach * sign

    def pick(sel, m):
        return torch.where(sel[:, None, None], m, eye)

    Fm = pick(draws["do_flip"], flip)
    A = pick(draws["do_aff"], affine_homography(H, W, draws["angles"], draws["trans"]))
    Pm = pick(draws["do_persp"], perspective_homography(H, W, corners))
    return Fm @ A @ Pm
