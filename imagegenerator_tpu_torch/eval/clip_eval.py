"""CLIP-based quality metrics — counterpart of
``imagegenerator_tpu/eval/clip_eval.py``.

* **CLIPScore** (Hessel et al. 2021): ``100 * max(cos(E_img, E_txt), 0)``
  averaged over (image, caption) pairs.
* **CLIP features** for the Fréchet distance (CLIP-FID): the image
  tower's projected embedding, not normalised (Kynkaanniemi et al. 2022).

Images enter as [0, 1] float NHWC at any size. On the model's device
they are resized to the tower's resolution (bicubic, Keys a = -0.5,
antialiased when shrinking: ``F.interpolate(..., antialias=True)``,
which is what ``jax.image.resize(..., "cubic")`` computes; PyTorch's
default bicubic, a = -0.75 without antialiasing, is not), then clipped
to [0, 1], then CLIP-normalised, in that order. The model is run over
fixed batches; the last, ragged batch runs at its own size.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from imagegenerator_tpu_torch.v2.clip import normalize_image

__all__ = ["image_embeddings", "text_embeddings", "clip_score", "prepare_images"]


def prepare_images(images01, resolution: int, dtype=None) -> torch.Tensor:
    """``(N, H, W, 3)`` [0, 1] images (a tensor on the model's device) ->
    the tower's input: resized to ``resolution`` where they are not at
    it, clipped, CLIP-normalised, in ``dtype`` (None: f32)."""
    x = images01.float()
    if x.shape[1] != resolution or x.shape[2] != resolution:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(resolution, resolution), mode="bicubic",
                          antialias=True, align_corners=False).permute(0, 2, 3, 1)
    return normalize_image(x.clamp(0.0, 1.0)).to(dtype or torch.float32)


def _device(model) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def image_embeddings(model, images01, batch_size: int = 32) -> np.ndarray:
    """``(N, H, W, 3)`` [0, 1] images (numpy or a tensor) through
    ``model.encode_image`` (a ``v2.clip.CLIP``, on its device and in its
    dtype) -> ``(N, embed_dim)`` f32 numpy."""
    images01 = torch.as_tensor(np.asarray(images01, np.float32))
    if images01.ndim != 4 or images01.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) images, got {tuple(images01.shape)}")
    dev, res = _device(model), model.config.image_resolution
    out = []
    for start in range(0, images01.shape[0], batch_size):
        x = prepare_images(images01[start:start + batch_size].to(dev), res, model.dtype)
        out.append(model.encode_image(x).float().cpu().numpy())
    return np.concatenate(out, axis=0)


@torch.no_grad()
def text_embeddings(model, tokens, batch_size: int = 64) -> np.ndarray:
    """``(N, context_length)`` int tokens -> ``(N, embed_dim)`` f32
    numpy."""
    tokens = torch.as_tensor(np.asarray(tokens, np.int64))
    dev = _device(model)
    out = [model.encode_text(tokens[s:s + batch_size].to(dev)).float().cpu().numpy()
           for s in range(0, tokens.shape[0], batch_size)]
    return np.concatenate(out, axis=0)


def clip_score(image_embeds, text_embeds) -> float:
    """Mean CLIPScore over aligned (image, text) embedding rows: ``100 *
    max(cos, 0)`` per pair, in float64 on the host."""
    ie = np.asarray(image_embeds, np.float64)
    te = np.asarray(text_embeds, np.float64)
    if ie.shape != te.shape:
        raise ValueError(f"embedding shapes differ: {ie.shape} vs {te.shape}")
    ie = ie / np.linalg.norm(ie, axis=-1, keepdims=True)
    te = te / np.linalg.norm(te, axis=-1, keepdims=True)
    cos = (ie * te).sum(axis=-1)
    return float(np.mean(np.maximum(cos, 0.0)) * 100.0)
