"""Latent initialization images — the port's own copy of
``imagegenerator_tpu/v2/init_image.py`` (numpy only): uint8 uniform
noise, or 3-channel linear gradients with random endpoints (R
horizontal, G/B vertical). Returned as float32 [0, 1] HWC arrays.
"""

from __future__ import annotations

import numpy as np


def random_noise_image(w: int, h: int, rng: np.random.Generator) -> np.ndarray:
    return rng.integers(0, 255, (h, w, 3), dtype=np.uint8).astype(np.float32) / 255.0


def _gradient_2d(start, stop, width, height, horizontal):
    if horizontal:
        return np.tile(np.linspace(start, stop, width), (height, 1))
    return np.tile(np.linspace(start, stop, height), (width, 1)).T


def random_gradient_image(w: int, h: int, rng: np.random.Generator) -> np.ndarray:
    starts = (0.0, 0.0, float(rng.integers(0, 255)))
    stops = (
        float(rng.integers(1, 255)),
        float(rng.integers(2, 255)),
        float(rng.integers(3, 128)),
    )
    horizontal = (True, False, False)
    out = np.zeros((h, w, 3), np.float32)
    for i in range(3):
        out[:, :, i] = _gradient_2d(starts[i], stops[i], w, h, horizontal[i])
    return np.clip(out, 0, 255).astype(np.float32) / 255.0
