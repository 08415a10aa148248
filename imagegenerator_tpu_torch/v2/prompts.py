"""Prompt parsing and the CLIP spherical-distance prompt loss —
counterpart of ``imagegenerator_tpu/v2/prompts.py``.

* ``split_prompt`` parses ``"text:weight:stop"`` with defaults (1, -inf).
* The prompt loss: squared spherical distance between normalised image
  and text embeddings, ``(||u - v|| / 2).arcsin()^2 * 2``, sign-flipped by
  the weight's sign (negative prompts push away), floored at ``stop``
  through ``replace_grad`` (gradients vanish once the distance passes the
  stop threshold), then scaled by |weight| and averaged over cutouts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from imagegenerator_tpu_torch.ops.grad_utils import replace_grad


def split_prompt(prompt: str) -> tuple[str, float, float]:
    """'text:weight:stop' -> (text, weight, stop); missing fields default
    to weight=1, stop=-inf."""
    parts = prompt.rsplit(":", 2)
    text = parts[0]
    weight = float(parts[1]) if len(parts) > 1 and parts[1] else 1.0
    stop = float(parts[2]) if len(parts) > 2 and parts[2] else float("-inf")
    return text, weight, stop


class PromptSpec(NamedTuple):
    embed: torch.Tensor  # (1, D) CLIP text embedding (unnormalised)
    weight: torch.Tensor  # scalar
    stop: torch.Tensor  # scalar


def spherical_dist(u, v):
    """Squared spherical distance between the L2-normalised rows of u
    ``(..., N, D)`` and v ``(..., M, D)`` -> ``(..., N, M)``. The arcsin
    argument is clamped to [0, 1 - 1e-7]: for near-antipodal embeddings
    float error can push ||diff|| / 2 past 1, which would make the value
    and the gradient NaN; the 1e-12 inside the sqrt keeps the norm's
    gradient finite at diff == 0."""
    un = u / u.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    vn = v / v.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    diff = un[..., :, None, :] - vn[..., None, :, :]
    norm = torch.sqrt(diff.square().sum(dim=-1) + 1e-12)
    half = (norm / 2.0).clamp(0.0, 1.0 - 1e-7)
    return torch.asin(half).square() * 2.0


def prompt_loss(image_embeds, spec: PromptSpec):
    """image_embeds ``(N_cutouts, D)`` -> the scalar prompt loss."""
    dists = spherical_dist(image_embeds, spec.embed)  # (N, 1)
    dists = dists * torch.sign(spec.weight)
    floored = replace_grad(dists, torch.maximum(dists, spec.stop))
    return spec.weight.abs() * floored.mean()
