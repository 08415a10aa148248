"""Seeded weights for every tensor of a model's ``state_dict``, made on
the device in two large draws, f32 as the program holds them.

The law, by name and shape: normalisation scales 1 and shifts 0
(``LayerNorm``, ``BatchNorm``), running means 0 and variances 1;
embeddings normal with BERT's ``initializer_range`` 0.02; every other
tensor uniform in ``+-1/sqrt(fan_in)``, where a weight's fan-in is the
product of its shape past the first axis (a transposed convolution's
``(in, out, k, k)`` weight gives ``out * k * k``, torch's own rule) and a
bias takes its weight's.
"""

from __future__ import annotations

import math

import torch

from portbench.common import mix

WEIGHT_STREAM = 1
EMBEDDING_STD = 0.02


def _law(name: str, shapes: dict):
    """``("const", value)``, ``("normal", std)`` or ``("uniform", bound)``."""
    if name.endswith("running_mean"):
        return "const", 0.0
    if name.endswith("running_var"):
        return "const", 1.0
    if "LayerNorm" in name or "BatchNorm" in name:
        return "const", 1.0 if name.endswith("weight") else 0.0
    if "embeddings" in name:
        return "normal", EMBEDDING_STD
    weight = name if name.endswith("weight") else name[: -len("bias")] + "weight"
    fan_in = math.prod(shapes[weight][1:])
    return "uniform", 1.0 / math.sqrt(fan_in)


def make(shapes: dict, seed: int, device) -> dict:
    """name -> f32 tensor on ``device`` for ``shapes`` (name -> shape), in
    sorted name order: one uniform and one normal draw for all."""
    names = sorted(shapes)
    laws = {n: _law(n, shapes) for n in names}
    count = {kind: sum(math.prod(shapes[n]) for n in names if laws[n][0] == kind)
             for kind in ("uniform", "normal")}
    g = torch.Generator(device=device).manual_seed(mix(seed, WEIGHT_STREAM))
    flat = {"uniform": torch.rand(count["uniform"], generator=g, device=device).mul_(2).sub_(1),
            "normal": torch.randn(count["normal"], generator=g, device=device)}
    at = {"uniform": 0, "normal": 0}
    out = {}
    for n in names:
        kind, value = laws[n]
        shape = tuple(shapes[n])
        if kind == "const":
            out[n] = torch.full(shape, value, device=device)
            continue
        size = math.prod(shape)
        out[n] = flat[kind][at[kind]:at[kind] + size].view(shape).mul(value)
        at[kind] += size
    return out
