"""Generators seeded from two integers."""

from __future__ import annotations

import torch


def mixed_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step`` of the run seeded ``seed``: seeded
    with a 64-bit mix of the two (splitmix64's finalizer), every bit of
    which depends on both, since a CPU generator reads only the low 32
    bits of its seed."""
    mask = (1 << 64) - 1
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xD1B54A32D192ED03 + 0x2545F4914F6CDD1D) & mask
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
    return torch.Generator(device=device).manual_seed((x ^ (x >> 31)) & ((1 << 63) - 1))
