"""Dropout at BERT's hidden and embedding sites — counterpart of flax's
``nn.Dropout`` and of ``imagegenerator_tpu/ops/dropout.py``.

Both functions draw from an explicit ``torch.Generator`` on x's device.
Their bitstreams are PyTorch's, not threefry's: what carries over is the
keep rate, the rescaling and the errors.

* ``dropout`` — ``nn.Dropout``: keep with probability ``1 - rate``, then
  ``where(keep, x / keep_prob, 0)`` in x's dtype.
* ``bits_dropout`` — the keep decision drawn as ``bits``-wide integers:
  keep if ``draw >= thr`` with ``thr = round(rate * 2**bits)``, and rescale
  by the exact quantised keep probability ``1 - thr / 2**bits``, so the
  expectation is x exactly.

As in JAX, the keep probability is rounded to x's dtype before the
divide (a bf16 x is divided by a bf16 keep probability).
"""

from __future__ import annotations

import torch

__all__ = ["dropout", "bits_dropout"]


def _rescale(x, keep, keep_prob: float):
    scale = torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x, rate: float, generator=None):
    """``nn.Dropout(rate)`` in training mode."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return _rescale(x, keep, keep_prob)


def bits_dropout(x, rate: float, bits: int = 16, generator=None):
    """Unbiased dropout with a ``bits``-wide draw (8, 16 or 32).

    A positive rate that quantises to ``thr == 0`` (dropout silently off)
    or to ``thr == 2**bits`` (keep probability 0) raises ``ValueError``,
    as in the JAX package."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must be in [0, 1), got {rate}")
    if bits not in (8, 16, 32):
        raise KeyError(bits)
    n = 1 << bits
    thr = int(round(rate * n))
    if rate > 0.0 and thr == 0:
        raise ValueError(
            f"rate={rate} quantizes to 0 at bits={bits} (dropout would be"
            " silently disabled); use more bits for rates this small"
        )
    if thr >= n:
        raise ValueError(
            f"rate={rate} quantizes to keep probability 0 at bits={bits};"
            " use more bits for rates this close to 1"
        )
    if thr == 0:
        return x
    dtype = torch.int64 if bits == 32 else torch.int32
    draw = torch.randint(0, n, x.shape, generator=generator, device=x.device, dtype=dtype)
    return _rescale(x, draw >= thr, 1.0 - thr / n)
