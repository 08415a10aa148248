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

``keep_mask`` draws either function's keep decision alone and
``apply_keep`` applies one: a caller that must draw a mask before the
forward that uses it (a recomputed forward, a shard of a wider draw)
draws with the first and applies with the second, bit for bit what
``dropout`` and ``bits_dropout`` compute.
"""

from __future__ import annotations

import torch

__all__ = ["dropout", "bits_dropout", "keep_mask", "apply_keep"]


def _rescale(x, keep, keep_prob: float):
    scale = torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


def _threshold(rate: float, bits: int):
    """``(thr, n)`` of a ``bits``-wide draw, with ``bits_dropout``'s checks."""
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
    return thr, n


def keep_probability(rate: float, bits: int | None = None) -> float:
    """What a kept element is divided by: ``1 - rate`` for ``dropout``
    (``bits`` None), the quantised keep probability for ``bits_dropout``."""
    if bits is None:
        return 1.0 - rate
    thr, n = _threshold(rate, bits)
    return 1.0 - thr / n


def keep_mask(shape, rate: float, bits: int | None = None, generator=None, device=None):
    """The keep decision ``dropout`` (``bits`` None) or ``bits_dropout``
    draws for an x of ``shape`` on ``device``, as a bool tensor (True =
    keep); the same draw from the same generator state."""
    if bits is None:
        return torch.rand(shape, generator=generator, device=device) < 1.0 - rate
    thr, n = _threshold(rate, bits)
    dtype = torch.int64 if bits == 32 else torch.int32
    return torch.randint(0, n, shape, generator=generator, device=device, dtype=dtype) >= thr


def apply_keep(x, keep, keep_prob: float):
    """``where(keep, x / keep_prob, 0)`` in x's dtype."""
    return _rescale(x, keep, keep_prob)


def dropout(x, rate: float, generator=None):
    """``nn.Dropout(rate)`` in training mode."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    return _rescale(x, keep_mask(x.shape, rate, None, generator, x.device), 1.0 - rate)


def bits_dropout(x, rate: float, bits: int = 16, generator=None):
    """Unbiased dropout with a ``bits``-wide draw (8, 16 or 32).

    A positive rate that quantises to ``thr == 0`` (dropout silently off)
    or to ``thr == 2**bits`` (keep probability 0) raises ``ValueError``,
    as in the JAX package."""
    thr, n = _threshold(rate, bits)
    if thr == 0:
        return x
    return _rescale(x, keep_mask(x.shape, rate, bits, generator, x.device), 1.0 - thr / n)
