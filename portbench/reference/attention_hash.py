"""The attention-prob dropout's keep mask: a frozen copy of the counter
hash that the port's attention kernels draw their bits from
(``csrc/attention_common.cuh``), addressed by (seed, batch row, head,
query, key). The reference computes it here, from its own copy, so that
no later change to the program can change what the reference expects.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def threshold(rate: float) -> int:
    """Keep iff ``bits >= threshold(rate)``."""
    return min(int(rate * 4294967296.0), 4294967295)


def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), in two 16-bit
    halves of ``c`` so that no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _finalize(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_mask(batch: int, num_heads: int, seq: int, seed: int, rate: float, device=None):
    """``(batch, heads, T, T)`` bool, True where the element is kept."""
    dev = dict(dtype=torch.int64, device=device)
    b = torch.arange(batch, **dev)[:, None]
    h = torch.arange(num_heads, **dev)[None, :]
    salt = (seed + b * 1000003 + h * 7919) & _MASK32
    r = torch.arange(seq, **dev)[:, None]
    c = torch.arange(seq, **dev)[None, :]
    rc = (_mul32(r, 0x9E3779B9) + _mul32(c, 0x85EBCA6B)) & _MASK32
    x = (rc + _mul32(salt, 0xC2B2AE35)[:, :, None, None]) & _MASK32
    return _finalize(x) >= threshold(rate)
