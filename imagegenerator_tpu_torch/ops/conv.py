"""2-D convolutions with PyTorch padding semantics, on NCHW tensors.

Counterpart of ``imagegenerator_tpu/ops/conv.py``. The JAX package kept
torch's shape rules on NHWC/HWIO layouts; here the layouts are torch's
own, so the ops are ``F.conv2d``/``F.conv_transpose2d``. The JAX package
left its convs to XLA rather than to a kernel of its own, and the port
leaves them to cuDNN.

Kernel layouts and the mapping from the JAX package's:
  * ``conv2d``:           ``(out, in, kh, kw)`` = HWIO ``.transpose(3, 2, 0, 1)``
  * ``conv_transpose2d``: ``(in, out, kh, kw)`` = JAX ``(kh, kw, out, in)``
    ``.transpose(3, 2, 0, 1)``
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x, w, b=None, *, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Output spatial size ``(in + 2p - k) // s + 1``."""
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def conv_transpose2d(x, w, b=None, *, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Output spatial size ``(in - 1) * s - 2p + k`` (no output padding or
    dilation; the models never use them)."""
    return F.conv_transpose2d(x, w, b, stride=stride, padding=padding)
