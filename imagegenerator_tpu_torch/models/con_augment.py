"""Conditioning Augmentation (StackGAN) — counterpart of
``imagegenerator_tpu/models/con_augment.py``:

    tem (tem_size) -> relu(Linear(h_dim)) -> mu, sigma (c_dim each)
    c_hat = mu + sigma * eps,  eps ~ N(0, I)

``sigma`` is the raw Dense output (no exp), as in the reference. The
layers compute in the dtype of ``tem``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from imagegenerator_tpu_torch.ops.layers import Dense


class ConditioningAugmentation(nn.Module):
    def __init__(self, tem_size=512, h_dim=256, c_dim=128, *, device=None,
                 generator=None):
        super().__init__()
        self.c_dim = c_dim
        kw = dict(device=device, generator=generator)
        self.h = Dense(tem_size, h_dim, **kw)
        self.mu = Dense(h_dim, c_dim, **kw)
        self.sigma = Dense(h_dim, c_dim, **kw)

    def encode(self, tem):
        h = F.relu(self.h(tem))
        return self.mu(h), self.sigma(h)

    def forward(self, tem, eps=None, generator=None):
        """Returns ``(c_hat, mu, sigma)``. ``eps`` is drawn from
        ``generator`` (on tem's device) unless it is given."""
        mu, sigma = self.encode(tem)
        if eps is None:
            eps = torch.randn(
                sigma.shape, generator=generator, device=sigma.device
            )
        return mu + sigma * eps.to(sigma.dtype), mu, sigma
