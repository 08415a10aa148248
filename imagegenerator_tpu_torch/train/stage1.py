"""Stage-I system, sampling subset — counterpart of
``imagegenerator_tpu/train/stage1.py``: deterministic text encode
(dropout off) -> projection -> CA -> z -> G1 in eval mode, 64 px.
Training waits for a later port.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from imagegenerator_tpu_torch.models.bert import BertConfig, BertEncoder
from imagegenerator_tpu_torch.models.con_augment import ConditioningAugmentation
from imagegenerator_tpu_torch.models.stackgan import StageIGenerator
from imagegenerator_tpu_torch.ops.layers import Dense


@dataclasses.dataclass(frozen=True)
class Stage1Config:
    """Model shape of the JAX ``Stage1Config`` (defaults: the reference's
    64 px nets over BERT-base); ``compute_dtype`` is a torch dtype or
    None (f32)."""

    tem_size: int = 512
    c_dim: int = 128
    z_dim: int = 100
    h_dim: int = 256
    seq_len: int = 128
    gen_channels: tuple = (192, 96, 48, 24)
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    compute_dtype: Any = None

    @property
    def resolution(self) -> int:
        return 2 ** (len(self.gen_channels) + 2)

    @classmethod
    def tiny(cls, **kw) -> "Stage1Config":
        """The JAX package's tiny config: tiny widths, 16 px."""
        defaults = dict(
            tem_size=32,
            c_dim=16,
            z_dim=12,
            h_dim=16,
            seq_len=8,
            gen_channels=(24, 12),
            bert=BertConfig.tiny(),
        )
        defaults.update(kw)
        return cls(**defaults)


class Stage1System(nn.Module):
    """The stage-1 generator side in eval mode. Module names are the JAX
    state's (``encoder``, ``projection``, ``con_augment``, ``generator``);
    ``FLAX_FIELDS`` maps each to its ``params``/``batch_stats`` subtree."""

    FLAX_FIELDS = {
        "encoder": ("params/encoder", None),
        "projection": ("params/projection", None),
        "con_augment": ("params/con_augment", None),
        "generator": ("params/generator", "batch_stats/generator"),
    }

    def __init__(self, config: Stage1Config, *, device=None, generator=None):
        super().__init__()
        self.config = c = config
        kw = dict(device=device, generator=generator)
        self.encoder = BertEncoder(c.bert, dtype=c.compute_dtype, **kw)
        self.projection = Dense(c.bert.hidden_size, c.tem_size, dtype=c.compute_dtype, **kw)
        self.con_augment = ConditioningAugmentation(c.tem_size, c.h_dim, c.c_dim, **kw)
        self.generator = StageIGenerator(
            c.c_dim, c.z_dim, c.gen_channels, dtype=c.compute_dtype, **kw
        )
        self.eval()

    def encode_text(self, tokens, mask):
        """tokens -> tem: CLS hidden state -> projection (dropout off)."""
        hidden = self.encoder(tokens, mask)
        return self.projection(hidden[:, 0, :].float())

    @torch.no_grad()
    def sample(self, batch: dict, generator=None, noise=None):
        """64 px images ``(B, 64, 64, 3)`` from ``{'input_ids',
        'attention_mask'}`` or a precomputed ``{'tem'}``. The CA ``eps``
        and then ``z`` are drawn from ``generator`` unless ``noise``
        gives them (``'ca_eps'``, ``'z'``)."""
        noise = noise or {}
        if "tem" in batch:
            tem = batch["tem"].float()
        else:
            tem = self.encode_text(batch["input_ids"], batch["attention_mask"])
        c_hat, _, _ = self.con_augment(tem, eps=noise.get("ca_eps"), generator=generator)
        z = noise.get("z")
        if z is None:
            z = torch.randn(
                (tem.shape[0], self.config.z_dim), generator=generator, device=tem.device
            )
        return self.generator(torch.cat([c_hat, z.float()], dim=1))
