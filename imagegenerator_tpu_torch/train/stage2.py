"""Stage-II system, sampling subset — counterpart of
``imagegenerator_tpu/train/stage2.py``: the frozen stage-1 stack
(text -> projection -> CA1 -> G1, 64 px) under CA2 -> G2 (256 px), all in
eval mode. Training waits for a later port.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from imagegenerator_tpu_torch.models.bert import BertConfig, BertEncoder
from imagegenerator_tpu_torch.models.con_augment import ConditioningAugmentation
from imagegenerator_tpu_torch.models.stackgan import StageIGenerator, StageIIGenerator
from imagegenerator_tpu_torch.ops.layers import Dense


@dataclasses.dataclass(frozen=True)
class Stage2Config:
    """Model shape of the JAX ``Stage2Config`` (defaults: the reference's
    64 -> 256 px pipeline over BERT-base); ``compute_dtype`` is a torch
    dtype or None (f32)."""

    tem_size: int = 512
    c_dim: int = 128
    z_dim: int = 100
    h_dim: int = 256
    seq_len: int = 128
    num_residual: int = 4
    gen1_channels: tuple = (192, 96, 48, 24)
    g2_in_channels: int = 128
    g2_feat_channels: int = 512
    g2_res_channels: int = 320
    g2_up_channels: tuple = (320, 160, 80)
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    compute_dtype: Any = None

    @property
    def res1(self) -> int:
        """Stage-1 (input) resolution."""
        return 2 ** (len(self.gen1_channels) + 2)

    @property
    def resolution(self) -> int:
        """Stage-2 (output) resolution."""
        return self.res1 // 4 * 2 ** (len(self.g2_up_channels) + 1)

    @classmethod
    def tiny(cls, **kw) -> "Stage2Config":
        """The JAX package's tiny config: tiny widths, a 16 -> 32 px
        pyramid."""
        defaults = dict(
            tem_size=32,
            c_dim=16,
            z_dim=12,
            h_dim=16,
            seq_len=8,
            num_residual=1,
            gen1_channels=(24, 12),
            g2_in_channels=8,
            g2_feat_channels=16,
            g2_res_channels=8,
            g2_up_channels=(16, 8),
            bert=BertConfig.tiny(),
        )
        defaults.update(kw)
        return cls(**defaults)


class Stage2System(nn.Module):
    """Module names are the JAX state's; ``FLAX_FIELDS`` maps each to its
    subtree of ``Stage2State`` (``frozen_params``, ``frozen_gen_stats``,
    ``params``, ``batch_stats``)."""

    FLAX_FIELDS = {
        "encoder": ("frozen_params/encoder", None),
        "projection": ("frozen_params/projection", None),
        "con_augment_1": ("frozen_params/con_augment_1", None),
        "gen_1": ("frozen_params/gen_1", "frozen_gen_stats"),
        "con_augment_2": ("params/con_augment_2", None),
        "gen_2": ("params/generator", "batch_stats/generator"),
    }

    def __init__(self, config: Stage2Config, *, device=None, generator=None):
        super().__init__()
        self.config = c = config
        kw = dict(device=device, generator=generator)
        dt = c.compute_dtype
        self.encoder = BertEncoder(c.bert, dtype=dt, **kw)
        self.projection = Dense(c.bert.hidden_size, c.tem_size, dtype=dt, **kw)
        self.con_augment_1 = ConditioningAugmentation(c.tem_size, c.h_dim, c.c_dim, **kw)
        self.gen_1 = StageIGenerator(c.c_dim, c.z_dim, c.gen1_channels, dtype=dt, **kw)
        self.con_augment_2 = ConditioningAugmentation(c.tem_size, c.h_dim, c.c_dim, **kw)
        self.gen_2 = StageIIGenerator(
            c.c_dim,
            num_residual=c.num_residual,
            in_channels=c.g2_in_channels,
            feat_channels=c.g2_feat_channels,
            res_channels=c.g2_res_channels,
            up_channels=c.g2_up_channels,
            dtype=dt,
            **kw,
        )
        self.eval()

    def embed_texts(self, tokens, mask):
        """Caption embeddings through the frozen encoder + projection;
        feed them back as ``batch['tem']``."""
        hidden = self.encoder(tokens, mask)
        return self.projection(hidden[:, 0, :].float())

    def _frozen_64_from_tem(self, tem, generator, noise):
        """CA1 -> G1 from a text embedding: 64 px images, NHWC."""
        c_hat1, _, _ = self.con_augment_1(tem, eps=noise.get("ca1_eps"), generator=generator)
        z = noise.get("z")
        if z is None:
            z = torch.randn(
                (tem.shape[0], self.config.z_dim), generator=generator, device=tem.device
            )
        return self.gen_1(torch.cat([c_hat1, z.float()], dim=1))

    def _frozen_64(self, tokens, mask, generator, noise):
        """Frozen text -> CA1 -> G1. Returns ``(tem, fake_64)``."""
        tem = self.embed_texts(tokens, mask)
        return tem, self._frozen_64_from_tem(tem, generator, noise)

    @torch.no_grad()
    def sample(self, batch: dict, generator=None, noise=None):
        """256 px images ``(B, 256, 256, 3)`` in [-1, 1] from
        ``{'input_ids', 'attention_mask'}`` or a precomputed ``{'tem'}``.
        Noise is drawn from ``generator`` in the JAX order (CA1 ``eps``,
        ``z``, CA2 ``eps``) unless ``noise`` gives a draw (``'ca1_eps'``,
        ``'z'``, ``'ca2_eps'``)."""
        noise = noise or {}
        if "tem" in batch:
            tem = batch["tem"].float()
            fake_64 = self._frozen_64_from_tem(tem, generator, noise)
        else:
            tem, fake_64 = self._frozen_64(
                batch["input_ids"], batch["attention_mask"], generator, noise
            )
        c_hat2, _, _ = self.con_augment_2(tem, eps=noise.get("ca2_eps"), generator=generator)
        return self.gen_2(fake_64, c_hat2)
