"""Stage-II system: the 256 px refinement WGAN-GP training step and
sampling — counterpart of ``imagegenerator_tpu/train/stage2.py``. The
frozen stage-1 stack (text encoder -> projection -> CA1 -> G1, 64 px)
feeds CA2 -> G2 (256 px) and the Stage-II critic; the step trains CA2,
G2 and the critic through the update core of ``train/wgan.py``.

Order of work in a step (JAX ``train_step``):
  1. the caption permutation; the text embedding ``tem`` (``batch['tem']``,
     or ONE forward of the frozen encoder and projection in eval mode,
     the ``text`` span) and ``tem_mis = tem[perm]``;
  2. critic iteration i: the frozen CA1 -> G1 (eval mode) on that
     iteration's noise, then CA2 -> G2 in training mode without grad (G2's
     BatchNorm statistics update), then the critic update;
  3. the generator step on the last iteration's noise: G2 once more from
     the carried statistics against the updated critic, ``loss =
     -mean(s_fake) + kl(mu2, sigma2)``. The JAX step runs the frozen stack
     again on the last iteration's keys; the stack is deterministic, so
     the port keeps that iteration's 64 px images instead (same values).

Only CA2, G2 and the critic are ever in training mode or seen by an
optimizer; the frozen stack stays in eval mode under ``no_grad``.

Noise: the permutation, then per iteration (ca1_eps, z, ca2_eps, gp_eps);
a ``noise`` dict replays ``perm (B,)`` and the others by iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from imagegenerator_tpu_torch.models.bert import BertConfig, BertEncoder
from imagegenerator_tpu_torch.models.con_augment import ConditioningAugmentation
from imagegenerator_tpu_torch.models.stackgan import (
    StageIGenerator,
    StageIIDiscriminator,
    StageIIGenerator,
)
from imagegenerator_tpu_torch.ops.layers import Dense
from imagegenerator_tpu_torch.ops.remat import remat
from imagegenerator_tpu_torch.train import losses, wgan
from imagegenerator_tpu_torch.train.stage1 import Stage1Config
from imagegenerator_tpu_torch.utils.device import entry_device
from imagegenerator_tpu_torch.utils.profiling import span

# the JAX state's names of the trained modules -> the system's attributes
TRAINED = {"con_augment_2": "con_augment_2", "generator": "gen_2", "critic": "critic_2"}
GEN_SIDE = ("con_augment_2", "generator")
# a Stage1System's modules -> the frozen stack's
FROM_STAGE1 = {"encoder": "encoder", "projection": "projection",
               "con_augment": "con_augment_1", "generator": "gen_1"}


@dataclasses.dataclass(frozen=True)
class Stage2Config:
    """The JAX ``Stage2Config``'s fields and defaults (the reference's
    64 -> 256 px pipeline over BERT-base); ``compute_dtype`` is a torch
    dtype or None (f32)."""

    tem_size: int = 512
    c_dim: int = 128
    z_dim: int = 100
    nd: int = 128
    h_dim: int = 256
    n_critic: int = 5
    lambda_gp: float = 10.0
    lr: float = 1e-3
    sched_step: int = 100
    sched_gamma: float = 0.5
    kl_mode: str = "correct"
    seq_len: int = 128
    num_residual: int = 4
    remat: bool = False
    unroll_critic: int = 1
    gen1_channels: tuple = (192, 96, 48, 24)
    g2_in_channels: int = 128
    g2_feat_channels: int = 512
    g2_res_channels: int = 320
    g2_up_channels: tuple = (320, 160, 80)
    d2_channels: tuple = (16, 32, 64, 128, 256, 512)
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
            nd=16,
            h_dim=16,
            seq_len=8,
            num_residual=1,
            gen1_channels=(24, 12),
            g2_in_channels=8,
            g2_feat_channels=16,
            g2_res_channels=8,
            g2_up_channels=(16, 8),
            d2_channels=(8, 16, 32),
            bert=BertConfig.tiny(),
        )
        defaults.update(kw)
        return cls(**defaults)

    def stage1_config(self, **kw) -> Stage1Config:
        """The config of the stage-1 system whose trained modules this
        one freezes."""
        return Stage1Config(
            tem_size=self.tem_size,
            c_dim=self.c_dim,
            z_dim=self.z_dim,
            nd=self.nd,
            h_dim=self.h_dim,
            seq_len=self.seq_len,
            gen_channels=self.gen1_channels,
            bert=self.bert,
            compute_dtype=self.compute_dtype,
            **kw,
        )


class Stage2System(wgan.WganSystem):
    """Module names are the JAX state's; ``FLAX_FIELDS`` maps each to its
    subtree of ``Stage2State`` (``frozen_params``, ``frozen_gen_stats``,
    ``params``, ``batch_stats``). The system also holds the three
    optimizers (under the JAX state's names ``con_augment_2``,
    ``generator``, ``critic``) and the step count. Between steps every
    module is in eval mode (``sample``). Built on the card unless
    ``device`` names another (``"cpu"``, ``"meta"``); without a card the
    default raises."""

    FLAX_FIELDS = {
        "encoder": ("frozen_params/encoder", None),
        "projection": ("frozen_params/projection", None),
        "con_augment_1": ("frozen_params/con_augment_1", None),
        "gen_1": ("frozen_params/gen_1", "frozen_gen_stats"),
        "con_augment_2": ("params/con_augment_2", None),
        "gen_2": ("params/generator", "batch_stats/generator"),
        "critic_2": ("params/critic", "batch_stats/critic"),
    }
    TRAINED = TRAINED
    GEN_SIDE = GEN_SIDE

    def __init__(self, config: Stage2Config, *, device=None, generator=None):
        super().__init__(config)
        c = config
        kw = dict(device=entry_device(device), generator=generator)
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
        self.critic_2 = StageIIDiscriminator(c.tem_size, c.nd, c.d2_channels, dtype=dt, **kw)
        self.eval()

    def load_stage1(self, stage1_system) -> None:
        """Take the frozen stack from a trained ``Stage1System``: its
        encoder, projection, CA and generator (parameters and BatchNorm
        statistics), copied."""
        with torch.no_grad():
            for theirs, ours in FROM_STAGE1.items():
                getattr(self, ours).load_state_dict(getattr(stage1_system, theirs).state_dict())

    @torch.no_grad()
    def embed_texts(self, tokens, mask):
        """Caption embeddings through the frozen encoder + projection;
        feed them back as ``batch['tem']``."""
        hidden = self.encoder(tokens, mask)
        return self.projection(hidden[:, 0, :].float())

    def frozen_64(self, tem, eps, z, generator=None):
        """The frozen CA1 -> G1: 64 px images, NHWC; CA1's ``eps``, then
        ``z``, drawn from ``generator`` where None."""
        return wgan.conditioned(self.con_augment_1, self.gen_1, tem, eps, z, self.config.z_dim, generator)[0]

    def _gen2_forward(self, fake_64, tem, eps, generator=None):
        """CA2 -> G2; returns ``(fake_256, mu2, sigma2)``."""
        c_hat2, mu2, sigma2 = self.con_augment_2(tem, eps=eps, generator=generator)
        return self.gen_2(fake_64, c_hat2), mu2, sigma2

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
        else:
            tem = self.embed_texts(batch["input_ids"], batch["attention_mask"])
        fake_64 = self.frozen_64(tem, noise.get("ca1_eps"), noise.get("z"), generator)
        return self._gen2_forward(fake_64, tem, noise.get("ca2_eps"), generator)[0]

    def train_step(self, batch: dict, generator=None, noise=None, reduce=None):
        """One optimizer step, in place. ``batch``: ``image``
        ``(B, 256, 256, 3)`` in [-1, 1] (f32) or uint8 (normalised on the
        device as ``x * 2/255 - 1``), and either ``input_ids`` and
        ``attention_mask`` ``(B, T)`` int or precomputed embeddings ``tem``
        ``(B, tem_size)``. Returns the metrics of ``finish_step``;
        ``reduce`` as there."""
        with span("train_step"):
            c = self.config
            reduce = reduce or (lambda tensors: None)
            noise = noise or {}
            real = wgan.images(batch["image"])
            bsz, dev = real.shape[0], real.device

            def draw(name, i, fn, shape, **kw):
                return noise[name][i] if name in noise else fn(shape, generator=generator, device=dev, **kw)

            perm = noise.get("perm")
            if perm is None:
                perm = torch.randperm(bsz, generator=generator, device=dev)
            with torch.no_grad():
                if "tem" in batch:
                    tem = batch["tem"].float()
                else:
                    with span("text"):
                        tem = self.embed_texts(batch["input_ids"], batch["attention_mask"])
                tem_mis = tem[perm]

            with self.training_mode():
                for i in range(c.n_critic):
                    with span("critic"):
                        ca1_eps = draw("ca1_eps", i, torch.randn, (bsz, c.c_dim))
                        z = draw("z", i, torch.randn, (bsz, c.z_dim))
                        ca2_eps = draw("ca2_eps", i, torch.randn, (bsz, c.c_dim))
                        gp_eps = draw("gp_eps", i, torch.rand, (bsz, 1, 1, 1), dtype=real.dtype)
                        with torch.no_grad():
                            fake_64 = self.frozen_64(tem, ca1_eps, z)
                            fake_256 = self._gen2_forward(fake_64, tem, ca2_eps)[0]
                        loss_critic, gp = self.critic_update(real, fake_256, tem, tem_mis, gp_eps, reduce)

                # generator side, with the last iteration's noise and 64 px images
                params = self.params_of(*GEN_SIDE)
                with span("generator"):
                    fake_256, mu2, sigma2 = self._gen2_forward(fake_64, tem, ca2_eps)
                    s_fake = remat(self.critic_2, fake_256, tem) if c.remat else self.critic_2(fake_256, tem)
                    s_fake = s_fake.reshape(-1).float()
                    kl = losses.kl_term(mu2, sigma2, c.kl_mode)
                    loss_gen = losses.wgan_generator_loss(s_fake) + kl
                    grads = torch.autograd.grad(loss_gen, params)
                self.generator_update(grads, reduce)
            return self.finish_step(loss_critic, gp, loss_gen, kl, reduce)
