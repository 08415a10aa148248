"""Stage-I system: the 64 px text-conditioned WGAN-GP training step and
sampling — counterpart of ``imagegenerator_tpu/train/stage1.py``.

``Stage1System.train_step`` runs the JAX step eagerly: ``n_critic``
critic updates, each with the second-order gradient penalty, then one
update of the encoder, projection, CA and generator through one BERT
forward and backward. The modules, optimizers and step count live on the
system and are updated in place.

Order of work in a step (JAX ``train_step``):
  1. the caption permutation, ``tokens_mis = tokens[perm]``;
  2. the text forward: by default ONE forward with grad, over the doubled
     batch ``[tokens; tokens_mis]`` (or over the matched rows alone when
     ``text_reuse_mismatched``, ``tem_mis = tem[perm]``); the critic loop
     reads it detached, and the generator loss backpropagates through the
     same graph, so a step runs one BERT forward and one backward. With
     ``text_resample_per_iter`` every critic iteration re-encodes the
     doubled batch, and the generator step backpropagates through the
     last iteration's forward: the JAX step re-runs that forward with the
     same dropout key, so its values are the same;
  3. critic iteration i: G1 in training mode (BN statistics update, no
     grad) on that iteration's CA and z noise; the image tower on real,
     fake, then the GP's interpolation, in that order (the critic's BN
     statistics thread through the three passes); tower(real) scored
     against tem and tem_mis; ``loss = mean([s_mis, s_fake]) -
     mean(s_real) + lambda * gp``; an Adam update of the critic;
  4. the generator step, with the last iteration's CA and z noise against
     the updated critic (a full critic forward in training mode, which
     updates its BN once more): ``loss = -mean(s_fake) + kl``. Its
     gradients are taken with ``torch.autograd.grad`` on the generator
     side's parameters alone, so nothing of it reaches the critic.

Noise comes from ``generator`` on the device in a fixed order: the
permutation, then per iteration (ca_eps, z, gp_eps), with the dropout
masks drawn where the forwards need them. The fused attention's dropout
seeds come from the CPU ``host_generator``. A ``noise`` dict replays
given draws: ``perm (B,)``, ``ca_eps``, ``z``, ``gp_eps`` (each indexed by
iteration) and ``attn_seeds`` (int32 seeds, one per fused attention layer
and text forward, in order).

``remat`` and ``unroll_critic`` are XLA knobs. ``unroll_critic`` has no
effect in eager PyTorch; ``remat=True`` is not ported and ``train_step``
raises ``NotImplementedError``. Data parallelism and tensor parallelism
are not in this port yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from imagegenerator_tpu_torch.models.bert import BertConfig, BertEncoder
from imagegenerator_tpu_torch.models.con_augment import ConditioningAugmentation
from imagegenerator_tpu_torch.models.stackgan import StageIDiscriminator, StageIGenerator
from imagegenerator_tpu_torch.ops.layers import Dense
from imagegenerator_tpu_torch.train import losses, schedules
from imagegenerator_tpu_torch.utils.device import entry_device

MODULES = ("encoder", "projection", "con_augment", "generator", "critic")
GEN_SIDE = ("encoder", "projection", "con_augment", "generator")


@dataclasses.dataclass(frozen=True)
class Stage1Config:
    """The JAX ``Stage1Config``'s fields and defaults (the reference's
    64 px nets over BERT-base); ``compute_dtype`` is a torch dtype or None
    (f32)."""

    tem_size: int = 512
    c_dim: int = 128
    z_dim: int = 100
    nd: int = 128
    h_dim: int = 256
    n_critic: int = 5
    lambda_gp: float = 10.0
    lr: float = 1e-3
    encoder_lr: float = 5e-5
    sched_step: int = 100
    sched_gamma: float = 0.5
    kl_mode: str = "correct"
    text_dropout: bool = True
    text_resample_per_iter: bool = False
    text_reuse_mismatched: bool | None = None
    remat: bool = False
    unroll_critic: int = 1
    seq_len: int = 128
    gen_channels: tuple = (192, 96, 48, 24)
    disc_channels: tuple = (64, 128, 256, 512)
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
            nd=16,
            h_dim=16,
            seq_len=8,
            gen_channels=(24, 12),
            disc_channels=(12, 24),
            bert=BertConfig.tiny(),
        )
        defaults.update(kw)
        return cls(**defaults)


class Stage1System(nn.Module):
    """The five modules of the JAX state (``encoder``, ``projection``,
    ``con_augment``, ``generator``, ``critic``), their optimizers and the
    step count. ``FLAX_FIELDS`` maps each module to its
    ``params``/``batch_stats`` subtree. Between steps the modules are in
    eval mode (``sample``); ``train_step`` runs them in training mode.
    Built on the card unless ``device`` names another (``"cpu"``,
    ``"meta"``); without a card the default raises."""

    FLAX_FIELDS = {
        "encoder": ("params/encoder", None),
        "projection": ("params/projection", None),
        "con_augment": ("params/con_augment", None),
        "generator": ("params/generator", "batch_stats/generator"),
        "critic": ("params/critic", "batch_stats/critic"),
    }

    def __init__(self, config: Stage1Config, *, device=None, generator=None):
        super().__init__()
        self.config = c = config
        kw = dict(device=entry_device(device), generator=generator)
        self.encoder = BertEncoder(c.bert, dtype=c.compute_dtype, **kw)
        self.projection = Dense(c.bert.hidden_size, c.tem_size, dtype=c.compute_dtype, **kw)
        self.con_augment = ConditioningAugmentation(c.tem_size, c.h_dim, c.c_dim, **kw)
        self.generator = StageIGenerator(
            c.c_dim, c.z_dim, c.gen_channels, dtype=c.compute_dtype, **kw
        )
        self.critic = StageIDiscriminator(
            c.tem_size, c.nd, c.disc_channels, dtype=c.compute_dtype, **kw
        )
        self.step = 0
        self._optimizers = None
        self.eval()

    @property
    def optimizers(self) -> dict:
        """One optimizer per module, made at first use on the modules'
        current parameters (a system loaded by ``convert`` replaces them)."""
        if self._optimizers is None:
            self._optimizers = {
                name: (schedules.adamw if name == "encoder" else schedules.adam)(
                    getattr(self, name).parameters(), self._base_lr(name)
                )
                for name in MODULES
            }
        return self._optimizers

    def _base_lr(self, name):
        return self.config.encoder_lr if name == "encoder" else self.config.lr

    def _update(self, name):
        """Set ``name``'s lr from its own update count, then step it. The
        critic's StepLR boundary is ``sched_step * n_critic`` (it updates
        n_critic times per step)."""
        c = self.config
        step_size = c.sched_step * (c.n_critic if name == "critic" else 1)
        opt = self.optimizers[name]
        schedules.set_lr(opt, self._base_lr(name), step_size, c.sched_gamma)
        opt.step()

    def encode_text(self, tokens, mask, deterministic=True, generator=None,
                    host_generator=None):
        """tokens -> tem: CLS hidden state -> projection."""
        hidden = self.encoder(
            tokens, mask, deterministic=deterministic, generator=generator,
            host_generator=host_generator,
        )
        return self.projection(hidden[:, 0, :].float())

    def _gen_forward(self, tem, eps, z):
        """CA -> [c_hat || z] -> G1; returns ``(fake, mu, sigma)``."""
        c_hat, mu, sigma = self.con_augment(tem, eps=eps)
        return self.generator(torch.cat([c_hat, z.float()], dim=1)), mu, sigma

    @torch.no_grad()
    def sample(self, batch: dict, generator=None, noise=None):
        """64 px images ``(B, 64, 64, 3)`` from ``{'input_ids',
        'attention_mask'}`` or a precomputed ``{'tem'}``, in eval mode. The
        CA ``eps`` and then ``z`` are drawn from ``generator`` unless
        ``noise`` gives them (``'ca_eps'``, ``'z'``)."""
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

    def _critic_update(self, real, fake, tem, tem_mis, gp_eps):
        """One critic iteration's loss and Adam update; returns
        ``(loss, gp)`` detached."""
        critic = self.critic

        def head(feat, t):
            return critic.score(feat, t).reshape(-1).float()

        feat_real = critic.features(real)
        feat_fake = critic.features(fake)
        s_real, s_mis, s_fake = head(feat_real, tem), head(feat_real, tem_mis), head(feat_fake, tem)
        gp, _ = losses.gradient_penalty_aux(
            lambda images: (head(critic.features(images), tem), None), real, fake, eps=gp_eps
        )
        loss = losses.wgan_critic_loss(s_real, torch.cat([s_mis, s_fake])) + self.config.lambda_gp * gp
        self.optimizers["critic"].zero_grad(set_to_none=True)
        loss.backward()
        self._update("critic")
        return loss.detach(), gp.detach()

    def train_step(self, batch: dict, generator=None, noise=None, host_generator=None):
        """One optimizer step, in place. ``batch``: ``input_ids``,
        ``attention_mask`` ``(B, T)`` int and ``image`` ``(B, 64, 64, 3)``
        in [-1, 1] (f32) or uint8 (normalised on the device as
        ``x * 2/255 - 1``). Returns ``{loss_critic, loss_gen, gp, kl}`` as
        0-d tensors: the last critic iteration's loss and penalty, the
        generator loss and its KL term."""
        c = self.config
        if c.remat:
            raise NotImplementedError("Stage1Config.remat is not ported to PyTorch")
        noise = noise or {}
        tokens, mask, real = batch["input_ids"], batch["attention_mask"], batch["image"]
        if real.dtype == torch.uint8:
            real = real.float() * (2.0 / 255.0) - 1.0
        bsz, dev = tokens.shape[0], tokens.device

        def draw(name, i, fn):
            return noise[name][i] if name in noise else fn()

        perm = noise.get("perm")
        if perm is None:
            perm = torch.randperm(bsz, generator=generator, device=dev)
        tokens_2b = torch.cat([tokens, tokens[perm]])
        mask_2b = torch.cat([mask, mask[perm]])
        seeds = iter(noise["attn_seeds"]) if "attn_seeds" in noise else host_generator
        text = dict(deterministic=not c.text_dropout, generator=generator, host_generator=seeds)
        reuse_mis = c.text_reuse_mismatched
        if reuse_mis is None:
            reuse_mis = not c.text_dropout  # exact when dropout is off

        def text_both():
            tem_2b = self.encode_text(tokens_2b, mask_2b, **text)
            return tem_2b[:bsz], tem_2b[bsz:]

        self.train()
        try:
            tems = None
            if not c.text_resample_per_iter:
                if reuse_mis:
                    tem = self.encode_text(tokens, mask, **text)
                    tems = (tem, tem[perm])
                else:
                    tems = text_both()
            for i in range(c.n_critic):
                if c.text_resample_per_iter:
                    # the last iteration's forward keeps its graph for the
                    # generator step
                    with torch.set_grad_enabled(i == c.n_critic - 1):
                        tems = text_both()
                tem, tem_mis = (t.detach() for t in tems)
                ca_eps = draw("ca_eps", i, lambda: torch.randn(
                    (bsz, c.c_dim), generator=generator, device=dev))
                z = draw("z", i, lambda: torch.randn(
                    (bsz, c.z_dim), generator=generator, device=dev))
                gp_eps = draw("gp_eps", i, lambda: torch.rand(
                    (bsz, 1, 1, 1), generator=generator, device=dev, dtype=real.dtype))
                with torch.no_grad():
                    fake = self._gen_forward(tem, ca_eps, z)[0]
                loss_critic, gp = self._critic_update(real, fake, tem, tem_mis, gp_eps)

            # generator side, with the last iteration's CA and z noise
            tem = tems[0]
            fake, mu, sigma = self._gen_forward(tem, ca_eps, z)
            s_fake = self.critic(fake, tem).reshape(-1).float()
            kl = losses.kl_term(mu, sigma, c.kl_mode)
            loss_gen = losses.wgan_generator_loss(s_fake) + kl
            params = [p for name in GEN_SIDE for p in getattr(self, name).parameters()]
            for p, g in zip(params, torch.autograd.grad(loss_gen, params)):
                p.grad = g
            for name in GEN_SIDE:
                self._update(name)
        finally:
            self.eval()
        self.step += 1
        return {
            "loss_critic": loss_critic,
            "loss_gen": loss_gen.detach(),
            "gp": gp,
            "kl": kl.detach(),
        }
