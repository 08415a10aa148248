"""The WGAN-GP update core that both training systems share
(``train/stage1.py``, ``train/stage2.py``).

A system's ``train_step`` runs the JAX step eagerly and in place:
``n_critic`` critic updates, each with the second-order gradient penalty,
then one update of the generator side (``GEN_SIDE``), whose gradients
are taken with ``torch.autograd.grad`` in its parameters alone, so
nothing of the generator loss reaches the critic. Each module's
optimizer follows its role (``schedules.py``) and sets its lr from its
own update count just before it steps; the critic's StepLR boundary is
``sched_step * n_critic`` (it updates ``n_critic`` times a step).

Data parallelism: ``reduce`` (``parallel/dp.py::all_reduce_mean``)
averages over the ranks where the JAX step calls ``pmean``: the critic's
gradients before each critic update, the generator side's before its
update, and the four metrics. BatchNorm statistics stay per rank.

``remat`` wraps the JAX package's ``jax.checkpoint`` sites in
``ops/remat.py::remat``: the critic's image tower (real, fake and the
GP's interpolation) and its full forward in the generator step; the
recomputation leaves the critic's BatchNorm statistics alone.
``unroll_critic`` is an XLA knob and has no effect in eager PyTorch.

The step's phases are named in a running profiler's trace
(``utils/profiling.py::span``): ``train_step`` around it all, ``text``
(each text forward), ``critic`` (each iteration, its update's
``optimizer`` span inside), ``generator``, stage 1's ``text_backward``,
then one ``optimizer`` span per generator-side update.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from imagegenerator_tpu_torch.ops.remat import remat as remat_fn
from imagegenerator_tpu_torch.train import losses, schedules
from imagegenerator_tpu_torch.utils.profiling import span


def critic_loss(critic, real, fake, tem, tem_mis, gp_eps, lambda_gp, remat=False):
    """One critic iteration's loss, with its graph: the image tower in
    training mode on ``real``, ``fake``, then the GP's interpolation, in
    that order (the BatchNorm statistics thread through the three
    passes); tower(real) scored against ``tem`` and ``tem_mis``. Returns
    ``(mean([s_mis, s_fake]) - mean(s_real) + lambda_gp * gp, gp)``.
    ``remat`` recomputes each tower pass in the backward."""

    def head(feat, t):
        return critic.score(feat, t).reshape(-1).float()

    features = (lambda images: remat_fn(critic.features, images)) if remat else critic.features
    feat_real = features(real)
    feat_fake = features(fake)
    s_real, s_mis, s_fake = head(feat_real, tem), head(feat_real, tem_mis), head(feat_fake, tem)
    gp, _ = losses.gradient_penalty_aux(
        lambda images: (head(features(images), tem), None), real, fake, eps=gp_eps
    )
    return losses.wgan_critic_loss(s_real, torch.cat([s_mis, s_fake])) + lambda_gp * gp, gp


def conditioned(con_augment, net, tem, eps, z, z_dim, generator=None):
    """CA -> [c_hat || z] -> a stage-I generator; CA's ``eps``, then
    ``z``, drawn from ``generator`` where None. Returns ``(images, mu,
    sigma)``."""
    c_hat, mu, sigma = con_augment(tem, eps=eps, generator=generator)
    if z is None:
        z = torch.randn((tem.shape[0], z_dim), generator=generator, device=tem.device)
    return net(torch.cat([c_hat, z.float()], dim=1)), mu, sigma


def images(x):
    """A batch's images in [-1, 1]: uint8 is normalised on the device as
    ``x * 2/255 - 1``."""
    return x.float() * (2.0 / 255.0) - 1.0 if x.dtype == torch.uint8 else x


class WganSystem(nn.Module):
    """The config, the step count and one optimizer per trained module,
    with the updates of a step. A system names its trained modules in
    ``TRAINED`` (the JAX state's name -> the attribute) and its generator
    side, in the order of its parameters, in ``GEN_SIDE``."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.step = 0
        self.reset_optimizers()

    def reset_optimizers(self) -> None:
        """Drop the optimizers and their state; the next use makes them
        anew on the modules' current parameters (``convert`` replaces them)."""
        self._optimizers = None

    @property
    def optimizers(self) -> dict:
        """One optimizer per trained module, under its JAX name, made at
        first use: AdamW at ``encoder_lr`` for a trained text encoder,
        Adam at ``lr`` for every other module."""
        if self._optimizers is None:
            self._optimizers = {
                name: schedules.adamw(self.params_of(name), self.config.encoder_lr) if name == "encoder"
                else schedules.adam(self.params_of(name), self.config.lr)
                for name in self.TRAINED
            }
        return self._optimizers

    def params_of(self, *names) -> list:
        """The parameters of the trained modules ``names``, in order."""
        return [p for n in names for p in getattr(self, self.TRAINED[n]).parameters()]

    def _update(self, name):
        c = self.config
        step_size = c.sched_step * (c.n_critic if name == "critic" else 1)
        opt = self.optimizers[name]
        with span("optimizer"):
            schedules.set_lr(opt, opt.defaults["lr"], step_size, c.sched_gamma)  # from its initial lr
            opt.step()

    @contextlib.contextmanager
    def training_mode(self):
        """The trained modules in training mode inside; every module in
        eval mode after, however the block ends."""
        for attr in self.TRAINED.values():
            getattr(self, attr).train()
        try:
            yield
        finally:
            self.eval()

    def critic_update(self, real, fake, tem, tem_mis, gp_eps, reduce):
        """One critic iteration's loss and Adam update; returns ``(loss,
        gp)`` detached."""
        c = self.config
        critic = getattr(self, self.TRAINED["critic"])
        loss, gp = critic_loss(critic, real, fake, tem, tem_mis, gp_eps, c.lambda_gp, c.remat)
        self.optimizers["critic"].zero_grad(set_to_none=True)
        loss.backward()
        reduce([p.grad for p in critic.parameters()])
        self._update("critic")
        return loss.detach(), gp.detach()

    def generator_update(self, grads, reduce):
        """The generator side's gradients, in ``GEN_SIDE``'s order of its
        parameters: averaged, set, then one update per module."""
        grads = list(grads)
        reduce(grads)
        schedules.set_grads(self.params_of(*self.GEN_SIDE), grads)
        for name in self.GEN_SIDE:
            self._update(name)

    def finish_step(self, loss_critic, gp, loss_gen, kl, reduce) -> dict:
        """Count the step; returns ``{loss_critic, loss_gen, gp, kl}`` as
        0-d tensors (the last critic iteration's loss and penalty, the
        generator loss and its KL term), averaged over the data-parallel
        ranks in place by ``reduce(tensors)``."""
        self.step += 1
        metrics = {"loss_critic": loss_critic, "loss_gen": loss_gen.detach().clone(),
                   "gp": gp, "kl": kl.detach().clone()}
        reduce(list(metrics.values()))
        return metrics
