"""WGAN-GP and conditioning-KL losses — counterpart of
``imagegenerator_tpu/train/losses.py``.

* critic loss    = mean(negatives) - mean(real) (+ lambda * GP by the caller)
* generator loss = -mean(critic(fake, tem)) + KL term
* GP: interpolate real and fake with a per-sample uniform eps, take the
  gradient of the summed critic scores with respect to the interpolated
  images with ``create_graph=True``, so that differentiating the penalty
  in the critic's parameters gives the second-order term, and return
  ``mean((||g||_2 - 1)^2)``.

``kl_term``: ``s = sum(1 + log sigma^2 - mu^2 - sigma^2)`` is -2 KL;
``kl_mode='correct'`` returns ``-s`` (a +2 KL penalty), ``'faithful'``
the reference's inverted sign ``s``.
"""

from __future__ import annotations

import torch


def wgan_critic_loss(real_scores, negative_scores):
    return negative_scores.mean() - real_scores.mean()


def wgan_generator_loss(fake_scores):
    return -fake_scores.mean()


def kl_term(mu, sigma, mode: str = "correct"):
    s = torch.sum(1.0 + torch.log(sigma * sigma) - mu * mu - sigma * sigma)
    if mode == "faithful":
        return s
    if mode == "correct":
        return -s
    raise ValueError(f"unknown kl_mode: {mode}")


def gradient_penalty_aux(critic_fn, real, fake, eps=None, generator=None):
    """WGAN-GP on NHWC images. ``critic_fn(images) -> (scores, aux)``;
    returns ``(gp, aux)``. ``aux`` (the BatchNorm statistics the
    interpolated batch's train-mode forward updated, in the port simply
    that forward's side effect) comes from the same forward the input
    gradient is taken through. ``eps (B, 1, 1, 1)`` is drawn uniform from
    ``generator`` unless given."""
    b = real.shape[0]
    if eps is None:
        eps = torch.rand((b, 1, 1, 1), generator=generator, device=real.device, dtype=real.dtype)
    interp = (real * eps + fake * (1.0 - eps)).detach().requires_grad_(True)
    scores, aux = critic_fn(interp)
    (grads,) = torch.autograd.grad(scores.sum(), interp, create_graph=True)
    norms = torch.sqrt(torch.sum(grads.reshape(b, -1) ** 2, dim=1) + 1e-12)
    return torch.mean((norms - 1.0) ** 2), aux
