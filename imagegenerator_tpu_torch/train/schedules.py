"""Optimizers and the StepLR schedule — counterpart of
``imagegenerator_tpu/train/schedules.py``.

Adam(0.9, 0.999, eps 1e-8) for the GAN modules, AdamW with weight decay
0.01 for the text encoder. ``torch.optim.Adam`` and ``AdamW`` compute
optax's ``adam``/``adamw`` update algebra (bias-corrected moments,
``lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)``). optax evaluates the
schedule at each optimizer's own update count before the update, so the
caller sets each optimizer's lr from its own count with ``set_lr`` just
before ``step``.
"""

from __future__ import annotations

import torch


def step_lr(base_lr: float, step_size: int, gamma: float, count: int) -> float:
    """StepLR: ``base_lr * gamma ** (count // step_size)``."""
    return base_lr * gamma ** (count // step_size)


def adam(params, lr: float):
    """The GAN modules' optimizer; lr is set per update by ``set_lr``."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def adamw(params, lr: float):
    """The text encoder's optimizer (torch's AdamW default decay 0.01)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)


def update_count(opt: torch.optim.Optimizer) -> int:
    """How many updates ``opt`` has made: its state's ``step`` (a CPU
    tensor, so reading it needs no device sync)."""
    for group in opt.param_groups:
        for p in group["params"]:
            state = opt.state.get(p)
            if state and "step" in state:
                return int(state["step"])
    return 0


def set_lr(opt: torch.optim.Optimizer, base_lr: float, step_size: int, gamma: float) -> None:
    lr = step_lr(base_lr, step_size, gamma, update_count(opt))
    for group in opt.param_groups:
        group["lr"] = lr
