"""The toy system's plain reference: the two-layer MLP and Adam written
out from their equations, the forward and backward in ``dtype``, the
parameters and Adam's moments in float32."""

from __future__ import annotations

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


class Reference:
    def __init__(self, conf: dict, dtype=torch.float32):
        self.lr, self.dtype = conf["lr"], dtype

    def init_state(self, theta0: dict) -> dict:
        params = {n: t.detach().float().clone() for n, t in theta0.items()}
        return {"params": params, "m": {n: torch.zeros_like(t) for n, t in params.items()},
                "v": {n: torch.zeros_like(t) for n, t in params.items()}, "count": 0}

    def step(self, state: dict, shards: list) -> dict:
        (batch, _), = shards
        P = {n: t.to(self.dtype, copy=True).requires_grad_() for n, t in state["params"].items()}
        x, y = batch["x"].to(self.dtype), batch["y"].to(self.dtype)
        h = torch.tanh(x @ P["fc1.weight"].T + P["fc1.bias"])
        loss = ((h @ P["fc2.weight"].T + P["fc2.bias"] - y).float() ** 2).mean()
        grads = dict(zip(P, torch.autograd.grad(loss, list(P.values()))))
        state["count"] += 1
        t, (b1, b2) = state["count"], BETAS
        for n, g in grads.items():
            g = g.float()
            state["m"][n].mul_(b1).add_(g, alpha=1 - b1)
            state["v"][n].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = state["m"][n] / (1 - b1 ** t)
            v_hat = state["v"][n] / (1 - b2 ** t)
            state["params"][n] -= self.lr * m_hat / (v_hat.sqrt() + EPS)
        return {"loss": loss.detach()}
