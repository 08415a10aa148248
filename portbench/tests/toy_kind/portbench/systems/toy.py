"""A toy kind of system, added to a copy of the harness as new files
alone (``portbench/tests/test_new_kind.py``): a two-layer MLP in float32
regressing seeded rows, trained by ``torch.optim.Adam``, with one loss
and one phase span."""

from __future__ import annotations

import math
from collections import OrderedDict

import torch

from portbench.common import mix
from portbench.reference.toy import BETAS, EPS, Reference

SPANS = ("toy_step",)
FAULTS = ("stale", "half_batch")
TINY_LIMITS = {"loss_gap": 1e-4, "grad_norm_gap": 1e-4, "change_norm_gap": 1e-3}


def faults(world: int) -> tuple:
    return FAULTS


def tiny_config(conf: dict, **overrides) -> dict:
    return dict(conf, **overrides)


def tiny_mix(mix_spec: dict) -> dict:
    return dict(mix_spec)


class System:
    def __init__(self, conf: dict, mix_spec: dict, seed: int, device, fault: str | None = None, rank: int = 0):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault {fault!r}: one of {FAULTS}")
        self.conf, self.mix, self.seed, self.fault, self.rank = conf, mix_spec, seed, fault, rank
        self.device = torch.device(device)
        self.rows = mix_spec["rows"]
        self.images_per_step = self.rows
        self.model = None

    def plan(self) -> None:
        c = self.conf
        self.shapes = {"fc1.weight": (c["hidden"], c["inputs"]), "fc1.bias": (c["hidden"],),
                       "fc2.weight": (c["outputs"], c["hidden"]), "fc2.bias": (c["outputs"],)}
        self.pool = [self._batch(k) for k in range(self.mix["pool_batches"])]

    def build(self) -> None:
        self.plan()
        c = self.conf
        self.model = torch.nn.Sequential(OrderedDict(
            fc1=torch.nn.Linear(c["inputs"], c["hidden"]), act=torch.nn.Tanh(),
            fc2=torch.nn.Linear(c["hidden"], c["outputs"]))).to(self.device)
        self.model.load_state_dict(self.initial_params())
        self.opt = torch.optim.Adam(self.model.parameters(), lr=c["lr"], betas=BETAS, eps=EPS)

    def initial_params(self) -> dict:
        g = torch.Generator(device=self.device).manual_seed(mix(self.seed, 1))
        bound = lambda n: 1.0 / math.sqrt(self.shapes[n.replace("bias", "weight")][1])
        return {n: (torch.rand(s, generator=g, device=self.device) * 2 - 1) * bound(n)
                for n, s in self.shapes.items()}

    def _batch(self, k: int) -> dict:
        c = self.conf
        g = torch.Generator(device=self.device).manual_seed(mix(self.seed, 2, k))
        return {"x": torch.randn(self.rows, c["inputs"], generator=g, device=self.device),
                "y": torch.randn(self.rows, c["outputs"], generator=g, device=self.device)}

    def batch(self, k: int) -> dict:
        return self.pool[k % len(self.pool)]

    def step(self, k: int) -> dict:
        b = self.batch(k)
        if self.fault == "half_batch":
            b = {key: v[: self.rows // 2] for key, v in b.items()}
        before = [p.detach().clone() for p in self.model.parameters()] if self.fault == "stale" else None
        with torch.profiler.record_function("toy_step"):
            self.opt.zero_grad(set_to_none=True)
            loss = ((self.model(b["x"]) - b["y"]) ** 2).mean()
            loss.backward()
            self.opt.step()
        if before is not None:
            with torch.no_grad():
                for p, old in zip(self.model.parameters(), before):
                    p.copy_(old)
        return {"loss": loss.detach()}

    def rates(self, images: int, seconds: float) -> dict:
        return {"toy_rows_per_s": images / seconds}

    @staticmethod
    def loss_names() -> tuple:
        return ("loss",)

    def grad_norms(self) -> dict:
        out = {}
        for n, p in self.model.named_parameters():
            st = self.opt.state[p]
            out[n] = float(st["exp_avg"].norm() / (1 - BETAS[0] ** int(st["step"])))
        return out

    def trained_params(self) -> dict:
        return {n: p.detach().to("cpu", torch.float32, copy=True) for n, p in self.model.named_parameters()}

    def free(self) -> None:
        self.model = self.opt = None

    def reference(self) -> Reference:
        return Reference(self.conf)

    def control(self) -> Reference:
        return Reference(self.conf, torch.bfloat16)

    def shards(self, k: int) -> list:
        return [(self.batch(k), None)]

    def reference_grad_norms(self, state) -> dict:
        return {n: float(m.norm() / (1 - BETAS[0] ** state["count"])) for n, m in state["m"].items()}

    def reference_params(self, state) -> dict:
        return state["params"]

    def leaf_groups(self) -> dict:
        return {"mlp": sorted(self.shapes)}

    def compared_groups(self) -> dict:
        return self.leaf_groups()

    def flops_per_step(self) -> float:
        c = self.conf
        return 6.0 * self.rows * (c["inputs"] * c["hidden"] + c["hidden"] * c["outputs"])

    def attention_work(self, k: int) -> list:
        return []
