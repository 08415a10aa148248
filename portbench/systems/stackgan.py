"""The StackGAN training step as a system under test: the port's
``Stage1System.train_step`` or ``Stage2System.train_step``, built at the
configuration's widths with the benchmark's seeded weights, fed the
mix's batches, and every draw handed in through ``noise=``, so that the
plain reference (``reference/stackgan.py``) can replay the same step.

Draws are made per step from the run's seed, as ``train.cli`` draws them
from ``(seed, step)``. The hoisted text forward's dropout (stage 1) is
its keep masks, the embedding's and two per layer over the doubled
caption batch, and one int32 seed per layer for the attention kernel's
counter hash.

Data parallelism (a mix's ``ranks`` over 1): one ``System`` a rank, on
its own card, steps its own rows (``traffic.pool`` of its rank) with its
own draws, and the port's step averages at its ``pmean`` sites through
``parallel/dp.py::all_reduce_mean``, as ``train.cli`` runs it under
``torchrun``. Rank ``r``'s draws of step ``k`` are seeded from ``(seed,
stream, k, r)``; at one rank from ``(seed, stream, k)``, as before ranks
were. ``shards(k)`` makes every rank's batch and draws again from the
seed, so that the reference steps exactly what the ranks stepped.

``fault`` plants one fault of the kinds the check must catch in a
training cell (the tests, and the readings of each fault on the chip),
on every rank: ``stale`` (the step leaves the parameters as they were),
``half_batch`` (the step sees the first half of its rows only, and takes
its means over them), ``no_exchange`` (over several ranks: ``reduce``
does nothing, so each rank steps on its own gradients).
"""

from __future__ import annotations

import dataclasses
import torch

from portbench import traffic, weights
from portbench.common import mix
from portbench.reference.stackgan import BETAS, Reference, _is_buffer

NOISE_STREAM = 3
SEED_STREAM = 4
FAULTS = ("stale", "half_batch", "no_exchange")
LOSSES = ("loss_critic", "loss_gen")
DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def _config_fields(cls, conf: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in conf.items() if k in names}


class System:
    """A cell's system on one card: the whole of it, or rank ``rank`` of
    the mix's ``ranks``."""

    def __init__(self, conf: dict, mix_spec: dict, seed: int, device, fault: str | None = None,
                 rank: int = 0):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault {fault!r}: one of {FAULTS}")
        self.world, self.rank = mix_spec["ranks"], rank
        if fault == "no_exchange" and self.world == 1:
            raise ValueError("fault no_exchange: the cell has one rank, no exchange")
        self.conf, self.mix, self.seed = conf, mix_spec, seed
        self.device = torch.device(device)
        self.stage = conf["stage"]
        self.fault = fault
        self.compute = DTYPES[conf["compute_dtype"]]
        self.batch_per_rank = mix_spec["batch_per_rank"]
        self.images_per_step = self.batch_per_rank * self.world
        res1 = 2 ** (len(conf["gen_channels" if self.stage == 1 else "gen1_channels"]) + 2)
        self.resolution = res1 if self.stage == 1 else res1 // 4 * 2 ** (len(conf["g2_up_channels"]) + 1)
        self.port = None

    # ----------------------------------------------------------- set-up

    def _port_config(self):
        from imagegenerator_tpu_torch.models.bert import BertConfig

        c = self.conf
        bert = BertConfig(**_config_fields(BertConfig, c["bert"]))
        if self.stage == 1:
            from imagegenerator_tpu_torch.train.stage1 import Stage1Config, Stage1System

            fields = _config_fields(Stage1Config, c)
            cls, system = Stage1Config, Stage1System
        else:
            from imagegenerator_tpu_torch.train.stage2 import Stage2Config, Stage2System

            fields = _config_fields(Stage2Config, c)
            cls, system = Stage2Config, Stage2System
        for k, v in fields.items():
            if isinstance(v, list):
                fields[k] = tuple(v)
        fields.update(bert=bert, compute_dtype=self.compute)
        return cls(**fields), system

    def plan(self):
        """The shapes of every tensor (from the port's system built on the
        ``meta`` device) and the mix's resident batches; returns the meta
        system."""
        cfg, cls = self._port_config()
        meta = cls(cfg, device="meta")
        self.shapes = {k: tuple(v.shape) for k, v in meta.state_dict().items()}
        self.trained = self._optimizer_modules()
        self.pools = {self.rank: self._pool(self.rank)}
        return meta

    def build(self) -> None:
        """The port's system on the card, its tensors allocated empty and
        filled with the seeded weights by ``state_dict`` name."""
        port = self.plan().to_empty(device=self.device)
        port.load_state_dict(weights.make(self.shapes, self.seed, self.device))
        self.port = port

    def _optimizer_modules(self) -> dict:
        if self.stage == 1:
            return {n: n for n in ("encoder", "projection", "con_augment", "generator", "critic")}
        return {"con_augment_2": "con_augment_2", "generator": "gen_2", "critic": "critic_2"}

    def _pool(self, rank: int):
        bert = self.conf["bert"]
        return traffic.pool(self.mix, self.seed, rank, self.conf["seq_len"], bert["vocab_size"],
                            self.resolution, self.device)

    def batch(self, k: int, rank: int | None = None) -> dict:
        """Step ``k``'s batch of this rank, or of ``rank``."""
        rank = self.rank if rank is None else rank
        if rank not in self.pools:
            self.pools[rank] = self._pool(rank)
        pool = self.pools[rank]
        return pool[k % len(pool)]

    # ------------------------------------------------------------ draws

    def _draw_seed(self, stream: int, k: int, rank: int) -> int:
        return mix(self.seed, stream, k) if self.world == 1 else mix(self.seed, stream, k, rank)

    def noise(self, k: int, rank: int | None = None) -> dict:
        """Step ``k``'s draws of this rank, or of ``rank``."""
        rank = self.rank if rank is None else rank
        c, B, dev = self.conf, self.batch_per_rank, self.device
        g = torch.Generator(device=dev).manual_seed(self._draw_seed(NOISE_STREAM, k, rank))
        n = c["n_critic"]
        out = {"perm": torch.randperm(B, generator=g, device=dev)}
        names = ("ca_eps", "z", "gp_eps") if self.stage == 1 else ("ca1_eps", "z", "ca2_eps", "gp_eps")
        for name in names:
            if name == "gp_eps":
                out[name] = torch.rand((n, B, 1, 1, 1), generator=g, device=dev)
            else:
                width = c["z_dim"] if name == "z" else c["c_dim"]
                out[name] = torch.randn((n, B, width), generator=g, device=dev)
        if self.stage == 1 and c["bert"]["dropout_rate"] > 0.0:
            bert, T = c["bert"], c["seq_len"]
            keep = 1.0 - bert["dropout_rate"]
            shape = (2 * B, T, bert["hidden_size"])
            out["text_masks"] = [torch.rand(shape, generator=g, device=dev) < keep
                                 for _ in range(1 + 2 * bert["num_layers"])]
            host = torch.Generator().manual_seed(self._draw_seed(SEED_STREAM, k, rank))
            out["attn_seeds"] = torch.randint(-2**31, 2**31, (bert["num_layers"],), generator=host).tolist()
        return out

    # ------------------------------------------------------------- step

    def step(self, k: int, noise: dict | None = None) -> dict:
        """Step ``k`` of the port's system, in place; the metrics as 0-d
        tensors."""
        batch, noise = self.batch(k), noise if noise is not None else self.noise(k)
        if self.fault == "half_batch":
            batch, noise = _first_half(batch, noise, self.batch_per_rank)
        before = None
        if self.fault == "stale":
            before = {n: p.detach().clone() for n, p in self.port.named_parameters()}
        if self.world == 1:
            metrics = self.port.train_step(batch, noise=noise)
        else:
            metrics = self.port.train_step(batch, noise=noise, reduce=self._reduce)
        if before is not None:
            with torch.no_grad():
                for n, p in self.port.named_parameters():
                    p.copy_(before[n])
        return metrics

    def _reduce(self, tensors) -> None:
        """The mean over the ranks at the step's ``pmean`` sites: the
        port's own all-reduce (``no_exchange``: none)."""
        if self.fault != "no_exchange":
            from imagegenerator_tpu_torch.parallel import dp

            dp.all_reduce_mean(tensors)

    def rates(self, images: int, seconds: float) -> dict:
        """The cell's rate, images of every step in the window over its
        seconds (over every rank), under each name a cell of this kind
        reports it by (``BENCHMARK.json`` says which cell reports which):
        the device-bound stage-2 step and the launch-bound stage-1 step
        each have a bound of their own. The stage-1 step over several
        ranks reports it per layer (``metrics/images_per_s.py``)."""
        rate = images / seconds
        return {"train_images_per_s": rate, "stage1_train_images_per_s": rate}

    @staticmethod
    def loss_names() -> tuple:
        """The step's losses that ``check.compare`` holds: the critic's
        (``loss_gap``) and the generator's (``gen_loss_gap``)."""
        return LOSSES

    # --------------------------------------------------------- readings

    def grad_norms(self) -> dict:
        """Each trained leaf's gradient as its optimizer took it, from
        Adam's first moment ``m / (1 - beta1^t)`` (after the step's first
        update, exactly the gradient), as norms."""
        names, norms = [], []
        for opt_name, attr in self.trained.items():
            opt = self.port.optimizers[opt_name]
            beta1 = opt.param_groups[0]["betas"][0]
            for pname, p in getattr(self.port, attr).named_parameters():
                st = opt.state[p]
                t = int(st["step"])
                names.append(f"{attr}.{pname}")
                norms.append(torch.linalg.vector_norm(st["exp_avg"].float()) / (1.0 - beta1 ** t))
        return dict(zip(names, torch.stack(norms).tolist()))

    def trained_params(self) -> dict:
        """The trained leaves, copied to the host."""
        return {f"{attr}.{pname}": p.detach().to("cpu", torch.float32, copy=True)
                for attr in self.trained.values()
                for pname, p in getattr(self.port, attr).named_parameters()}

    def free(self) -> None:
        """Drop the port's system (the resident batches stay, for the
        reference)."""
        self.port = None

    # -------------------------------------------------------- reference

    def reference(self, quant=None) -> Reference:
        return Reference(self.conf, self.stage, self.compute, quant)

    def initial_params(self) -> dict:
        return weights.make(self.shapes, self.seed, self.device)

    def shards(self, k: int) -> list:
        """Step ``k``'s ``(batch, noise)`` of every rank, in rank order, as
        the reference takes them."""
        return [(self.batch(k, r), self.noise(k, r)) for r in range(self.world)]

    def reference_grad_norms(self, state) -> dict:
        out = {}
        for o in state["opts"].values():
            corr = 1.0 - BETAS[0] ** o["count"]
            for name in o["names"]:
                out[name] = torch.linalg.vector_norm(o["m"][name]) / corr
        return {k: float(v) for k, v in out.items()}

    def reference_params(self, state) -> dict:
        return {k: v for k, v in state["params"].items() if not _is_buffer(k) and self._is_trained(k)}

    def leaf_groups(self) -> dict:
        """Each optimizer's trained leaves, by ``state_dict`` name."""
        return {opt: [n for n in sorted(self.shapes) if n.startswith(attr + ".") and not _is_buffer(n)]
                for opt, attr in self.trained.items()}

    def compared_groups(self) -> dict:
        """The optimizers whose leaves ``check.py`` compares: the critic and
        the generator, which the KL term does not reach."""
        groups = self.leaf_groups()
        return {opt: groups[opt] for opt in ("critic", "generator")}

    def _is_trained(self, name: str) -> bool:
        return any(name.startswith(attr + ".") for attr in self.trained.values())

    # ------------------------------------------------------------ work

    def flops_per_step(self) -> float:
        """Model FLOPs of one step over every rank: the reference's step
        at this cell's shapes, counted by ``FlopCounterMode`` on the
        ``meta`` device."""
        from torch.utils.flop_counter import FlopCounterMode

        meta = torch.device("meta")
        ref = self.reference()
        params = {k: torch.empty(s, device=meta) for k, s in self.shapes.items()}
        state = ref.init_state(params)
        to_meta = lambda t: torch.empty_like(t, device=meta) if torch.is_tensor(t) else t
        shards = [({k: to_meta(v) for k, v in batch.items()},
                   {k: ([to_meta(x) for x in v] if isinstance(v, list) else to_meta(v)) for k, v in noise.items()})
                  for batch, noise in self.shards(0)]
        with FlopCounterMode(display=False) as counter:
            ref.step(state, shards)
        return float(counter.get_total_flops())

    def attention_work(self, k: int) -> list:
        """The attention calls of this rank's step ``k``: per call the
        key lengths of its rows, T, the hidden width, the heads and
        whether it has a backward (``metrics/attention_roofline.py``)."""
        bert = self.conf["bert"]
        batch = self.batch(k)
        lengths = batch["attention_mask"].sum(dim=1)
        if self.stage == 1:
            perm = self.noise_perm(k)
            rows, backward = torch.cat([lengths, lengths[perm]]), True
        else:
            rows, backward = lengths, False
        call = {"lengths": rows.tolist(), "seq": self.conf["seq_len"], "hidden": bert["hidden_size"],
                "heads": bert["num_heads"], "backward": backward,
                "element_bytes": 2 if self.compute == torch.bfloat16 else 4}
        return [call] * bert["num_layers"]

    def noise_perm(self, k: int):
        g = torch.Generator(device=self.device).manual_seed(self._draw_seed(NOISE_STREAM, k, self.rank))
        return torch.randperm(self.batch_per_rank, generator=g, device=self.device)


def _first_half(batch: dict, noise: dict, rows: int):
    """The fault ``half_batch``: the first half of the rows and of every
    draw, a permutation of those rows."""
    h = rows // 2
    batch = {k: v[:h] for k, v in batch.items()}
    out = {}
    for k, v in noise.items():
        if k == "perm":
            out[k] = v[v < h]
        elif k == "text_masks":
            out[k] = [m[:2 * h] for m in v]
        elif k == "attn_seeds":
            out[k] = v
        else:
            out[k] = v[:, :h]
    return batch, out

