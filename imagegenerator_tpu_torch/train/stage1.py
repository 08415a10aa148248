"""Stage-I system: the 64 px text-conditioned WGAN-GP training step and
sampling — counterpart of ``imagegenerator_tpu/train/stage1.py``. The
step trains the encoder, projection, CA, G1 and the critic through the
update core of ``train/wgan.py``, with one BERT forward and backward.

Order of work in a step (JAX ``train_step``):
  1. the caption permutation, ``tokens_mis = tokens[perm]``;
  2. the text forward: by default ONE forward with grad, over the doubled
     batch ``[tokens; tokens_mis]`` (or over the matched rows alone when
     ``text_reuse_mismatched``, ``tem_mis = tem[perm]``); the critic loop
     reads it detached, and the generator loss backpropagates through the
     same graph. With ``text_resample_per_iter`` every critic iteration
     re-encodes the doubled batch, and the generator step backpropagates
     through the last iteration's forward: the JAX step re-runs that
     forward with the same dropout key, so its values are the same;
  3. critic iteration i: G1 in training mode (BN statistics update, no
     grad) on that iteration's CA and z noise, then the critic update;
  4. the generator step, with the last iteration's CA and z noise against
     the updated critic: ``loss = -mean(s_fake) + kl``, its gradients
     taken in two calls split at the text embedding (bit for bit those of
     one call; the encoder's backward shows as ``text_backward``).

Noise: the permutation, then per iteration (ca_eps, z, gp_eps), with the
dropout masks drawn where the forwards need them. The fused attention's
dropout seeds come from the CPU ``host_generator``. A ``noise`` dict
replays ``perm (B,)``, ``ca_eps``, ``z``, ``gp_eps`` and ``attn_seeds``
(int32 seeds, one per fused attention layer and text forward, in order);
``text_masks`` replays the hoisted text forward's dropout, the keep
masks of the doubled (or matched) caption batch in the forward's order.

Tensor parallelism (``shard``, the counterpart of ``shard_state_2d`` and
``make_train_step_2d``): on a data x model grid (``parallel/mesh.py``)
the encoder is split Megatron-style over the model group and the step is
JAX's meshless step on the global batch, as GSPMD runs it: the loader
gives each data index its rows; the tokens are gathered over the data
group, the permutation and every noise draw are made for the global
batch and each rank keeps its rows; each data index encodes its
contiguous share of the doubled caption batch and the embeddings are
gathered back (differentiably); BatchNorm statistics are those of the
global batch (``BatchNorm.sync``); the KL term, a sum over rows, is
scaled by the data size so that the average over the data group is the
global sum. ``reduce`` then averages over the data group only, for every
parameter: a shard's gradient over the ranks that hold the same shard.
Adam's moments follow their parameter's shard.

``remat`` also checkpoints the hoisted text forward a BERT layer at a
time, its dropout masks and seeds drawn before it (``BertEncoder.draw``)
so that the recomputation replays them; recomputing the whole forward at
once would bring every layer's activations back together (they set the
step's peak; ``tools/probe_torch_memory.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from imagegenerator_tpu_torch.models.bert import BertConfig, BertEncoder, Draws, Predrawn
from imagegenerator_tpu_torch.models.con_augment import ConditioningAugmentation
from imagegenerator_tpu_torch.models.stackgan import StageIDiscriminator, StageIGenerator
from imagegenerator_tpu_torch.ops.layers import BatchNorm, Dense
from imagegenerator_tpu_torch.ops.remat import remat as remat_fn
from imagegenerator_tpu_torch.parallel import tp as tp_ops
from imagegenerator_tpu_torch.train import losses, wgan
from imagegenerator_tpu_torch.utils.device import entry_device
from imagegenerator_tpu_torch.utils.profiling import span

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


class Stage1System(wgan.WganSystem):
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
    TRAINED = dict(zip(MODULES, MODULES))
    GEN_SIDE = GEN_SIDE

    def __init__(self, config: Stage1Config, *, device=None, generator=None):
        super().__init__(config)
        c = config
        kw = dict(device=entry_device(device), generator=generator)
        self.encoder = BertEncoder(c.bert, dtype=c.compute_dtype, **kw)
        self.projection = Dense(c.bert.hidden_size, c.tem_size, dtype=c.compute_dtype, **kw)
        self.con_augment = ConditioningAugmentation(c.tem_size, c.h_dim, c.c_dim, **kw)
        self.generator = StageIGenerator(c.c_dim, c.z_dim, c.gen_channels, dtype=c.compute_dtype, **kw)
        self.critic = StageIDiscriminator(c.tem_size, c.nd, c.disc_channels, dtype=c.compute_dtype, **kw)
        self.grid = None
        self.eval()

    def shard(self, grid) -> None:
        """Place the system on a data x model grid (``parallel/mesh.py``),
        in place: the encoder split over the model group (with its AdamW
        moments, where it has taken steps), the generator's and critic's
        BatchNorm statistics over the data group. ``train_step`` then
        runs the grid step; pass it ``reduce`` over the data group."""
        if self.grid is not None:
            raise RuntimeError("the system is on a grid already")
        self.grid = grid
        if grid.data > 1:
            for module in (self.generator, self.critic):
                for bn in module.modules():
                    if isinstance(bn, BatchNorm):
                        bn.sync, bn.sync_size = grid.data_group, grid.data
        if grid.model == 1:
            return
        state = {name: self.optimizers[name.split(".", 1)[0]].state.get(p) for name, p in self.named_parameters()}
        self.encoder.shard_model(tp_ops.ModelShard(grid.model_index, grid.model, grid.model_group))
        self.reset_optimizers()
        sliced = tp_ops.sharded_keys(self)
        for name, p in self.named_parameters():
            st = state.get(name)
            if st:
                dim, shard = sliced.get(name, (None, None))
                self.optimizers[name.split(".", 1)[0]].state[p] = {
                    k: (tp_ops.shard_tensor(v, dim, shard).clone() if k != "step" else v.clone())
                    for k, v in st.items()}

    def encode_text(self, tokens, mask, deterministic=True, generator=None,
                    host_generator=None, draws=None, remat=False):
        """tokens -> tem: CLS hidden state -> projection; ``remat``
        recomputes the encoder a layer at a time in the backward."""
        hidden = self.encoder(
            tokens, mask, deterministic=deterministic, generator=generator,
            host_generator=host_generator, draws=draws, remat=remat,
        )
        return self.projection(hidden[:, 0, :].float())

    def _gen_forward(self, tem, eps, z, generator=None):
        """CA -> [c_hat || z] -> G1; returns ``(fake, mu, sigma)``."""
        return wgan.conditioned(self.con_augment, self.generator, tem, eps, z, self.config.z_dim, generator)

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
        return self._gen_forward(tem, noise.get("ca_eps"), noise.get("z"), generator)[0]

    def train_step(self, batch: dict, generator=None, noise=None, host_generator=None, reduce=None):
        """One optimizer step, in place. ``batch``: ``input_ids``,
        ``attention_mask`` ``(B, T)`` int and ``image`` ``(B, 64, 64, 3)``
        in [-1, 1] (f32) or uint8 (normalised on the device as
        ``x * 2/255 - 1``); on a grid, this data index's rows of the
        global batch. Returns the metrics of ``finish_step``; ``reduce``
        as there (on a grid: over the data group)."""
        with span("train_step"):
            c = self.config
            reduce = reduce or (lambda tensors: None)
            noise = noise or {}
            tokens, mask, real = batch["input_ids"], batch["attention_mask"], wgan.images(batch["image"])
            bsz, dev = tokens.shape[0], tokens.device
            grid = self.grid
            data, d = (grid.data, grid.data_index) if grid is not None else (1, 0)
            group = grid.data_group if grid is not None else None
            B = bsz * data  # the global batch
            mine = slice(d * bsz, (d + 1) * bsz)  # this data index's rows of it
            gather = lambda t: tp_ops.all_gather_rows(t, group, d, data)
            tokens_all, mask_all = (tokens, mask) if data == 1 else (gather(tokens), gather(mask))

            def draw(name, i, fn, shape, **kw):
                # each draw is the global batch's; a data index keeps its rows
                t = noise[name][i] if name in noise else fn(shape, generator=generator, device=dev, **kw)
                return t if data == 1 else t[mine]

            perm = noise.get("perm")
            if perm is None:
                perm = torch.randperm(B, generator=generator, device=dev)
            seeds = iter(noise["attn_seeds"]) if "attn_seeds" in noise else host_generator
            reuse_mis = c.text_reuse_mismatched
            if reuse_mis is None:
                reuse_mis = not c.text_dropout  # exact when dropout is off

            def text(ids, ids_mask, predrawn=None):
                """The text forward over the global batch ``ids``: this data
                index encodes its contiguous share and the embeddings of all
                rows are gathered back; ``predrawn`` replays its dropout."""
                with span("text"):
                    n = ids.shape[0] // data
                    share = slice(d * n, (d + 1) * n)
                    rows = None if data == 1 else (d * n, ids.shape[0])
                    ids, ids_mask = ids[share], ids_mask[share]
                    if predrawn is None and c.remat and c.text_dropout:
                        predrawn = self.encoder.draw(n * data, ids.shape[1], dev, generator, seeds)
                    draws = Draws(generator, seeds, rows=rows) if predrawn is None else predrawn.draws(rows)
                    tem = self.encode_text(ids, ids_mask, not c.text_dropout, draws=draws, remat=c.remat)
                    return tem if data == 1 else gather(tem)

            def text_both():
                tem_2b = text(torch.cat([tokens_all, tokens_all[perm]]),
                              torch.cat([mask_all, mask_all[perm]]), replayed)
                return tem_2b[:B][mine], tem_2b[B:][mine]

            replayed = None
            if "text_masks" in noise:
                if c.text_resample_per_iter:
                    raise ValueError("noise['text_masks'] replays the hoisted text forward only")
                replayed = Predrawn(list(noise["text_masks"]), list(noise.get("attn_seeds", ())))

            with self.training_mode():
                tems = None
                if not c.text_resample_per_iter:
                    if reuse_mis:
                        tem_all = text(tokens_all, mask_all, replayed)
                        tems = (tem_all[mine], tem_all[perm][mine])
                    else:
                        tems = text_both()
                for i in range(c.n_critic):
                    with span("critic"):
                        if c.text_resample_per_iter:
                            # the last iteration's forward keeps its graph for the
                            # generator step
                            with torch.set_grad_enabled(i == c.n_critic - 1):
                                tems = text_both()
                        tem, tem_mis = (t.detach() for t in tems)
                        ca_eps = draw("ca_eps", i, torch.randn, (B, c.c_dim))
                        z = draw("z", i, torch.randn, (B, c.z_dim))
                        gp_eps = draw("gp_eps", i, torch.rand, (B, 1, 1, 1), dtype=real.dtype)
                        with torch.no_grad():
                            fake = self._gen_forward(tem, ca_eps, z)[0]
                        loss_critic, gp = self.critic_update(real, fake, tem, tem_mis, gp_eps, reduce)

                # generator side, with the last iteration's CA and z noise
                tem = tems[0]
                text_params = self.params_of("encoder", "projection")
                gan_params = self.params_of("con_augment", "generator")
                with span("generator"):
                    fake, mu, sigma = self._gen_forward(tem, ca_eps, z)
                    s_fake = (remat_fn(self.critic, fake, tem) if c.remat else self.critic(fake, tem))
                    s_fake = s_fake.reshape(-1).float()
                    kl = losses.kl_term(mu, sigma, c.kl_mode)
                    if data > 1:
                        kl = kl * data  # a sum over rows: the data group's average is the global sum
                    loss_gen = losses.wgan_generator_loss(s_fake) + kl
                    # down to the text embedding only: the encoder's nodes
                    # are left to the next call, with their saved tensors
                    *gan_grads, g_tem = torch.autograd.grad(loss_gen, gan_params + [tem])
                with span("text_backward"):
                    text_grads = torch.autograd.grad(tem, text_params, grad_outputs=g_tem)
                self.generator_update([*text_grads, *gan_grads], reduce)
            return self.finish_step(loss_critic, gp, loss_gen, kl, reduce)
