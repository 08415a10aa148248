"""Plain PyTorch reference of the StackGAN WGAN-GP training step, stage 1
(BERT fine-tuned inside the GAN step, 64 px nets) and stage 2 (frozen
BERT and stage-I stack, 256 px nets).

It follows the published architecture and the step the configuration
states, written out from the equations: parameters are a flat dict of f32
tensors under the port's ``state_dict`` names, so the benchmark hands the
same weights to both sides, and every layer is a plain ``torch``
operation. It imports nothing of the program and none of its plain
kernel versions; the attention dropout's counter hash is the frozen copy
beside this file.

Precision is the configuration's: parameters, optimizer state, BatchNorm
and LayerNorm statistics in f32, every dense layer, convolution and
attention product in the compute dtype (``compute``), the residual
stream of the text encoder in f32 from its first LayerNorm on. ``quant``
rounds both operands of every product to a lower format first, and the
gradients that reach them (the control, ``fp8_e4m3`` below); it is None
for the reference itself.

Data parallelism: ``step`` takes a list of shards, one per rank, each a
``(batch, noise)`` pair. Every shard runs its own forward and backward
with its own BatchNorm statistics; the gradients, and the reported
losses, are the mean over the shards, as the all-reduce at the
optimizer makes them. One shard is the one-chip step.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.attention_hash import keep_mask

BN_EPS = 1e-5
LEAKY = 0.1
MASK_FILL = -3e7
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
WEIGHT_DECAY = 0.01  # the text encoder's AdamW


def _fp8(x, dtype, largest):
    """``x`` rounded to an fp8 format with one scale for the whole tensor
    (its largest magnitude at the format's ``largest``), in x's dtype."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = largest / amax
    return ((x.detach().float() * scale).to(dtype).float() / scale).to(x.dtype)


class _GradE5M2(torch.autograd.Function):
    """The identity forward; the backward rounds the arriving gradient to
    e5m2, differentiably (straight through), so the gradient penalty's
    second-order pass runs through it too."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g + (_fp8(g, torch.float8_e5m2, 57344.0) - g).detach()


def fp8_e4m3(x):
    """FP8 training's rounding of a product's operand: e4m3 forward with
    one scale a tensor, the gradient through it rounded to e5m2 (the
    formats of FP8 training recipes). Both pass the gradient straight
    through otherwise."""
    x = x + (_fp8(x, torch.float8_e4m3fn, 448.0) - x).detach()
    return _GradE5M2.apply(x)


class Reference:
    """One configuration's step. ``cfg``: the configuration file's
    ``config`` (widths, step settings, ``bert``), ``stage`` 1 or 2,
    ``compute``: the compute dtype."""

    def __init__(self, cfg: dict, stage: int, compute=torch.bfloat16, quant=None):
        self.cfg, self.stage, self.dt, self.quant = cfg, stage, compute or torch.float32, quant
        self.bert = cfg["bert"]

    # ------------------------------------------------------------ layers

    def _q(self, x):
        return x if self.quant is None else self.quant(x)

    def dense(self, P, name, x, dtype=None):
        dt = dtype or x.dtype
        w, b = P[f"{name}.weight"].to(dt), P[f"{name}.bias"].to(dt)
        return F.linear(self._q(x.to(dt)), self._q(w), b)

    def conv(self, P, name, x, stride, padding, transpose=False):
        dt = self.dt or x.dtype
        w = P[f"{name}.weight"].to(dt)
        b = P.get(f"{name}.bias")
        b = None if b is None else b.to(dt)
        fn = F.conv_transpose2d if transpose else F.conv2d
        return fn(self._q(x.to(dt)), self._q(w), b, stride=stride, padding=padding)

    def batchnorm(self, P, name, x, train):
        """Batch statistics in training mode (the biased variance
        ``E[x^2] - E[x]^2``, clamped at 0), the running ones in eval
        mode; output in the compute dtype."""
        xf = x.float()
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        else:
            mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
        mul = torch.rsqrt(var + BN_EPS) * P[f"{name}.weight"]
        y = (xf - mean[:, None, None]) * mul[:, None, None] + P[f"{name}.bias"][:, None, None]
        return y.to(self.dt or torch.float32)

    def up(self, P, name, x, train, first=False):
        geom = (1, 0) if first else (2, 1)
        x = self.conv(P, f"{name}.ConvTranspose2d_0", x, *geom, transpose=True)
        return F.relu(self.batchnorm(P, f"{name}.BatchNorm_0", x, train))

    def down(self, P, name, x, train):
        x = self.conv(P, f"{name}.Conv2d_0", x, 2, 1)
        return F.leaky_relu(self.batchnorm(P, f"{name}.BatchNorm_0", x, train), LEAKY)

    def layernorm(self, P, name, x):
        """Two-pass variance in f32; output f32."""
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        xc = xf - mean
        var = (xc * xc).mean(dim=-1, keepdim=True)
        eps = self.bert["layer_norm_eps"]
        return xc * torch.rsqrt(var + eps) * P[f"{name}.weight"] + P[f"{name}.bias"]

    # ------------------------------------------------------- text encoder

    def _dropout(self, x, keep):
        """``where(keep, x / keep_prob, 0)``, the keep probability rounded
        to x's dtype first."""
        kp = torch.tensor(1.0 - self.bert["dropout_rate"], dtype=x.dtype, device=x.device)
        return torch.where(keep, x / kp, torch.zeros((), dtype=x.dtype, device=x.device))

    def attention(self, q, k, v, mask, rate, seed):
        """Softmax attention over packed heads: scores in f32 at
        ``1/sqrt(d)``, masked keys filled, ``p = exp(s - max)`` and its sum
        ``l`` before dropout, the dropped-out ``p`` rounded to v's dtype
        for ``p V``, the context divided by ``l``."""
        B, T, H = q.shape
        nh = self.bert["num_heads"]
        hd = H // nh
        heads = lambda t: self._q(t).reshape(B, T, nh, hd).float()
        s = torch.einsum("bqhd,bkhd->bhqk", heads(q), heads(k)) * (1.0 / math.sqrt(hd))
        s = torch.where(mask[:, None, None, :] > 0, s, MASK_FILL)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
        l = p.sum(dim=-1, keepdim=True)
        if rate > 0.0:
            keep = keep_mask(B, nh, T, seed, rate, q.device)
            p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
        ctx = torch.einsum("bhqk,bkhd->bqhd", self._q(p.to(v.dtype)).float(), heads(v))
        ctx = ctx / l.permute(0, 2, 1, 3)
        return ctx.reshape(B, T, H).to(q.dtype)

    def encode(self, P, prefix, ids, mask, train, masks=None, seeds=None):
        """tokens -> CLS hidden state -> projection: the text embedding.
        ``train`` turns dropout on, from ``masks`` (the embedding's, then
        two per layer) and ``seeds`` (one per layer, the attention's)."""
        bert, dt = self.bert, self.dt
        T = ids.shape[1]
        e = f"{prefix}.embeddings"
        x = (P[f"{e}.word_embeddings.weight"][ids]
             + P[f"{e}.position_embeddings.weight"][:T][None]
             + P[f"{e}.token_type_embeddings.weight"][0][None, None])
        x = self.layernorm(P, f"{e}.LayerNorm", x)
        masks = iter(masks or ())
        seeds = iter(seeds or ())
        if train:
            x = self._dropout(x, next(masks))
        x = x.to(dt)
        rate = bert["dropout_rate"] if train else 0.0
        for i in range(bert["num_layers"]):
            L = f"{prefix}.encoder.layer.{i}"
            q, k, v = (self.dense(P, f"{L}.attention.self.{n}", x, dt) for n in ("query", "key", "value"))
            ctx = self.attention(q, k, v, mask, rate, next(seeds) if train else 0)
            a = self.dense(P, f"{L}.attention.output.dense", ctx, dt)
            if train:
                a = self._dropout(a, next(masks))
            x = self.layernorm(P, f"{L}.attention.output.LayerNorm", x + a)
            y = F.gelu(self.dense(P, f"{L}.intermediate.dense", x, dt))
            y = self.dense(P, f"{L}.output.dense", y, dt)
            if train:
                y = self._dropout(y, next(masks))
            x = self.layernorm(P, f"{L}.output.LayerNorm", x + y)
        proj = "projection"
        return self.dense(P, proj, x[:, 0, :].float(), dt)

    # --------------------------------------------------------- GAN nets

    def con_augment(self, P, name, tem, eps):
        """mu, sigma from ``relu(Dense(tem))``, computed in tem's dtype;
        ``c_hat = mu + sigma * eps``."""
        h = F.relu(self.dense(P, f"{name}.h", tem))
        mu, sigma = self.dense(P, f"{name}.mu", h), self.dense(P, f"{name}.sigma", h)
        return mu + sigma * eps.to(sigma.dtype), mu, sigma

    def generator1(self, P, name, c_hat, z, train, n_up):
        x = torch.cat([c_hat, z.float()], dim=1)[:, :, None, None]
        for i in range(n_up):
            x = self.up(P, f"{name}.UpBlock_{i}", x, train, first=(i == 0))
        x = self.conv(P, f"{name}.ConvTranspose2d_0", x, 2, 1, transpose=True)
        return torch.tanh(x).permute(0, 2, 3, 1)

    def generator2(self, P, name, img64, c_hat, train):
        c = self.cfg
        x = F.leaky_relu(self.conv(P, f"{name}.Conv2d_0", img64.permute(0, 3, 1, 2), 2, 1), LEAKY)
        x = self.down(P, f"{name}.DownBlock_0", x, train)
        B, _, h, w = x.shape
        rep = c_hat[:, :, None, None].expand(B, c_hat.shape[1], h, w).to(x.dtype)
        x = torch.cat([x, rep], dim=1)
        for i in range(c["num_residual"]):
            R = f"{name}.ResidualBlock_{i}"
            identity = x
            x = F.relu(self.batchnorm(P, f"{R}.BatchNorm_0", self.conv(P, f"{R}.Conv2d_0", x, 1, 1), train))
            x = F.relu(self.batchnorm(P, f"{R}.BatchNorm_1", self.conv(P, f"{R}.Conv2d_1", x, 1, 1), train))
            x = self.batchnorm(P, f"{R}.BatchNorm_2", self.conv(P, f"{R}.Conv2d_2", x, 1, 1), train)
            x = F.relu(x + identity)
        for i in range(len(c["g2_up_channels"])):
            x = self.up(P, f"{name}.UpBlock_{i}", x, train)
        x = self.conv(P, f"{name}.ConvTranspose2d_0", x, 2, 1, transpose=True)
        return torch.tanh(x).permute(0, 2, 3, 1)

    def critic_features(self, P, name, img, n_down):
        x = F.leaky_relu(self.conv(P, f"{name}.conv_in", img.permute(0, 3, 1, 2), 2, 1), LEAKY)
        for i in range(n_down):
            x = self.down(P, f"{name}.down_blocks_{i}", x, True)
        return x

    def critic_score(self, P, name, feat, tem):
        """The head: Dense on tem, replicated over the map after the image
        channels, a 1x1 conv, flattened in (h, w, c) order, Dense(1)."""
        B, _, h, w = feat.shape
        compressed = self.dense(P, f"{name}.head.Dense_0", tem, self.dt)
        rep = compressed[:, :, None, None].expand(B, compressed.shape[1], h, w).to(feat.dtype)
        x = self.conv(P, f"{name}.head.Conv2d_0", torch.cat([feat, rep], dim=1), 1, 0)
        x = self.dense(P, f"{name}.head.Dense_1", x.permute(0, 2, 3, 1).reshape(B, -1), self.dt)
        return x.reshape(-1).float()

    # ------------------------------------------------------------ losses

    def critic_loss(self, P, name, n_down, real, fake, tem, tem_mis, gp_eps):
        lam = self.cfg["lambda_gp"]
        feat_real = self.critic_features(P, name, real, n_down)
        feat_fake = self.critic_features(P, name, fake, n_down)
        s_real = self.critic_score(P, name, feat_real, tem)
        s_mis = self.critic_score(P, name, feat_real, tem_mis)
        s_fake = self.critic_score(P, name, feat_fake, tem)
        interp = (real * gp_eps + fake * (1.0 - gp_eps)).detach().requires_grad_(True)
        scores = self.critic_score(P, name, self.critic_features(P, name, interp, n_down), tem)
        (g,) = torch.autograd.grad(scores.sum(), interp, create_graph=True)
        norms = torch.sqrt(torch.sum(g.reshape(g.shape[0], -1) ** 2, dim=1) + 1e-12)
        gp = torch.mean((norms - 1.0) ** 2)
        loss = torch.cat([s_mis, s_fake]).mean() - s_real.mean() + lam * gp
        return loss, gp

    def kl(self, mu, sigma):
        s = torch.sum(1.0 + torch.log(sigma * sigma) - mu * mu - sigma * sigma)
        return -s if self.cfg["kl_mode"] == "correct" else s

    # -------------------------------------------------------------- step

    def trained(self) -> dict:
        """Optimizer name -> the parameter-name prefixes it updates, and
        whether it is AdamW (the text encoder) and its learning rate."""
        c = self.cfg
        if self.stage == 1:
            return {"critic": (("critic.",), False, c["lr"]),
                    "encoder": (("encoder.",), True, c["encoder_lr"]),
                    "projection": (("projection.",), False, c["lr"]),
                    "con_augment": (("con_augment.",), False, c["lr"]),
                    "generator": (("generator.",), False, c["lr"])}
        return {"critic": (("critic_2.",), False, c["lr"]),
                "con_augment_2": (("con_augment_2.",), False, c["lr"]),
                "generator": (("gen_2.",), False, c["lr"])}

    def init_state(self, params: dict) -> dict:
        """The step's state: f32 parameters (copies) and, per optimizer, its
        leaves' names, moments and update count."""
        P = {k: v.detach().clone().float() for k, v in params.items()}
        opts = {}
        for opt, (prefixes, _, _) in self.trained().items():
            names = [k for k in P if k.startswith(prefixes) and not _is_buffer(k)]
            opts[opt] = {"names": names, "count": 0,
                         "m": {k: torch.zeros_like(P[k]) for k in names},
                         "v": {k: torch.zeros_like(P[k]) for k in names}}
        return {"params": P, "opts": opts}

    def _adam(self, state, opt, grads):
        """torch's Adam (AdamW for the text encoder) on ``grads``, name ->
        mean gradient over the shards. The learning rate is the base one:
        the StepLR boundary lies past the steps compared."""
        _, decoupled, lr = self.trained()[opt]
        o, P = state["opts"][opt], state["params"]
        o["count"] += 1
        t = o["count"]
        b1, b2 = BETAS
        with torch.no_grad():
            for k in o["names"]:
                g = grads[k]
                if decoupled:
                    P[k].mul_(1.0 - lr * WEIGHT_DECAY)
                o["m"][k].mul_(b1).add_(g, alpha=1.0 - b1)
                o["v"][k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (o["v"][k].sqrt() / math.sqrt(1.0 - b2 ** t)).add_(ADAM_EPS)
                P[k].addcdiv_(o["m"][k], denom, value=-lr / (1.0 - b1 ** t))

    def _mean_grads(self, losses_and_params):
        """Mean over the shards of each shard's gradient of its loss."""
        total = None
        for loss, names, leaves in losses_and_params:
            gs = torch.autograd.grad(loss, leaves)
            gs = {k: g.detach().float() for k, g in zip(names, gs)}
            total = gs if total is None else {k: total[k] + gs[k] for k in total}
        n = len(losses_and_params)
        return {k: g / n for k, g in total.items()}

    def step(self, state, shards) -> dict:
        """One training step over ``shards`` (a list of ``(batch,
        noise)``), in place on ``state``. Returns the step's metrics, each
        the mean over the shards: the last critic iteration's loss and
        penalty, the generator loss and its KL term, as 0-d tensors."""
        return (self._step1 if self.stage == 1 else self._step2)(state, shards)

    @staticmethod
    def _leaves(state, opt_names):
        """The parameters of these optimizers as fresh leaves that share
        the state's storage: ``(names, leaves)``."""
        names = [k for o in opt_names for k in state["opts"][o]["names"]]
        leaves = [state["params"][k].detach().requires_grad_(True) for k in names]
        return names, leaves

    def _image(self, image):
        return image.float() * (2.0 / 255.0) - 1.0 if image.dtype == torch.uint8 else image.float()

    def _step1(self, state, shards):
        c, P = self.cfg, state["params"]
        n_up, n_down = len(c["gen_channels"]), len(c["disc_channels"]) - 1
        gen_side = ("encoder", "projection", "con_augment", "generator")
        metrics = {}
        # the text forward of each shard keeps its graph for the generator step
        names, leaves = self._leaves(state, gen_side)
        Pg = dict(P, **dict(zip(names, leaves)))
        tems = []
        for batch, noise in shards:
            ids, mask = batch["input_ids"], batch["attention_mask"]
            perm = noise["perm"]
            tem_2b = self.encode(Pg, "encoder", torch.cat([ids, ids[perm]]), torch.cat([mask, mask[perm]]),
                                 True, noise.get("text_masks"), noise.get("attn_seeds"))
            B = ids.shape[0]
            tems.append((tem_2b[:B], tem_2b[B:]))
        for i in range(c["n_critic"]):
            cnames, cleaves = self._leaves(state, ("critic",))
            Pc = dict(P, **dict(zip(cnames, cleaves)))
            terms = []
            for (batch, noise), (tem, tem_mis) in zip(shards, tems):
                tem, tem_mis = tem.detach(), tem_mis.detach()
                with torch.no_grad():
                    c_hat, _, _ = self.con_augment(P, "con_augment", tem, noise["ca_eps"][i])
                    fake = self.generator1(P, "generator", c_hat, noise["z"][i], True, n_up)
                loss, gp = self.critic_loss(Pc, "critic", n_down, self._image(batch["image"]), fake,
                                            tem, tem_mis, noise["gp_eps"][i])
                terms.append((loss, cnames, cleaves))
                if i == c["n_critic"] - 1:
                    _accumulate(metrics, loss_critic=loss, gp=gp, n=len(shards))
            self._adam(state, "critic", self._mean_grads(terms))
        terms = []
        for (batch, noise), (tem, _) in zip(shards, tems):
            i = c["n_critic"] - 1
            c_hat, mu, sigma = self.con_augment(Pg, "con_augment", tem, noise["ca_eps"][i])
            fake = self.generator1(Pg, "generator", c_hat, noise["z"][i], True, n_up)
            s_fake = self.critic_score(P, "critic", self.critic_features(P, "critic", fake, n_down), tem)
            kl = self.kl(mu, sigma)
            loss_gen = -s_fake.mean() + kl
            terms.append((loss_gen, names, leaves))
            _accumulate(metrics, loss_gen=loss_gen, kl=kl, n=len(shards))
        grads = self._mean_grads(terms)
        for opt in gen_side:
            self._adam(state, opt, grads)
        return metrics

    def _step2(self, state, shards):
        c, P = self.cfg, state["params"]
        n_up1, n_down = len(c["gen1_channels"]), len(c["d2_channels"]) - 1
        metrics = {}
        tems = []
        with torch.no_grad():
            for batch, noise in shards:
                tem = self.encode(P, "encoder", batch["input_ids"], batch["attention_mask"], False)
                tems.append((tem, tem[noise["perm"]]))
        fakes64 = [None] * len(shards)
        for i in range(c["n_critic"]):
            cnames, cleaves = self._leaves(state, ("critic",))
            Pc = dict(P, **dict(zip(cnames, cleaves)))
            terms = []
            for s, ((batch, noise), (tem, tem_mis)) in enumerate(zip(shards, tems)):
                with torch.no_grad():
                    c1, _, _ = self.con_augment(P, "con_augment_1", tem, noise["ca1_eps"][i])
                    fakes64[s] = self.generator1(P, "gen_1", c1, noise["z"][i], False, n_up1)
                    c2, _, _ = self.con_augment(P, "con_augment_2", tem, noise["ca2_eps"][i])
                    fake = self.generator2(P, "gen_2", fakes64[s], c2, True)
                loss, gp = self.critic_loss(Pc, "critic_2", n_down, self._image(batch["image"]), fake,
                                            tem, tem_mis, noise["gp_eps"][i])
                terms.append((loss, cnames, cleaves))
                if i == c["n_critic"] - 1:
                    _accumulate(metrics, loss_critic=loss, gp=gp, n=len(shards))
            self._adam(state, "critic", self._mean_grads(terms))
        gen_side = ("con_augment_2", "generator")
        names, leaves = self._leaves(state, gen_side)
        Pg = dict(P, **dict(zip(names, leaves)))
        terms = []
        for s, ((batch, noise), (tem, _)) in enumerate(zip(shards, tems)):
            i = c["n_critic"] - 1
            c2, mu, sigma = self.con_augment(Pg, "con_augment_2", tem, noise["ca2_eps"][i])
            fake = self.generator2(Pg, "gen_2", fakes64[s], c2, True)
            s_fake = self.critic_score(P, "critic_2", self.critic_features(P, "critic_2", fake, n_down), tem)
            kl = self.kl(mu, sigma)
            loss_gen = -s_fake.mean() + kl
            terms.append((loss_gen, names, leaves))
            _accumulate(metrics, loss_gen=loss_gen, kl=kl, n=len(shards))
        grads = self._mean_grads(terms)
        for opt in gen_side:
            self._adam(state, opt, grads)
        return metrics


def _accumulate(metrics: dict, n: int, **values) -> None:
    """Add each value's share of the mean over ``n`` shards (0-d f32)."""
    for k, v in values.items():
        v = v.detach().float() / n
        metrics[k] = metrics[k] + v if k in metrics else v


def _is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var", "num_batches_tracked"))
