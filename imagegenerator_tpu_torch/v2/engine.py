"""VQGAN+CLIP latent-optimization engine — counterpart of
``imagegenerator_tpu/v2/engine.py``.

One iteration: synth (vector_quantize -> VQGAN decode -> clamped [0, 1])
-> ``cutn`` cutouts -> CLIP image embeddings -> per-prompt spherical
losses -> backward -> Adam step on the latent -> clamp z to the
codebook's per-channel range. Generation is batched: ``z`` is
``(B, h, w, e_dim)`` and each batch element optimizes against its own
prompt set (padded to a common P with zero weights).

Where the JAX package compiles the iteration into one graph and chains a
window of them with ``lax.scan``, the port runs it eagerly: ``chain`` is
a Python loop of ``step`` with no host synchronisation between steps.
The latent and the Adam moments are updated in place (``step`` returns
the state it was given); ``LatentState.clone`` copies a state.

Randomness: each iteration's draws (``MakeCutouts.draw``) come from a
``torch.Generator`` on the engine's device seeded from (run seed,
``state.step``) by ``iteration_generator``, so ``chain`` equals stepping
and a resumed run equals an uninterrupted one. ``step(..., draws=...)``
replays given draws instead.

A batch split over ranks: an engine built with ``shard=(rank, world)``
steps rows ``[rank * b, (rank + 1) * b)`` of a batch of ``world * b``
(``b`` its latent's batch). It draws for the whole batch from the same
generator and keeps its own rows (``MakeCutouts.take_images``), so the
ranks together draw what one process draws. The loss is a sum over the
batch's rows, so no rank needs another's gradient.

``GenerateEngine`` is an entry point: it builds on the card unless
``device`` names another, and raises when the card is wanted and absent.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from imagegenerator_tpu_torch.ops.grad_utils import clamp_with_grad, replace_grad
from imagegenerator_tpu_torch.train import schedules
from imagegenerator_tpu_torch.utils.device import entry_device
from imagegenerator_tpu_torch.utils.rng import mixed_generator
from imagegenerator_tpu_torch.v2.clip import CLIP, CLIPConfig, normalize_image
from imagegenerator_tpu_torch.v2.cutouts import MakeCutouts
from imagegenerator_tpu_torch.v2.prompts import spherical_dist
from imagegenerator_tpu_torch.v2.vqgan import VQGANConfig, VQModel

# the generator of iteration ``step`` of the run seeded ``seed``
iteration_generator = mixed_generator


class LatentState:
    """The latent ``z (B, h, w, e_dim)`` f32, its Adam optimizer (count
    and the moments ``mu``, ``nu``) and the iteration count ``step``, a
    host integer so that seeding an iteration reads nothing from the
    device."""

    def __init__(self, z, step_size: float, step: int = 0):
        self.z = z.detach().clone().float().requires_grad_(True)
        self.step_size = step_size
        self.opt = schedules.adam([self.z], step_size)
        self.step = int(step)

    @property
    def count(self) -> int:
        return schedules.update_count(self.opt)

    def moments(self):
        """``(mu, nu)``; zeros before the first update."""
        st = self.opt.state.get(self.z) or {}
        zeros = torch.zeros_like(self.z)
        return st.get("exp_avg", zeros).detach(), st.get("exp_avg_sq", zeros).detach()

    def set_adam(self, count: int, mu, nu) -> None:
        self.opt.state.clear()
        if count:
            self.opt.state[self.z] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu.detach().clone().to(self.z),
                "exp_avg_sq": nu.detach().clone().to(self.z),
            }

    def leaves(self) -> list:
        """The flattened leaves of the JAX package's ``LatentState``, as
        numpy: z, Adam count (int32), mu, nu, step (int32)."""
        mu, nu = self.moments()
        return [
            self.z.detach().cpu().numpy().copy(), np.asarray(self.count, np.int32),
            mu.cpu().numpy().copy(), nu.cpu().numpy().copy(), np.asarray(self.step, np.int32),
        ]

    @classmethod
    def from_leaves(cls, leaves, step_size: float, device=None) -> "LatentState":
        z, count, mu, nu, step = (np.asarray(a) for a in leaves)
        state = cls(torch.from_numpy(z.astype(np.float32)).to(device), step_size, int(step))
        state.set_adam(int(count), *(torch.from_numpy(m.astype(np.float32)).to(device)
                                     for m in (mu, nu)))
        return state

    def clone(self) -> "LatentState":
        new = LatentState(self.z, self.step_size, self.step)
        new.set_adam(self.count, *self.moments())
        return new


def frozen(cls, config, state: dict | None, dtype=None, *, device, generator=None, **kw):
    """``cls(config, dtype, **kw)`` frozen in eval mode: loaded from
    ``state`` (a ``state_dict`` of tensors or numpy arrays, held strictly
    to the module's names; the module is built without storage and the
    tensors assigned) or, for None, drawn at random from ``generator``."""
    if state is None:
        module = cls(config, dtype, device=device, generator=generator, **kw)
    else:
        module = cls(config, dtype, device="meta", **kw)
        tensors = {k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))).detach()
                   .to(device, torch.float32) for k, v in state.items()}
        module.load_state_dict(tensors, strict=True, assign=True)
    return module.requires_grad_(False).eval()


class GenerateEngine:
    """The frozen VQGAN and CLIP, the cutout sampler and the iteration.

    ``vqgan_state`` and ``clip_state`` are ``state_dict``s under taming's
    and OpenAI's parameter names (tensors or numpy arrays); None draws a
    random init from ``generator``. ``warp_kernel`` and ``warp_split`` go
    to ``MakeCutouts`` (None: the environment's choice);
    ``use_vq_kernel`` to the codebook search (None: the kernel on the
    card, False: the plain version). ``shard``: ``(rank, world)`` of a
    batch split over ranks (see the module's docstring)."""

    def __init__(self, vqgan_config: VQGANConfig, clip_config: CLIPConfig,
                 vqgan_state: dict | None = None, clip_state: dict | None = None, *,
                 cutn: int = 32, cut_pow: float = 1.0, step_size: float = 0.1,
                 augment: bool = True, compute_dtype=None, warp_kernel: bool | None = None,
                 warp_split: bool | None = None, use_vq_kernel: bool | None = None,
                 shard: tuple[int, int] = (0, 1), device=None, generator=None):
        self.device = entry_device(device)
        self.shard = shard
        self.vqgan_config, self.clip_config = vqgan_config, clip_config
        self.cutn, self.step_size, self.compute_dtype = cutn, step_size, compute_dtype
        self.vqmodel = frozen(VQModel, vqgan_config, vqgan_state, compute_dtype, device=self.device,
                              generator=generator, use_vq_kernel=use_vq_kernel)
        self.clip = frozen(CLIP, clip_config, clip_state, compute_dtype, device=self.device,
                           generator=generator)
        self.make_cutouts = MakeCutouts(
            cut_size=clip_config.image_resolution, cutn=cutn, cut_pow=cut_pow,
            augment=augment, warp_split=warp_split, warp_kernel=warp_kernel,
        )
        codebook = self.vqmodel.codebook.detach()
        # per-channel codebook bounds, which z is clamped to after a step
        self.z_min = codebook.amin(dim=0)[None, None, None, :]
        self.z_max = codebook.amax(dim=0)[None, None, None, :]

    # ---------------------------------------------------------------- init
    @torch.no_grad()
    def encode_text(self, tokens) -> torch.Tensor:
        """tokens ``(N, context)`` -> ``(N, embed_dim)`` f32."""
        tokens = torch.as_tensor(np.asarray(tokens)).to(self.device)
        return self.clip.encode_text(tokens).float()

    @torch.no_grad()
    def encode_image_to_latent(self, images) -> torch.Tensor:
        """[-1, 1] NHWC images -> quantized latents (the init-image
        path)."""
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        return self.vqmodel.encode(images)[0].float()

    def random_token_latent(self, generator, batch: int, h: int, w: int) -> torch.Tensor:
        """Random codebook entries, one per latent position."""
        idx = torch.randint(0, self.vqgan_config.n_embed, (batch, h, w),
                            generator=generator, device=self.device)
        return self.vqmodel.codebook.detach()[idx].float()

    def init_state(self, z) -> LatentState:
        return LatentState(torch.as_tensor(z).to(self.device), self.step_size)

    # ---------------------------------------------------------------- synth
    def synth(self, z) -> torch.Tensor:
        """latent -> [0, 1] NHWC image with straight-through quantize and
        a clamped gradient."""
        dec = self.vqmodel.decode(self.vqmodel.quantize(z))
        return clamp_with_grad((dec.float() + 1.0) / 2.0, 0.0, 1.0)

    def image_shape(self, z):
        B, h, w, _ = z.shape
        f = self.vqgan_config.f
        return (B, h * f, w * f, self.vqgan_config.out_ch)

    def draw(self, generator, z) -> dict:
        """The cutout draws of one iteration at ``z``: for the whole batch
        of a split one, of which this engine keeps its rows."""
        rank, world = self.shard
        B, *image = self.image_shape(z)
        draws = self.make_cutouts.draw(generator, (B * world, *image), self.device)
        return draws if world == 1 else self.make_cutouts.take_images(draws, rank * B, (rank + 1) * B)

    # ---------------------------------------------------------------- loss
    def _losses(self, z, draws, embeds, weights, stops) -> torch.Tensor:
        """Per-(batch, prompt) loss matrix ``(B, P)`` from embeds
        ``(B, P, D)`` and weights, stops ``(B, P)``."""
        B = z.shape[0]
        cuts = self.make_cutouts.apply(draws, self.synth(z))  # (B * cutn, s, s, C)
        img_embeds = self.clip.encode_image(normalize_image(cuts)).float()
        d = spherical_dist(img_embeds.reshape(B, self.cutn, -1), embeds)  # (B, cutn, P)
        d = d * torch.sign(weights)[:, None, :]
        floored = replace_grad(d, torch.maximum(d, stops[:, None, :]))
        return weights.abs() * floored.mean(dim=1)

    def losses(self, z, generator, embeds, weights, stops) -> torch.Tensor:
        """The loss matrix at ``z`` with fresh draws, no gradient."""
        with torch.no_grad():
            return self._losses(z, self.draw(generator, z), embeds, weights, stops)

    # ---------------------------------------------------------------- step
    def step(self, state: LatentState, generator, embeds, weights, stops, *, draws=None):
        """One optimization iteration, in place on ``state``: returns
        ``(state, per-prompt losses (B, P))``. The cutout draws come from
        ``generator`` (on the engine's device) unless ``draws`` gives
        them."""
        if draws is None:
            draws = self.draw(generator, state.z)
        state.opt.zero_grad(set_to_none=True)
        losses = self._losses(state.z, draws, embeds, weights, stops)
        losses.sum().backward()
        state.opt.step()
        with torch.no_grad():
            state.z.copy_(torch.maximum(torch.minimum(state.z, self.z_max), self.z_min))
        state.step += 1
        return state, losses.detach()

    def chain(self, state: LatentState, n: int, seed: int, embeds, weights, stops):
        """``n`` iterations with no host synchronisation between them;
        iteration ``state.step`` draws from ``iteration_generator(seed,
        state.step)``. Returns ``(state, per-iteration losses (n, B,
        P))``."""
        per_step = []
        for _ in range(n):
            gen = iteration_generator(seed, state.step, self.device)
            state, losses = self.step(state, gen, embeds, weights, stops)
            per_step.append(losses)
        return state, torch.stack(per_step)

    # ---------------------------------------------------------------- run
    def run(self, state: LatentState, seed: int, embeds, weights, stops, iterations: int,
            display_freq: int = 20, checkin=None, progress=None, state_callback=None):
        """The run loop in the JAX package's order: each ``display_freq``
        window runs as one ``chain``; at a checkin the image and the
        losses are computed before the next window is enqueued and
        fetched to the host after it, as is the last window's loss for
        ``progress(done, total, last_losses (B, P))``. (On one CUDA
        stream the fetch then waits for the window just enqueued.)

        ``checkin(i, images (B, H, W, 3) numpy, losses (B, P) numpy)``
        is called at iteration 0, every ``display_freq`` and at the end.
        ``state_callback(iters_done, state)`` is called at the same
        cadence, and once more with the final state, with a copy made
        before the next window updates the live state in place."""
        embeds, weights, stops = (torch.as_tensor(t).to(self.device) for t in (embeds, weights, stops))
        i = 0
        pending = None  # (iterations done, device losses of the finished chain)
        last_state_save = None
        while True:
            do_checkin = (checkin is not None or state_callback is not None) and i % display_freq == 0
            saved = None
            if do_checkin and state_callback is not None:
                saved = (i, state.clone())
            if do_checkin and checkin is not None:
                with torch.no_grad():
                    imgs = self.synth(state.z)
                losses = self.losses(state.z, iteration_generator(seed, i, self.device),
                                     embeds, weights, stops)
            if i < iterations:
                n = min(display_freq - i % display_freq, iterations - i)
                state, chain_losses = self.chain(state, n, seed, embeds, weights, stops)
            if pending is not None and progress is not None:
                done, dev_losses = pending
                progress(done, iterations, dev_losses.cpu().numpy())
            pending = (i + n, chain_losses[-1]) if i < iterations else None
            if do_checkin and checkin is not None:
                checkin(i, imgs.cpu().numpy(), losses.cpu().numpy())
            if saved is not None:
                state_callback(*saved)
                last_state_save = saved[0]
            if i >= iterations:
                break
            i += n
        if state_callback is not None and last_state_save != iterations:
            state_callback(iterations, state)
        return state


def save_latent_state(path: str, iters_done: int, state: LatentState) -> None:
    """Atomic npz snapshot of a ``LatentState`` and its completed
    iteration count, in the JAX package's layout: its state's flattened
    leaves ``leaf_0 .. leaf_4`` = z, Adam count (int32), mu, nu, step
    (int32), plus ``iters_done`` and ``n_leaves``. Either package resumes
    from the other's file. Written to a temporary file and renamed, so
    an interrupt cannot corrupt an existing snapshot."""
    leaves = state.leaves()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, iters_done=np.int64(iters_done), n_leaves=np.int64(len(leaves)),
                 **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    os.replace(tmp, path)


def load_latent_state(path: str, template: LatentState, shard: tuple[int, int] = (0, 1)):
    """Restore ``(iters_done, LatentState)`` written by
    ``save_latent_state`` of either package. ``template`` (build it with
    ``engine.init_state(z)`` for the same geometry) gives the shapes, the
    device and the step size; a file of another image size, batch or
    optimizer raises ``ValueError``. With ``shard=(rank, world)`` the file
    holds the whole batch of a split one, ``world`` times the template's,
    and this rank's rows are restored."""
    with np.load(path) as d:
        iters_done = int(d["iters_done"])
        n = int(d["n_leaves"])
        loaded = [d[f"leaf_{i}"] for i in range(n)]
    rank, world = shard
    B, *rest = template.z.shape
    whole = (B * world, *rest)
    want = [whole, (), whole, whole, ()]
    if n != len(want):
        raise ValueError(
            f"state file {path} holds {n} leaves; the current engine state has "
            f"{len(want)} — different optimizer or version"
        )
    for k, (got, shape) in enumerate(zip(loaded, want)):
        if tuple(got.shape) != shape:
            raise ValueError(
                f"state leaf {k}: file shape {tuple(got.shape)} != expected {shape} "
                "(different image size, batch, or codebook geometry)"
            )
    rows = slice(rank * B, (rank + 1) * B)
    loaded = [a[rows] if a.ndim else a for a in loaded]
    return iters_done, LatentState.from_leaves(loaded, template.step_size, template.z.device)


def pad_prompt_specs(embed_list, weight_list, stop_list, pad_to: int | None = None):
    """Stack per-prompt embeddings into ``(1, P, D)``, ``(1, P)``,
    ``(1, P)`` numpy arrays with zero-weight padding, so that prompt sets
    of different sizes share one batch."""
    P = pad_to or max(1, len(embed_list))
    D = embed_list[0].shape[-1] if embed_list else 1
    embeds = np.zeros((1, P, D), np.float32)
    weights = np.zeros((1, P), np.float32)
    stops = np.full((1, P), -np.inf, np.float32)
    for i, (e, w, s) in enumerate(zip(embed_list, weight_list, stop_list)):
        embeds[0, i] = e
        weights[0, i] = w
        stops[0, i] = s
    return embeds, weights, stops
