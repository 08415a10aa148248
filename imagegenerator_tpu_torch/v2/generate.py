"""v2 generation CLI: ``python -m imagegenerator_tpu_torch.v2.generate -p
"..."`` — counterpart of ``imagegenerator_tpu/v2/generate.py``.

Loads the VQGAN checkpoint (+ yaml config) and CLIP, builds per-prompt
text embeddings, initialises the latent (random tokens, or an encoded
random-noise or gradient image), optimizes it with Adam, and writes the
output PNG with the prompt in a ``comment`` text chunk, printing the
per-prompt losses every ``--save_every`` iterations. Runs on the card
unless ``--cuda_device cpu``; without a card the default fails.

``--profile_dir DIR`` writes a ``torch.profiler`` trace of the
optimisation loop (``utils/profiling.py``).

A ``--prompts_file`` batch spreads over ranks under ``torchrun``
(``WORLD_SIZE`` > 1), as the JAX package shards it over its devices:

    torchrun --standalone --nproc_per_node 2 -m imagegenerator_tpu_torch.v2.generate \
        --prompts_file prompts.txt ...

Each rank (on ``cuda:LOCAL_RANK``; ``-cd cuda:0`` puts every rank on one
card, ``-cd cpu`` on the CPU) optimises its own ``batch / world`` rows
and draws what one process would (``engine.py``); at each checkin rank 0
gathers the images and losses and prints, writes the PNGs and the
``--state`` file as one process does, and a resumed run gives each rank
its rows of that file. The batch must divide over the ranks.

Without checkpoint files on disk it falls back to randomly initialised
tiny models, with a warning, so that the whole pipeline stays runnable.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

from imagegenerator_tpu_torch.parallel import dp
from imagegenerator_tpu_torch.utils.device import entry_device
from imagegenerator_tpu_torch.utils.png import write_png
from imagegenerator_tpu_torch.utils.profiling import trace
from imagegenerator_tpu_torch.v2.arg_parser import get_parser
from imagegenerator_tpu_torch.v2.clip import CLIPConfig, clip_config_from_state_dict
from imagegenerator_tpu_torch.v2.engine import (
    GenerateEngine,
    LatentState,
    load_latent_state,
    pad_prompt_specs,
    save_latent_state,
)
from imagegenerator_tpu_torch.v2.init_image import random_gradient_image, random_noise_image
from imagegenerator_tpu_torch.v2.prompts import split_prompt
from imagegenerator_tpu_torch.v2.tokenizer import open_tokenizer
from imagegenerator_tpu_torch.v2.vqgan import VQGANConfig, config_from_yaml_dict

DEFAULT_IMAGE_SIZE = 128

CLIP_CONFIGS = {
    "ViT-B/32": CLIPConfig.vit_b32,
    "ViT-B/16": CLIPConfig.vit_b16,
    "ViT-L/14": CLIPConfig.vit_l14,
    "ViT-L/14@336px": CLIPConfig.vit_l14_336,
    "RN50": CLIPConfig.rn50,
    "RN101": CLIPConfig.rn101,
    "RN50x4": CLIPConfig.rn50x4,
    "RN50x16": CLIPConfig.rn50x16,
    "RN50x64": CLIPConfig.rn50x64,
}

# entries of a published checkpoint that are no parameter of the models
_VQGAN_DROP = ("loss.",)
_CLIP_DROP = ("logit_scale", "input_resolution", "context_length", "vocab_size")
_CLIP_DROP_SUFFIX = ".num_batches_tracked"  # the ResNet towers' BatchNorm counters


def load_torch_state_dict(path: str) -> dict:
    """The ``state_dict`` of a torch checkpoint: the object itself, or
    its ``state_dict`` entry (taming's Lightning ``.ckpt``)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):  # a whole (TorchScript or pickled) module
        obj = obj.state_dict()
    return obj.get("state_dict", obj) if isinstance(obj, dict) else obj


def load_vqgan(config_path: str, ckpt_path: str):
    """yaml + .ckpt -> ``(config, state_dict)`` under taming's names;
    ``(tiny config, None)``, a random tiny model, if either is absent."""
    if os.path.exists(config_path) and os.path.exists(ckpt_path):
        import yaml

        with open(config_path) as f:
            y = yaml.safe_load(f)
        target = y["model"].get("target", "taming.models.vqgan.VQModel")
        if not target.endswith("VQModel"):
            raise ValueError(f"unknown model type: {target}")
        sd = load_torch_state_dict(ckpt_path)
        sd = {k: v for k, v in sd.items() if not k.startswith(_VQGAN_DROP)}
        return config_from_yaml_dict(y["model"]["params"]), sd
    print(f"[warn] VQGAN checkpoint not found ({ckpt_path}); "
          "using a randomly-initialized tiny model", file=sys.stderr)
    return VQGANConfig.tiny(), None


def load_clip(model_name: str, ckpt_path: str | None):
    """``(config, state_dict)`` under OpenAI's names from a checkpoint;
    ``(tiny config, None)``, a random tiny model, if it is absent."""
    if model_name not in CLIP_CONFIGS:
        raise ValueError(
            f"unsupported CLIP model {model_name!r}; choose one of {sorted(CLIP_CONFIGS)}"
        )
    if ckpt_path and os.path.exists(ckpt_path):
        sd = load_torch_state_dict(ckpt_path)
        sd = {k: v for k, v in sd.items() if k not in _CLIP_DROP and not k.endswith(_CLIP_DROP_SUFFIX)}
        return clip_config_from_state_dict(sd), sd
    print(f"[warn] CLIP checkpoint not found for {model_name}; "
          "using a randomly-initialized tiny model", file=sys.stderr)
    return CLIPConfig.tiny(), None


def save_png(path: str, image01: np.ndarray, comment: str) -> None:
    """[0, 1] HWC float -> PNG with the prompt in a ``comment`` text
    chunk."""
    arr = np.clip(np.asarray(image01) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    write_png(path, arr, {"comment": comment})


def main(argv=None):
    args = get_parser(DEFAULT_IMAGE_SIZE).parse_args(argv)

    # prompt sets: one image per set. A single -p "a|b" is one image with
    # two prompts; --prompts_file is one set per line, run as one batch.
    prompt_sets: list[list[str]] = []
    if args.prompts_file:
        with open(args.prompts_file) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    prompt_sets.append(line.split("|"))
    elif args.prompts:
        prompt_sets.append(args.prompts.strip().split("|"))
    else:
        prompt_sets.append([])

    batch = len(prompt_sets)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = dp.local_batch_size(batch, world)  # raises unless the batch divides over the ranks
    device = dp.init_from_env(args.cuda_device) if world > 1 else entry_device(args.cuda_device)
    rows = slice(dp.rank() * local, (dp.rank() + 1) * local)
    say = print if dp.is_main() else (lambda *_: None)
    try:
        _generate(args, prompt_sets, rows, say, device)
    finally:
        if world > 1:
            torch.distributed.destroy_process_group()


def _generate(args, prompt_sets, rows, say, device):
    """The run of ``main`` on this rank's ``rows`` of the batch; ``say``
    prints on rank 0 only."""
    batch, world = len(prompt_sets), dp.world()
    seed = args.seed if args.seed is not None else int.from_bytes(os.urandom(4), "little")
    if world > 1:  # every rank runs on rank 0's seed
        seed = int(dp.all_reduce_sum(seed if dp.is_main() else 0)[0])
    say("Using seed:", seed)
    # one generator for the models' random init and the latent's; the
    # iterations draw from generators seeded by (seed, iteration)
    gen = torch.Generator(device=device).manual_seed(seed)

    vq_cfg, vq_state = load_vqgan(args.vqgan_config, args.vqgan_checkpoint)
    clip_cfg, clip_state = load_clip(args.clip_model, args.clip_checkpoint)
    engine = GenerateEngine(
        vq_cfg, clip_cfg, vq_state, clip_state, step_size=args.step_size,
        shard=(dp.rank(), world), device=device, generator=gen,
    )

    f = vq_cfg.f
    toks_x, toks_y = args.size[0] // f, args.size[1] // f
    side_x, side_y = toks_x * f, toks_y * f

    if args.init_noise in ("random", "gradient"):
        rng = np.random.default_rng(seed)
        img_fn = random_noise_image if args.init_noise == "random" else random_gradient_image
        imgs01 = np.stack([img_fn(side_x, side_y, rng) for _ in range(batch)])
        z = engine.encode_image_to_latent(imgs01[rows] * 2.0 - 1.0)
    else:
        z = engine.random_token_latent(gen, batch, toks_y, toks_x)[rows]

    # per-prompt CLIP text embeddings of this rank's sets, padded to a
    # common P across all sets
    tokenizer = open_tokenizer(args.bpe_vocab, clip_cfg.context_length, clip_cfg.vocab_size)
    p_max = max(1, max(len(s) for s in prompt_sets))
    specs = []
    for prompts in prompt_sets[rows]:
        embed_list, weights, stops = [], [], []
        for prompt in prompts:
            txt, w, s = split_prompt(prompt)
            embed_list.append(engine.encode_text(tokenizer([txt])).cpu().numpy()[0])
            weights.append(w)
            stops.append(s)
        specs.append(pad_prompt_specs(embed_list, weights, stops, pad_to=p_max))
    embeds, w_arr, s_arr = (np.concatenate([r[k] for r in specs]) for k in range(3))

    state = engine.init_state(z)

    # --state: restored after init_state, which gives load_latent_state
    # the shapes to hold the file to
    it0 = 0
    state_callback = None
    if args.state_path:
        if os.path.exists(args.state_path):
            it0, state = load_latent_state(args.state_path, state, engine.shard)
            say(f"Resumed state at iteration {it0} from {args.state_path}")

        def state_callback(i, st):
            if world > 1:  # the whole batch's z and Adam moments, to rank 0
                st = LatentState.from_leaves([dp.gather_rows(a) if a.ndim else a for a in st.leaves()],
                                             st.step_size)
            if dp.is_main():
                save_latent_state(args.state_path, it0 + i, st)

    remaining = max(0, args.max_iterations - it0)
    stem, ext = os.path.splitext(args.output)

    def out_path(i: int) -> str:
        return args.output if batch == 1 else f"{stem}_{i}{ext or '.png'}"

    def checkin(i, imgs, losses):
        imgs, losses = dp.gather_rows(imgs), dp.gather_rows(losses)
        if not dp.is_main():
            return
        for b, prompts in enumerate(prompt_sets):
            per_prompt = losses[b, : max(1, len(prompts))]
            loss_str = ", ".join(f"{v:g}" for v in per_prompt)
            prefix = f"[{b}] " if batch > 1 else ""
            print(f"{prefix}i: {it0 + i}, loss: {per_prompt.sum():g}, losses: {loss_str}")
            save_png(out_path(b), imgs[b], f"{prompts}")

    def progress(done, total, last_losses):
        last_losses = dp.gather_rows(last_losses)
        per_image = [f"{last_losses[b, : max(1, len(p))].sum():g}"
                     for b, p in enumerate(prompt_sets)]
        say(f"progress: {it0 + done}/{args.max_iterations} iterations, "
            f"loss: {', '.join(per_image)}")

    prof = trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    try:
        with prof:
            engine.run(
                state, seed, embeds, w_arr, s_arr, iterations=remaining,
                display_freq=args.display_freq, checkin=checkin, progress=progress,
                state_callback=state_callback,
            )
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
