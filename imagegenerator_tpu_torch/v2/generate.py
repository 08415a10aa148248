"""v2 generation CLI: ``python -m imagegenerator_tpu_torch.v2.generate -p
"..."`` — counterpart of ``imagegenerator_tpu/v2/generate.py``.

Loads the VQGAN checkpoint (+ yaml config) and CLIP, builds per-prompt
text embeddings, initialises the latent (random tokens, or an encoded
random-noise or gradient image), optimizes it with Adam, and writes the
output PNG with the prompt in a ``comment`` text chunk, printing the
per-prompt losses every ``--save_every`` iterations. Runs on the card
unless ``--cuda_device cpu``; without a card the default fails.

Without checkpoint files on disk it falls back to randomly initialised
tiny models, with a warning, so that the whole pipeline stays runnable.
Not ported: the ModifiedResNet CLIP models (``-m RN50`` ...),
``--profile_dir``, images whose short side exceeds the CLIP resolution
(the lanczos cutout path), and sharding a batch of prompt sets over
several devices; each raises ``NotImplementedError`` (a batch runs on
the one device).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from imagegenerator_tpu_torch.utils.device import entry_device
from imagegenerator_tpu_torch.utils.png import write_png
from imagegenerator_tpu_torch.v2.arg_parser import get_parser
from imagegenerator_tpu_torch.v2.clip import CLIPConfig, clip_config_from_state_dict
from imagegenerator_tpu_torch.v2.engine import (
    GenerateEngine,
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
    if CLIP_CONFIGS[model_name]().is_resnet:
        raise NotImplementedError(
            f"CLIP model {model_name}: the ModifiedResNet image towers are not ported; "
            "use a ViT model"
        )
    if ckpt_path and os.path.exists(ckpt_path):
        sd = load_torch_state_dict(ckpt_path)
        sd = {k: v for k, v in sd.items() if k not in _CLIP_DROP}
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
    if args.profile_dir:
        raise NotImplementedError("--profile_dir is not ported yet")
    device = entry_device(args.cuda_device)

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
    seed = args.seed if args.seed is not None else int.from_bytes(os.urandom(4), "little")
    print("Using seed:", seed)
    # one generator for the models' random init and the latent's; the
    # iterations draw from generators seeded by (seed, iteration)
    gen = torch.Generator(device=device).manual_seed(seed)

    vq_cfg, vq_state = load_vqgan(args.vqgan_config, args.vqgan_checkpoint)
    clip_cfg, clip_state = load_clip(args.clip_model, args.clip_checkpoint)
    engine = GenerateEngine(
        vq_cfg, clip_cfg, vq_state, clip_state, step_size=args.step_size,
        device=device, generator=gen,
    )

    f = vq_cfg.f
    toks_x, toks_y = args.size[0] // f, args.size[1] // f
    side_x, side_y = toks_x * f, toks_y * f

    if args.init_noise in ("random", "gradient"):
        rng = np.random.default_rng(seed)
        img_fn = random_noise_image if args.init_noise == "random" else random_gradient_image
        imgs01 = np.stack([img_fn(side_x, side_y, rng) for _ in range(batch)])
        z = engine.encode_image_to_latent(imgs01 * 2.0 - 1.0)
    else:
        z = engine.random_token_latent(gen, batch, toks_y, toks_x)

    # per-prompt CLIP text embeddings, padded to a common P across sets
    tokenizer = open_tokenizer(args.bpe_vocab, clip_cfg.context_length, clip_cfg.vocab_size)
    p_max = max(1, max(len(s) for s in prompt_sets))
    rows = []
    for prompts in prompt_sets:
        embed_list, weights, stops = [], [], []
        for prompt in prompts:
            txt, w, s = split_prompt(prompt)
            embed_list.append(engine.encode_text(tokenizer([txt])).cpu().numpy()[0])
            weights.append(w)
            stops.append(s)
        rows.append(pad_prompt_specs(embed_list, weights, stops, pad_to=p_max))
    embeds, w_arr, s_arr = (np.concatenate([r[k] for r in rows]) for k in range(3))

    state = engine.init_state(z)

    # --state: restored after init_state, which gives load_latent_state
    # the shapes to hold the file to
    it0 = 0
    state_callback = None
    if args.state_path:
        if os.path.exists(args.state_path):
            it0, state = load_latent_state(args.state_path, state)
            print(f"Resumed state at iteration {it0} from {args.state_path}")

        def state_callback(i, st):
            save_latent_state(args.state_path, it0 + i, st)

    remaining = max(0, args.max_iterations - it0)
    stem, ext = os.path.splitext(args.output)

    def out_path(i: int) -> str:
        return args.output if batch == 1 else f"{stem}_{i}{ext or '.png'}"

    def checkin(i, imgs, losses):
        for b, prompts in enumerate(prompt_sets):
            per_prompt = losses[b, : max(1, len(prompts))]
            loss_str = ", ".join(f"{v:g}" for v in per_prompt)
            prefix = f"[{b}] " if batch > 1 else ""
            print(f"{prefix}i: {it0 + i}, loss: {per_prompt.sum():g}, losses: {loss_str}")
            save_png(out_path(b), imgs[b], f"{prompts}")

    def progress(done, total, last_losses):
        per_image = [f"{last_losses[b, : max(1, len(p))].sum():g}"
                     for b, p in enumerate(prompt_sets)]
        print(f"progress: {it0 + done}/{args.max_iterations} iterations, "
              f"loss: {', '.join(per_image)}")

    try:
        engine.run(
            state, seed, embeds, w_arr, s_arr, iterations=remaining,
            display_freq=args.display_freq, checkin=checkin, progress=progress,
            state_callback=state_callback,
        )
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
