"""v2 CLI flags — the port's own copy of
``imagegenerator_tpu/v2/arg_parser.py``: the same short and long names,
dests and defaults, except that ``-cd/--cuda_device`` takes ``cuda`` (the
default) or ``cpu``, and JAX's ``--rng_impl`` is not carried."""

from __future__ import annotations

import argparse


def get_parser(default_image_size: int = 128) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ImageGenv2 using VQGAN+CLIP (PyTorch, CUDA)")
    p.add_argument("-p", "--prompts", type=str, default=None, dest="prompts",
                   help="Text prompts (| separated; each 'text:weight:stop')")
    p.add_argument("-i", "--iterations", type=int, default=200,
                   dest="max_iterations", help="Optimization iterations to run")
    p.add_argument("-se", "--save_every", type=int, default=20,
                   dest="display_freq", help="Checkin/save interval (iterations)")
    p.add_argument("-s", "--size", nargs=2, type=int,
                   default=[default_image_size, default_image_size],
                   dest="size", help="Output image width and height (pixels)")
    p.add_argument("-m", "--clip_model", type=str, default="ViT-B/32",
                   dest="clip_model", help="CLIP model variant (ViT-B/32, ViT-B/16, ViT-L/14)")
    p.add_argument("-conf", "--vqgan_config", type=str,
                   default="checkpoints/vqgan_imagenet_f16_16384.yaml",
                   dest="vqgan_config", help="Path to the VQGAN yaml config")
    p.add_argument("-ckpt", "--vqgan_checkpoint", type=str,
                   default="checkpoints/vqgan_imagenet_f16_16384.ckpt",
                   dest="vqgan_checkpoint", help="Path to the VQGAN .ckpt weights")
    p.add_argument("-lr", "--learning_rate", type=float, default=0.1,
                   dest="step_size", help="Adam step size for the latent")
    p.add_argument("-sd", "--seed", type=int, default=None, dest="seed",
                   help="Seed (random when omitted)")
    p.add_argument("-cd", "--cuda_device", type=str, default="cuda",
                   dest="cuda_device",
                   help="Device to run on: cuda (default; fails without a card), "
                        "cuda:N or cpu")
    p.add_argument("-o", "--output", type=str, default="output.png",
                   dest="output", help="Output PNG path")
    p.add_argument("-in", "--init_noise", type=str, default=None,
                   dest="init_noise",
                   help="Latent init image kind: random | gradient")
    p.add_argument("--bpe_vocab", type=str, default=None, dest="bpe_vocab",
                   help="Path to CLIP bpe_simple_vocab_16e6.txt.gz")
    p.add_argument("--clip_checkpoint", type=str, default=None,
                   dest="clip_checkpoint",
                   help="Path to an OpenAI CLIP .pt checkpoint (a state_dict)")
    p.add_argument("--prompts_file", type=str, default=None,
                   dest="prompts_file",
                   help="File with one prompt set per line; generates one "
                        "image per line as one batch (outputs <stem>_<i>.png)")
    p.add_argument("--profile_dir", type=str, default=None,
                   dest="profile_dir",
                   help="Not ported yet: raises NotImplementedError")
    p.add_argument("--state", type=str, default=None, dest="state_path",
                   help="Path of an npz resume snapshot: the latent and the "
                        "optimizer state are saved here at every --save_every "
                        "checkin (atomic tmp+rename) and on completion, and "
                        "restored at startup when the file exists. An "
                        "interrupted run relaunched with the same command and "
                        "--seed continues where it stopped with the same "
                        "per-iteration draws (they are seeded from the saved "
                        "step counter). The file has the JAX package's layout, "
                        "so either package resumes the other's snapshot")
    return p
