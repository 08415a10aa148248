"""Weights-day playbook: validate published checkpoints the moment they
land on disk, on the card: the port's counterpart of the JAX package's
``tools/validate_real_weights.py``, with the same sections, flags, probe
inputs and golden files, plus ``--device``.

When the published taming VQGAN ``.ckpt``/``.yaml``, OpenAI CLIP ``.pt``,
SpanBERT ``pytorch_model.bin`` and CLIP BPE merges are on disk, run:

    python -m imagegenerator_tpu_torch.tools.validate_real_weights \\
        --vqgan_config checkpoints/vqgan_imagenet_f16_16384.yaml \\
        --vqgan_checkpoint checkpoints/vqgan_imagenet_f16_16384.ckpt \\
        --clip_checkpoint checkpoints/ViT-B-32.pt \\
        --bert_checkpoint checkpoints/spanbert/pytorch_model.bin \\
        --bpe_vocab checkpoints/bpe_simple_vocab_16e6.txt.gz \\
        --out weights_day/ --strict

Every section is optional: pass whichever files you have. Per file: load
-> structural checks -> a deterministic forward on a fixed probe input ->
golden arrays under ``--out`` (``vqgan_roundtrip.npz``, ``clip_embeds.npz``,
``bert_cls.npz``) -> with VQGAN and CLIP both present, one fixed-seed 128
px generation through the v2 CLI (``weights_day_sample.png``) and its
CLIPScore against its prompt and an unrelated foil; ``MANIFEST.json``
lists the sections run. Each section runs in f32 on ``--device`` (the
card by default; without one it raises, it never falls back to the CPU).
A path given that does not exist is an error, not a random model.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from imagegenerator_tpu_torch.eval import clip_eval
from imagegenerator_tpu_torch.eval.cli import load_image_set
from imagegenerator_tpu_torch.models.bert import BertEncoder, load_bert_checkpoint
from imagegenerator_tpu_torch.utils.device import entry_device
from imagegenerator_tpu_torch.v2 import generate
from imagegenerator_tpu_torch.v2.clip import CLIP, normalize_image
from imagegenerator_tpu_torch.v2.engine import frozen
from imagegenerator_tpu_torch.v2.tokenizer import open_tokenizer
from imagegenerator_tpu_torch.v2.vqgan import VQModel

EVAL_PROMPT = "a watercolor painting of a fox in a snowy forest"
EVAL_FOIL = "a spreadsheet of quarterly earnings figures"
CLIP_PROMPTS = ["a photo of a cat", "a diagram of a steam engine"]


def _section(name):
    print(f"\n=== {name} ===", flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _exists(*paths) -> None:
    for path in paths:
        if path and not os.path.exists(path):
            raise FileNotFoundError(path)


def _save_golden(out_dir: str, name: str, **arrays) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.npz")
    np.savez(path, **arrays)
    print(f"golden written: {path}")


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy() if t.is_floating_point() else t.detach().cpu().numpy()


def _clip_tokens(tokenizer, prompts, cfg) -> np.ndarray:
    tokens = tokenizer(prompts)
    if tokens.max() >= cfg.vocab_size:
        # only possible in a dry run: a real merges file pairs with the
        # published 49408-vocab model; synthetic tiny checkpoints do not
        print(f"[dry-run] tokenizer ids exceed the model vocab ({tokens.max()} >= {cfg.vocab_size}); "
              "folding into range")
        tokens = tokens % cfg.vocab_size
    return tokens


@torch.no_grad()
def validate_vqgan(config_path: str, ckpt_path: str, out_dir: str, device):
    _section(f"VQGAN: {ckpt_path}")
    _exists(config_path, ckpt_path)
    cfg, state = generate.load_vqgan(config_path, ckpt_path)
    print(f"config: f={cfg.f}, n_embed={cfg.n_embed}, embed_dim={cfg.embed_dim}")
    model = frozen(VQModel, cfg, state, device=device)
    _check(tuple(model.codebook.shape) == (cfg.n_embed, cfg.embed_dim), f"codebook {tuple(model.codebook.shape)}")
    # deterministic probe image: encode -> quantize -> decode roundtrip
    x = np.sin(np.arange(128 * 128 * 3, dtype=np.float32).reshape(1, 128, 128, 3) * 0.37)
    z_q, idx = model.encode(torch.from_numpy(x).to(device))
    dec = model.decode(z_q)
    z_q, idx, dec = _numpy(z_q), _numpy(idx), _numpy(dec)
    print(f"encode: z_q {z_q.shape}, used codes {len(np.unique(idx))}")
    print(f"decode: {dec.shape}, range [{dec.min():.3f}, {dec.max():.3f}]")
    _check(dec.shape == x.shape, f"decoded shape {dec.shape}")
    _check(bool(np.isfinite(dec).all()), "decoded image not finite")
    _save_golden(out_dir, "vqgan_roundtrip", z_q=z_q, indices=idx, decoded=dec)
    return cfg, state


@torch.no_grad()
def validate_clip(ckpt_path: str, bpe_path: str | None, out_dir: str, device):
    _section(f"CLIP: {ckpt_path}")
    _exists(ckpt_path, bpe_path)
    cfg, state = generate.load_clip("ViT-B/32", ckpt_path)
    print(f"config: image_res={cfg.image_resolution}, embed_dim={cfg.embed_dim}, "
          f"vision={'RN' if cfg.is_resnet else 'ViT'}")
    model = frozen(CLIP, cfg, state, device=device)
    tokens = _clip_tokens(open_tokenizer(bpe_path, cfg.context_length, cfg.vocab_size), CLIP_PROMPTS, cfg)
    print(f"token ids[0][:8]: {tokens[0][:8].tolist()}")
    te = _numpy(model.encode_text(torch.from_numpy(tokens).to(device)))
    r = cfg.image_resolution
    probe = np.linspace(0, 1, r * r * 3, dtype=np.float32).reshape(1, r, r, 3)
    ie = _numpy(model.encode_image(normalize_image(torch.from_numpy(probe).to(device))))
    te_n = te / np.linalg.norm(te, axis=-1, keepdims=True)
    ie_n = ie / np.linalg.norm(ie, axis=-1, keepdims=True)
    print(f"text embeds {te.shape}, image embeds {ie.shape}, sims {(ie_n @ te_n.T).ravel()}")
    _check(bool(np.isfinite(te_n).all() and np.isfinite(ie_n).all()), "CLIP embeddings not finite")
    _save_golden(out_dir, "clip_embeds", tokens=tokens, text_embeds=te, image_embeds=ie)
    return cfg, state


@torch.no_grad()
def validate_bert(ckpt_path: str, out_dir: str, device):
    _section(f"BERT (SpanBERT): {ckpt_path}")
    _exists(ckpt_path)
    state, cfg = load_bert_checkpoint(ckpt_path)
    print(f"config: hidden={cfg.hidden_size}, layers={cfg.num_layers}, vocab={cfg.vocab_size}")
    enc = frozen(BertEncoder, cfg, state, device=device)
    ids = np.arange(2 * 16, dtype=np.int32).reshape(2, 16) % cfg.vocab_size
    mask = torch.ones((2, 16), dtype=torch.int32, device=device)
    cls = _numpy(enc(torch.from_numpy(ids).to(device), mask)[:, 0, :])
    print(f"CLS hidden: {cls.shape}, norm {np.linalg.norm(cls, axis=-1)}")
    _check(bool(np.isfinite(cls).all()), "CLS hidden state not finite")
    _save_golden(out_dir, "bert_cls", input_ids=ids, cls=cls)
    return cfg, state


def real_generation(args, out_dir: str, clip_cfg) -> None:
    """One fixed-seed 128 px generation through the v2 CLI path. In a dry
    run whose BPE ids exceed the (synthetic) CLIP's vocab, which the v2
    CLI refuses where JAX's embedding lookup clamps them, the CLI runs
    with its fallback tokenizer."""
    _section("real generation (v2 CLI path)")
    out_png = os.path.join(out_dir, "weights_day_sample.png")
    argv = ["-p", EVAL_PROMPT, "-i", str(args.iterations), "-se", str(args.iterations), "-sd", "123456",
            "-o", out_png, "-conf", args.vqgan_config, "-ckpt", args.vqgan_checkpoint, "-m", args.clip_model,
            "-cd", args.device]
    if args.clip_checkpoint:
        argv += ["--clip_checkpoint", args.clip_checkpoint]
    if args.bpe_vocab:
        ids = open_tokenizer(args.bpe_vocab, clip_cfg.context_length, clip_cfg.vocab_size)([EVAL_PROMPT])
        if ids.max() < clip_cfg.vocab_size:
            argv += ["--bpe_vocab", args.bpe_vocab]
        else:
            print(f"[dry-run] tokenizer ids exceed the model vocab ({ids.max()} >= {clip_cfg.vocab_size}); "
                  "generating with the CLI's fallback tokenizer")
    generate.main(argv)
    print(f"sample written: {out_png}")


@torch.no_grad()
def validate_eval(args, out_dir: str, device) -> tuple[float, float]:
    """CLIPScore of the weights-day sample against its own prompt and an
    unrelated foil, from one model load and one image embedding (real
    weights only can tell them apart, so a dry run just reports; with
    ``--strict`` the matched prompt must score higher). Returns
    ``(matched, foil)``."""
    _section("evaluation (CLIPScore on the weights-day sample)")
    sample = load_image_set(os.path.join(out_dir, "weights_day_sample.png"))
    cfg, state = generate.load_clip(args.clip_model, args.clip_checkpoint)
    model = frozen(CLIP, cfg, state, device=device)
    tokens = _clip_tokens(open_tokenizer(args.bpe_vocab, cfg.context_length, cfg.vocab_size),
                          [EVAL_PROMPT, EVAL_FOIL], cfg)
    ie = clip_eval.image_embeddings(model, sample, batch_size=1)
    te = clip_eval.text_embeddings(model, tokens, batch_size=2)
    matched, foil = clip_eval.clip_score(ie, te[:1]), clip_eval.clip_score(ie, te[1:])
    ok = matched > foil
    print(f"CLIPScore matched prompt: {matched:.2f}, foil: {foil:.2f} -> "
          f"{'DISCRIMINATES' if ok else 'no discrimination'}")
    if args.strict:
        # published CLIP weights must rank the generation's own prompt
        # above an unrelated foil; synthetic or random ones cannot
        _check(ok, "CLIP weights failed to rank the generation's own prompt above an unrelated foil")
    return matched, foil


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m imagegenerator_tpu_torch.tools.validate_real_weights",
                                description=__doc__.split("\n")[0])
    p.add_argument("--vqgan_config", default=None)
    p.add_argument("--vqgan_checkpoint", default=None)
    p.add_argument("--clip_checkpoint", default=None)
    p.add_argument("--clip_model", default="ViT-B/32")
    p.add_argument("--bert_checkpoint", default=None)
    p.add_argument("--bpe_vocab", default=None)
    p.add_argument("--iterations", type=int, default=50)
    p.add_argument("--out", default="weights_day")
    p.add_argument("--strict", action="store_true",
                   help="assert semantic checks that only hold for real published weights (CLIPScore "
                        "prompt discrimination): use on weights day")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card), cuda:N or cpu")
    return p


def main(argv=None) -> list:
    """Runs the sections the given files allow; returns their names, as
    ``MANIFEST.json`` lists them."""
    p = get_parser()
    args = p.parse_args(argv)
    vqgan = bool(args.vqgan_config and args.vqgan_checkpoint)
    if not (vqgan or args.clip_checkpoint or args.bert_checkpoint):
        p.error("no checkpoint paths given: nothing to validate")
    device = entry_device(args.device)
    ran = []
    if vqgan:
        validate_vqgan(args.vqgan_config, args.vqgan_checkpoint, args.out, device)
        ran.append("vqgan")
    if args.clip_checkpoint:
        clip_cfg, _ = validate_clip(args.clip_checkpoint, args.bpe_vocab, args.out, device)
        ran.append("clip")
    if args.bert_checkpoint:
        validate_bert(args.bert_checkpoint, args.out, device)
        ran.append("bert")
    if "vqgan" in ran and "clip" in ran:
        real_generation(args, args.out, clip_cfg)
        ran.append("generation")
        validate_eval(args, args.out, device)
        ran.append("eval")
    manifest = os.path.join(args.out, "MANIFEST.json")
    with open(manifest, "w") as f:
        json.dump({"validated": ran}, f)
    print(f"\nAll sections passed: {ran} (manifest: {manifest})")
    return ran


if __name__ == "__main__":
    main()
