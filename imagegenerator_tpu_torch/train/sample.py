"""Sampling CLI: generate images from v1 weights on a CUDA card.

Counterpart of ``imagegenerator_tpu/train/sample.py``, with the same
flags and output: caption tokens -> BERT -> projection -> CA -> G1
(64 px, stage 1) and on to CA2 -> G2 (256 px, stage 2), one PNG per
sample, ``sample_{i}_{j}.png``, with the caption in a ``comment`` chunk.

    python -m imagegenerator_tpu_torch.train.sample --stage 2 \\
        --checkpoint_dir ./checkpoints --caption "a red bus|a snowy street" \\
        -n 4 -o samples/ --fused_attn --fused_ln

Weights come from ``<checkpoint_dir>/Stage{N}/params.npz``: the flat
``<field>/<flax path>`` dict of ``imagegenerator_tpu_torch.convert``.
Where the JAX CLI differs: ``--device`` (default ``cuda``, which must be
available), and ``--fused_attn``/``--fused_ln`` route BERT's attention
and LayerNorms through the hand-written kernels, as the training CLI's
flags do there. Orbax checkpoints and ``--ema`` wait for the checkpoint
port.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--stage", type=int, choices=[1, 2], default=2,
                   help="1 = 64px generator, 2 = 256px refinement stack")
    p.add_argument("--checkpoint_dir", required=True,
                   help="directory holding Stage{N}/params.npz")
    p.add_argument("--caption", required=True,
                   help="caption(s), '|'-separated")

    def _positive(v):
        n = int(v)
        if n < 1:
            raise argparse.ArgumentTypeError("must be >= 1")
        return n

    p.add_argument("-n", "--num_samples", type=_positive, default=1,
                   help="samples per caption (fresh CA/z noise each)")
    p.add_argument("-o", "--output", default="samples",
                   help="output directory (created if missing)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ema", action="store_true",
                   help="sample EMA averages (not ported yet: exits)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model config (must match the weights)")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda must be available when asked")
    p.add_argument("--tem_size", type=int, default=512)
    p.add_argument("--c_dim", type=int, default=128)
    p.add_argument("--z_dim", type=int, default=100)
    p.add_argument("--nd", type=int, default=128,
                   help="critic text width of the training run; sampling "
                        "has no critic and ignores it")
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--bert_vocab", type=int, default=28996)
    p.add_argument("--bert_checkpoint", default=None,
                   help="torch SpanBERT/BERT state_dict used at training: "
                        "its inferred architecture shapes the encoder; the "
                        "weights themselves come from params.npz")
    p.add_argument("--gelu", choices=["exact", "exact_outbwd", "tanh"],
                   default="exact",
                   help="text-encoder GELU flavor; must match training "
                        "(exact_outbwd equals exact at inference)")
    p.add_argument("--fused_attn", action="store_true",
                   help="text-encoder attention through the hand-written "
                        "CUDA kernel (ops/kernels/attention.py)")
    p.add_argument("--fused_ln", action="store_true",
                   help="text-encoder LayerNorms through the hand-written "
                        "Triton kernel (ops/kernels/layernorm.py)")
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer name/path (must match training); "
                        "default: the deterministic hash tokenizer")
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)

    import torch

    from imagegenerator_tpu_torch import convert
    from imagegenerator_tpu_torch.data.tokenizer import make_tokenizer
    from imagegenerator_tpu_torch.models import bert
    from imagegenerator_tpu_torch.train import stage1 as s1
    from imagegenerator_tpu_torch.train import stage2 as s2
    from imagegenerator_tpu_torch.utils.png import write_png

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available")
    if args.ema:
        raise SystemExit(
            "--ema: EMA checkpoints are not ported yet; sample the live "
            "weights without --ema"
        )
    captions = [c.strip() for c in args.caption.split("|") if c.strip()]
    if not captions:
        raise SystemExit("--caption is empty")

    bert_cfg = bert.BertConfig(vocab_size=args.bert_vocab)
    if args.bert_checkpoint:
        sd = torch.load(args.bert_checkpoint, map_location="cpu", weights_only=True)
        bert_cfg = bert.config_from_state_dict(bert.strip_prefix(sd))
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    common = dict(
        tem_size=args.tem_size,
        c_dim=args.c_dim,
        z_dim=args.z_dim,
        seq_len=args.seq_len,
        compute_dtype=dtype,
        bert=bert_cfg,
    )
    tiny_kw = dict(bert=bert_cfg, seq_len=args.seq_len) if args.bert_checkpoint else {}
    config_cls = s1.Stage1Config if args.stage == 1 else s2.Stage2Config
    cfg = config_cls.tiny(**tiny_kw) if args.tiny else config_cls(**common)
    cfg = dataclasses.replace(cfg, bert=dataclasses.replace(
        cfg.bert,
        gelu_approximate=args.gelu == "tanh",
        gelu_output_bwd=args.gelu == "exact_outbwd",
        fused_ln=args.fused_ln,
        fused_attention=args.fused_attn,
    ))

    path = os.path.join(args.checkpoint_dir, f"Stage{args.stage}", "params.npz")
    if not os.path.exists(path):
        raise SystemExit(f"no checkpoint found at {path}")
    with np.load(path) as f:
        flat = dict(f)
    from_numpy = convert.stage1_from_numpy if args.stage == 1 else convert.stage2_from_numpy
    system = from_numpy(flat, cfg, device)
    if "epoch" in flat:
        print(f"Loaded checkpoint at epoch {int(flat['epoch'])}")
    else:
        print(f"Loaded checkpoint {path}")

    tok = make_tokenizer(args.tokenizer, args.seq_len, cfg)
    # caption i repeated num_samples times, sample index varying fastest
    texts = [c for c in captions for _ in range(args.num_samples)]
    batch = {k: torch.from_numpy(v).to(device) for k, v in tok(texts).items()}
    gen = torch.Generator(device=device).manual_seed(args.seed)
    imgs = system.sample(batch, generator=gen)  # (B, H, W, 3) in [-1, 1]
    arr = ((imgs.float() + 1.0) * 127.5 + 0.5).clamp(0, 255).to(torch.uint8).cpu().numpy()

    os.makedirs(args.output, exist_ok=True)
    for i, caption in enumerate(captions):
        for j in range(args.num_samples):
            out = os.path.join(args.output, f"sample_{i}_{j}.png")
            write_png(out, arr[i * args.num_samples + j], {"comment": caption})
            print(f"wrote {out} ({arr.shape[1]}x{arr.shape[2]}): {caption}")


if __name__ == "__main__":
    main()
