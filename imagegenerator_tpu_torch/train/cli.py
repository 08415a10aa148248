"""v1 training CLI: train stage 1 (64 px) or stage 2 (256 px) on a CUDA
card — counterpart of ``imagegenerator_tpu/train/cli.py``, with its flags
and defaults (TEM_SIZE=512, lr=1e-3, c_dim=128, z_dim=100, Nd=128, 500
epochs, batch 32).

    python -m imagegenerator_tpu_torch.train.cli --stage 1 \\
        --data /data/coco --root train2017 --ann_file annotations/captions_train2017.json \\
        --checkpoint_dir ./checkpoints --fused_attn --fused_ln --ema 0.999
    python -m imagegenerator_tpu_torch.train.cli --stage 2 \\
        --stage1_checkpoint ./checkpoints/Stage1 ... --checkpoint_dir ./checkpoints

Checkpoints go to ``<checkpoint_dir>/Stage{N}/`` (``checkpoint/manager.py``);
running the same command again resumes from the latest one and prints
``Loaded checkpoint at epoch N``.

Data parallelism, one process per card, through ``torchrun``::

    torchrun --standalone --nproc_per_node 4 -m imagegenerator_tpu_torch.train.cli \
        --multihost --stage 1 ...

``--multihost`` joins the process group torchrun describes
(``parallel/dp.py``); each rank trains on ``cuda:LOCAL_RANK`` over NCCL,
reads its own ``1 / world`` slice of the manifest and takes
``--batch_size`` samples a step (the batch is per rank, as in the JAX CLI,
where it is per data-parallel shard); gradients and metrics are averaged
over the ranks. ``--device cuda:0`` puts every rank on one card (over
gloo), ``--device cpu`` on the CPU (gloo). Rank 0 writes checkpoints and
metrics; every rank resumes.

``--profile_dir DIR`` writes a ``torch.profiler`` trace of the training
loop, one file per rank (``utils/profiling.py``). Its spans name the
loop's phases: ``data`` (the wait for the loader's next batch) and
``train_step``, inside which ``text`` (the encoder's forward),
``critic`` (each of the ``n_critic`` iterations), ``generator``,
``text_backward`` (stage 1: the encoder's backward) and ``optimizer``
(each update). Each kernel on the card belongs to the span in which it
was launched, found by its launch's ``correlation``: so the trace reads
how a step's card time divides between the phases, and whether the card
waits for data.

Tensor parallelism (stage 1), over the ranks torchrun starts::

    torchrun --standalone --nproc_per_node 4 -m imagegenerator_tpu_torch.train.cli \
        --multihost --tp 2 --stage 1 --fused_attn --fused_ln ...

``--tp N`` lays the ranks out as a (world / N, N) data x model grid
(``parallel/mesh.py``): the in-step BERT is split Megatron-style over
each model group and the step is the one-process step on the global
batch (``Stage1System.shard``); each data index reads its own slice of
the manifest and ``--batch_size`` is per data index, as in the JAX CLI,
where it is per data-parallel shard. N must divide the world size. With
``--device cuda:0`` the ranks share one card over gloo.

Where the JAX CLI differs: ``--device`` (default ``cuda``, which must be
available); no ``--rng_impl`` (an XLA knob).
"""

from __future__ import annotations

import argparse
import dataclasses


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="StackGAN-style two-stage trainer (PyTorch, CUDA)")
    p.add_argument("--stage", type=int, choices=(1, 2), default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda must be available when asked")
    # data
    p.add_argument("--data", type=str, default="gs://data-and-checkpoints-bucket",
                   help="dataset store url (gs://bucket, local path, mem://)")
    p.add_argument("--root", type=str, default="dataset/train2017")
    p.add_argument("--ann_file", type=str,
                   default="dataset/annotations/captions_train2017.json")
    # hyperparameters
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_epochs", type=int, default=500)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--encoder_lr", type=float, default=5e-5)
    p.add_argument("--tem_size", type=int, default=512)
    p.add_argument("--c_dim", type=int, default=128)
    p.add_argument("--z_dim", type=int, default=100)
    p.add_argument("--nd", type=int, default=128)
    p.add_argument("--n_critic", type=int, default=5)
    p.add_argument("--lambda_gp", type=float, default=10.0)
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--kl_mode", choices=("correct", "faithful"), default="correct")
    p.add_argument("--dtype", choices=("f32", "bf16"), default="bf16")
    # infra
    p.add_argument("--checkpoint_dir", type=str, default="./checkpoints")
    p.add_argument("--stage1_checkpoint", type=str, default=None,
                   help="stage-2: directory of the stage-1 checkpoint to freeze "
                        "(the stage-1 run's <checkpoint_dir>/Stage1)")
    p.add_argument("--logdir", type=str, default=None)
    p.add_argument("--tiny", action="store_true",
                   help="tiny model config (CPU smoke runs)")
    p.add_argument("--bert_vocab", type=int, default=28996)
    p.add_argument("--gelu", choices=["exact", "exact_outbwd", "tanh"], default="exact",
                   help="text-encoder GELU flavor: 'exact' (erf, what HF SpanBERT "
                        "computes; default), 'exact_outbwd' (the same forward; the "
                        "backward recovers the CDF from the saved gelu output, "
                        "ops/gelu.py), or 'tanh' (the approximation)")
    p.add_argument("--text_reuse_mis", action="store_true",
                   help="stage 1: reuse the matched-caption embeddings for the "
                        "mismatched pairs (tem_mis = tem[perm]), which halves the "
                        "text-encoder work. Exact when text dropout is off (then it "
                        "is automatic); under dropout the mismatched pair shares "
                        "its matched twin's dropout sample")
    p.add_argument("--dropout_bits", type=int, choices=[8, 16, 32], default=None,
                   help="mask-draw width of the text encoder's dropout sites "
                        "outside the fused attention kernel: 32 = torch's own "
                        "dropout (default); 16 or 8 draw that many random bits per "
                        "element and keep an element where they fall below the "
                        "keep probability rounded to 2^-bits (ops/dropout.py). "
                        "Unbiased: kept values are rescaled by that rounded "
                        "probability")
    p.add_argument("--fused_attn", action="store_true",
                   help="text-encoder attention (QK^T + softmax + dropout + PV) "
                        "through the hand-written CUDA kernels, forward and "
                        "backward (ops/kernels/attention.py); the dropout mask "
                        "comes from a counter hash of a per-layer seed")
    p.add_argument("--fused_ln", action="store_true",
                   help="text-encoder LayerNorms through the hand-written kernels "
                        "(ops/kernels/layernorm.py)")
    p.add_argument("--bert_checkpoint", type=str, default=None,
                   help="local HF torch state_dict (pytorch_model.bin / .pt) of "
                        "the pretrained text encoder; the architecture is "
                        "inferred from the weights")
    p.add_argument("--tokenizer", type=str, default=None,
                   help="local HF tokenizer dir/name; default: the "
                        "dependency-free HashTokenizer")
    p.add_argument("--multihost", action="store_true",
                   help="data parallelism over torch.distributed, one process per "
                        "card, as torchrun starts them (its RANK, WORLD_SIZE, "
                        "LOCAL_RANK, ... environment); --batch_size is per rank")

    def _decay(v):
        d = float(v)
        if not 0.0 <= d < 1.0:
            raise argparse.ArgumentTypeError(f"EMA decay must be in [0, 1), got {d}")
        return d

    p.add_argument("--ema", type=_decay, default=None, metavar="DECAY",
                   help="keep an exponential moving average of the generator-side "
                        "parameters at this decay (e.g. 0.999); stored in "
                        "checkpoints as a side dict and sampled with "
                        "train.sample --ema (train/ema.py)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the training loop here, "
                        "one file per rank")
    p.add_argument("--image_dtype", choices=["uint8", "float32"], default="uint8",
                   help="loader -> device image dtype. uint8 (default): the loader "
                        "ships resampled bytes and the train step normalises to "
                        "[-1, 1] on the device, a quarter of the host-to-device "
                        "bytes at <= 0.5/255 quantization after the resample. "
                        "float32: normalised on the host, 4x the bytes")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree (stage 1): splits the in-step BERT "
                        "Megatron-style over a (data, model) grid of the ranks "
                        "(parallel/mesh.py); the rank count must be divisible by "
                        "this. 1 = pure data parallelism")
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.tp > 1 and args.stage != 1:
        raise SystemExit("--tp applies to stage 1 (the in-step BERT)")
    try:
        _run(args)
    finally:
        if args.multihost:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


def _run(args):
    import contextlib

    import torch

    from imagegenerator_tpu_torch import convert
    from imagegenerator_tpu_torch.checkpoint import CheckpointManager
    from imagegenerator_tpu_torch.data.coco import CocoCaptions
    from imagegenerator_tpu_torch.data.pipeline import DataLoader
    from imagegenerator_tpu_torch.data.storage import open_store
    from imagegenerator_tpu_torch.data.tokenizer import make_tokenizer
    from imagegenerator_tpu_torch.models import bert
    from imagegenerator_tpu_torch.parallel import dp, mesh
    from imagegenerator_tpu_torch.train import stage1 as s1
    from imagegenerator_tpu_torch.train import stage2 as s2
    from imagegenerator_tpu_torch.train.trainer import Stage1Trainer, Stage2Trainer, TrainerOptions
    from imagegenerator_tpu_torch.utils.device import entry_device
    from imagegenerator_tpu_torch.utils.profiling import trace

    try:
        # with --multihost the default "cuda" is this rank's cuda:LOCAL_RANK
        device = dp.init_from_env(args.device) if args.multihost else entry_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}") from e
    grid = None
    if args.tp > 1:
        try:
            grid = mesh.make_grid(args.tp)
        except ValueError as e:
            raise SystemExit(str(e)) from e
        print(f"[tp] rank {dp.rank()} of {dp.world()}: data index {grid.data_index} of {grid.data}, "
              f"model index {grid.model_index} of {grid.model}", flush=True)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32

    # Pretrained text encoder: its inferred architecture flows into the
    # train config; the weights are loaded after the system is built.
    bert_state = None
    bert_cfg = bert.BertConfig(vocab_size=args.bert_vocab)
    if args.bert_checkpoint:
        bert_state, bert_cfg = bert.load_bert_checkpoint(args.bert_checkpoint)
        print(f"Loaded pretrained BERT: {bert_cfg.num_layers}L/"
              f"{bert_cfg.hidden_size}H vocab={bert_cfg.vocab_size}")
    flags = dict(
        gelu_approximate=args.gelu == "tanh",
        gelu_output_bwd=args.gelu == "exact_outbwd",
        fused_ln=args.fused_ln,
        fused_attention=args.fused_attn,
        dropout_bits=args.dropout_bits or bert_cfg.dropout_bits,
    )
    bert_cfg = dataclasses.replace(bert_cfg, **flags)

    common = dict(
        tem_size=args.tem_size,
        c_dim=args.c_dim,
        z_dim=args.z_dim,
        nd=args.nd,
        n_critic=args.n_critic,
        lambda_gp=args.lambda_gp,
        kl_mode=args.kl_mode,
        seq_len=args.seq_len,
        compute_dtype=dtype,
        bert=bert_cfg,
    )
    # the tiny configs keep their own widths, f32 and the tiny BERT (with the
    # flags above); with a pretrained checkpoint: tiny GAN, real encoder
    tiny_bert = bert_cfg if bert_state is not None else dataclasses.replace(
        bert.BertConfig.tiny(), **flags)
    tiny_kw = dict(n_critic=args.n_critic, bert=tiny_bert)
    if bert_state is not None:
        tiny_kw.update(seq_len=args.seq_len)
    s1_kw = {"text_reuse_mismatched": True} if args.text_reuse_mis else {}

    def stage1_config(**kw):
        if args.tiny:
            return s1.Stage1Config.tiny(**tiny_kw, **kw)
        return s1.Stage1Config(lr=args.lr, encoder_lr=args.encoder_lr, **common, **kw)

    if args.stage == 1:
        cfg = stage1_config(**s1_kw)
    else:
        cfg = s2.Stage2Config.tiny(**tiny_kw) if args.tiny else s2.Stage2Config(lr=args.lr, **common)

    # the dataset's image size follows the config's resolution; each rank
    # (on a grid: each data index) reads its own slice of the manifest
    shard, shards = (dp.rank(), dp.world()) if grid is None else (grid.data_index, grid.data)
    dataset = CocoCaptions(open_store(args.data), args.root, args.ann_file,
                           image_size=cfg.resolution, host_index=shard,
                           host_count=shards, image_dtype=args.image_dtype)
    tokenizer = make_tokenizer(args.tokenizer, args.seq_len, cfg)
    loader = DataLoader(dataset, tokenizer, batch_size=args.batch_size, seed=args.seed,
                        device=device)
    options = TrainerOptions(
        num_epochs=args.num_epochs,
        seed=args.seed,
        checkpoint_dir=f"{args.checkpoint_dir}/Stage{args.stage}",
        logdir=args.logdir,
        ema_decay=args.ema,
    )
    init = torch.Generator(device=device).manual_seed(args.seed)
    prof = trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()

    if args.stage == 1:
        system = s1.Stage1System(cfg, device=device, generator=init)
        if bert_state is not None and CheckpointManager(options.checkpoint_dir).latest_epoch() < 0:
            # fresh runs only: a resumed checkpoint carries the fine-tuned weights
            system.encoder.load_state_dict(bert_state)
        trainer = Stage1Trainer(system, loader, options, grid=grid)
        start_epoch = trainer.init_state()
        with prof:
            trainer.fit(start_epoch)
        return

    system = s2.Stage2System(cfg, device=device, generator=init)
    trainer = Stage2Trainer(system, loader, options)
    stage1_system = None
    if args.stage1_checkpoint:
        flat, _ = CheckpointManager(args.stage1_checkpoint).restore_latest()
        if flat is None:
            raise SystemExit(f"--stage1_checkpoint: no checkpoint found under "
                             f"{args.stage1_checkpoint}")
        stage1_system = convert.stage1_from_numpy(flat, stage1_config(), device)
    start_epoch = trainer.init_state(stage1_system)
    if bert_state is not None and start_epoch == 0 and stage1_system is None:
        # no stage-1 checkpoint to inherit from: freeze the pretrained encoder
        system.encoder.load_state_dict(bert_state)
    with prof:
        trainer.fit(start_epoch)


if __name__ == "__main__":
    main()
