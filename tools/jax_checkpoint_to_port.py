#!/usr/bin/env python3
"""Carry a training run's checkpoint from the JAX package to the PyTorch
port, or back.

The JAX package checkpoints a stage as Orbax directories
(``imagegenerator_tpu/checkpoint/manager.py``); the port as one flat
``<field>/<flax path>`` ``.npz`` dict (``imagegenerator_tpu_torch/
checkpoint/manager.py``). Both keep the same layout under
``<dir>/Stage{N}/``: ``epochs/checkpoint_epoch_<E>``, ``latest`` and the
``LATEST_EPOCH`` marker, written last. This program reads the newest
epoch of one and writes it as the same epoch of the other, the
parameters, BatchNorm statistics, Adam state, step and, for a run with
``--ema``, the generator side's averages (the JAX ``aux["ema"]`` tree,
the port's ``aux/ema/`` keys):

    # a run trained by the JAX package -> the port (train.cli resume,
    # --stage1_checkpoint, train.sample --ema)
    python tools/jax_checkpoint_to_port.py --stage 1 --checkpoint_dir jax_run --out_dir port_run [train flags]
    # a run trained by the port (a --tp run included) -> the JAX package
    python tools/jax_checkpoint_to_port.py --to jax --stage 2 --checkpoint_dir port_run --out_dir jax_run [...]

The state's structure comes from the JAX config that the same flags
build as ``train/cli.py`` builds it (``--tiny``, ``--bert_checkpoint``,
``--tem_size``, ...; the other flags of that CLI are read and have no
effect here). The program raises where the source has no marker, where
the Orbax metadata cannot be read, and where the source's keys or shapes
are not the target state's: it never falls back to another layout.

It imports JAX, Orbax and both packages; the port itself imports none of
the JAX side.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from flax import traverse_util  # noqa: E402

from imagegenerator_tpu.checkpoint.manager import CheckpointManager as JaxCheckpointManager  # noqa: E402
from imagegenerator_tpu.models.bert import BertConfig, load_bert_checkpoint  # noqa: E402
from imagegenerator_tpu.train import stage1 as s1  # noqa: E402
from imagegenerator_tpu.train import stage2 as s2  # noqa: E402
from imagegenerator_tpu.train.cli import get_parser as train_parser  # noqa: E402
from imagegenerator_tpu_torch.checkpoint.manager import CheckpointManager as PortCheckpointManager  # noqa: E402

STAGE1_FIELDS = ("params", "batch_stats")
STAGE2_FIELDS = ("frozen_params", "frozen_gen_stats", "params", "batch_stats")


def fields(stage: int) -> tuple:
    return STAGE1_FIELDS if stage == 1 else STAGE2_FIELDS


def _adam(opt_state):
    return next(s for s in opt_state if hasattr(s, "mu"))


def jax_flat(state, fields=STAGE1_FIELDS, leaf=np.asarray) -> dict:
    """A ``Stage1State`` (or, with its ``fields``, a ``Stage2State``) as
    the port's flat dict: each of ``fields`` by flax path, the Adam
    state of every optimizer (``opt_state/<m>/count``, ``mu/...``,
    ``nu/...``) and ``step``. ``leaf`` maps each array (the identity
    keeps an abstract state's shapes)."""
    flat = {}
    for field in fields:
        for path, a in traverse_util.flatten_dict(getattr(state, field)).items():
            flat[field + "/" + "/".join(path)] = leaf(a)
    for m, st in state.opt_state.items():
        adam = _adam(st)
        flat[f"opt_state/{m}/count"] = leaf(adam.count)
        for name in ("mu", "nu"):
            for path, a in traverse_util.flatten_dict(getattr(adam, name)).items():
                flat[f"opt_state/{m}/{name}/" + "/".join(path)] = leaf(a)
    flat["step"] = leaf(state.step)
    return flat


def jax_state_from_flat(template, flat, fields=STAGE1_FIELDS):
    """The inverse of ``jax_flat`` on the structure of ``template`` (a
    state or an abstract one): every optax part that counts takes the
    Adam count, as the chain advances them together (each its own
    buffer: a donating step takes each leaf's buffer once)."""

    def tree(prefix):
        items = {tuple(k[len(prefix):].split("/")): jnp.array(v)
                 for k, v in flat.items() if k.startswith(prefix)}
        return traverse_util.unflatten_dict(items)

    opt_state = {}
    for m, st in template.opt_state.items():
        count = lambda: jnp.array(flat[f"opt_state/{m}/count"], jnp.int32)  # noqa: E731
        parts = []
        for s in st:
            if hasattr(s, "mu"):
                s = s._replace(count=count(), mu=tree(f"opt_state/{m}/mu/"), nu=tree(f"opt_state/{m}/nu/"))
            elif "count" in s._fields:
                s = s._replace(count=count())
            parts.append(s)
        opt_state[m] = type(st)(parts)
    return template.replace(**{field: tree(field + "/") for field in fields},
                            opt_state=opt_state, step=jnp.array(flat["step"], jnp.int32))


def check_keys(have: dict, want: dict, what: str) -> None:
    """``have`` holds exactly ``want``'s keys, at its shapes (arrays or
    their metadata); raises ``ValueError`` naming the differences."""
    extra, missing = sorted(set(have) - set(want)), sorted(set(want) - set(have))
    shapes = sorted(k for k in set(have) & set(want) if tuple(have[k].shape) != tuple(want[k].shape))
    if extra or missing or shapes:
        raise ValueError(f"{what} is not the target state: {len(extra)} keys it does not have "
                         f"{extra[:5]}, {len(missing)} missing {missing[:5]}, {len(shapes)} of other shape "
                         f"{[(k, tuple(have[k].shape), tuple(want[k].shape)) for k in shapes[:5]]}")


def _path(keys) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k)))) for k in keys)


def _leaves(tree) -> dict:
    return {_path(p): a for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_config(args):
    """The JAX ``Stage{1,2}Config`` that ``train/cli.py`` builds from
    these flags."""
    dtype = jnp.bfloat16 if args.dtype == "bf16" else jnp.float32
    bert = BertConfig(vocab_size=args.bert_vocab)
    if args.bert_checkpoint:
        _, bert = load_bert_checkpoint(args.bert_checkpoint)
    bert = dataclasses.replace(
        bert, gelu_approximate=args.gelu == "tanh" or bert.gelu_approximate,
        gelu_output_bwd=args.gelu == "exact_outbwd" or bert.gelu_output_bwd,
        fused_ln=args.fused_ln or bert.fused_ln, fused_attention=args.fused_attn or bert.fused_attention,
        dropout_bits=bert.dropout_bits if args.dropout_bits is None else args.dropout_bits)
    common = dict(tem_size=args.tem_size, c_dim=args.c_dim, z_dim=args.z_dim, nd=args.nd, n_critic=args.n_critic,
                  lambda_gp=args.lambda_gp, kl_mode=args.kl_mode, seq_len=args.seq_len, compute_dtype=dtype,
                  bert=bert)
    tiny_kw = dict(n_critic=args.n_critic)
    if args.bert_checkpoint:
        tiny_kw.update(bert=bert, seq_len=args.seq_len)
    if args.stage == 1:
        s1_kw = {"text_reuse_mismatched": True} if args.text_reuse_mis else {}
        if args.tiny:
            return s1.Stage1Config.tiny(**tiny_kw, **s1_kw)
        return s1.Stage1Config(lr=args.lr, encoder_lr=args.encoder_lr, **common, **s1_kw)
    return s2.Stage2Config.tiny(**tiny_kw) if args.tiny else s2.Stage2Config(lr=args.lr, **common)


def template(args):
    """The stage's state for these flags, abstract (nothing allocated)."""
    cfg = jax_config(args)
    system = (s1.Stage1System if args.stage == 1 else s2.Stage2System)(cfg)
    return jax.eval_shape(lambda key: system.init(key, args.batch_size), jax.random.key(0))


def saved_tree(manager: JaxCheckpointManager, epoch: int) -> dict:
    """The Orbax metadata tree of ``epoch``'s checkpoint; raises where it
    cannot be read (the JAX manager reads such a checkpoint as one
    without aux instead)."""
    path = manager._epoch_dir(epoch)
    try:
        tree = manager._ckptr.metadata(path).item_metadata.tree
    except (OSError, ValueError, AttributeError) as e:
        raise ValueError(f"{path}: the checkpoint's metadata cannot be read ({e!r})") from e
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: the checkpoint's metadata holds no tree ({type(tree).__name__})")
    return tree


def jax_to_port(args) -> int:
    """The newest epoch of ``<checkpoint_dir>/Stage{N}`` (Orbax) ->
    ``<out_dir>/Stage{N}`` (the port's ``.npz``); returns the epoch."""
    src = JaxCheckpointManager(os.path.join(args.checkpoint_dir, f"Stage{args.stage}"))
    epoch = src.latest_epoch()
    if epoch < 0:
        raise FileNotFoundError(f"{src._marker()}: no LATEST_EPOCH marker, so no complete checkpoint")
    tree = saved_tree(src, epoch)
    composite = set(tree) == {"state", "aux"}
    want = template(args)
    check_keys(_leaves(tree["state"] if composite else tree), _leaves(want), f"{src._epoch_dir(epoch)}")
    state, aux, start = src.restore_latest_with_aux(want)
    if start != epoch + 1 or (aux is None) == composite:
        raise ValueError(f"{src._epoch_dir(epoch)}: restored epoch {start - 1}, aux {aux is not None}; "
                         f"the metadata read epoch {epoch}, aux {composite}")
    flat = jax_flat(state, fields(args.stage))
    dst = PortCheckpointManager(os.path.join(args.out_dir, f"Stage{args.stage}"))
    if aux is None:
        dst.save(epoch, flat)
    else:
        ema = traverse_util.flatten_dict(aux["ema"], sep="/")
        dst.save_with_aux(epoch, flat, {f"ema/{k}": np.asarray(v) for k, v in ema.items()})
    return epoch


def port_to_jax(args) -> int:
    """The newest epoch of ``<checkpoint_dir>/Stage{N}`` (the port's) ->
    ``<out_dir>/Stage{N}`` (Orbax, as the JAX trainer writes it); returns
    the epoch."""
    src = PortCheckpointManager(os.path.join(args.checkpoint_dir, f"Stage{args.stage}"))
    flat, aux, start = src.restore_latest_with_aux()
    if flat is None:
        raise FileNotFoundError(f"{src._marker()}: no LATEST_EPOCH marker, so no complete checkpoint")
    want = template(args)
    check_keys(flat, jax_flat(want, fields(args.stage), leaf=lambda a: a), src._epoch_dir(start - 1))
    state = jax_state_from_flat(want, flat, fields(args.stage))
    dst = JaxCheckpointManager(os.path.join(args.out_dir, f"Stage{args.stage}"))
    if aux is None:
        dst.save(start - 1, jax.device_get(state))
    else:
        extra = sorted(k for k in aux if not k.startswith("ema/"))
        if extra:
            raise ValueError(f"{src._epoch_dir(start - 1)}: aux keys the JAX trainer does not have: {extra[:5]}")
        ema = traverse_util.unflatten_dict({k[len("ema/"):]: jnp.asarray(v) for k, v in aux.items()}, sep="/")
        dst.save_with_aux(start - 1, jax.device_get(state), {"ema": jax.device_get(ema)})
    dst.wait()  # publishes the marker once the save has committed
    return start - 1


def get_parser() -> argparse.ArgumentParser:
    p = train_parser()
    p.description = __doc__.split("\n\n")[0]
    p.add_argument("--to", choices=("port", "jax"), default="port",
                   help="port: a JAX run's Orbax checkpoint -> the port's .npz (default); jax: the reverse")
    p.add_argument("--out_dir", required=True,
                   help="root of the converted run: writes OUT_DIR/Stage{N}/ (--checkpoint_dir is the source)")
    return p


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    epoch = (jax_to_port if args.to == "port" else port_to_jax)(args)
    print(f"Stage{args.stage} epoch {epoch}: {args.checkpoint_dir} -> {args.out_dir} ({args.to})")
    return epoch


if __name__ == "__main__":
    main()
