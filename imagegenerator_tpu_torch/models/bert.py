"""BERT encoder — the text encoder of the v1 pipeline, counterpart of
``imagegenerator_tpu/models/bert.py``.

``BertEncoder`` uses HuggingFace ``BertModel``'s submodule names
(``embeddings.word_embeddings``, ``encoder.layer.N.attention.self.query``,
``attention.output.LayerNorm``, ...), so an HF SpanBERT/BERT
``state_dict`` loads with ``load_state_dict``. ``deterministic=True``
(the default) runs it in inference mode; ``deterministic=False`` is the
training forward of the stage-1 step, with dropout at every site of the
JAX encoder, in its order: the embeddings (after the LayerNorm, before
the dtype cast), the attention probabilities (inside the kernel with
``fused_attention``), after the attention-out Dense and after the output
Dense.

Where a training forward's dropout comes from is a ``Draws``: masks
drawn from a device generator as the forward reaches each site, or
replayed from masks drawn beforehand (``BertEncoder.draw``: a recomputed
forward under remat must see the masks of the first). ``Draws.rows``
addresses the masks by the global batch row, so a forward over a slice
of a batch draws (or keeps) the whole batch's masks and uses its rows.

Tensor parallelism (``shard_model``): the query, key, value and
intermediate Dense layers become column-parallel and the two output
Dense layers row-parallel (``parallel/tp.py``), the attention runs the
rank's ``num_heads / tp`` heads on a packed width ``hidden / tp``, and
the embeddings and every LayerNorm stay whole, so the LayerNorm kernels
run unchanged on every rank. The attention-prob dropout stays addressed
by the global (row, head): the fused kernel's seed takes the shard's row
and head offsets (``seed + row * 1000003 + head * 7919`` is linear in
both), the unfused path keeps its heads of the whole mask.

Dtype flow, as in the JAX encoder: embeddings are summed in f32 and
normalised in f32, the result is cast to the compute dtype before layer
0, every Dense computes in the compute dtype, and a LayerNorm returns
``promote(x, f32 scale)`` = f32, so from layer 1 on the residual stream
is f32. ``fused_attention`` and ``fused_ln`` route attention and every
LayerNorm through the hand-written kernels of ``ops/kernels``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from imagegenerator_tpu_torch.ops.dropout import apply_keep, keep_mask, keep_probability
from imagegenerator_tpu_torch.ops.gelu import gelu_exact_output_bwd
from imagegenerator_tpu_torch.ops.kernels import attention as attn_kernel
from imagegenerator_tpu_torch.ops.kernels import layernorm as ln_kernel
from imagegenerator_tpu_torch.ops.layers import Dense
from imagegenerator_tpu_torch.ops.remat import remat as remat_fn
from imagegenerator_tpu_torch.parallel import tp as tp_ops


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """Same fields and defaults as the JAX package's ``BertConfig``.
    ``dropout_rate`` and ``dropout_bits`` act in the training forward
    (``deterministic=False``); ``gelu_output_bwd`` changes only the
    backward."""

    vocab_size: int = 28996
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout_rate: float = 0.1
    gelu_approximate: bool = False
    gelu_output_bwd: bool = False
    fused_ln: bool = False
    fused_attention: bool = False
    dropout_bits: int = 32

    @classmethod
    def tiny(cls, vocab_size: int = 128) -> "BertConfig":
        return cls(
            vocab_size=vocab_size,
            hidden_size=16,
            num_layers=1,
            num_heads=2,
            intermediate_size=32,
            max_position_embeddings=64,
        )


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics (parameters ``weight``/``bias``, HF's
    names). ``fused`` takes the kernel, whose variance is two-pass as on
    the TPU; otherwise flax ``nn.LayerNorm``'s formula: the fast variance
    ``max(E[x^2] - E[x]^2, 0)``, ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``, output ``promote(x, f32)``."""

    def __init__(self, d, eps, fused=False, *, device=None):
        super().__init__()
        self.eps, self.fused = eps, fused
        self.weight = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x):
        if self.fused:
            return ln_kernel.fused_layernorm(x, self.weight, self.bias, self.eps)
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean) * mul + self.bias
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))


@dataclasses.dataclass
class Draws:
    """Where a training forward's randomness comes from. ``generator``
    draws the keep masks on the ids' device as the forward reaches each
    site; ``masks``, where given, is an iterator of keep masks drawn
    beforehand, in the forward's order, used instead. ``seeds`` gives the
    fused attention's int32 seeds: a CPU ``torch.Generator`` (so the draw
    needs no device sync) or an iterator of ints. ``rows = (offset,
    total)``: the forward runs rows ``[offset, offset + B)`` of a batch of
    ``total``; every mask is (or was) drawn for all ``total`` rows and all
    heads, and the forward keeps its own."""

    generator: Any = None
    seeds: Any = None
    masks: Any = None
    rows: tuple | None = None


def _fold_seed(seed: int, row: int, head: int) -> int:
    """A shard's seed: the kernel's salt ``seed + row * 1000003 + head *
    7919`` is linear in row and head (wrapping int32), so the offsets of a
    shard fold into its seed."""
    return ((seed + row * 1000003 + head * 7919 + 2**31) % 2**32) - 2**31


def _next_seed(seeds) -> int:
    if seeds is None:
        raise ValueError("BERT: fused attention with dropout draws its seed from host_generator, which is None")
    if isinstance(seeds, torch.Generator):
        return int(torch.randint(-2**31, 2**31, (), generator=seeds))
    return next(seeds)


def _bits(cfg: BertConfig):
    return None if cfg.dropout_bits == 32 else cfg.dropout_bits


def _dropout(cfg: BertConfig, x, deterministic: bool, draws: Draws, heads=None):
    """A hidden, embedding or (unfused) attention-prob dropout site:
    ``nn.Dropout`` at the 32-bit default, ``bits_dropout`` at
    ``dropout_bits`` 16 or 8 (``ops/dropout.py``, the same draws). The
    mask covers ``draws.rows``' whole batch and, at a prob site,
    ``heads = (slice, total)``'s every head; x takes its part."""
    if deterministic or cfg.dropout_rate == 0.0:
        return x
    if draws.masks is not None:
        keep = next(draws.masks)
    else:
        shape = list(x.shape)
        if draws.rows is not None:
            shape[0] = draws.rows[1]
        if heads is not None:
            shape[1] = heads[1]
        keep = keep_mask(shape, cfg.dropout_rate, _bits(cfg), draws.generator, x.device)
    if draws.rows is not None:
        keep = keep[draws.rows[0]:draws.rows[0] + x.shape[0]]
    if heads is not None:
        keep = keep[:, heads[0]]
    return apply_keep(x, keep, keep_probability(cfg.dropout_rate, _bits(cfg)))


def _fused(cfg: BertConfig, is_cuda: bool, seq_len: int) -> bool:
    """Whether attention takes the fused kernels: on the card always
    (``fused_attention`` set), on the CPU at the JAX package's shapes."""
    return cfg.fused_attention and (
        is_cuda or attn_kernel.supported(seq_len, cfg.hidden_size, cfg.num_heads))


def _embedding(n, d, device, generator):
    # torch's nn.Embedding law, N(0, 1)
    w = torch.empty((n, d), device=device).normal_(generator=generator)
    return nn.Embedding(n, d, _weight=w, device=device)


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device, generator):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = _embedding(cfg.vocab_size, h, device, generator)
        self.position_embeddings = _embedding(cfg.max_position_embeddings, h, device, generator)
        self.token_type_embeddings = _embedding(cfg.type_vocab_size, h, device, generator)
        self.LayerNorm = LayerNorm(h, cfg.layer_norm_eps, cfg.fused_ln, device=device)


class _SelfAttentionProj(nn.Module):
    def __init__(self, h, dtype, kw):
        super().__init__()
        self.query = Dense(h, h, dtype=dtype, **kw)
        self.key = Dense(h, h, dtype=dtype, **kw)
        self.value = Dense(h, h, dtype=dtype, **kw)


class _DenseLN(nn.Module):
    """HF's ``*.output`` blocks: a Dense and the LayerNorm after it."""

    def __init__(self, d_in, d_out, cfg, dtype, kw):
        super().__init__()
        self.dense = Dense(d_in, d_out, dtype=dtype, **kw)
        self.LayerNorm = LayerNorm(d_out, cfg.layer_norm_eps, cfg.fused_ln, device=kw["device"])


class _Attention(nn.Module):
    def __init__(self, cfg, dtype, kw):
        super().__init__()
        self.cfg = cfg
        self.shard = None  # a ModelShard under tensor parallelism
        self.self = _SelfAttentionProj(cfg.hidden_size, dtype, kw)
        self.output = _DenseLN(cfg.hidden_size, cfg.hidden_size, cfg, dtype, kw)

    def context(self, x, mask, deterministic=True, draws=None):
        """Attention context before the output Dense, as the JAX
        ``_SelfAttention`` computes it on either path, over this rank's
        heads under tensor parallelism. With dropout on, the fused
        kernel's int32 seed comes from ``draws.seeds``, the unfused path's
        mask from ``draws``."""
        cfg, shard = self.cfg, self.shard
        B, T, _ = x.shape
        nh, head0 = cfg.num_heads, 0
        if shard is not None:
            x = tp_ops.copy_to_model(x, shard.group)
            nh, head0 = nh // shard.size, shard.index * (nh // shard.size)
        q, k, v = self.self.query(x), self.self.key(x), self.self.value(x)
        h = q.shape[-1]
        # On the card the kernel takes the call or raises; only a CPU
        # tensor falls back to einsum off the JAX package's shapes.
        if _fused(cfg, q.is_cuda, T):
            rate, seed = (0.0 if deterministic else cfg.dropout_rate), 0
            if rate > 0.0:
                row0 = 0 if draws.rows is None else draws.rows[0]
                seed = _fold_seed(_next_seed(draws.seeds), row0, head0)
            return attn_kernel.fused_attention(
                q, k, v, mask, num_heads=nh, dropout_rate=rate, seed=seed
            )
        hd = h // nh
        split = lambda t: t.reshape(B, T, nh, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", split(q).float(), split(k).float())
        logits = logits / math.sqrt(hd)
        if mask is not None:
            logits = torch.where(
                mask[:, None, None, :] > 0, logits, torch.finfo(logits.dtype).min
            )
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        probs = _dropout(cfg, probs, deterministic, draws, (slice(head0, head0 + nh), cfg.num_heads))
        dt = torch.promote_types(probs.dtype, v.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(dt), split(v).to(dt))
        return ctx.reshape(B, T, h)


class _Layer(nn.Module):
    def __init__(self, cfg, dtype, kw):
        super().__init__()
        self.cfg = cfg
        self.shard = None
        self.attention = _Attention(cfg, dtype, kw)
        self.intermediate = nn.Module()
        self.intermediate.dense = Dense(cfg.hidden_size, cfg.intermediate_size, dtype=dtype, **kw)
        self.output = _DenseLN(cfg.intermediate_size, cfg.hidden_size, cfg, dtype, kw)

    def forward(self, x, mask, deterministic=True, draws=None):
        cfg, out = self.cfg, self.attention.output
        ctx = self.attention.context(x, mask, deterministic, draws)
        attn = _dropout(cfg, out.dense(ctx), deterministic, draws)
        x = out.LayerNorm(x + attn)
        h = x if self.shard is None else tp_ops.copy_to_model(x, self.shard.group)
        y = self.intermediate.dense(h)
        if cfg.gelu_output_bwd and not cfg.gelu_approximate:
            y = gelu_exact_output_bwd(y)
        else:
            y = F.gelu(y, approximate="tanh" if cfg.gelu_approximate else "none")
        y = _dropout(cfg, self.output.dense(y), deterministic, draws)
        return self.output.LayerNorm(x + y)


@dataclasses.dataclass
class Predrawn:
    """Every mask and seed of one training forward, drawn before it
    (``BertEncoder.draw``); ``draws(rows)`` replays them, as often as a
    recomputed forward needs."""

    masks: list
    seeds: list

    def draws(self, rows=None) -> Draws:
        return Draws(masks=iter(self.masks), seeds=iter(self.seeds), rows=rows)


class BertEncoder(nn.Module):
    """Returns the full last hidden state; CLS = ``out[:, 0, :]``."""

    def __init__(self, config: BertConfig, dtype=None, *, device=None, generator=None):
        super().__init__()
        self.config, self.dtype = config, dtype
        kw = dict(device=device, generator=generator)
        self.embeddings = _Embeddings(config, device, generator)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            [_Layer(config, dtype, kw) for _ in range(config.num_layers)]
        )

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic=True, generator=None, host_generator=None, draws=None, remat=False):
        """``deterministic=False`` turns dropout on: masks drawn from
        ``generator`` (on the ids' device), the fused attention's int32
        seeds, one per layer, from ``host_generator``: a CPU
        ``torch.Generator`` or an iterator of seeds. ``draws`` (a
        ``Draws``) replaces both. ``remat`` keeps only each layer's input
        for the backward, which recomputes the layers one at a time
        (``ops/remat.py``); with dropout on, ``draws`` must replay masks
        drawn beforehand (``draw``), and each layer's recomputation
        replays its own."""
        if draws is None:
            draws = Draws(generator, host_generator)
        T = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        e = self.embeddings
        pos = torch.arange(T, device=input_ids.device)[None, :]
        x = (
            e.word_embeddings(input_ids)
            + e.position_embeddings(pos)
            + e.token_type_embeddings(token_type_ids)
        )
        x = _dropout(self.config, e.LayerNorm(x), deterministic, draws)
        if self.dtype is not None:
            x = x.to(self.dtype)
        for layer in self.encoder.layer:
            if remat:
                x = remat_fn(self._replaying(layer, attention_mask, deterministic, draws, T, x.is_cuda), x)
            else:
                x = layer(x, attention_mask, deterministic, draws)
        return x

    def _replaying(self, layer, attention_mask, deterministic, draws, seq_len, is_cuda):
        """``layer``'s forward as a function of its input alone, replaying
        the masks and seeds it takes from ``draws`` (taken now) on every
        call, so that its recomputation sees the draws of the first."""
        cfg, masks, seeds = self.config, [], []
        if not deterministic and cfg.dropout_rate > 0.0:
            if draws.masks is None:
                raise ValueError("BERT: remat with dropout replays masks drawn beforehand (BertEncoder.draw)")
            fused = _fused(cfg, is_cuda, seq_len)
            masks = [next(draws.masks) for _ in range(2 if fused else 3)]
            seeds = [next(draws.seeds)] if fused else []
        rows = draws.rows
        return lambda x: layer(x, attention_mask, deterministic, Draws(masks=iter(masks), seeds=iter(seeds), rows=rows))

    def draw(self, batch: int, seq_len: int, device, generator=None, host_generator=None) -> Predrawn:
        """The masks and seeds a training forward over ``batch`` rows of
        ``seq_len`` tokens on ``device`` would draw from these generators,
        drawn now in its order (the same draws, bit for bit)."""
        cfg, masks, seeds = self.config, [], []
        if cfg.dropout_rate == 0.0:
            return Predrawn(masks, seeds)
        bits = _bits(cfg)
        hidden = lambda: keep_mask((batch, seq_len, cfg.hidden_size), cfg.dropout_rate, bits, generator, device)
        masks.append(hidden())
        fused = _fused(cfg, torch.device(device).type == "cuda", seq_len)
        for _ in self.encoder.layer:
            if fused:
                seeds.append(_next_seed(host_generator))
            else:
                masks.append(keep_mask((batch, cfg.num_heads, seq_len, seq_len), cfg.dropout_rate, bits,
                                       generator, device))
            masks.extend((hidden(), hidden()))
        return Predrawn(masks, seeds)

    def shard_model(self, shard) -> None:
        """Split the encoder over a model group (``parallel/tp.py``
        ``ModelShard``), in place, by ``tp.shard_dim``'s rules: each rank
        keeps its column slices of query, key, value and intermediate, its
        row slices of the two output Dense layers, and every other tensor
        whole."""
        if self.config.num_heads % shard.size:
            raise ValueError(f"{self.config.num_heads} heads do not split over {shard.size} model ranks")
        tp_ops.shard_dense_layers(self, shard)
        for layer in self.encoder.layer:
            layer.shard = layer.attention.shard = shard


def config_from_state_dict(state_dict: dict) -> BertConfig:
    """Infer a ``BertConfig`` from an HF BERT ``state_dict`` by shape; the
    head count is ``hidden // 64``, as in the BERT-base family."""

    def shape(name):
        for key in (name, f"bert.{name}"):
            if key in state_dict:
                return tuple(state_dict[key].shape)
        raise KeyError(name)

    vocab, hidden = shape("embeddings.word_embeddings.weight")
    layers = 0
    while any(
        f"{pfx}encoder.layer.{layers}.intermediate.dense.weight" in state_dict
        for pfx in ("", "bert.")
    ):
        layers += 1
    return BertConfig(
        vocab_size=vocab,
        hidden_size=hidden,
        num_layers=layers,
        num_heads=max(1, hidden // 64),
        intermediate_size=shape("encoder.layer.0.intermediate.dense.weight")[0],
        max_position_embeddings=shape("embeddings.position_embeddings.weight")[0],
        type_vocab_size=shape("embeddings.token_type_embeddings.weight")[0],
    )


def strip_prefix(state_dict: dict) -> dict:
    """Drop HF's ``bert.`` prefix and the keys this encoder has no use for
    (pooler, heads, position-id buffers)."""
    out = {}
    for key, val in state_dict.items():
        key = key.removeprefix("bert.")
        if key.startswith(("embeddings.", "encoder.")) and not key.endswith("position_ids"):
            out[key] = val
    return out


def load_bert_checkpoint(path: str):
    """A local HF torch checkpoint (``pytorch_model.bin`` / ``.pt``
    state_dict) -> ``(state_dict, config)``: the encoder's own keys, which
    ``BertEncoder.load_state_dict`` takes, and the architecture inferred
    from their shapes."""
    state_dict = strip_prefix(torch.load(path, map_location="cpu", weights_only=True))
    return state_dict, config_from_state_dict(state_dict)
