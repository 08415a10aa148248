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

import torch
import torch.nn.functional as F
from torch import nn

from imagegenerator_tpu_torch.ops.dropout import bits_dropout, dropout
from imagegenerator_tpu_torch.ops.gelu import gelu_exact_output_bwd
from imagegenerator_tpu_torch.ops.kernels import attention as attn_kernel
from imagegenerator_tpu_torch.ops.kernels import layernorm as ln_kernel
from imagegenerator_tpu_torch.ops.layers import Dense


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


def _dropout(cfg: BertConfig, x, deterministic: bool, generator):
    """A hidden, embedding or (unfused) attention-prob dropout site:
    ``nn.Dropout`` at the 32-bit default, ``bits_dropout`` at
    ``dropout_bits`` 16 or 8."""
    if deterministic:
        return x
    if cfg.dropout_bits != 32:
        return bits_dropout(x, cfg.dropout_rate, cfg.dropout_bits, generator)
    return dropout(x, cfg.dropout_rate, generator)


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
        self.self = _SelfAttentionProj(cfg.hidden_size, dtype, kw)
        self.output = _DenseLN(cfg.hidden_size, cfg.hidden_size, cfg, dtype, kw)

    def context(self, x, mask, deterministic=True, generator=None, host_generator=None):
        """Attention context before the output Dense, as the JAX
        ``_SelfAttention`` computes it on either path. With dropout on,
        the fused kernel's int32 seed is drawn from ``host_generator`` (a
        CPU generator, so the draw needs no device-to-host sync, or an
        iterator of seeds), the unfused path's mask from ``generator``."""
        cfg = self.cfg
        B, T, h = x.shape
        nh = cfg.num_heads
        q, k, v = self.self.query(x), self.self.key(x), self.self.value(x)
        # On the card the kernel takes the call or raises; only a CPU
        # tensor falls back to einsum off the JAX package's shapes.
        if cfg.fused_attention and (q.is_cuda or attn_kernel.supported(T, h, nh)):
            rate, seed = (0.0 if deterministic else cfg.dropout_rate), 0
            if rate > 0.0:
                if host_generator is None:
                    raise ValueError(
                        "BERT: fused attention with dropout draws its seed "
                        "from host_generator, which is None"
                    )
                if isinstance(host_generator, torch.Generator):
                    seed = int(torch.randint(-2**31, 2**31, (), generator=host_generator))
                else:
                    seed = next(host_generator)
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
        probs = _dropout(cfg, probs, deterministic, generator)
        dt = torch.promote_types(probs.dtype, v.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(dt), split(v).to(dt))
        return ctx.reshape(B, T, h)


class _Layer(nn.Module):
    def __init__(self, cfg, dtype, kw):
        super().__init__()
        self.cfg = cfg
        self.attention = _Attention(cfg, dtype, kw)
        self.intermediate = nn.Module()
        self.intermediate.dense = Dense(cfg.hidden_size, cfg.intermediate_size, dtype=dtype, **kw)
        self.output = _DenseLN(cfg.intermediate_size, cfg.hidden_size, cfg, dtype, kw)

    def forward(self, x, mask, deterministic=True, generator=None, host_generator=None):
        cfg, out = self.cfg, self.attention.output
        ctx = self.attention.context(x, mask, deterministic, generator, host_generator)
        attn = _dropout(cfg, out.dense(ctx), deterministic, generator)
        x = out.LayerNorm(x + attn)
        y = self.intermediate.dense(x)
        if cfg.gelu_output_bwd and not cfg.gelu_approximate:
            y = gelu_exact_output_bwd(y)
        else:
            y = F.gelu(y, approximate="tanh" if cfg.gelu_approximate else "none")
        y = _dropout(cfg, self.output.dense(y), deterministic, generator)
        return self.output.LayerNorm(x + y)


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
                deterministic=True, generator=None, host_generator=None):
        """``deterministic=False`` turns dropout on: masks drawn from
        ``generator`` (on the ids' device), the fused attention's int32
        seeds, one per layer, from ``host_generator``: a CPU
        ``torch.Generator`` or an iterator of seeds."""
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
        x = _dropout(self.config, e.LayerNorm(x), deterministic, generator)
        if self.dtype is not None:
            x = x.to(self.dtype)
        for layer in self.encoder.layer:
            x = layer(x, attention_mask, deterministic, generator, host_generator)
        return x


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

