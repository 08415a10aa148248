"""CLIP (ViT image tower + causal text transformer) — counterpart of
``imagegenerator_tpu/v2/clip.py``.

  * visual: stride-``patch`` conv embed (no bias) -> prepend class token
    -> learned positional embedding -> pre-LN transformer with QuickGELU
    MLPs -> ``ln_post`` on the class token -> projection to ``embed_dim``.
  * text: token embedding -> positional embedding -> causally masked
    transformer -> ``ln_final`` -> features at the EOT token (argmax of
    the token ids) -> text projection.

Parameter names are OpenAI's (``visual.conv1.weight``,
``visual.transformer.resblocks.0.attn.in_proj_weight``,
``transformer.resblocks.0.mlp.c_fc.weight``, ``text_projection``), so a
published ``state_dict`` loads directly (its ``logit_scale`` and the
scalar shape entries dropped). Images are NHWC, CLIP-normalised.

Dtype rules are the JAX module's: parameters are f32; Dense and
LayerNorm compute in ``dtype`` (LayerNorm's statistics in f32, its result
in ``dtype``); attention logits and softmax are f32 and the
probabilities are cast to v's dtype; the causal mask fills with the
lowest finite f32, not -inf. The attention is plain PyTorch, as it is
plain XLA in the JAX package. The ModifiedResNet image towers (RN50 ...)
are not ported: building a ``CLIP`` from such a config raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imagegenerator_tpu_torch.ops.layers import Dense


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    # vision: ``vision_layers`` int = ViT depth; tuple = ModifiedResNet
    # stage depths (OpenAI's build_model convention)
    image_resolution: int = 224
    vision_width: int = 768
    vision_layers: Any = 12
    vision_heads: int = 12
    patch_size: int = 32
    # text
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8

    @property
    def is_resnet(self) -> bool:
        return isinstance(self.vision_layers, (tuple, list))

    @classmethod
    def vit_b32(cls) -> "CLIPConfig":
        return cls()

    @classmethod
    def vit_b16(cls) -> "CLIPConfig":
        return cls(patch_size=16)

    @classmethod
    def rn50(cls) -> "CLIPConfig":
        return cls(embed_dim=1024, vision_width=64, vision_layers=(3, 4, 6, 3), vision_heads=32)

    @classmethod
    def rn101(cls) -> "CLIPConfig":
        return cls(embed_dim=512, vision_width=64, vision_layers=(3, 4, 23, 3), vision_heads=32)

    @classmethod
    def rn50x4(cls) -> "CLIPConfig":
        return cls(embed_dim=640, image_resolution=288, vision_width=80,
                   vision_layers=(4, 6, 10, 6), vision_heads=40, text_width=640, text_heads=10)

    @classmethod
    def rn50x16(cls) -> "CLIPConfig":
        return cls(embed_dim=768, image_resolution=384, vision_width=96,
                   vision_layers=(6, 8, 18, 8), vision_heads=48, text_width=768, text_heads=12)

    @classmethod
    def rn50x64(cls) -> "CLIPConfig":
        return cls(embed_dim=1024, image_resolution=448, vision_width=128,
                   vision_layers=(3, 15, 36, 10), vision_heads=64, text_width=1024, text_heads=16)

    @classmethod
    def vit_l14(cls) -> "CLIPConfig":
        return cls(embed_dim=768, vision_width=1024, vision_layers=24, vision_heads=16,
                   patch_size=14, text_width=768, text_layers=12, text_heads=12)

    @classmethod
    def vit_l14_336(cls) -> "CLIPConfig":
        return dataclasses.replace(cls.vit_l14(), image_resolution=336)

    @classmethod
    def tiny(cls) -> "CLIPConfig":
        return cls(embed_dim=16, image_resolution=32, vision_width=16, vision_layers=2,
                   vision_heads=2, patch_size=8, vocab_size=256, context_length=16,
                   text_width=16, text_layers=2, text_heads=2)


def clip_config_from_state_dict(sd: dict) -> CLIPConfig:
    """Infer the architecture from an OpenAI CLIP ``state_dict``, as
    ``clip.build_model`` does (ViT towers; a ModifiedResNet tower's
    config is inferred too, so that loading it can say what it is)."""

    def depth(prefix, part):
        return max(int(k.split(".")[part]) for k in sd if k.startswith(prefix)) + 1

    text_width = sd["ln_final.weight"].shape[0]
    text = dict(
        vocab_size=sd["token_embedding.weight"].shape[0],
        context_length=sd["positional_embedding"].shape[0],
        text_width=text_width,
        text_layers=depth("transformer.resblocks.", 2),
        text_heads=max(1, text_width // 64),
    )
    if not any(k.startswith("visual.transformer.") for k in sd):
        if "visual.attnpool.c_proj.weight" not in sd:
            raise ValueError(
                "unrecognized CLIP state_dict: neither a ViT (visual.transformer.*) "
                "nor a modified-ResNet (visual.attnpool.*) image tower"
            )
        vision_width = sd["visual.conv1.weight"].shape[0] * 2  # the stem is w / 2
        grid = int(round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5))
        return CLIPConfig(
            embed_dim=sd["visual.attnpool.c_proj.weight"].shape[0],
            image_resolution=grid * 32,
            vision_width=vision_width,
            vision_layers=tuple(depth(f"visual.layer{s}.", 2) for s in (1, 2, 3, 4)),
            vision_heads=max(1, vision_width * 32 // 64),
            **text,
        )
    vision_width = sd["visual.conv1.weight"].shape[0]
    patch_size = sd["visual.conv1.weight"].shape[-1]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=patch_size * grid,
        vision_width=vision_width,
        vision_layers=depth("visual.transformer.resblocks.", 3),
        vision_heads=max(1, vision_width // 64),
        patch_size=patch_size,
        **text,
    )


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class LayerNorm(nn.Module):
    """LayerNorm (eps 1e-6, flax's default, which the JAX towers use)
    with f32 statistics; result in ``dtype``, or in
    ``promote(x, f32)`` when None."""

    def __init__(self, width, dtype=None, *, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(width, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(width, dtype=torch.float32, device=device))

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias, 1e-6)
        return y.to(self.dtype or torch.float32)


class _Attention(nn.Module):
    """OpenAI's ``nn.MultiheadAttention`` parameters (``in_proj_weight``,
    ``in_proj_bias``, ``out_proj``) with the JAX block's arithmetic."""

    def __init__(self, width, heads, causal, dtype=None, *, device=None, generator=None):
        super().__init__()
        self.heads, self.causal, self.dtype = heads, causal, dtype
        kw = dict(device=device, generator=generator)
        packed = Dense(width, 3 * width, dtype=dtype, **kw)
        self.in_proj_weight, self.in_proj_bias = packed.weight, packed.bias
        self.out_proj = Dense(width, width, dtype=dtype, **kw)

    def forward(self, h):
        B, T, C = h.shape
        dtype = self.dtype or h.dtype
        qkv = F.linear(h.to(dtype), self.in_proj_weight.to(dtype), self.in_proj_bias.to(dtype))
        q, k, v = (t.reshape(B, T, self.heads, C // self.heads).transpose(1, 2)
                   for t in qkv.split(C, dim=-1))  # (B, heads, T, hd)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(C // self.heads)
        if self.causal:
            mask = torch.ones((T, T), dtype=torch.bool, device=h.device).tril()
            logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        ctx = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, C)
        return self.out_proj(ctx)


class _MLP(nn.Module):
    def __init__(self, width, dtype=None, **kw):
        super().__init__()
        self.c_fc = Dense(width, 4 * width, dtype=dtype, **kw)
        self.c_proj = Dense(4 * width, width, dtype=dtype, **kw)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN residual attention block with a QuickGELU MLP."""

    def __init__(self, width, heads, causal=False, dtype=None, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.ln_1 = LayerNorm(width, dtype, device=device)
        self.attn = _Attention(width, heads, causal, dtype, **kw)
        self.ln_2 = LayerNorm(width, dtype, device=device)
        self.mlp = _MLP(width, dtype, **kw)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width, layers, heads, causal, dtype, **kw):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal, dtype, **kw) for _ in range(layers)
        )

    def forward(self, x):
        for block in self.resblocks:
            x = block(x)
        return x


class _PatchEmbed(nn.Module):
    """The stride-``patch`` conv of OpenAI's ``visual.conv1`` (weight
    ``(width, 3, p, p)``, no bias) computed as a reshape and one matrix
    product, as the JAX module does."""

    def __init__(self, width, patch, dtype=None, *, device=None, generator=None):
        super().__init__()
        self.patch, self.dtype = patch, dtype
        w = torch.empty((width, 3, patch, patch), dtype=torch.float32, device=device)
        self.weight = nn.Parameter(w.normal_(0.0, (3 * patch * patch) ** -0.5, generator=generator))

    def forward(self, images):
        p = self.patch
        B, H, W, C = images.shape
        dtype = self.dtype or images.dtype
        x = images.to(dtype).reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, (H // p) * (W // p), p * p * C)
        w = self.weight.to(dtype).permute(2, 3, 1, 0).reshape(p * p * C, -1)  # (py, px, c) rows
        return x @ w


def _normal(shape, std, *, device=None, generator=None):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.Parameter(t.normal_(0.0, std, generator=generator))


class VisionTransformer(nn.Module):
    def __init__(self, config: CLIPConfig, dtype=None, *, device=None, generator=None):
        super().__init__()
        c = config
        kw = dict(device=device, generator=generator)
        scale = c.vision_width ** -0.5
        tokens = (c.image_resolution // c.patch_size) ** 2 + 1
        self.conv1 = _PatchEmbed(c.vision_width, c.patch_size, dtype, **kw)
        self.class_embedding = _normal((c.vision_width,), scale, **kw)
        self.positional_embedding = _normal((tokens, c.vision_width), scale, **kw)
        self.ln_pre = LayerNorm(c.vision_width, dtype, device=device)
        self.transformer = _Transformer(c.vision_width, c.vision_layers, c.vision_heads, False, dtype, **kw)
        self.ln_post = LayerNorm(c.vision_width, dtype, device=device)
        self.proj = _normal((c.vision_width, c.embed_dim), scale, **kw)

    def forward(self, images):
        """images ``(B, R, R, 3)``, CLIP-normalised -> ``(B, embed_dim)``."""
        x = self.conv1(images)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.transformer(self.ln_pre(x))
        x = self.ln_post(x[:, 0, :])
        return x @ self.proj.to(x.dtype)


class CLIP(nn.Module):
    """``encode_image`` and ``encode_text``; the text tower's modules sit
    at the top level, as in OpenAI's model."""

    def __init__(self, config: CLIPConfig, dtype=None, *, device=None, generator=None):
        super().__init__()
        if config.is_resnet:
            raise NotImplementedError(
                "the ModifiedResNet CLIP image towers (RN50, RN101, RN50x4, ...) are "
                "not ported; use a ViT model"
            )
        self.config = c = config
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        self.visual = VisionTransformer(c, dtype, **kw)
        self.token_embedding = nn.Embedding(c.vocab_size, c.text_width, device=device)
        with torch.no_grad():
            self.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
        self.positional_embedding = _normal((c.context_length, c.text_width), 0.01, **kw)
        self.transformer = _Transformer(c.text_width, c.text_layers, c.text_heads, True, dtype, **kw)
        self.ln_final = LayerNorm(c.text_width, dtype, device=device)
        self.text_projection = _normal((c.text_width, c.embed_dim), c.text_width ** -0.5, **kw)

    def encode_image(self, images):
        return self.visual(images)

    def encode_text(self, tokens):
        """tokens ``(B, context)`` int -> ``(B, embed_dim)``; features at
        the EOT position (the per-row argmax of the ids)."""
        tokens = tokens.long()
        x = self.token_embedding(tokens)
        x = x + self.positional_embedding[: x.shape[1]].to(x.dtype)
        x = self.ln_final(self.transformer(x))
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return x @ self.text_projection.to(x.dtype)

    def forward(self, images, tokens):
        return self.encode_image(images), self.encode_text(tokens)


# CLIP's image normalisation constants
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def normalize_image(x):
    """[0, 1] NHWC -> CLIP-normalised."""
    mean = torch.as_tensor(IMAGE_MEAN, device=x.device)
    std = torch.as_tensor(IMAGE_STD, device=x.device)
    return (x - mean) / std
