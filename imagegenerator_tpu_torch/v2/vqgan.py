"""VQGAN (taming-transformers ``VQModel``) — counterpart of
``imagegenerator_tpu/v2/vqgan.py``.

Encoder/Decoder: conv_in -> per-resolution ResnetBlocks (GroupNorm(32) +
swish + 3x3 convs, 1x1 ``nin_shortcut`` on a channel change) with spatial
self-attention at ``attn_resolutions``; strided-conv downsample with
(0, 1) padding / nearest-2x + conv upsample; mid = Resnet-Attn-Resnet;
GroupNorm + swish + conv_out. ``quant_conv`` / ``post_quant_conv`` 1x1
projections around the codebook.

Parameter names are taming's (``encoder.down.0.block.0.norm1.weight``,
``decoder.up.4.upsample.conv.weight``, ``quantize.embedding.weight``),
so a published ``state_dict`` loads directly once its ``loss.*`` keys are
dropped. Images and latents are NHWC at ``VQModel``'s methods, as in the
JAX package; inside, tensors are NCHW.

Dtype rules are the JAX module's: parameters are f32; convs compute in
``dtype`` (or the input's when None); GroupNorm (eps 1e-6,
``min(32, C)`` groups) takes its statistics in f32 and returns f32
whatever its input; attention logits and softmax are f32 and the
probabilities are cast to v's dtype. The attention is plain PyTorch, as
it is plain XLA in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from imagegenerator_tpu_torch.ops.grad_utils import replace_grad
from imagegenerator_tpu_torch.ops.layers import Conv2d
from imagegenerator_tpu_torch.ops.quantize import nearest_codebook_indices, vector_quantize


@dataclasses.dataclass(frozen=True)
class VQGANConfig:
    embed_dim: int = 256
    n_embed: int = 16384
    # ddconfig
    z_channels: int = 256
    resolution: int = 256
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: Sequence[int] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Sequence[int] = (16,)
    dropout: float = 0.0

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)

    @property
    def f(self) -> int:
        """Spatial downsampling factor: ``2 ** (num_resolutions - 1)``."""
        return 2 ** (self.num_resolutions - 1)

    @classmethod
    def tiny(cls) -> "VQGANConfig":
        return cls(
            embed_dim=8, n_embed=32, z_channels=8, resolution=32, ch=8,
            ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
        )

    @classmethod
    def imagenet_f16_16384(cls) -> "VQGANConfig":
        return cls()


def config_from_yaml_dict(params: dict) -> VQGANConfig:
    """Build a config from a taming yaml's ``model.params`` mapping."""
    dd = params["ddconfig"]
    return VQGANConfig(
        embed_dim=params["embed_dim"],
        n_embed=params["n_embed"],
        z_channels=dd["z_channels"],
        resolution=dd["resolution"],
        in_channels=dd.get("in_channels", 3),
        out_ch=dd.get("out_ch", 3),
        ch=dd["ch"],
        ch_mult=tuple(dd["ch_mult"]),
        num_res_blocks=dd["num_res_blocks"],
        attn_resolutions=tuple(dd.get("attn_resolutions", ())),
        dropout=dd.get("dropout", 0.0),
    )


class GroupNorm(nn.Module):
    """``GroupNorm(min(32, C), eps=1e-6)`` over NCHW with f32 statistics
    and an f32 result."""

    def __init__(self, channels, *, device=None):
        super().__init__()
        self.groups = min(32, channels)
        self.weight = nn.Parameter(torch.ones(channels, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32, device=device))

    def forward(self, x):
        return F.group_norm(x.float(), self.groups, self.weight, self.bias, 1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch, out_ch, dtype=None, **kw):
        super().__init__()
        self.norm1 = GroupNorm(in_ch, device=kw.get("device"))
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1, dtype=dtype, **kw)
        self.norm2 = GroupNorm(out_ch, device=kw.get("device"))
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, dtype=dtype, **kw)
        if in_ch != out_ch:
            self.nin_shortcut = Conv2d(in_ch, out_ch, 1, dtype=dtype, **kw)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, ch, dtype=None, **kw):
        super().__init__()
        self.norm = GroupNorm(ch, device=kw.get("device"))
        self.q = Conv2d(ch, ch, 1, dtype=dtype, **kw)
        self.k = Conv2d(ch, ch, 1, dtype=dtype, **kw)
        self.v = Conv2d(ch, ch, 1, dtype=dtype, **kw)
        self.proj_out = Conv2d(ch, ch, 1, dtype=dtype, **kw)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        q, k, v = (conv(h).reshape(B, C, H * W) for conv in (self.q, self.k, self.v))
        logits = torch.bmm(q.float().transpose(1, 2), k.float()) * (C ** -0.5)  # (B, q, k)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        h = torch.bmm(v, attn.transpose(1, 2)).reshape(B, C, H, W)
        return x + self.proj_out(h)


class Downsample(nn.Module):
    def __init__(self, ch, dtype=None, **kw):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=0, dtype=dtype, **kw)

    def forward(self, x):
        # (0, 1) padding on H and W, then a stride-2 conv without padding
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch, dtype=None, **kw):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1, dtype=dtype, **kw)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Mid(nn.Module):
    def __init__(self, ch, dtype, **kw):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch, dtype, **kw)
        self.attn_1 = AttnBlock(ch, dtype, **kw)
        self.block_2 = ResnetBlock(ch, ch, dtype, **kw)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class _Level(nn.Module):
    """One resolution: its ResnetBlocks, each followed by its AttnBlock
    where the resolution has attention, then the resampling."""

    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()

    def forward(self, h):
        for i, block in enumerate(self.block):
            h = block(h)
            if len(self.attn):
                h = self.attn[i](h)
        for name in ("downsample", "upsample"):
            if hasattr(self, name):
                h = getattr(self, name)(h)
        return h


class Encoder(nn.Module):
    def __init__(self, config: VQGANConfig, dtype=None, **kw):
        super().__init__()
        c = config
        self.conv_in = Conv2d(c.in_channels, c.ch, 3, padding=1, dtype=dtype, **kw)
        self.down = nn.ModuleList()
        cur_res, block_in = c.resolution, c.ch
        for level, mult in enumerate(c.ch_mult):
            down = _Level()
            for _ in range(c.num_res_blocks):
                down.block.append(ResnetBlock(block_in, c.ch * mult, dtype, **kw))
                block_in = c.ch * mult
                if cur_res in c.attn_resolutions:
                    down.attn.append(AttnBlock(block_in, dtype, **kw))
            if level != c.num_resolutions - 1:
                down.downsample = Downsample(block_in, dtype, **kw)
                cur_res //= 2
            self.down.append(down)
        self.mid = _Mid(block_in, dtype, **kw)
        self.norm_out = GroupNorm(block_in, device=kw.get("device"))
        self.conv_out = Conv2d(block_in, c.z_channels, 3, padding=1, dtype=dtype, **kw)

    def forward(self, x):
        h = self.conv_in(x)
        for down in self.down:
            h = down(h)
        return self.conv_out(F.silu(self.norm_out(self.mid(h))))


class Decoder(nn.Module):
    def __init__(self, config: VQGANConfig, dtype=None, **kw):
        super().__init__()
        c = config
        block_in = c.ch * c.ch_mult[-1]
        self.conv_in = Conv2d(c.z_channels, block_in, 3, padding=1, dtype=dtype, **kw)
        self.mid = _Mid(block_in, dtype, **kw)
        cur_res = c.resolution // c.f
        ups = []
        for level in reversed(range(c.num_resolutions)):
            up = _Level()
            out_ch = c.ch * c.ch_mult[level]
            for _ in range(c.num_res_blocks + 1):
                up.block.append(ResnetBlock(block_in, out_ch, dtype, **kw))
                block_in = out_ch
                if cur_res in c.attn_resolutions:
                    up.attn.append(AttnBlock(block_in, dtype, **kw))
            if level != 0:
                up.upsample = Upsample(block_in, dtype, **kw)
                cur_res *= 2
            ups.insert(0, up)  # taming's order: up[level]
        self.up = nn.ModuleList(ups)
        self.norm_out = GroupNorm(block_in, device=kw.get("device"))
        self.conv_out = Conv2d(block_in, c.out_ch, 3, padding=1, dtype=dtype, **kw)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for up in reversed(self.up):
            h = up(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class _Codebook(nn.Module):
    """taming's ``VectorQuantizer`` holds its codes as an ``nn.Embedding``
    named ``embedding``; drawn U(+-1 / n_embed) as taming draws them."""

    def __init__(self, n_embed, embed_dim, *, device=None, generator=None):
        super().__init__()
        self.embedding = nn.Embedding(n_embed, embed_dim, device=device)
        with torch.no_grad():
            self.embedding.weight.uniform_(-1.0 / n_embed, 1.0 / n_embed, generator=generator)


class VQModel(nn.Module):
    """``encode``: image -> (quantized z, indices); ``decode``: z ->
    image. Images are NHWC in [-1, 1]; latents are NHWC with C =
    ``embed_dim``. ``use_vq_kernel`` is passed to ``vector_quantize``
    (None: the kernel on the card; False: the plain version)."""

    def __init__(self, config: VQGANConfig, dtype=None, *, device=None, generator=None,
                 use_vq_kernel: bool | None = None):
        super().__init__()
        self.config = c = config
        self.use_vq_kernel = use_vq_kernel
        kw = dict(device=device, generator=generator)
        self.encoder = Encoder(c, dtype, **kw)
        self.decoder = Decoder(c, dtype, **kw)
        # taming's name for the codebook module; ``quantize`` is also a
        # method here, as in the JAX module, so it is registered directly
        self._modules["quantize"] = _Codebook(c.n_embed, c.embed_dim, **kw)
        self.quant_conv = Conv2d(c.z_channels, c.embed_dim, 1, dtype=dtype, **kw)
        self.post_quant_conv = Conv2d(c.embed_dim, c.z_channels, 1, dtype=dtype, **kw)

    @property
    def codebook(self):
        return self._modules["quantize"].embedding.weight

    def quantize(self, z):
        return vector_quantize(z, self.codebook, use_kernel=self.use_vq_kernel)

    def encode(self, x):
        h = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        indices = nearest_codebook_indices(h, self.codebook, use_kernel=self.use_vq_kernel)
        z_q = self.codebook.detach()[indices.long()].to(h.dtype)
        return replace_grad(z_q, h), indices

    def decode(self, z_q):
        return self.decoder(self.post_quant_conv(z_q.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)

    def forward(self, x):
        return self.decode(self.encode(x)[0])
