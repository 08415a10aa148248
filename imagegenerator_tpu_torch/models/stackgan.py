"""StackGAN Stage-I / Stage-II generators and discriminators —
counterpart of ``imagegenerator_tpu/models/stackgan.py`` (eval and train
mode).

Both generators take and return images NHWC ``(B, H, W, 3)`` in [-1, 1],
the JAX package's layout. Every net runs NCHW inside with
``channels_last`` strides, so that cuDNN, whose kernels are NHWC,
transposes nothing: a permute of an NHWC image is such a view, G1's seed
is a 1x1 NHWC map, and the concatenations are made along NHWC's last
axis; a conv on a channels-last input returns one (``ops/layers.py``),
and a generator's output permuted back is plain NHWC memory. Submodule
names follow flax's automatic names (``UpBlock_0``, ``ConvTranspose2d_0``,
...), so each parameter's path matches its path in the JAX package's
parameter tree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from imagegenerator_tpu_torch.ops.layers import (
    BatchNorm,
    Conv2d,
    ConvTranspose2d,
    Dense,
    DownBlock,
    UpBlock,
)


def _concat_replicated(x, v):
    """``x`` NCHW ``(B, C, h, w)`` with ``v (B, D)`` replicated over its
    map and appended after its channels, in ``x``'s dtype: ``(B, C + D, h,
    w)``, channels-last. Concatenated on NHWC's last axis, since a
    concatenation along NCHW channels with an expanded operand falls back
    to NCHW memory."""
    B, _, h, w = x.shape
    rep = v.to(x.dtype)[:, None, None, :].expand(B, h, w, v.shape[1])
    return torch.cat([x.permute(0, 2, 3, 1), rep], dim=3).permute(0, 3, 1, 2)


class StageIGenerator(nn.Module):
    """``[c_hat || z]`` -> 1x1 -> ConvT k4 s1 p0 (4x4) -> stride-2 UpBlocks
    -> ConvT to RGB + tanh. Resolution ``2**(len(channels) + 2)``; the
    default (192, 96, 48, 24) is the reference's 64 px generator."""

    def __init__(self, c_dim=128, z_dim=100, channels=(192, 96, 48, 24),
                 dtype=None, *, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        in_ch = c_dim + z_dim
        for i, feat in enumerate(channels):
            geom = dict(kernel_size=4, stride=1, padding=0) if i == 0 else {}
            setattr(self, f"UpBlock_{i}", UpBlock(in_ch, feat, **geom, **kw))
            in_ch = feat
        self.n_up = len(channels)
        self.ConvTranspose2d_0 = ConvTranspose2d(in_ch, 3, 4, 2, 1, **kw)

    def forward(self, x):
        """x: ``(B, c_dim + z_dim)`` -> ``(B, res, res, 3)``."""
        x = x[:, None, None, :].permute(0, 3, 1, 2)  # a 1x1 NHWC map: channels-last
        for i in range(self.n_up):
            x = getattr(self, f"UpBlock_{i}")(x)
        return torch.tanh(self.ConvTranspose2d_0(x)).permute(0, 2, 3, 1)


class _TextImageCriticHead(nn.Module):
    """The critic's stateless head: ``Dense(nd)`` on ``tem``, replicated
    over the feature map and concatenated after the image channels, 1x1
    conv to ``resize_ch``, flattened in NHWC (h, w, c) order as in JAX,
    ``Dense(1)``. No BatchNorm, so one tower pass can be scored against
    several text embeddings."""

    def __init__(self, tem_size, nd, feat_ch, resize_ch=128, spatial=4,
                 dtype=None, *, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.Dense_0 = Dense(tem_size, nd, **kw)
        self.Conv2d_0 = Conv2d(feat_ch + nd, resize_ch, 1, 1, 0, **kw)
        self.Dense_1 = Dense(resize_ch * spatial * spatial, 1, **kw)

    def forward(self, feat, tem):
        """feat NCHW ``(B, C, 4, 4)``, tem ``(B, tem_size)`` -> ``(B, 1)``."""
        x = self.Conv2d_0(_concat_replicated(feat, self.Dense_0(tem)))
        return self.Dense_1(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


class StageIDiscriminator(nn.Module):
    """Conv(k4 s2 p1) + LeakyReLU(0.1) -> DownBlocks -> (B, 512, 4, 4)
    image tower, then the text-image head. ``channels``: the stem conv,
    then one DownBlock each; input resolution ``2**(len(channels) + 2)``.
    Submodule names are flax's (``conv_in``, ``down_blocks_N``,
    ``head``)."""

    HEAD_CHANNELS = 128  # the head's 1x1 conv width

    def __init__(self, tem_size=512, nd=128, channels=(64, 128, 256, 512),
                 dtype=None, *, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.conv_in = Conv2d(3, channels[0], 4, 2, 1, **kw)
        self.n_down = len(channels) - 1
        for i, (cin, cout) in enumerate(zip(channels, channels[1:])):
            setattr(self, f"down_blocks_{i}", DownBlock(cin, cout, **kw))
        self.head = _TextImageCriticHead(tem_size, nd, channels[-1], self.HEAD_CHANNELS, **kw)

    def features(self, img):
        """Image tower: NHWC ``(B, r, r, 3)`` -> NCHW ``(B, C, 4, 4)``."""
        x = F.leaky_relu(self.conv_in(img.permute(0, 3, 1, 2)), 0.1)
        for i in range(self.n_down):
            x = getattr(self, f"down_blocks_{i}")(x)
        return x

    def score(self, feat, tem):
        return self.head(feat, tem)

    def forward(self, img, tem):
        return self.score(self.features(img), tem)


class StageIIDiscriminator(StageIDiscriminator):
    """The Stage-I critic's shape at 256 px: a stem conv and five
    DownBlocks, ``channels`` (16, 32, 64, 128, 256, 512), and a head whose
    1x1 conv is 160 wide. ``features`` / ``score`` split as there."""

    HEAD_CHANNELS = 160

    def __init__(self, tem_size=512, nd=128, channels=(16, 32, 64, 128, 256, 512),
                 dtype=None, *, device=None, generator=None):
        super().__init__(tem_size, nd, channels, dtype, device=device, generator=generator)


class ResidualBlock(nn.Module):
    """conv3x3+BN -> ReLU -> conv3x3+BN -> ReLU -> conv3x3+BN -> +id -> ReLU."""

    def __init__(self, in_ch, intermediate, dtype=None, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(use_bias=False, dtype=dtype, device=device, generator=generator)
        chans = [(in_ch, intermediate), (intermediate, intermediate), (intermediate, in_ch)]
        for i, (cin, cout) in enumerate(chans):
            setattr(self, f"Conv2d_{i}", Conv2d(cin, cout, 3, 1, 1, **kw))
            setattr(self, f"BatchNorm_{i}", BatchNorm(cout, dtype=dtype, device=device))

    def forward(self, x):
        identity = x
        x = F.relu(self.BatchNorm_0(self.Conv2d_0(x)))
        x = F.relu(self.BatchNorm_1(self.Conv2d_1(x)))
        x = self.BatchNorm_2(self.Conv2d_2(x))
        return F.relu(x + identity)


class StageIIGenerator(nn.Module):
    """64 px image -> Conv+LReLU -> DownBlock (16x16x512) -> concat c_hat
    replicated (640 ch) -> ResidualBlocks -> UpBlocks -> ConvT + tanh.
    Output resolution ``in / 4 * 2**(len(up_channels) + 1)``; the
    defaults are the reference's 64 -> 256 px refinement."""

    def __init__(self, c_dim=128, num_residual=4, in_channels=128,
                 feat_channels=512, res_channels=320, up_channels=(320, 160, 80),
                 dtype=None, *, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.Conv2d_0 = Conv2d(3, in_channels, 4, 2, 1, **kw)
        self.DownBlock_0 = DownBlock(in_channels, feat_channels, **kw)
        ch = feat_channels + c_dim
        self.n_res, self.n_up = num_residual, len(up_channels)
        for i in range(num_residual):
            setattr(self, f"ResidualBlock_{i}", ResidualBlock(ch, res_channels, **kw))
        for i, feat in enumerate(up_channels):
            setattr(self, f"UpBlock_{i}", UpBlock(ch, feat, **kw))
            ch = feat
        self.ConvTranspose2d_0 = ConvTranspose2d(ch, 3, 4, 2, 1, **kw)

    def forward(self, img_64, c_hat):
        """img_64 ``(B, r, r, 3)``, c_hat ``(B, c_dim)`` ->
        ``(B, R, R, 3)``."""
        x = F.leaky_relu(self.Conv2d_0(img_64.permute(0, 3, 1, 2)), 0.1)
        x = _concat_replicated(self.DownBlock_0(x), c_hat)
        for i in range(self.n_res):
            x = getattr(self, f"ResidualBlock_{i}")(x)
        for i in range(self.n_up):
            x = getattr(self, f"UpBlock_{i}")(x)
        return torch.tanh(self.ConvTranspose2d_0(x)).permute(0, 2, 3, 1)
