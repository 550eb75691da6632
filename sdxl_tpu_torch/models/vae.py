"""SDXL VAE (counterpart of sdxl_tpu/models/vae.py).

Encoder: conv_in 3 -> 128, four blocks of two ResnetBlocks with a
stride-2 3x3 downsampler on all but the last (PyTorch's asymmetric
(0, 1, 0, 1) padding: one zero row below, one column right), mid,
GN/SiLU/conv_out to 8 quant channels; ``quant_conv`` (1x1) follows and
``encode_image`` keeps the first 4 channels, the posterior mean (no
sampling).

Decoder: conv_in 4 -> 512, mid (ResnetBlock, single-head spatial
self-attention with 1x1-conv q/k/v, ResnetBlock), four blocks of three
ResnetBlocks with a nearest-2x + 3x3 conv upsampler on all but the last,
GN/SiLU/conv_out to RGB. ``post_quant_conv`` (1x1) runs first.

The quant convs are optional, as in the reference: FLUX.1's VAE ships
without them (``quant_conv=False`` builds a half without its 1x1 conv).
SD3's and FLUX.1's VAEs have 16 latent channels and 32 quant channels.

Layout: ``encode_image`` and ``decode_latent`` take and return NHWC like
the reference; inside, activations are contiguous NCHW and the mid
attention sees [B, HW, C] tokens. The pipelines run both halves in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import AutoencoderConfig
from ..ops.attention import qkv_attention
from ..ops.conv import conv2d_pad_br, upsample_nearest_2x
from .layers import Conv2d, GroupNorm


class ResnetBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, n_group: int, **kw):
        super().__init__()
        self.norm1 = GroupNorm(c_in, n_group, **kw)
        self.conv1 = Conv2d(c_in, c_out, 3, **kw)
        self.norm2 = GroupNorm(c_out, n_group, **kw)
        self.conv2 = Conv2d(c_out, c_out, 3, **kw)
        self.nin_shortcut = (Conv2d(c_in, c_out, 1, **kw)
                             if c_in != c_out else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention over the HW tokens."""

    def __init__(self, c: int, n_group: int, **kw):
        super().__init__()
        self.norm = GroupNorm(c, n_group, **kw)
        self.q, self.k, self.v, self.proj_out = (Conv2d(c, c, 1, **kw)
                                                 for _ in range(4))

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x)

        def tokens(conv):
            return conv(y).flatten(2).transpose(1, 2)  # [B, HW, C]

        o = qkv_attention(tokens(self.q), tokens(self.k), tokens(self.v),
                          None, 1)
        return x + self.proj_out(o.transpose(1, 2).reshape(b, c, h, w))


class Mid(nn.Module):
    def __init__(self, c: int, n_group: int, **kw):
        super().__init__()
        self.block_1 = ResnetBlock(c, c, n_group, **kw)
        self.attn = AttnBlock(c, n_group, **kw)
        self.block_2 = ResnetBlock(c, c, n_group, **kw)

    def forward(self, x):
        return self.block_2(self.attn(self.block_1(x)))


class Downsample(Conv2d):
    """Stride-2 3x3 conv after one zero row below and one column right."""

    def __init__(self, c: int, **kw):
        super().__init__(c, c, 3, stride=2, **kw)

    def forward(self, x):
        return conv2d_pad_br(x, self.weight, self.bias, 2)


class EncoderBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, n_group: int, downsample: bool,
                 **kw):
        super().__init__()
        self.res1 = ResnetBlock(c_in, c_out, n_group, **kw)
        self.res2 = ResnetBlock(c_out, c_out, n_group, **kw)
        self.downsampler = Downsample(c_out, **kw) if downsample else None

    def forward(self, x):
        x = self.res2(self.res1(x))
        if self.downsampler is not None:
            x = self.downsampler(x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: AutoencoderConfig, **kw):
        super().__init__()
        g = cfg.n_group
        chans = cfg.encoder_channels
        first, last = chans[0][1], chans[-1][1]
        self.conv_in = Conv2d(3, first, 3, **kw)
        self.blocks = nn.ModuleList(
            EncoderBlock(ci, co, g, i != len(chans) - 1, **kw)
            for i, (ci, co) in enumerate(chans))
        self.mid = Mid(last, g, **kw)
        self.norm_out = GroupNorm(last, g, **kw)
        self.conv_out = Conv2d(last, cfg.n_channels_out, 3, **kw)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.blocks:
            x = block(x)
        x = self.mid(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class DecoderBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, n_group: int, upsample: bool,
                 **kw):
        super().__init__()
        self.res1 = ResnetBlock(c_in, c_out, n_group, **kw)
        self.res2 = ResnetBlock(c_out, c_out, n_group, **kw)
        self.res3 = ResnetBlock(c_out, c_out, n_group, **kw)
        self.upsampler = Conv2d(c_out, c_out, 3, **kw) if upsample else None

    def forward(self, x):
        x = self.res3(self.res2(self.res1(x)))
        if self.upsampler is not None:
            x = self.upsampler(upsample_nearest_2x(x))
        return x


class Decoder(nn.Module):
    def __init__(self, cfg: AutoencoderConfig, **kw):
        super().__init__()
        g = cfg.n_group
        chans = cfg.decoder_channels
        first, last = chans[0][0], chans[-1][1]
        self.conv_in = Conv2d(cfg.latent_channels, first, 3, **kw)
        self.mid = Mid(first, g, **kw)
        self.blocks = nn.ModuleList(
            DecoderBlock(ci, co, g, i != len(chans) - 1, **kw)
            for i, (ci, co) in enumerate(chans))
        self.norm_out = GroupNorm(last, g, **kw)
        self.conv_out = Conv2d(last, 3, 3, **kw)

    def forward(self, x):
        x = self.mid(self.conv_in(x))
        for block in self.blocks:
            x = block(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class VAEDecoder(nn.Module):
    """The decoding half of the autoencoder: post_quant_conv (when
    ``quant_conv``) + decoder."""

    def __init__(self, cfg: AutoencoderConfig, device=None,
                 dtype=torch.float32, quant_conv: bool = True):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.post_quant_conv = (Conv2d(cfg.latent_channels,
                                       cfg.latent_channels, 1, **kw)
                                if quant_conv else None)
        self.decoder = Decoder(cfg, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.conv_in.weight.dtype


class VAEEncoder(nn.Module):
    """The encoding half of the autoencoder: encoder + quant_conv (when
    ``quant_conv``)."""

    def __init__(self, cfg: AutoencoderConfig, device=None,
                 dtype=torch.float32, quant_conv: bool = True):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.encoder = Encoder(cfg, **kw)
        self.quant_conv = (Conv2d(cfg.n_channels_out, cfg.n_channels_out, 1,
                                  **kw) if quant_conv else None)

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder.conv_in.weight.dtype


def encode_image(model: VAEEncoder, x: torch.Tensor) -> torch.Tensor:
    """RGB [B, H, W, 3] in [-1, 1] -> posterior mean [B, H/8, W/8, C]."""
    h = model.encoder(x.permute(0, 3, 1, 2).contiguous())
    if model.quant_conv is not None:
        h = model.quant_conv(h)
    return h[:, :model.cfg.latent_channels].permute(0, 2, 3, 1)


def decode_latent(model: VAEDecoder, latent: torch.Tensor) -> torch.Tensor:
    """Latent [B, h, w, C] (already normalised: divided by the scale
    factor, plus SD3's and FLUX.1's shift) -> RGB [B, 8h, 8w, 3] in about
    [-1, 1]."""
    x = latent.permute(0, 3, 1, 2).contiguous()
    if model.post_quant_conv is not None:
        x = model.post_quant_conv(x)
    return model.decoder(x).permute(0, 2, 3, 1)
