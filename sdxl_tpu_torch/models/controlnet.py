"""ControlNet (Zhang et al. 2023, arXiv:2302.05543) for the SDXL UNet
(counterpart of sdxl_tpu/models/controlnet.py).

The trunk is a copy of the UNet's input blocks and middle block, built
from the same ``unet_block_plan`` with the UNet's modules; a small conv
stack (``cond_embed``) embeds the full-resolution conditioning image to
the latent grid and is added to input block 0's output; one 1x1 "zero
conv" per input block and one after the middle block give the residuals
the UNet adds to its skips and to its middle block's output
(``unet_forward(control_residuals=...)``).

The trunk runs on the 4-channel latent, with the UNet's timestep, context
and label (the CFG pair where the UNet runs it), never on an inpainting
or InstructPix2Pix UNet's extra input channels. The conditioning image is
[0, 1] RGB (diffusers' convention), not the VAE's [-1, 1]. Activations
are NCHW as in the UNet: ``control_cond_embed`` returns the embedding
NCHW and ``controlnet_forward`` NCHW residuals.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import UNetConfig
from .layers import Conv2d
from .unet import (
    UNetBlock,
    _input_blocks,
    _middle,
    _mlp2,
    _unet_embed,
    middle_block,
    unet_block_plan,
)

# diffusers ControlNetConditioningEmbedding's channel plan
COND_EMBED_CHANNELS = (16, 32, 96, 256)


class ControlCondEmbed(nn.Module):
    """conv_in -> (conv1, stride-2 conv2) x 3 with SiLU -> conv_out: the
    RGB image at 8x the latent grid down to model_channels at the grid."""

    def __init__(self, model_channels: int, **kw):
        super().__init__()
        c = COND_EMBED_CHANNELS
        self.conv_in = Conv2d(3, c[0], 3, **kw)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({"conv1": Conv2d(c[i], c[i], 3, **kw),
                           "conv2": Conv2d(c[i], c[i + 1], 3, stride=2,
                                           **kw)})
            for i in range(len(c) - 1))
        self.conv_out = Conv2d(c[-1], model_channels, 3, **kw)


class ControlNet(nn.Module):
    """The trunk's parameters, named as in the reference's tree."""

    def __init__(self, cfg: UNetConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        in_plan, mid_spec, _ = unet_block_plan(cfg)
        emb_dim = cfg.time_embed_dim
        self.time_embed = _mlp2(cfg.model_channels, emb_dim, **kw)
        self.label_embed = (_mlp2(cfg.adm_in_channels, emb_dim, **kw)
                            if cfg.adm_in_channels else None)
        self.cond_embed = ControlCondEmbed(cfg.model_channels, **kw)
        self.input_blocks = nn.ModuleList(UNetBlock(s, cfg, **kw)
                                          for s in in_plan)
        self.zero_convs = nn.ModuleList(Conv2d(s.ch_out, s.ch_out, 1, **kw)
                                        for s in in_plan)
        self.middle_block = middle_block(mid_spec, cfg, **kw)
        self.zero_conv_mid = Conv2d(mid_spec.ch_out, mid_spec.ch_out, 1, **kw)


def control_cond_embed(model: ControlNet, image: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] image in [0, 1] -> [B, model_channels, H/8, W/8] NCHW,
    in the trunk's dtype."""
    ce = model.cond_embed
    x = image.permute(0, 3, 1, 2).to(ce.conv_in.weight.dtype)
    x = F.silu(ce.conv_in(x))
    for blk in ce.blocks:
        x = F.silu(blk["conv1"](x))
        x = F.silu(blk["conv2"](x))
    return ce.conv_out(x)


def controlnet_forward(model: ControlNet, x: torch.Tensor,
                       timesteps: torch.Tensor, context: torch.Tensor,
                       label: Optional[torch.Tensor], cond_emb: torch.Tensor,
                       cross_kv=None) -> Tuple[List[torch.Tensor],
                                               torch.Tensor]:
    """The trunk on the UNet's inputs (x NHWC [B, h, w, 4]); cond_emb:
    control_cond_embed's output at the same batch. Returns (one NCHW down
    residual per input block, aligned with the UNet's skips; the NCHW mid
    residual). cross_kv: precompute_cross_kv(model, context), the trunk's
    input and middle blocks' K/V of a fixed context."""
    emb = _unet_embed(model, timesteps, label, x.dtype)
    ckv = cross_kv or {}
    x, saved = _input_blocks(model, x, emb, context,
                             ckv.get("input_blocks", {}), inject=cond_emb)
    down = [zc(s) for zc, s in zip(model.zero_convs, saved)]
    x = _middle(model, x, emb, context, ckv.get("middle_block"))
    return down, model.zero_conv_mid(x)

