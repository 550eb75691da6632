"""CLIP vision transformer, the IP-Adapter image encoder (counterpart of
sdxl_tpu/models/clip_vision.py).

transformers' ``CLIPVisionModelWithProjection`` semantics: patch conv ->
[CLS] + learned position embeddings -> pre-LN -> bidirectional pre-LN
blocks (the text towers' ``CLIPBlock`` without the causal mask) -> post-LN
on the CLS token -> visual projection. Its heads are 80 wide over 257
tokens at ViT-H, so ``use_flash`` routes none of them: they run the plain
attention, as XLA runs them in the reference. f32 throughout.

Parameters are named as in the reference's tree (``class_embedding``,
``patch_embedding``, ``position_embedding``, ``pre_ln``, ``post_ln``,
``blocks``, ``visual_projection`` [n_state, embed_dim]).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import CLIPConfig
from .clip import CLIPBlock
from .layers import LayerNorm

# CLIP's image normalisation (transformers CLIPImageProcessor defaults)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    n_state: int = 1280       # ViT-H/14 (ip-adapter_sdxl_vit-h's encoder)
    n_head: int = 16
    n_layer: int = 32
    embed_dim: int = 1024     # projection_dim
    quick_gelu: bool = False  # OpenAI ViT-L uses quick_gelu; laion gelu

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def text_cfg(self) -> CLIPConfig:
        """The block's config (it reads n_state, n_head and quick_gelu)."""
        return CLIPConfig(n_state=self.n_state, embed_dim=self.embed_dim,
                          n_head=self.n_head, n_layer=self.n_layer,
                          quick_gelu=self.quick_gelu)


class CLIPVisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        s, p = cfg.n_state, cfg.patch_size
        self.cfg = cfg
        self.class_embedding = nn.Parameter(torch.empty(s, **kw))
        self.patch_embedding = nn.Conv2d(3, s, p, stride=p, bias=False, **kw)
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.n_patches + 1, s, **kw))
        self.pre_ln = LayerNorm(s, **kw)
        self.post_ln = LayerNorm(s, **kw)
        self.blocks = nn.ModuleList(CLIPBlock(cfg.text_cfg(), **kw)
                                    for _ in range(cfg.n_layer))
        self.visual_projection = nn.Parameter(
            torch.empty(s, cfg.embed_dim, **kw))


def preprocess_image(images, cfg: CLIPVisionConfig,
                     device=None) -> torch.Tensor:
    """[B, H, W, 3] or [H, W, 3] (uint8, or float in [0, 1]; numpy or a
    tensor) -> normalised [B, S, S, 3] f32 at the tower's input size on
    ``device``: a bicubic resize clipped to [0, 1], then CLIP's mean and
    std. The reference's jax.image.resize "bicubic" is Keys' cubic with
    a = -0.5, antialiased when it shrinks; torch's antialiased bicubic is
    that filter (its plain bicubic uses a = -0.75 and no antialias)."""
    x = images if isinstance(images, torch.Tensor) else torch.as_tensor(
        np.asarray(images))
    x = x.to(device)
    if x.dim() == 3:
        x = x[None]
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    s = cfg.image_size
    if tuple(x.shape[1:3]) != (s, s):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(s, s), mode="bicubic",
                          align_corners=False, antialias=True)
        x = x.permute(0, 2, 3, 1).clamp(0.0, 1.0)
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)
    return (x - mean) / std


def clip_vision_tokens(model: CLIPVisionModel,
                       pixels: torch.Tensor) -> torch.Tensor:
    """Patch + CLS + position embeddings -> [B, 1 + n_patches, n_state]."""
    b = pixels.shape[0]
    w = model.patch_embedding.weight
    patches = F.conv2d(pixels.permute(0, 3, 1, 2).to(w.dtype), w,
                       stride=model.cfg.patch_size)
    patches = patches.flatten(2).transpose(1, 2)  # row-major over the grid
    cls = model.class_embedding.expand(b, 1, -1)
    x = torch.cat([cls, patches], dim=1)
    return x + model.position_embedding[: x.shape[1]][None]


def clip_vision_hidden(model: CLIPVisionModel, pixels: torch.Tensor,
                       n_blocks: Optional[int] = None) -> torch.Tensor:
    """The hidden state after n_blocks blocks (all by default), no
    post-LN; n_layer - 1 gives the penultimate hidden the IP-Adapter
    "plus" Resampler reads (transformers' hidden_states[-2])."""
    x = model.pre_ln(clip_vision_tokens(model, pixels))
    for block in model.blocks[:n_blocks]:
        x = block(x, None)
    return x


def clip_vision_embed(model: CLIPVisionModel,
                      pixels: torch.Tensor) -> torch.Tensor:
    """The projected image embedding [B, embed_dim] (transformers'
    image_embeds): post-LN on the CLS token, then visual_projection."""
    x = clip_vision_hidden(model, pixels)
    return model.post_ln(x[:, 0]) @ model.visual_projection


def clip_vision_penultimate(model: CLIPVisionModel,
                            pixels: torch.Tensor) -> torch.Tensor:
    """The penultimate hidden states (the plus Resampler's input)."""
    return clip_vision_hidden(model, pixels, model.cfg.n_layer - 1)
