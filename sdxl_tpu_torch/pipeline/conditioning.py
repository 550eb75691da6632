"""Dual-CLIP conditioning for SDXL (counterpart of sdxl_tpu/pipeline/conditioning.py).

- CLIP ViT-L hidden at the penultimate layer, OpenCLIP bigG hidden at the
  penultimate layer plus its pooled embedding;
- context_full = cat(clip 768, openclip 1280) = 2048;
- channel context = pooled ++ sinusoid(size, crop, aspect) = 2816;
- the refiner's channel context replaces the aspect with the aesthetic
  score 6: pooled ++ sinusoid(size, crop, 6) = 2560;
- the unconditional branch runs the same towers on the negative prompt,
  memoised across requests in ``uncond_cache``.

Tokenisation is host-side (the reference's BPE tokenizers); the towers
run in f32 on the embedder's device. ``clip_skip`` > 0 taps both towers
that many blocks earlier. The reference's other defaults are fixed here:
crop (0, 0), attention-weight parsing on, at most 4 chunks of 77 tokens.

SD 1.x / 2.x's single-tower conditioning (pipeline/sd1.py) fills the same
dataclass with None in the OpenCLIP and channel fields.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..configs import EmbedderConfig
from ..models.clip import clip_hidden, clip_hidden_pooled
from ..ops.embeddings import conditioning_embedding
from .prompt import apply_prompt_weights, batch_weighted_tokens, pad_chunks

AESTHETIC_SCORE = 6  # the refiner's micro-conditioning


@dataclass
class Conditioning:
    """The 8 conditioning tensors and the target resolution. Unconditional
    tensors carry batch 1 and are broadcast at CFG time. SD 1.x / 2.x
    conditioning carries None in the six OpenCLIP and channel fields."""

    unconditional_context_full: torch.Tensor          # [1, 77k, 2048]
    unconditional_context_open_clip: Optional[torch.Tensor]  # [1, 77k, 1280]
    context_full: torch.Tensor                        # [B, 77k, 2048]
    context_open_clip: Optional[torch.Tensor]         # [B, 77k, 1280]
    unconditional_channel_context: Optional[torch.Tensor]  # [1, 2816]
    unconditional_channel_context_refiner: Optional[torch.Tensor]  # [1, 2560]
    channel_context: Optional[torch.Tensor]           # [B, 2816]
    channel_context_refiner: Optional[torch.Tensor]   # [B, 2560]
    resolution: Tuple[int, int]                       # (height, width)

    @property
    def batch(self) -> int:
        return self.context_full.shape[0]

    def astype(self, dtype: torch.dtype) -> "Conditioning":
        def cast(name):
            v = getattr(self, name)
            return v if name == "resolution" or v is None else v.to(dtype)
        return Conditioning(**{f.name: cast(f.name) for f in fields(self)})


def _conditioning_half(embedder: nn.ModuleDict, cfg: EmbedderConfig,
                       clip_tokens: torch.Tensor, oc_tokens: torch.Tensor,
                       size, crop, clip_w=None, oc_w=None,
                       clip_skip: int = 0):
    """One branch (conditional or unconditional). tokens: [B, k, 77]
    chunked ids; optional [B, k, 77] prompt weights. Hidden states are
    taken at the penultimate layer of each tower, clip_skip blocks
    earlier."""
    b, k, n_ctx = clip_tokens.shape
    clip_ctx = clip_hidden(embedder["clip"], clip_tokens.reshape(b * k, n_ctx),
                           cfg.clip_config.n_layer - 1 - clip_skip)
    clip_ctx = clip_ctx.reshape(b, k * n_ctx, -1)
    open_ctx, pooled = clip_hidden_pooled(
        embedder["open_clip"], oc_tokens.reshape(b * k, n_ctx),
        cfg.open_clip_config.n_layer - 1 - clip_skip)
    open_ctx = open_ctx.reshape(b, k * n_ctx, -1)
    pooled = pooled.reshape(b, k, -1)[:, 0]
    if clip_w is not None:
        clip_ctx = apply_prompt_weights(clip_ctx, clip_w.reshape(b, k * n_ctx))
        open_ctx = apply_prompt_weights(open_ctx, oc_w.reshape(b, k * n_ctx))
    context_full = torch.cat([clip_ctx, open_ctx], dim=-1)
    # the aspect input of the base model's micro-conditioning is the size
    channel = conditioning_embedding(pooled, 256, size, crop, size)
    aesthetic = torch.full((b, 1), AESTHETIC_SCORE, dtype=size.dtype,
                           device=size.device)
    channel_refiner = conditioning_embedding(pooled, 256, size, crop,
                                             aesthetic)
    return context_full, open_ctx, channel, channel_refiner


@torch.no_grad()
def text_to_conditioning(
    embedder: nn.ModuleDict,
    cfg: EmbedderConfig,
    clip_tokenizer,
    open_clip_tokenizer,
    prompts,
    resolution: Tuple[int, int] = (1024, 1024),
    negative_prompt: str = "",
    uncond_cache: dict | None = None,
    clip_skip: int = 0,
) -> Conditioning:
    """Prompts -> Conditioning. ``embedder`` holds the two towers under
    "clip" and "open_clip". ``uncond_cache`` (optional, caller-owned)
    memoises the unconditional half, which depends on the negative prompt,
    resolution, clip_skip, chunk count and weighting only."""
    if isinstance(prompts, str):
        prompts = [prompts]
    n = len(prompts)
    h, w = resolution
    device = embedder["clip"].token_embedding.device

    clip_ids, w_clip, u_clip_ids, uw_clip, weighted_c, k1 = \
        batch_weighted_tokens(prompts, negative_prompt, clip_tokenizer,
                              cfg.clip_config.n_ctx)
    oc_ids, w_oc, u_oc_ids, uw_oc, weighted_o, k2 = batch_weighted_tokens(
        prompts, negative_prompt, open_clip_tokenizer,
        cfg.open_clip_config.n_ctx)
    # the tokenizers can disagree on the chunk count near a boundary; pad
    # the shorter to the common k so the concatenated contexts align
    k = max(k1, k2)
    if k1 < k:
        clip_ids, w_clip, u_clip_ids, uw_clip = _pad_batch(
            clip_ids, w_clip, u_clip_ids, uw_clip, k, clip_tokenizer,
            cfg.clip_config.n_ctx)
    if k2 < k:
        oc_ids, w_oc, u_oc_ids, uw_oc = _pad_batch(
            oc_ids, w_oc, u_oc_ids, uw_oc, k, open_clip_tokenizer,
            cfg.open_clip_config.n_ctx)
    weighted = bool(weighted_c or weighted_o)

    def ids(a):
        return torch.as_tensor(a, dtype=torch.long, device=device)

    def wts(a):
        return torch.as_tensor(a, device=device) if weighted else None

    size = torch.tensor([[h, w]] * n, dtype=torch.int32, device=device)
    crop = torch.zeros((n, 2), dtype=torch.int32, device=device)

    cond = _conditioning_half(embedder, cfg, ids(clip_ids), ids(oc_ids), size,
                              crop, wts(w_clip), wts(w_oc), clip_skip)

    cache_key = (negative_prompt, (h, w), clip_skip, int(clip_ids.shape[1]),
                 weighted)
    if uncond_cache is not None and cache_key in uncond_cache:
        uncond = uncond_cache[cache_key]
    else:
        uncond = _conditioning_half(
            embedder, cfg, ids(u_clip_ids), ids(u_oc_ids), size[:1],
            crop[:1], wts(uw_clip), wts(uw_oc), clip_skip)
        if uncond_cache is not None:
            uncond_cache[cache_key] = uncond

    u_full, u_oc, u_ch, u_ch_ref = uncond
    ctx_full, ctx_oc, ch, ch_ref = cond
    return Conditioning(
        unconditional_context_full=u_full,
        unconditional_context_open_clip=u_oc,
        context_full=ctx_full,
        context_open_clip=ctx_oc,
        unconditional_channel_context=u_ch,
        unconditional_channel_context_refiner=u_ch_ref,
        channel_context=ch,
        channel_context_refiner=ch_ref,
        resolution=(h, w),
    )


def _pad_batch(ids, w, u_ids, u_w, k, tokenizer, n_ctx):
    padded = [pad_chunks(ids[i], w[i], k, tokenizer, n_ctx)
              for i in range(ids.shape[0])]
    u = pad_chunks(u_ids[0], u_w[0], k, tokenizer, n_ctx)
    return (np.stack([p[0] for p in padded]), np.stack([p[1] for p in padded]),
            u[0][None], u[1][None])
