"""Sinusoidal timestep and micro-conditioning embeddings
(counterpart of sdxl_tpu/ops/embeddings.py). Cos first, then sin."""

from __future__ import annotations

import math

import torch


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """[N] timesteps -> [N, dim] float32, cos-first."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=timesteps.device)
        * (-math.log(max_period) / half))
    args = timesteps.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=1)


def conditioning_embedding(pooled_text_enc: torch.Tensor, dim: int,
                           size: torch.Tensor, crop: torch.Tensor,
                           ar: torch.Tensor) -> torch.Tensor:
    """SDXL micro-conditioning: pooled text embedding ++ a ``dim``-wide
    sinusoid of each of the size, crop and aspect (or aesthetic) ints."""
    n_batch = pooled_text_enc.shape[0]
    cat = torch.cat([size, crop, ar], dim=1)
    w = cat.shape[1]
    embed = timestep_embedding(cat.reshape(n_batch * w), dim, 10000)
    embed = embed.reshape(n_batch, w * dim)
    return torch.cat([pooled_text_enc, embed.to(pooled_text_enc.dtype)], dim=1)
