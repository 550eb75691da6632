"""Sinusoidal timestep, LCM guidance and micro-conditioning embeddings
(counterpart of sdxl_tpu/ops/embeddings.py). The timestep sinusoid is cos
first, then sin; the LCM guidance embedding is sin first."""

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


def guidance_scale_embedding(w, dim: int) -> torch.Tensor:
    """LCM guidance embedding (arXiv:2310.04378 §4.1; diffusers
    LatentConsistencyModelPipeline.get_guidance_scale_embedding): ``w``
    (guidance_scale - 1, a number or a tensor) times 1000 in a sin-first
    sinusoid of ``half - 1``-spaced frequencies, [N, dim] f32, an odd dim
    zero-padded on the right. The phase reaches w * 1000 ~ 6.5e3, where one
    f32 ulp is ~8e-4 rad, so two libms agree to about 1e-3 there."""
    w = torch.as_tensor(w, dtype=torch.float32).reshape(-1) * 1000.0
    half = dim // 2
    log_scale = torch.log(torch.tensor(10000.0)) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32) * -log_scale)
    args = w[:, None] * freqs.to(w.device)[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


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
