"""Deterministic DDIM with pair-batched classifier-free guidance
(the DDIM subset of sdxl_tpu/pipeline/sampler.py).

- timestep grid (0..n_train-step_start).rev().step_by(n_train/n_steps):
  30 "steps" give 31 UNet iterations, as in the reference;
- eta = 0 DDIM update, latent carried in f32, the UNet in its own dtype;
- CFG eps = u + (c - u) * scale with [uncond | cond] in ONE batched UNet
  call; every cross-attention K/V of the fixed context is computed once;
- ᾱ lives on the device and the step loop reads no value back to the
  host, so the whole run is queued without a sync.

Latents are NHWC [B, h, w, 4] like the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..configs import DiffuserConfig
from ..models.unet import UNet, precompute_cross_kv, unet_forward
from .conditioning import Conditioning

N_STEPS_TOTAL = 1000


def scaled_linear_alphas_cumprod(n_steps: int = N_STEPS_TOTAL) -> np.ndarray:
    """SD's scaled-linear beta schedule -> cumulative alphas (float32)."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, n_steps,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def ddim_timesteps(step_start: int, n_steps: int,
                   n_train: int = N_STEPS_TOTAL) -> np.ndarray:
    step_size = n_train // n_steps
    hi = n_train - step_start
    return np.arange(hi - 1, -1, -step_size, dtype=np.int32)


def _cfg_contexts(cfg: DiffuserConfig, cond: Conditioning,
                  compute_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop-invariant [uncond | cond] context and channel tensors."""
    ctx = cond.context_full
    uctx = cond.unconditional_context_full.expand_as(ctx)
    ch = cond.channel_context
    uch = cond.unconditional_channel_context.expand_as(ch)
    return (torch.cat([uctx, ctx], dim=0).to(compute_dtype),
            torch.cat([uch, ch], dim=0).to(compute_dtype))


def _cfg_eps(unet: UNet, latent: torch.Tensor, t: torch.Tensor,
             ctx2: torch.Tensor, ch2: torch.Tensor, guidance_scale: float,
             compute_dtype: torch.dtype, cross_kv=None) -> torch.Tensor:
    """One guided epsilon: [uncond | cond] in a single UNet call."""
    n = latent.shape[0]
    x2 = torch.cat([latent, latent], dim=0).to(compute_dtype)
    t2 = t.expand(2 * n)
    eps2 = unet_forward(unet, x2, t2, ctx2, ch2, cross_kv).float()
    eps_u, eps_c = eps2.chunk(2, dim=0)
    return eps_u + (eps_c - eps_u) * guidance_scale


def _ddim_update(x0, eps, alpha_prev):
    """Deterministic (eta = 0) DDIM step to the previous grid point."""
    return x0 * torch.sqrt(alpha_prev) + eps * torch.sqrt(1.0 - alpha_prev)


@torch.no_grad()
def diffuse_latent(unet: UNet, cfg: DiffuserConfig,
                   alphas_cumprod: torch.Tensor, latent: torch.Tensor,
                   cond: Conditioning, guidance_scale: float,
                   n_steps: int = 30,
                   compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """DDIM loop over the full grid from ``latent`` (VP space at the first
    grid timestep)."""
    if cfg.is_refiner:
        raise NotImplementedError("the refiner stage is not ported yet")
    n_train = alphas_cumprod.shape[0]
    if cfg.n_steps != n_train:
        raise ValueError(
            f"DiffuserConfig.n_steps={cfg.n_steps} does not match the "
            f"alphas_cumprod table length {n_train}")
    step_size = n_train // n_steps
    device = alphas_cumprod.device
    ts = torch.as_tensor(ddim_timesteps(0, n_steps, n_train),
                         dtype=torch.long, device=device)
    a_t = alphas_cumprod[ts]
    one = torch.ones((), dtype=alphas_cumprod.dtype, device=device)
    a_prev = torch.where(ts >= step_size,
                         alphas_cumprod[(ts - step_size).clamp(min=0)], one)

    ctx2, ch2 = _cfg_contexts(cfg, cond, compute_dtype)
    cross_kv = precompute_cross_kv(unet, ctx2)
    lat = latent.float()
    for i in range(ts.shape[0]):
        alpha = a_t[i]
        eps = _cfg_eps(unet, lat, ts[i], ctx2, ch2, guidance_scale,
                       compute_dtype, cross_kv)
        x0 = (lat - eps * torch.sqrt(1.0 - alpha)) / torch.sqrt(alpha)
        lat = _ddim_update(x0, eps, a_prev[i])
    return lat


def gen_noise(generator: torch.Generator, cond: Conditioning,
              device) -> torch.Tensor:
    """Initial latent noise [B, h/8, w/8, 4], N(0, 1) in f32."""
    h, w = cond.resolution
    return torch.randn((cond.batch, h // 8, w // 8, 4), generator=generator,
                       dtype=torch.float32, device=device)


def sample_latent(unet: UNet, cfg: DiffuserConfig,
                  alphas_cumprod: torch.Tensor, cond: Conditioning,
                  generator: Optional[torch.Generator],
                  guidance_scale: float = 7.5, n_steps: int = 30,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  initial_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """txt2img latent: noise from ``generator`` unless ``initial_noise``
    is given, then the DDIM loop."""
    latent = (initial_noise if initial_noise is not None
              else gen_noise(generator, cond, alphas_cumprod.device))
    return diffuse_latent(unet, cfg, alphas_cumprod, latent, cond,
                          guidance_scale, n_steps, compute_dtype)
