"""Deterministic DDIM with pair-batched classifier-free guidance, the
refiner stage and latent inpainting (the DDIM subset of
sdxl_tpu/pipeline/sampler.py).

- timestep grid (0..n_train-step_start).rev().step_by(n_train/n_steps):
  30 "steps" give 31 UNet iterations, as in the reference;
- eta = 0 DDIM update, latent carried in f32, the UNet in its own dtype;
- CFG eps = u + (c - u) * scale with [uncond | cond] in ONE batched UNet
  call; every cross-attention K/V of the fixed context is computed once;
- the refiner (``cfg.is_refiner``) runs unguided on the OpenCLIP context
  and its 2560-wide channel context, batch B;
- inpainting pins the known region to the re-noised reference every step
  (``inpaint_pin``); a 9-channel inpainting UNet instead takes [mask,
  masked-image latent] as extra input channels;
- ᾱ lives on the device and the step loop reads no value back to the
  host, so the whole run is queued without a sync; the per-step pin noise
  is drawn on the device from an explicit torch.Generator before the loop.

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


def expert_cutoff(denoising_end: float, n_train: int = N_STEPS_TOTAL) -> int:
    """diffusers' discrete_timestep_cutoff for the ensemble-of-experts
    base -> refiner split: int(round(n_train - denoising_end * n_train)).
    The base runs the grid entries with t >= cutoff, the refiner the rest
    from the still-noisy handoff latent, with no re-noise."""
    if not 0.0 < denoising_end < 1.0:
        raise ValueError(
            f"denoising_end={denoising_end} must be strictly between 0 "
            "and 1 (the fraction of the noise range the base stage covers)")
    return int(round(n_train - denoising_end * n_train))


def expert_head_steps(alphas_cumprod, n_steps: int,
                      denoising_end: float) -> Tuple[int, int]:
    """(head_steps, grid_total) of an ensemble-of-experts split on the
    DDIM grid: the entries at or above the cutoff are the head."""
    n_train = int(alphas_cumprod.shape[0])
    cutoff = expert_cutoff(denoising_end, n_train)
    ts = ddim_timesteps(0, n_steps, n_train)
    head = int((ts >= cutoff).sum())
    total = int(ts.shape[0])
    if not 0 < head < total:
        raise ValueError(
            f"denoising_end={denoising_end} leaves "
            f"{'no head' if head == 0 else 'no tail'} steps on the "
            f"{total}-entry grid (cutoff t={cutoff}); use more steps or a "
            "less extreme split")
    return head, total


def _cfg_contexts(cfg: DiffuserConfig, cond: Conditioning,
                  compute_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop-invariant context and channel tensors: the refiner's OpenCLIP
    context and refiner channel (no CFG pair), or the base's
    [uncond | cond] pair."""
    if cfg.is_refiner:
        return (cond.context_open_clip.to(compute_dtype),
                cond.channel_context_refiner.to(compute_dtype))
    ctx = cond.context_full
    uctx = cond.unconditional_context_full.expand_as(ctx)
    ch = cond.channel_context
    uch = cond.unconditional_channel_context.expand_as(ch)
    return (torch.cat([uctx, ctx], dim=0).to(compute_dtype),
            torch.cat([uch, ch], dim=0).to(compute_dtype))


def _cfg_eps(unet: UNet, cfg: DiffuserConfig, latent: torch.Tensor,
             t: torch.Tensor, ctx2: torch.Tensor, ch2: torch.Tensor,
             guidance_scale: float, compute_dtype: torch.dtype,
             cross_kv=None, concat: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """One epsilon: the refiner's unguided call at batch B, or the base's
    guided one with [uncond | cond] in a single UNet call. concat (already
    CFG-doubled) is appended to the UNet's input channels, never to the
    latent the update sees."""
    n = latent.shape[0]
    if cfg.is_refiner:
        return unet_forward(unet, latent.to(compute_dtype), t.expand(n), ctx2,
                            ch2, cross_kv).float()
    x2 = torch.cat([latent, latent], dim=0).to(compute_dtype)
    if concat is not None:
        x2 = torch.cat([x2, concat.to(compute_dtype)], dim=-1)
    eps2 = unet_forward(unet, x2, t.expand(2 * n), ctx2, ch2, cross_kv).float()
    eps_u, eps_c = eps2.chunk(2, dim=0)
    return eps_u + (eps_c - eps_u) * guidance_scale


def _ddim_update(x0, eps, alpha_prev):
    """Deterministic (eta = 0) DDIM step to the previous grid point."""
    return x0 * torch.sqrt(alpha_prev) + eps * torch.sqrt(1.0 - alpha_prev)


def inpaint_pin(mask: torch.Tensor, lat: torch.Tensor,
                noised_ref: torch.Tensor) -> torch.Tensor:
    """Per-step inpainting pin (mask 1/True = generate). A bool mask
    selects; a float mask in [0, 1] blends m*lat + (1-m)*ref, which a
    {0, 1}-valued float mask makes equal to the bool path bitwise (the f32
    products by exactly 0 and 1 are exact)."""
    if mask.dtype == torch.bool:
        return torch.where(mask, lat, noised_ref)
    m = mask.to(lat.dtype)
    return m * lat + (1.0 - m) * noised_ref


@torch.no_grad()
def diffuse_latent(unet: UNet, cfg: DiffuserConfig,
                   alphas_cumprod: torch.Tensor, latent: torch.Tensor,
                   cond: Conditioning, guidance_scale: float,
                   step_start: int = 0, n_steps: int = 30,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   inpaint: bool = False,
                   reference: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   pin_noise: Optional[torch.Tensor] = None,
                   concat_channels: Optional[torch.Tensor] = None,
                   head_steps: int = 0, tail_from: int = 0) -> torch.Tensor:
    """DDIM loop over the grid from ``latent`` (VP space at the first grid
    timestep).

    inpaint: every step first pins ``latent`` to ``reference`` re-noised
    to the step's level where ``mask`` is 0/False, with pin noise
    ``pin_noise`` [T, B, h, w, 4] (T = the grid's entries, after
    tail_from) or, without it, T draws from ``generator``.
    concat_channels [B, h, w, 5]: mask + masked-image latent for
    9-channel inpainting UNets, doubled here for the CFG pair.
    head_steps > 0: run only the grid's first head_steps entries, ending
    at the handoff level alpha(ts[head_steps]); tail_from > 0: run the
    suffix ts[tail_from:] from the still-noisy handoff latent."""
    n_train = alphas_cumprod.shape[0]
    if cfg.n_steps != n_train:
        raise ValueError(
            f"DiffuserConfig.n_steps={cfg.n_steps} does not match the "
            f"alphas_cumprod table length {n_train}")
    step_size = n_train // n_steps
    ts_np = ddim_timesteps(step_start, n_steps, n_train)
    if head_steps and tail_from:
        raise ValueError("head_steps and tail_from are mutually exclusive "
                         "(one stage is either the head or the tail)")
    if head_steps and not 0 < head_steps < len(ts_np):
        raise ValueError(
            f"head_steps={head_steps} must leave at least one step on "
            f"each side of the {len(ts_np)}-entry grid")
    if tail_from:
        if not 0 < tail_from < len(ts_np):
            raise ValueError(
                f"tail_from={tail_from} must leave at least one step on "
                f"each side of the {len(ts_np)}-entry grid")
        ts_np = ts_np[tail_from:]
    device = alphas_cumprod.device
    ts = torch.as_tensor(ts_np, dtype=torch.long, device=device)
    a_t = alphas_cumprod[ts]
    one = torch.ones((), dtype=alphas_cumprod.dtype, device=device)
    a_prev = torch.where(ts >= step_size,
                         alphas_cumprod[(ts - step_size).clamp(min=0)], one)

    lat = latent.float()
    if inpaint:
        reference = reference.float()
        want = (len(ts_np), *lat.shape)
        if pin_noise is None:
            if generator is None:
                raise ValueError("inpaint needs a generator or pin_noise")
            pin_noise = torch.randn(want, generator=generator,
                                    dtype=torch.float32, device=device)
        elif tuple(pin_noise.shape) != want:
            raise ValueError(f"pin_noise shape {tuple(pin_noise.shape)}, "
                             f"expected {want}")
        pin_noise = pin_noise.to(device=device, dtype=torch.float32)

    ctx2, ch2 = _cfg_contexts(cfg, cond, compute_dtype)
    cross_kv = precompute_cross_kv(unet, ctx2)
    cc = concat_channels
    if cc is not None and not cfg.is_refiner:
        cc = torch.cat([cc, cc], dim=0)
    for i in range(head_steps or len(ts_np)):
        alpha = a_t[i]
        if inpaint:
            noised_ref = (reference * torch.sqrt(alpha)
                          + pin_noise[i] * torch.sqrt(1.0 - alpha))
            lat = inpaint_pin(mask, lat, noised_ref)
        eps = _cfg_eps(unet, cfg, lat, ts[i], ctx2, ch2, guidance_scale,
                       compute_dtype, cross_kv, cc)
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
                  initial_noise: Optional[torch.Tensor] = None,
                  reference: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  concat_channels: Optional[torch.Tensor] = None,
                  head_steps: int = 0,
                  pin_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """txt2img latent, with latent-mask inpainting when ``reference`` is
    given, then the DDIM loop (diffuse_latent). ``generator`` draws the
    initial noise unless ``initial_noise`` is given, then the pin noise
    unless ``pin_noise`` is given. head_steps > 0: the
    ensemble-of-experts base stage."""
    latent = (initial_noise if initial_noise is not None
              else gen_noise(generator, cond, alphas_cumprod.device))
    return diffuse_latent(
        unet, cfg, alphas_cumprod, latent, cond, guidance_scale, 0, n_steps,
        compute_dtype, inpaint=reference is not None, reference=reference,
        mask=mask, generator=generator, pin_noise=pin_noise,
        concat_channels=concat_channels, head_steps=head_steps)


def refine_latent(unet: UNet, cfg: DiffuserConfig,
                  alphas_cumprod: torch.Tensor, latent: torch.Tensor,
                  cond: Conditioning, generator: Optional[torch.Generator],
                  guidance_scale: float = 7.5, step_start: int = 800,
                  n_steps: int = 30,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  noise: Optional[torch.Tensor] = None, renoise: bool = True,
                  tail_from: int = 0) -> torch.Tensor:
    """Refiner stage (and img2img on the base UNet): re-noise ``latent`` at
    t = n_train - step_start with ``noise`` (drawn from ``generator``
    when not given), then run the grid from step_start — whose first
    entry is t - 1, as in the reference. renoise=False with tail_from=h:
    ``latent`` is already the still-noisy handoff of a head_steps=h base
    run; continue the full grid's suffix (step_start 0)."""
    if renoise:
        t = alphas_cumprod.shape[0] - step_start
        start_alpha = alphas_cumprod[t]
        if noise is None:
            noise = torch.randn(latent.shape, generator=generator,
                                dtype=torch.float32, device=latent.device)
        noised = (latent.float() * torch.sqrt(start_alpha)
                  + noise.to(latent.device).float()
                  * torch.sqrt(1.0 - start_alpha))
    else:
        noised = latent.float()
    return diffuse_latent(unet, cfg, alphas_cumprod, noised, cond,
                          guidance_scale, step_start, n_steps, compute_dtype,
                          tail_from=tail_from)
