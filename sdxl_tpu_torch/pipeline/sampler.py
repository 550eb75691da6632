"""The samplers' UNet side (sdxl_tpu/pipeline/sampler.py without LCM,
step previews and inversion): DDIM with pair-batched classifier-free
guidance, the twelve k-samplers (their math in k_samplers.py), the refiner
stage and latent inpainting.

- DDIM timestep grid (0..n_train-step_start).rev().step_by(n_train/
  n_steps): 30 "steps" give 31 UNet iterations, as in the reference;
- DDIM update with eta (0: deterministic), latent carried in f32, the
  UNet in its own dtype;
- k-samplers in sigma space (x = x0 + sigma * eps), the UNet's input
  scaled by 1/sqrt(sigma^2 + 1) in f32 before its cast;
- CFG eps = u + (c - u) * scale with [uncond | cond] in ONE batched UNet
  call, optionally std-rescaled (guidance_rescale); use_cfg=False runs the
  conditional rows alone; every cross-attention K/V of the fixed context
  is computed once;
- the refiner (``cfg.is_refiner``) runs unguided on the OpenCLIP context
  and its 2560-wide channel context, batch B;
- inpainting pins the known region to the re-noised reference every step
  (``inpaint_pin``); a 9-channel inpainting UNet instead takes [mask,
  masked-image latent] as extra input channels;
- ᾱ lives on the device and the step loop reads no value back to the
  host, so the whole run is queued without a sync; the per-step noise (the
  pin's, and the stochastic methods' and DDIM eta's step noise) is drawn
  on the device from an explicit torch.Generator before the loop, or
  given as a [T, B, h, w, 4] tensor.

Latents are NHWC [B, h, w, 4] like the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..configs import DiffuserConfig
from ..models.unet import UNet, precompute_cross_kv, unet_forward
from .conditioning import Conditioning
from .k_samplers import (
    K_MID,
    K_SAMPLERS,
    K_STOCHASTIC,
    SCHEDULES,
    k_sample,
    k_schedule,
    k_sigma_max,
    sigma_table,
)

N_STEPS_TOTAL = 1000


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


def expert_head_steps(alphas_cumprod, n_steps: int, denoising_end: float,
                      sampler: str = "ddim",
                      schedule: str = "linear") -> Tuple[int, int]:
    """(head_steps, grid_total) of an ensemble-of-experts split on the
    grid the sampler builds (DDIM's, or k_schedule's with karras's and
    ays's fractional timesteps): the entries at or above the cutoff are
    the head."""
    n_train = int(alphas_cumprod.shape[0])
    cutoff = expert_cutoff(denoising_end, n_train)
    if sampler == "ddim":
        ts = ddim_timesteps(0, n_steps, n_train).astype(np.float64)
    else:
        ts = k_schedule(alphas_cumprod, 0, n_steps, schedule)[0]
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
                  compute_dtype: torch.dtype, use_cfg: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop-invariant context and channel tensors: the refiner's OpenCLIP
    context and refiner channel (no CFG pair), the base's [uncond | cond]
    pair, or with use_cfg=False the base's conditional rows alone (as
    guidance_scale == 1, at half the UNet work)."""
    if cfg.is_refiner:
        return (cond.context_open_clip.to(compute_dtype),
                cond.channel_context_refiner.to(compute_dtype))
    ctx = cond.context_full
    ch = cond.channel_context
    if not use_cfg:
        return ctx.to(compute_dtype), ch.to(compute_dtype)
    uctx = cond.unconditional_context_full.expand_as(ctx)
    uch = cond.unconditional_channel_context.expand_as(ch)
    return (torch.cat([uctx, ctx], dim=0).to(compute_dtype),
            torch.cat([uch, ch], dim=0).to(compute_dtype))


def _cfg_eps(unet: UNet, cfg: DiffuserConfig, latent: torch.Tensor,
             t: torch.Tensor, ctx2: torch.Tensor, ch2: torch.Tensor,
             guidance_scale: float, compute_dtype: torch.dtype,
             cross_kv=None, concat: Optional[torch.Tensor] = None,
             use_cfg: bool = True, guidance_rescale: float = 0.0,
             return_uncond: bool = False):
    """One epsilon: the refiner's unguided call at batch B, the base's
    conditional call at batch B (use_cfg=False, contexts from
    _cfg_contexts(use_cfg=False)), or its guided one with [uncond | cond]
    in a single UNet call. concat (CFG-doubled by the caller where the
    pair runs) is appended to the UNet's input channels, never to the
    latent the update sees.

    guidance_rescale > 0 (guided calls only): Lin et al. 2023
    (arXiv:2305.08891 eq. 15-16), the guided eps rescaled to the
    conditional eps's std per image and mixed back by that fraction.
    return_uncond: also return the unconditional eps (the CFG++ sampler);
    it needs the guided pair."""
    n = latent.shape[0]
    if return_uncond and (cfg.is_refiner or not use_cfg):
        raise ValueError("CFG++ needs the pair-batched CFG path (a guided "
                         "base/family UNet, not the refiner or --no-cfg)")
    if cfg.is_refiner:
        return unet_forward(unet, latent.to(compute_dtype), t.expand(n), ctx2,
                            ch2, cross_kv).float()
    if not use_cfg:
        x = latent.to(compute_dtype)
        if concat is not None:
            x = torch.cat([x, concat.to(compute_dtype)], dim=-1)
        return unet_forward(unet, x, t.expand(n), ctx2, ch2, cross_kv).float()
    x2 = torch.cat([latent, latent], dim=0).to(compute_dtype)
    if concat is not None:
        x2 = torch.cat([x2, concat.to(compute_dtype)], dim=-1)
    eps2 = unet_forward(unet, x2, t.expand(2 * n), ctx2, ch2, cross_kv).float()
    eps_u, eps_c = eps2.chunk(2, dim=0)
    eps = eps_u + (eps_c - eps_u) * guidance_scale
    if guidance_rescale > 0.0:
        dims = tuple(range(1, eps.ndim))
        std_c = torch.std(eps_c, dim=dims, keepdim=True, correction=0)
        std_g = torch.std(eps, dim=dims, keepdim=True, correction=0)
        rescaled = eps * (std_c / torch.clamp(std_g, min=1e-12))
        eps = guidance_rescale * rescaled + (1.0 - guidance_rescale) * eps
    return (eps, eps_u) if return_uncond else eps


def ddim_sigma(alpha, alpha_prev, eta: float):
    """diffusers DDIMScheduler's eta * sqrt(variance):
    eta * sqrt((1-a_prev)/(1-a_t)) * sqrt(1 - a_t/a_prev); 0 where
    a_prev = 1."""
    var = (1.0 - alpha_prev) / (1.0 - alpha) * (1.0 - alpha / alpha_prev)
    return eta * torch.sqrt(torch.clamp(var, min=0.0))


def _ddim_update(x0, eps, alpha, alpha_prev, eta: float = 0.0, noise=None):
    """One DDIM step to the previous grid point. eta == 0: the reference's
    deterministic update. eta > 0: diffusers DDIMScheduler.step's
    stochastic one, sqrt(a_prev)*x0 + sqrt(1-a_prev-sigma^2)*eps +
    sigma*noise."""
    if eta <= 0:
        return x0 * torch.sqrt(alpha_prev) + eps * torch.sqrt(1.0 - alpha_prev)
    sig = ddim_sigma(alpha, alpha_prev, eta)
    dirn = torch.sqrt(torch.clamp(1.0 - alpha_prev - sig ** 2, min=0.0))
    return x0 * torch.sqrt(alpha_prev) + dirn * eps + sig * noise


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


def _draws(given: Optional[torch.Tensor], generator, shape, device,
           name: str) -> torch.Tensor:
    """Standard normals of `shape`, f32 on `device`: `given` checked, or
    drawn in one call from `generator`."""
    if given is None:
        if generator is None:
            raise ValueError(f"{name}: needs a generator or the draws")
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device)
    if tuple(given.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(given.shape)}, expected "
                         f"{tuple(shape)}")
    return given.to(device=device, dtype=torch.float32)


def _check_split(n: int, head_steps: int, tail_from: int) -> None:
    """head_steps / tail_from must each leave a step on both sides of an
    n-entry grid, and not come together."""
    if head_steps and tail_from:
        raise ValueError("head_steps and tail_from are mutually exclusive "
                         "(one stage is either the head or the tail)")
    for name, k in (("head_steps", head_steps), ("tail_from", tail_from)):
        if k and not 0 < k < n:
            raise ValueError(f"{name}={k} must leave at least one step on "
                             f"each side of the {n}-entry grid")


def _guided_setup(unet, cfg, cond, compute_dtype, use_cfg, concat_channels):
    """The loop-invariant contexts, their cross-attention K/V, and the
    concat channels (doubled where the CFG pair runs)."""
    ctx2, ch2 = _cfg_contexts(cfg, cond, compute_dtype, use_cfg)
    cc = concat_channels
    if cc is not None and use_cfg and not cfg.is_refiner:
        cc = torch.cat([cc, cc], dim=0)
    return ctx2, ch2, precompute_cross_kv(unet, ctx2), cc


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
                   head_steps: int = 0, tail_from: int = 0,
                   use_cfg: bool = True, guidance_rescale: float = 0.0,
                   ddim_eta: float = 0.0,
                   step_noise: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """DDIM loop over the grid from ``latent`` (VP space at the first grid
    timestep).

    inpaint: every step first pins ``latent`` to ``reference`` re-noised
    to the step's level where ``mask`` is 0/False, with pin noise
    ``pin_noise`` [T, B, h, w, 4] (T = the grid's entries, after
    tail_from) or, without it, T draws from ``generator``.
    ddim_eta > 0: stochastic DDIM, its step noise ``step_noise`` [T, B, h,
    w, 4] or T draws from ``generator`` (after the pin noise's).
    concat_channels [B, h, w, 5]: mask + masked-image latent for
    9-channel inpainting UNets, doubled here for the CFG pair.
    use_cfg=False: the conditional rows alone; guidance_rescale: see
    _cfg_eps.
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
    _check_split(len(ts_np), head_steps, tail_from)
    ts_np = ts_np[tail_from:]
    device = alphas_cumprod.device
    ts = torch.as_tensor(ts_np, dtype=torch.long, device=device)
    a_t = alphas_cumprod[ts]
    one = torch.ones((), dtype=alphas_cumprod.dtype, device=device)
    a_prev = torch.where(ts >= step_size,
                         alphas_cumprod[(ts - step_size).clamp(min=0)], one)

    lat = latent.float()
    want = (len(ts_np), *lat.shape)
    if inpaint:
        reference = reference.float()
        pin_noise = _draws(pin_noise, generator, want, device, "pin_noise")
    if ddim_eta > 0:
        step_noise = _draws(step_noise, generator, want, device, "step_noise")

    ctx2, ch2, cross_kv, cc = _guided_setup(unet, cfg, cond, compute_dtype,
                                            use_cfg, concat_channels)
    for i in range(head_steps or len(ts_np)):
        alpha = a_t[i]
        if inpaint:
            noised_ref = (reference * torch.sqrt(alpha)
                          + pin_noise[i] * torch.sqrt(1.0 - alpha))
            lat = inpaint_pin(mask, lat, noised_ref)
        eps = _cfg_eps(unet, cfg, lat, ts[i], ctx2, ch2, guidance_scale,
                       compute_dtype, cross_kv, cc, use_cfg, guidance_rescale)
        x0 = (lat - eps * torch.sqrt(1.0 - alpha)) / torch.sqrt(alpha)
        lat = _ddim_update(x0, eps, alpha, a_prev[i], ddim_eta,
                           None if step_noise is None else step_noise[i])
    return lat


@torch.no_grad()
def k_diffuse_latent(unet: UNet, cfg: DiffuserConfig, alphas_cumprod,
                     latent: torch.Tensor, cond: Conditioning,
                     guidance_scale: float, method: str = "euler",
                     step_start: int = 0, n_steps: int = 30,
                     compute_dtype: torch.dtype = torch.bfloat16,
                     inpaint: bool = False,
                     reference: Optional[torch.Tensor] = None,
                     mask: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     pin_noise: Optional[torch.Tensor] = None,
                     step_noise: Optional[torch.Tensor] = None,
                     schedule: str = "linear", use_cfg: bool = True,
                     guidance_rescale: float = 0.0,
                     concat_channels: Optional[torch.Tensor] = None,
                     head_steps: int = 0, tail_from: int = 0
                     ) -> torch.Tensor:
    """A k-sampler over the ᾱ table, from the sigma-space latent (x = x0 +
    sigma * eps at the schedule's first sigma): k_schedule's (timesteps,
    sigmas) on the host, then k_sample with the UNet's guided epsilon at
    lat / sqrt(sigma^2 + 1) (the variance-preserving latent, in f32, cast
    to the UNet's dtype in _cfg_eps).

    inpaint: each step first pins the latent to reference + sigma *
    pin_noise[i] where ``mask`` is 0/False. The stochastic methods
    (K_STOCHASTIC) add step_noise[i] each step. Both are [T, B, h, w, 4]
    standard normals (T = the grid's entries, after tail_from) or, without
    them, T draws each from ``generator``, the pin noise first.
    head_steps > 0: the grid's first head_steps steps, stopping at the
    handoff sigma sigmas[head_steps]. tail_from > 0: the suffix
    ts[tail_from:], sigmas[tail_from:] of the full schedule with fresh
    state (first step, warm-up orders, histories), as diffusers' refiner
    re-enters its scheduler; memoryless methods give one full run.
    euler_cfgpp unguided (the refiner, use_cfg=False) is plain euler.
    heun, dpm2, dpm2_a and dpmpp_2s_a evaluate the UNet twice a step
    but once on the last (see k_sample)."""
    if method not in K_SAMPLERS:
        raise ValueError(
            f"unknown k-sampler {method!r} ({'|'.join(K_SAMPLERS)})")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r} "
                         f"({'|'.join(SCHEDULES)})")
    ts, sigmas = k_schedule(alphas_cumprod, step_start, n_steps, schedule)
    _check_split(len(ts), head_steps, tail_from)
    ts, sigmas = ts[tail_from:], sigmas[tail_from:]
    if method == "euler_cfgpp" and (cfg.is_refiner or not use_cfg):
        method = "euler"  # unguided, eps_u == eps: CFG++ is Euler
    cfgpp = method == "euler_cfgpp"

    device = latent.device
    lat = latent.float()
    want = (len(ts), *lat.shape)
    pin = None
    if inpaint:
        reference = reference.float()
        pin_noise = _draws(pin_noise, generator, want, device, "pin_noise")

        def pin(x, i, sigma):
            return inpaint_pin(mask, x, reference + sigma * pin_noise[i])
    if method in K_STOCHASTIC:
        step_noise = _draws(step_noise, generator, want, device, "step_noise")

    ctx2, ch2, cross_kv, cc = _guided_setup(unet, cfg, cond, compute_dtype,
                                            use_cfg, concat_channels)

    def eps_fn(x, sigma, t):
        scaled = x / torch.sqrt(sigma ** 2 + 1.0)
        return _cfg_eps(unet, cfg, scaled, t, ctx2, ch2, guidance_scale,
                        compute_dtype, cross_kv, cc, use_cfg,
                        guidance_rescale, return_uncond=cfgpp)

    return k_sample(eps_fn, lat, method, ts, sigmas,
                    sigmas_full=(sigma_table(alphas_cumprod)
                                 if method in K_MID else None),
                    step_noise=step_noise, pin=pin, head_steps=head_steps)


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
                  pin_noise: Optional[torch.Tensor] = None,
                  use_cfg: bool = True, guidance_rescale: float = 0.0,
                  ddim_eta: float = 0.0,
                  step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """txt2img latent, with latent-mask inpainting when ``reference`` is
    given, then the DDIM loop (diffuse_latent). ``generator`` draws the
    initial noise unless ``initial_noise`` is given, then the pin noise
    and the eta step noise unless given. head_steps > 0: the
    ensemble-of-experts base stage."""
    latent = (initial_noise if initial_noise is not None
              else gen_noise(generator, cond, alphas_cumprod.device))
    return diffuse_latent(
        unet, cfg, alphas_cumprod, latent, cond, guidance_scale, 0, n_steps,
        compute_dtype, inpaint=reference is not None, reference=reference,
        mask=mask, generator=generator, pin_noise=pin_noise,
        concat_channels=concat_channels, head_steps=head_steps,
        use_cfg=use_cfg, guidance_rescale=guidance_rescale,
        ddim_eta=ddim_eta, step_noise=step_noise)


def euler_sample_latent(unet: UNet, cfg: DiffuserConfig, alphas_cumprod,
                        cond: Conditioning,
                        generator: Optional[torch.Generator],
                        guidance_scale: float = 7.5, n_steps: int = 30,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        method: str = "euler",
                        reference: Optional[torch.Tensor] = None,
                        mask: Optional[torch.Tensor] = None,
                        schedule: str = "linear", use_cfg: bool = True,
                        guidance_rescale: float = 0.0,
                        concat_channels: Optional[torch.Tensor] = None,
                        initial_noise: Optional[torch.Tensor] = None,
                        head_steps: int = 0,
                        pin_noise: Optional[torch.Tensor] = None,
                        step_noise: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """txt2img (and latent-mask inpainting) with a k-sampler: the initial
    noise (``initial_noise`` or drawn from ``generator``) times the
    schedule's first sigma, then k_diffuse_latent, whose pin and step
    noise ``generator`` draws next unless given. head_steps > 0 returns
    the still-noisy sigma-space handoff latent."""
    sigma_max = float(k_sigma_max(alphas_cumprod, n_steps, schedule))
    noise = (initial_noise if initial_noise is not None
             else gen_noise(generator, cond, alphas_cumprod.device))
    return k_diffuse_latent(
        unet, cfg, alphas_cumprod, noise.float() * sigma_max, cond,
        guidance_scale, method, 0, n_steps, compute_dtype,
        inpaint=reference is not None, reference=reference, mask=mask,
        generator=generator, pin_noise=pin_noise, step_noise=step_noise,
        schedule=schedule, use_cfg=use_cfg,
        guidance_rescale=guidance_rescale, concat_channels=concat_channels,
        head_steps=head_steps)


def refine_latent(unet: UNet, cfg: DiffuserConfig,
                  alphas_cumprod: torch.Tensor, latent: torch.Tensor,
                  cond: Conditioning, generator: Optional[torch.Generator],
                  guidance_scale: float = 7.5, step_start: int = 800,
                  n_steps: int = 30,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  noise: Optional[torch.Tensor] = None, renoise: bool = True,
                  tail_from: int = 0, use_cfg: bool = True,
                  guidance_rescale: float = 0.0, ddim_eta: float = 0.0,
                  step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
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
                          generator=generator, tail_from=tail_from,
                          use_cfg=use_cfg, guidance_rescale=guidance_rescale,
                          ddim_eta=ddim_eta, step_noise=step_noise)


def k_refine_latent(unet: UNet, cfg: DiffuserConfig, alphas_cumprod,
                    latent: torch.Tensor, cond: Conditioning,
                    generator: Optional[torch.Generator],
                    guidance_scale: float = 7.5, step_start: int = 800,
                    n_steps: int = 30,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    method: str = "euler", schedule: str = "linear",
                    use_cfg: bool = True, guidance_rescale: float = 0.0,
                    noise: Optional[torch.Tensor] = None,
                    renoise: bool = True, tail_from: int = 0,
                    step_noise: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The refiner stage (and img2img) with a k-sampler: re-noise the
    clean ``latent`` to the schedule's actual first sigma, x = latent +
    sigma_start * noise (``noise`` or drawn from ``generator``), then run
    the schedule's tail from step_start; the stochastic methods' step
    noise comes after. renoise=False with tail_from=h: ``latent`` is the
    still-noisy sigma-space handoff of a head_steps=h base run; continue
    the full schedule's suffix (step_start 0)."""
    lat = latent.float()
    if renoise:
        sigma_start = float(k_schedule(alphas_cumprod, step_start, n_steps,
                                       schedule)[1][0])
        if noise is None:
            noise = torch.randn(latent.shape, generator=generator,
                                dtype=torch.float32, device=latent.device)
        lat = lat + sigma_start * noise.to(latent.device).float()
    return k_diffuse_latent(
        unet, cfg, alphas_cumprod, lat, cond, guidance_scale, method,
        step_start, n_steps, compute_dtype, generator=generator,
        step_noise=step_noise, schedule=schedule, use_cfg=use_cfg,
        guidance_rescale=guidance_rescale, tail_from=tail_from)
