"""The samplers' UNet side (sdxl_tpu/pipeline/sampler.py): DDIM with
pair-batched classifier-free guidance, the twelve k-samplers (their math
in k_samplers.py), LCM, DDIM inversion, the refiner stage and latent
inpainting, with step previews, PAG, DeepCache, ControlNet (one or
several), IP-Adapter and InstructPix2Pix's 3-way guidance.

- DDIM timestep grid (0..n_train-step_start).rev().step_by(n_train/
  n_steps): 30 "steps" give 31 UNet iterations, as in the reference;
- DDIM update with eta (0: deterministic), latent carried in f32, the
  UNet in its own dtype;
- k-samplers in sigma space (x = x0 + sigma * eps), the UNet's input
  scaled by 1/sqrt(sigma^2 + 1) in f32 before its cast;
- LCM (diffusers' LCMScheduler): a few points of the distilled model's
  50-point DDIM grid, the consistency boundary scalings, a re-noise to the
  next point on each step but the last; an LCM-distilled UNet embeds the
  guidance through its cond_proj (no CFG pair);
- DDIM inversion walks the deterministic DDIM chain backward, from a
  clean latent to the noise that regenerates it;
- CFG eps = u + (c - u) * scale with [uncond | cond] in ONE batched UNet
  call, optionally std-rescaled (guidance_rescale); use_cfg=False runs the
  conditional rows alone; every cross-attention K/V of the fixed context
  is computed once; PAG (pag_scale) adds one conditional call a step with
  the middle block's self-attentions as the identity map; DeepCache
  (deepcache=(interval, branch)) runs the whole UNet every interval-th
  step and only its shallow blocks on the others;
- ControlNet (``controlnet``: one trunk or a sequence): each step's
  window scale is known on the host (``_control_window_scales``, diffusers'
  controlnet_keep); the trunks run on the 4-channel latent at the UNet's
  batch, their residuals scaled and summed in f32; a trunk whose scale is
  0 at a step is not run (the UNet's result is the same). Its
  conditioning-image embedding and cross K/V are computed once a request;
- IP-Adapter (``ip``): the image tokens' K/V join every cross-attention's
  precomputed K/V once a request (``_merge_ip``);
- InstructPix2Pix (``edit``): one batch-3 UNet call over [uncond | image
  | image+text] rows with the edit latents as 4 extra input channels,
  eps = e_u + s_I (e_i - e_u) + s_T (e_t - e_i);
- the refiner (``cfg.is_refiner``) runs unguided on the OpenCLIP context
  and its 2560-wide channel context, batch B;
- a v-prediction UNet (``cfg.prediction_type == "v"``, SD 2.1-768) has its
  output turned into an epsilon at the step's own ᾱ_t: DDIM's and LCM's
  grid point, a k-sampler's 1 / (sigma^2 + 1), the inversion's source
  level;
- SD 1.x / 2.x conditioning has no channel context: the UNet and the
  ControlNet trunks then take no label;
- inpainting pins the known region to the re-noised reference every step
  (``inpaint_pin``); a 9-channel inpainting UNet instead takes [mask,
  masked-image latent] as extra input channels;
- ᾱ lives on the device and the step loop reads no value back to the
  host, so the whole run is queued without a sync; the per-step noise (the
  pin's, and the stochastic methods', LCM's and DDIM eta's step noise) is
  drawn on the device from an explicit torch.Generator before the loop,
  or given as a [T, B, h, w, 4] tensor. The one exception is a step
  preview (preview_every / preview_callback): it copies the latent's
  preview image to the host between steps, one sync each, and the loop
  queues freely between two previews.

Latents are NHWC [B, h, w, 4] like the reference.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..configs import DiffuserConfig
from ..models.controlnet import (
    control_cond_embed,
    controlnet_forward,
)
from ..models.unet import (
    UNet,
    precompute_cross_kv,
    unet_forward,
    unet_forward_shallow,
)
from ..ops.embeddings import guidance_scale_embedding
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
                  compute_dtype: torch.dtype, use_cfg: bool = True,
                  rows3: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop-invariant context and channel tensors: the refiner's OpenCLIP
    context and refiner channel (no CFG pair), the base's [uncond | cond]
    pair, or with use_cfg=False the base's conditional rows alone (as
    guidance_scale == 1, at half the UNet work). rows3 (InstructPix2Pix):
    [uncond | uncond | cond], the first two rows told apart by the image
    channels the caller builds ([zeros | image | image])."""
    if cfg.is_refiner:
        return (cond.context_open_clip.to(compute_dtype),
                cond.channel_context_refiner.to(compute_dtype))
    lead = 2 if rows3 else 1

    def rows(c, u):
        """[u] * lead + [c] rows in compute_dtype (None stays None: SD
        1.x / 2.x conditioning has no channel context)."""
        if c is None:
            return None
        if not use_cfg:
            return c.to(compute_dtype)
        return torch.cat([u.expand_as(c)] * lead + [c],
                         dim=0).to(compute_dtype)
    return (rows(cond.context_full, cond.unconditional_context_full),
            rows(cond.channel_context, cond.unconditional_channel_context))


def _rows(tree, start: int):
    """The rows from ``start`` of every tensor in a cross-K/V tree."""
    if isinstance(tree, dict):
        return {k: _rows(v, start) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rows(v, start) for v in tree]
    return tree[start:]


def _guide(eps_u, eps_c, guidance_scale: float, guidance_rescale: float,
           pag=None):
    """u + (c - u) * scale, then PAG's pag_scale * (c - perturbed) term
    (``pag``, when given), then the guidance rescale (Lin et al. 2023,
    arXiv:2305.08891 eq. 15-16): the guided eps rescaled to the
    conditional eps's std per image and mixed back by that fraction."""
    eps = eps_u + (eps_c - eps_u) * guidance_scale
    if pag is not None:
        eps = eps + pag
    if guidance_rescale > 0.0:
        dims = tuple(range(1, eps.ndim))
        std_c = torch.std(eps_c, dim=dims, keepdim=True, correction=0)
        std_g = torch.std(eps, dim=dims, keepdim=True, correction=0)
        rescaled = eps * (std_c / torch.clamp(std_g, min=1e-12))
        eps = guidance_rescale * rescaled + (1.0 - guidance_rescale) * eps
    return eps


def _cfg_eps(unet: UNet, cfg: DiffuserConfig, latent: torch.Tensor,
             t: torch.Tensor, ctx2: torch.Tensor, ch2: torch.Tensor,
             guidance_scale: float, compute_dtype: torch.dtype,
             cross_kv=None, concat: Optional[torch.Tensor] = None,
             use_cfg: bool = True, guidance_rescale: float = 0.0,
             return_uncond: bool = False, t_add=None,
             pag_scale: float = 0.0, forward=None, control=None,
             control_scale=None, image_scale: Optional[float] = None,
             alpha_t: Optional[torch.Tensor] = None):
    """One epsilon: the refiner's unguided call at batch B, the base's
    conditional call at batch B (use_cfg=False, contexts from
    _cfg_contexts(use_cfg=False)), or its guided one with [uncond | cond]
    in a single UNet call. concat (CFG-doubled by the caller where the
    pair runs) is appended to the UNet's input channels, never to the
    latent the update sees.

    guidance_rescale > 0 (guided calls only): see _guide.
    return_uncond: also return the unconditional eps (the CFG++ sampler);
    it needs the guided pair. t_add: an LCM-distilled UNet's projected
    guidance embedding (models/unet.py _unet_embed). pag_scale > 0:
    Perturbed-Attention Guidance (Ahn et al. 2024, arXiv:2403.17377;
    diffusers' "mid" layers): one more UNet call on the conditional rows
    with the middle block's self-attentions as the identity map, and eps
    += pag_scale * (eps_cond - eps_perturbed), with or without CFG.
    forward(x, timesteps, context, label, cross_kv, **kw): the UNet call,
    by default unet_forward with t_add and cfg.freeu (FreeU) on every
    call; DeepCache passes its full-or-shallow switch (_deepcache_eps).
    control: _control_setup's [(trunk, cond_emb, cross K/V)], with
    control_scale this step's scale of each (a 0 skips its trunk); the
    trunks run on the latent (the CFG pair's where the UNet runs it), never
    on the concat channels, and the refiner takes none. image_scale
    (InstructPix2Pix, with the rows3 contexts and the [zeros | image |
    image] concat): e_u + image_scale (e_i - e_u) + guidance_scale (e_t -
    e_i) from one batch-3 call.

    alpha_t (a v-prediction UNet's, required there): the ᾱ of the
    variance-preserving ``latent``; each raw output v becomes eps =
    sqrt(ᾱ_t) v + sqrt(1 - ᾱ_t) x, x the UNet's input latent as the
    reference takes it: the batched pair's and ip2p's rows cast to
    compute_dtype, the unpaired calls' latent in f32."""
    n = latent.shape[0]
    if pag_scale and cfg.is_refiner:
        raise ValueError("PAG applies to the base/family UNets, not the "
                         "refiner (its stage runs unguided)")
    if return_uncond and (cfg.is_refiner or not use_cfg):
        raise ValueError("CFG++ needs the pair-batched CFG path (a guided "
                         "base/family UNet, not the refiner or --no-cfg)")
    v_pred = cfg.prediction_type == "v"
    if v_pred and alpha_t is None:
        raise ValueError("a v-prediction UNet needs the step's alpha_t")

    def to_eps(raw, x):
        if not v_pred:
            return raw
        return (torch.sqrt(alpha_t) * raw
                + torch.sqrt(1.0 - alpha_t) * x.float())

    if forward is None:
        def forward(x, ts, ctx, ch, kv, **kw):
            return unet_forward(unet, x, ts, ctx, ch, kv, t_add=t_add,
                                freeu=cfg.freeu, **kw)

    def call(x, ctx, ch, kv, **kw):
        return forward(x, t.expand(x.shape[0]), ctx, ch, kv, **kw).float()

    def with_concat(x, cc):
        return x if cc is None else torch.cat([x, cc.to(compute_dtype)],
                                              dim=-1)

    def residuals(x):
        """The trunks' residuals at x (scaled, summed in f32), or None
        when every scale of this step is 0."""
        total = None
        for (net, emb, kv), scale in zip(control, control_scale):
            scale = float(scale)
            if scale == 0:
                continue
            down, mid = controlnet_forward(net, x, t.expand(x.shape[0]),
                                           ctx2, ch2, emb, kv)
            parts = [r.float() * scale for r in down + [mid]]
            total = parts if total is None else [
                a + b for a, b in zip(total, parts)]
        return None if total is None else (total[:-1], total[-1])

    def control_kw(x):
        res = residuals(x) if control else None
        return {} if res is None else {"control_residuals": res}

    if cfg.is_refiner:
        return to_eps(call(latent.to(compute_dtype), ctx2, ch2, cross_kv),
                      latent)
    if image_scale is not None and use_cfg:
        x3 = torch.cat([latent] * 3, dim=0).to(compute_dtype)
        eps3 = to_eps(call(with_concat(x3, concat), ctx2, ch2, cross_kv), x3)
        e_u, e_i, e_t = eps3.chunk(3, dim=0)
        return e_u + image_scale * (e_i - e_u) + guidance_scale * (e_t - e_i)
    if not use_cfg:
        x = latent.to(compute_dtype)
        x_in = with_concat(x, concat)
        eps = to_eps(call(x_in, ctx2, ch2, cross_kv, **control_kw(x)), latent)
        if pag_scale:
            eps_pert = to_eps(call(x_in, ctx2, ch2, cross_kv, pag_mid=True),
                              latent)
            eps = eps + pag_scale * (eps - eps_pert)
        return eps
    x2 = torch.cat([latent, latent], dim=0).to(compute_dtype)
    x_in = with_concat(x2, concat)
    eps_u, eps_c = to_eps(call(x_in, ctx2, ch2, cross_kv, **control_kw(x2)),
                          x2).chunk(2, dim=0)
    pag = None
    if pag_scale:
        eps_pert = to_eps(call(x_in[n:], ctx2[n:],
                               None if ch2 is None else ch2[n:],
                               None if cross_kv is None
                               else _rows(cross_kv, n), pag_mid=True),
                          latent)
        pag = pag_scale * (eps_c - eps_pert)
    eps = _guide(eps_u, eps_c, guidance_scale, guidance_rescale, pag)
    return (eps, eps_u) if return_uncond else eps


def _deepcache_validate(deepcache, controlnet,
                        concat_channels) -> Tuple[int, int]:
    """DeepCache (arXiv:2312.00858) runs the plain txt2img / inpaint
    paths: ControlNet's residuals target the deep skips a shallow step
    never computes, and a 9-channel inpainting UNet's concat changes
    conv_in, so both are refused rather than silently wrong."""
    interval, branch = deepcache
    if interval < 1:
        raise ValueError("deepcache interval must be >= 1")
    if controlnet is not None:
        raise ValueError("deepcache is incompatible with ControlNet "
                         "(residuals target the skipped deep blocks)")
    if concat_channels is not None:
        raise ValueError("deepcache is incompatible with "
                         "inpainting-specialized (9-channel) UNets")
    return interval, branch


def _deepcache_eps(unet, cfg, ctx2, ch2, guidance_scale, compute_dtype,
                   cross_kv, use_cfg, guidance_rescale, deepcache):
    """eps(latent, t, alpha_t) of a step loop with DeepCache: _cfg_eps
    through a UNet call that counts the steps (one call a step: the loops refuse
    the methods that evaluate twice). Step 0 and every interval-th step
    after run the whole UNet and keep the fresh deep feature, the others
    only the shallow blocks around the kept one; the switch is a host
    bool, and step 0 is always full, so no cache exists before it."""
    interval, branch = deepcache
    state = {"step": 0, "cache": None}

    def forward(x, ts, ctx, ch, kv):
        if state["step"] % interval == 0:
            out, state["cache"] = unet_forward(
                unet, x, ts, ctx, ch, kv, freeu=cfg.freeu,
                cache_branch=branch)
            return out
        return unet_forward_shallow(unet, x, ts, ctx, ch, state["cache"],
                                    kv, branch=branch, freeu=cfg.freeu)

    def eps(latent, t, alpha_t):
        out = _cfg_eps(unet, cfg, latent, t, ctx2, ch2, guidance_scale,
                       compute_dtype, cross_kv, use_cfg=use_cfg,
                       guidance_rescale=guidance_rescale, forward=forward,
                       alpha_t=alpha_t)
        state["step"] += 1
        return out
    return eps


# Cheap latent -> RGB approximations (the standard public preview factors
# used across SD tooling, e.g. ComfyUI's latent_rgb_factors); a real decode
# of intermediates would cost a VAE pass per preview.
SDXL_LATENT_RGB = np.array(
    [[0.3920, 0.4054, 0.4549],
     [-0.2634, -0.0196, 0.0653],
     [0.0568, 0.1687, -0.0755],
     [-0.3112, -0.2359, -0.2076]], np.float32)
SD1_LATENT_RGB = np.array(
    [[0.298, 0.207, 0.208],
     [0.187, 0.286, 0.173],
     [-0.158, 0.189, 0.264],
     [-0.184, -0.271, -0.473]], np.float32)


def latent_to_preview(latent: torch.Tensor,
                      factors: Optional[np.ndarray] = None) -> np.ndarray:
    """[B, h, w, 4] latent -> [B, h, w, 3] uint8 preview on the host, by
    ``factors`` [4, 3] (None: SDXL_LATENT_RGB; SD 1.x / 2.x pipelines pass
    SD1_LATENT_RGB), the one device-to-host copy of a step preview."""
    f = torch.as_tensor(SDXL_LATENT_RGB if factors is None else factors,
                        dtype=torch.float32, device=latent.device)
    rgb = latent.float() @ f
    return ((rgb + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()


PreviewFn = Callable[[int, int, np.ndarray], None]


def _check_preview(preview_every: Optional[int]) -> None:
    if preview_every is not None and preview_every < 1:
        raise ValueError("preview_every must be >= 1")


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


def _edit_validate(cfg, concat_channels, inpaint, controlnet, deepcache,
                   pag_scale, ip, guidance_rescale, use_cfg) -> None:
    """InstructPix2Pix's refusals (the reference's, for both loops)."""
    if concat_channels is None:
        raise ValueError("edit=True needs concat_channels = the edit-image "
                         "latents [B,h,w,4]")
    if cfg.is_refiner:
        raise ValueError("InstructPix2Pix applies to the base/family UNets")
    if cfg.in_channels != 4 + concat_channels.shape[-1]:
        raise ValueError(
            "InstructPix2Pix needs an 8-channel edit UNet (in_channels="
            f"{cfg.in_channels}; e.g. timbrooks/instruct-pix2pix)")
    if inpaint or controlnet is not None or deepcache is not None:
        raise ValueError("InstructPix2Pix is not combinable with the "
                         "inpaint pin / ControlNet / DeepCache")
    if pag_scale or ip is not None:
        raise ValueError("InstructPix2Pix is not combinable with PAG or "
                         "IP-Adapter")
    if guidance_rescale and use_cfg:
        raise ValueError("guidance_rescale does not apply to the ip2p "
                         "3-way CFG")


def _control_window_scales(n: int, scale, window) -> np.ndarray:
    """Each step's ControlNet scale on the host: ``scale`` where step i
    lies in the (start, end) fraction window, 0 elsewhere (diffusers'
    controlnet_keep: i / n >= start and (i + 1) / n <= end). Several nets:
    ``scale`` and ``window`` sequences of N -> [n, N], a column a net."""
    if isinstance(scale, (tuple, list)):
        return np.stack([_control_window_scales(n, s, w)
                         for s, w in zip(scale, window)], axis=1)
    start, end = window
    keep = np.array([0.0 if (i / n < start or (i + 1) / n > end) else 1.0
                     for i in range(n)], np.float32)
    return keep * np.float32(scale)


def _control_setup(controlnet, control_image, ctx2, compute_dtype, use_cfg,
                   n: int, scale, window):
    """The loop-invariant ControlNet work of a request: for each trunk
    (one, or a sequence with a sequence of images) its conditioning-image
    embedding (doubled for the CFG pair) and cross-attention K/V; and each
    step's scales, [n, N] on the host. (None, None) without a ControlNet."""
    if controlnet is None:
        return None, None
    multi = isinstance(controlnet, (tuple, list))
    nets = tuple(controlnet) if multi else (controlnet,)
    images = tuple(control_image) if multi else (control_image,)
    control = []
    for net, image in zip(nets, images):
        emb = control_cond_embed(net, image.to(compute_dtype))
        if use_cfg:
            emb = torch.cat([emb, emb], dim=0)
        control.append((net, emb, precompute_cross_kv(net, ctx2)))
    scales = _control_window_scales(n, scale, window)
    return control, (scales if multi else scales[:, None])


def _merge_ip(cross_kv, ip, cfg: DiffuserConfig, cond: Conditioning,
              compute_dtype: torch.dtype, use_cfg: bool):
    """The cross K/V with IP-Adapter's image-token K/V merged in
    (models/ip_adapter.py merge_ip_kv). ip: {"layers": organize_ip_layers'
    tree, "tokens": [1 or B, n, d], "tokens_uncond": the unconditional
    rows' tokens, "scale": float}, paired [uncond | cond] as the text
    context is."""
    if ip is None:
        return cross_kv
    from ..models.ip_adapter import merge_ip_kv

    tok = ip["tokens"]
    tok = tok.expand(cond.batch, *tok.shape[1:])
    if use_cfg and not cfg.is_refiner:
        tok = torch.cat([ip["tokens_uncond"].expand_as(tok), tok], dim=0)
    return merge_ip_kv(cross_kv, ip["layers"], tok.to(compute_dtype),
                       ip["scale"])


def _check_extensions(pag_scale, deepcache, controlnet) -> None:
    if pag_scale and (controlnet is not None or deepcache is not None):
        raise ValueError("pag_scale is not combinable with ControlNet or "
                         "deepcache")


def _guided_setup(unet, cfg, cond, compute_dtype, use_cfg, concat_channels,
                  ip=None, edit: bool = False):
    """The loop-invariant contexts (rows3 for InstructPix2Pix), their
    cross-attention K/V with IP-Adapter's merged in, and the concat
    channels (doubled where the CFG pair runs; [zeros | image | image]
    for InstructPix2Pix)."""
    edit3 = edit and use_cfg and not cfg.is_refiner
    ctx2, ch2 = _cfg_contexts(cfg, cond, compute_dtype, use_cfg, edit3)
    cc = concat_channels
    if cc is not None and use_cfg and not cfg.is_refiner:
        cc = torch.cat([torch.zeros_like(cc), cc, cc] if edit3 else [cc, cc],
                       dim=0)
    cross_kv = _merge_ip(precompute_cross_kv(unet, ctx2), ip, cfg, cond,
                         compute_dtype, use_cfg)
    return ctx2, ch2, cross_kv, cc


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
                   step_noise: Optional[torch.Tensor] = None,
                   deepcache: Optional[Tuple[int, int]] = None,
                   pag_scale: float = 0.0,
                   preview_every: Optional[int] = None,
                   preview_callback: Optional[PreviewFn] = None,
                   controlnet=None,
                   control_image: Optional[torch.Tensor] = None,
                   control_scale=1.0, control_window=(0.0, 1.0), ip=None,
                   edit: bool = False, image_guidance_scale: float = 1.5,
                   preview_factors: Optional[np.ndarray] = None
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
    use_cfg=False: the conditional rows alone; guidance_rescale and
    pag_scale: see _cfg_eps. deepcache (interval, branch): DeepCache
    (arXiv:2312.00858), the whole UNet every interval-th step (step 0
    first), the ``branch`` shallowest blocks around the cached deep
    feature on the others; interval 1 is the plain loop's math.
    head_steps > 0: run only the grid's first head_steps entries, ending
    at the handoff level alpha(ts[head_steps]); tail_from > 0: run the
    suffix ts[tail_from:] from the still-noisy handoff latent.
    preview_every: after every preview_every steps but the last,
    preview_callback(done, total, [B, h, w, 3] uint8) gets
    latent_to_preview of the latent by preview_factors (a host copy); the
    final latent is the one the same request gives without previews, bit
    for bit.
    controlnet (a ControlNet or a sequence), control_image ([B, 8h, 8w, 3]
    in [0, 1], or a sequence), control_scale and control_window (floats
    and (start, end), or sequences): ControlNet guidance over the steps
    this call runs. ip: IP-Adapter (_merge_ip). edit (InstructPix2Pix):
    concat_channels are the unscaled edit latents [B, h, w, 4] of an
    8-channel UNet, guided by image_guidance_scale and guidance_scale."""
    _check_extensions(pag_scale, deepcache, controlnet)
    n_train = alphas_cumprod.shape[0]
    if cfg.n_steps != n_train:
        raise ValueError(
            f"DiffuserConfig.n_steps={cfg.n_steps} does not match the "
            f"alphas_cumprod table length {n_train}")
    _check_preview(preview_every)
    step_size = n_train // n_steps
    ts_np = ddim_timesteps(step_start, n_steps, n_train)
    _check_split(len(ts_np), head_steps, tail_from)
    ts_np = ts_np[tail_from:]
    total = len(ts_np)
    device = alphas_cumprod.device
    ts = torch.as_tensor(ts_np, dtype=torch.long, device=device)
    a_t = alphas_cumprod[ts]
    one = torch.ones((), dtype=alphas_cumprod.dtype, device=device)
    a_prev = torch.where(ts >= step_size,
                         alphas_cumprod[(ts - step_size).clamp(min=0)], one)

    lat = latent.float()
    want = (total, *lat.shape)
    if inpaint:
        reference = reference.float()
        pin_noise = _draws(pin_noise, generator, want, device, "pin_noise")
    if ddim_eta > 0:
        step_noise = _draws(step_noise, generator, want, device, "step_noise")

    if edit:
        _edit_validate(cfg, concat_channels, inpaint, controlnet, deepcache,
                       pag_scale, ip, guidance_rescale, use_cfg)
    ctx2, ch2, cross_kv, cc = _guided_setup(unet, cfg, cond, compute_dtype,
                                            use_cfg, concat_channels, ip,
                                            edit)
    control, scales = _control_setup(
        controlnet, control_image, ctx2, compute_dtype,
        use_cfg and not cfg.is_refiner, total, control_scale, control_window)
    if deepcache is not None:
        dc_eps = _deepcache_eps(
            unet, cfg, ctx2, ch2, guidance_scale, compute_dtype, cross_kv,
            use_cfg, guidance_rescale,
            _deepcache_validate(deepcache, controlnet, concat_channels))

        def eps_fn(x, t, alpha, i):
            return dc_eps(x, t, alpha)
    else:
        def eps_fn(x, t, alpha, i):
            return _cfg_eps(unet, cfg, x, t, ctx2, ch2, guidance_scale,
                            compute_dtype, cross_kv, cc, use_cfg,
                            guidance_rescale, pag_scale=pag_scale,
                            control=control,
                            control_scale=None if control is None
                            else scales[i],
                            image_scale=image_guidance_scale if edit
                            else None, alpha_t=alpha)
    for i in range(head_steps or total):
        alpha = a_t[i]
        if inpaint:
            noised_ref = (reference * torch.sqrt(alpha)
                          + pin_noise[i] * torch.sqrt(1.0 - alpha))
            lat = inpaint_pin(mask, lat, noised_ref)
        eps = eps_fn(lat, ts[i], alpha, i)
        x0 = (lat - eps * torch.sqrt(1.0 - alpha)) / torch.sqrt(alpha)
        lat = _ddim_update(x0, eps, alpha, a_prev[i], ddim_eta,
                           None if step_noise is None else step_noise[i])
        done = i + 1
        if preview_every and done % preview_every == 0 and done < total \
                and preview_callback is not None:
            preview_callback(done, total,
                             latent_to_preview(lat, preview_factors))
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
                     head_steps: int = 0, tail_from: int = 0,
                     deepcache: Optional[Tuple[int, int]] = None,
                     pag_scale: float = 0.0,
                     preview_every: Optional[int] = None,
                     preview_callback: Optional[PreviewFn] = None,
                     controlnet=None,
                     control_image: Optional[torch.Tensor] = None,
                     control_scale=1.0, control_window=(0.0, 1.0), ip=None,
                     edit: bool = False, image_guidance_scale: float = 1.5,
                     preview_factors: Optional[np.ndarray] = None
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
    but once on the last (see k_sample). pag_scale, deepcache: as
    diffuse_latent's (deepcache refuses the methods with a second
    evaluation, lms's history and CFG++). preview_every: as
    diffuse_latent's, the preview of the VP latent lat / sqrt(sigma^2 +
    1) at the step's sigma_next. controlnet, control_*, ip, edit: as
    diffuse_latent's (a step's second evaluation takes its step's control
    scale)."""
    if method not in K_SAMPLERS:
        raise ValueError(
            f"unknown k-sampler {method!r} ({'|'.join(K_SAMPLERS)})")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r} "
                         f"({'|'.join(SCHEDULES)})")
    _check_extensions(pag_scale, deepcache, controlnet)
    _check_preview(preview_every)
    ts, sigmas = k_schedule(alphas_cumprod, step_start, n_steps, schedule)
    _check_split(len(ts), head_steps, tail_from)
    ts, sigmas = ts[tail_from:], sigmas[tail_from:]
    if method == "euler_cfgpp" and (cfg.is_refiner or not use_cfg):
        method = "euler"  # unguided, eps_u == eps: CFG++ is Euler
    cfgpp = method == "euler_cfgpp"
    if deepcache is not None:
        if cfgpp:
            raise ValueError("euler_cfgpp is not combinable with deepcache "
                             "(the cached-step eps path has no uncond "
                             "split)")
        if method == "heun" or method in K_MID:
            raise ValueError(f"{method} (two UNet evals per step) is not "
                             "combinable with deepcache")
        if method == "lms":
            raise ValueError("lms (4-deep derivative history) is not "
                             "combinable with deepcache")
        deepcache = _deepcache_validate(deepcache, controlnet,
                                        concat_channels)
    if edit:
        if cfgpp:
            raise ValueError("euler_cfgpp does not apply to the ip2p 3-way "
                             "CFG (no single uncond direction)")
        _edit_validate(cfg, concat_channels, inpaint, controlnet, deepcache,
                       pag_scale, ip, guidance_rescale, use_cfg)

    device = latent.device
    lat = latent.float()
    total = len(ts)
    want = (total, *lat.shape)
    pin = None
    if inpaint:
        reference = reference.float()
        pin_noise = _draws(pin_noise, generator, want, device, "pin_noise")

        def pin(x, i, sigma):
            return inpaint_pin(mask, x, reference + sigma * pin_noise[i])
    if method in K_STOCHASTIC:
        step_noise = _draws(step_noise, generator, want, device, "step_noise")

    ctx2, ch2, cross_kv, cc = _guided_setup(unet, cfg, cond, compute_dtype,
                                            use_cfg, concat_channels, ip,
                                            edit)
    control, scales = _control_setup(
        controlnet, control_image, ctx2, compute_dtype,
        use_cfg and not cfg.is_refiner, total, control_scale, control_window)
    if deepcache is not None:
        dc_eps = _deepcache_eps(unet, cfg, ctx2, ch2, guidance_scale,
                                compute_dtype, cross_kv, use_cfg,
                                guidance_rescale, deepcache)

        def eps_fn(x, sigma, t, i):
            return dc_eps(x / torch.sqrt(sigma ** 2 + 1.0), t,
                          1.0 / (sigma ** 2 + 1.0))
    else:
        def eps_fn(x, sigma, t, i):
            scaled = x / torch.sqrt(sigma ** 2 + 1.0)
            return _cfg_eps(unet, cfg, scaled, t, ctx2, ch2, guidance_scale,
                            compute_dtype, cross_kv, cc, use_cfg,
                            guidance_rescale, return_uncond=cfgpp,
                            pag_scale=pag_scale, control=control,
                            control_scale=None if control is None
                            else scales[i],
                            image_scale=image_guidance_scale if edit
                            else None, alpha_t=1.0 / (sigma ** 2 + 1.0))

    on_step = None
    if preview_every and preview_callback is not None:
        def on_step(done, x):
            if done % preview_every == 0 and done < total:
                vp = x / np.sqrt(float(sigmas[done]) ** 2 + 1.0)
                preview_callback(done, total,
                                 latent_to_preview(vp, preview_factors))

    return k_sample(eps_fn, lat, method, ts, sigmas,
                    sigmas_full=(sigma_table(alphas_cumprod)
                                 if method in K_MID else None),
                    step_noise=step_noise, pin=pin, head_steps=head_steps,
                    on_step=on_step)


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
                  step_noise: Optional[torch.Tensor] = None,
                  **extensions) -> torch.Tensor:
    """txt2img latent, with latent-mask inpainting when ``reference`` is
    given, then the DDIM loop (diffuse_latent). ``generator`` draws the
    initial noise unless ``initial_noise`` is given, then the pin noise
    and the eta step noise unless given. head_steps > 0: the
    ensemble-of-experts base stage. extensions: diffuse_latent's
    deepcache, pag_scale, previews, ControlNet, ip and edit keywords."""
    latent = (initial_noise if initial_noise is not None
              else gen_noise(generator, cond, alphas_cumprod.device))
    return diffuse_latent(
        unet, cfg, alphas_cumprod, latent, cond, guidance_scale, 0, n_steps,
        compute_dtype, inpaint=reference is not None, reference=reference,
        mask=mask, generator=generator, pin_noise=pin_noise,
        concat_channels=concat_channels, head_steps=head_steps,
        use_cfg=use_cfg, guidance_rescale=guidance_rescale,
        ddim_eta=ddim_eta, step_noise=step_noise, **extensions)


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
                        step_noise: Optional[torch.Tensor] = None,
                        **extensions) -> torch.Tensor:
    """txt2img (and latent-mask inpainting) with a k-sampler: the initial
    noise (``initial_noise`` or drawn from ``generator``) times the
    schedule's first sigma, then k_diffuse_latent, whose pin and step
    noise ``generator`` draws next unless given. head_steps > 0 returns
    the still-noisy sigma-space handoff latent. extensions:
    k_diffuse_latent's deepcache, pag_scale, previews, ControlNet, ip and
    edit keywords."""
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
        head_steps=head_steps, **extensions)


def refine_latent(unet: UNet, cfg: DiffuserConfig,
                  alphas_cumprod: torch.Tensor, latent: torch.Tensor,
                  cond: Conditioning, generator: Optional[torch.Generator],
                  guidance_scale: float = 7.5, step_start: int = 800,
                  n_steps: int = 30,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  noise: Optional[torch.Tensor] = None, renoise: bool = True,
                  tail_from: int = 0, use_cfg: bool = True,
                  guidance_rescale: float = 0.0, ddim_eta: float = 0.0,
                  step_noise: Optional[torch.Tensor] = None,
                  **extensions) -> torch.Tensor:
    """Refiner stage (and img2img on the base UNet): re-noise ``latent`` at
    t = n_train - step_start with ``noise`` (drawn from ``generator``
    when not given), then run the grid from step_start — whose first
    entry is t - 1, as in the reference. renoise=False with tail_from=h:
    ``latent`` is already the still-noisy handoff of a head_steps=h base
    run; continue the full grid's suffix (step_start 0). extensions
    (img2img and hires-fix; the refiner refuses PAG and gets no
    ControlNet): diffuse_latent's deepcache, pag_scale, ControlNet and ip
    keywords."""
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
                          ddim_eta=ddim_eta, step_noise=step_noise,
                          **extensions)


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
                    step_noise: Optional[torch.Tensor] = None,
                    **extensions) -> torch.Tensor:
    """The refiner stage (and img2img) with a k-sampler: re-noise the
    clean ``latent`` to the schedule's actual first sigma, x = latent +
    sigma_start * noise (``noise`` or drawn from ``generator``), then run
    the schedule's tail from step_start; the stochastic methods' step
    noise comes after. renoise=False with tail_from=h: ``latent`` is the
    still-noisy sigma-space handoff of a head_steps=h base run; continue
    the full schedule's suffix (step_start 0). extensions: see
    refine_latent."""
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
        guidance_rescale=guidance_rescale, tail_from=tail_from,
        **extensions)


# ---------------------------------------------------------------------------
# LCM (Latent Consistency Models, arXiv:2310.04378; LCM-LoRA
# arXiv:2311.05556): diffusers' LCMScheduler (set_timesteps' linspace index
# selection, the discrete boundary scalings, the per-step re-noise)
# ---------------------------------------------------------------------------

# the distilled model's DDIM grid (LCMScheduler's original_inference_steps)
LCM_ORIGINAL_STEPS = 50
# LCMScheduler's boundary-condition constants
LCM_TIMESTEP_SCALING = 10.0
LCM_SIGMA_DATA = 0.5


def lcm_timesteps(n_steps: int, original_steps: int = LCM_ORIGINAL_STEPS,
                  n_train: int = N_STEPS_TOTAL,
                  strength: float = 1.0) -> np.ndarray:
    """LCMScheduler.set_timesteps: the distilled model's
    ``original_steps``-point DDIM grid (t = k*i - 1, k = n_train //
    original_steps), windowed by ``strength``; n_steps of its points by
    floor(linspace) indexing over the descending grid."""
    k = n_train // original_steps
    n_origin = max(int(original_steps * strength), 1)
    origin = (np.arange(1, n_origin + 1, dtype=np.int64) * k - 1)[::-1]
    if n_steps > len(origin):
        raise ValueError(
            f"LCM: n_steps={n_steps} exceeds the trained grid "
            f"({len(origin)} points at original_steps={original_steps}, "
            f"strength={strength})")
    idx = np.floor(np.linspace(0, len(origin), num=n_steps,
                               endpoint=False)).astype(np.int64)
    return origin[idx].astype(np.int32)


def lcm_step_update(lat, eps, alpha, alpha_prev, t, noise, is_last: bool):
    """One LCMScheduler.step (epsilon prediction): the consistency
    function f = c_skip(t) * x + c_out(t) * x0 with the discrete boundary
    scalings, then, unless this is the last step, the re-noise to the
    next grid point sqrt(a_prev) * f + sqrt(1 - a_prev) * noise. Returns
    (next latent, f)."""
    x0 = (lat - torch.sqrt(1.0 - alpha) * eps) / torch.sqrt(alpha)
    st = torch.as_tensor(t, dtype=torch.float32,
                         device=lat.device) * LCM_TIMESTEP_SCALING
    c_skip = LCM_SIGMA_DATA ** 2 / (st ** 2 + LCM_SIGMA_DATA ** 2)
    c_out = st / torch.sqrt(st ** 2 + LCM_SIGMA_DATA ** 2)
    denoised = c_out * x0 + c_skip * lat
    if is_last:
        return denoised, denoised
    return (torch.sqrt(alpha_prev) * denoised
            + torch.sqrt(1.0 - alpha_prev) * noise), denoised


def lcm_guidance_add(unet: UNet, cfg: DiffuserConfig, guidance_scale: float,
                     compute_dtype: torch.dtype) -> Optional[torch.Tensor]:
    """An LCM-distilled UNet's t_add [1, model_channels]: the guidance
    embedding of w = guidance_scale - 1 (f32) through cond_proj, once a
    request. None for a UNet without cond_proj."""
    if not cfg.time_cond_proj_dim:
        return None
    device = next(unet.parameters()).device
    w = torch.tensor(guidance_scale, dtype=torch.float32) - 1.0
    w_emb = guidance_scale_embedding(w, cfg.time_cond_proj_dim)
    return unet.time_embed["cond_proj"](w_emb.to(device, compute_dtype))


@torch.no_grad()
def lcm_diffuse_latent(unet: UNet, cfg: DiffuserConfig,
                       alphas_cumprod: torch.Tensor, latent: torch.Tensor,
                       cond: Conditioning, guidance_scale: float,
                       generator: Optional[torch.Generator] = None,
                       n_steps: int = 4, strength: float = 1.0,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       inpaint: bool = False,
                       reference: Optional[torch.Tensor] = None,
                       mask: Optional[torch.Tensor] = None,
                       use_cfg: bool = False,
                       concat_channels: Optional[torch.Tensor] = None,
                       pin_noise: Optional[torch.Tensor] = None,
                       step_noise: Optional[torch.Tensor] = None,
                       controlnet=None,
                       control_image: Optional[torch.Tensor] = None,
                       control_scale=1.0, control_window=(0.0, 1.0),
                       ip=None) -> torch.Tensor:
    """The LCM loop over lcm_timesteps' grid. An LCM-distilled UNet
    (cfg.time_cond_proj_dim > 0) embeds the guidance (w = guidance_scale
    - 1) through cond_proj and runs without CFG; a standard UNet
    (LCM-LoRA) may run the CFG pair at a small scale. Each step but the
    last re-noises with step_noise[i] ([n, B, h, w, 4], or n draws from
    ``generator`` after the pin noise's); inpaint pins as DDIM does, with
    pin_noise[i]. strength < 1 windows the grid (img2img): ``latent`` is
    already noised to its first point. controlnet, control_*, ip: as
    diffuse_latent's."""
    n_train = alphas_cumprod.shape[0]
    if cfg.n_steps != n_train:
        raise ValueError(
            f"DiffuserConfig.n_steps={cfg.n_steps} does not match the "
            f"alphas_cumprod table length {n_train}")
    if cfg.time_cond_proj_dim and use_cfg:
        raise ValueError(
            "LCM-distilled UNets (time_cond_proj_dim > 0) embed guidance; "
            "run them with use_cfg=False")
    if cfg.is_refiner:
        raise ValueError("LCM sampling applies to the base/family UNets, "
                         "not the SDXL refiner")
    ts_np = lcm_timesteps(n_steps, LCM_ORIGINAL_STEPS, n_train, strength)
    n = len(ts_np)
    device = alphas_cumprod.device
    ts = torch.as_tensor(ts_np, dtype=torch.long, device=device)
    a_t = alphas_cumprod[ts]
    # the next grid point's alpha (not read on the last step)
    a_prev = torch.cat([alphas_cumprod[ts[1:]], a_t[-1:]])

    lat = latent.float()
    want = (n, *lat.shape)
    if inpaint:
        reference = reference.float()
        pin_noise = _draws(pin_noise, generator, want, device, "pin_noise")
    step_noise = _draws(step_noise, generator, want, device, "step_noise")
    ctx2, ch2, cross_kv, cc = _guided_setup(unet, cfg, cond, compute_dtype,
                                            use_cfg, concat_channels, ip)
    control, scales = _control_setup(controlnet, control_image, ctx2,
                                     compute_dtype, use_cfg, n,
                                     control_scale, control_window)
    t_add = lcm_guidance_add(unet, cfg, guidance_scale, compute_dtype)
    for i in range(n):
        alpha = a_t[i]
        if inpaint:
            noised_ref = (reference * torch.sqrt(alpha)
                          + pin_noise[i] * torch.sqrt(1.0 - alpha))
            lat = inpaint_pin(mask, lat, noised_ref)
        eps = _cfg_eps(unet, cfg, lat, ts[i], ctx2, ch2, guidance_scale,
                       compute_dtype, cross_kv, cc, use_cfg, t_add=t_add,
                       control=control, control_scale=None
                       if control is None else scales[i], alpha_t=alpha)
        lat, _ = lcm_step_update(lat, eps, alpha, a_prev[i], ts[i],
                                 step_noise[i], i == n - 1)
    return lat


def lcm_sample_latent(unet: UNet, cfg: DiffuserConfig, alphas_cumprod,
                      cond: Conditioning,
                      generator: Optional[torch.Generator],
                      guidance_scale: float = 7.5, n_steps: int = 4,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      reference: Optional[torch.Tensor] = None,
                      mask: Optional[torch.Tensor] = None,
                      use_cfg: bool = False,
                      concat_channels: Optional[torch.Tensor] = None,
                      initial_noise: Optional[torch.Tensor] = None,
                      pin_noise: Optional[torch.Tensor] = None,
                      step_noise: Optional[torch.Tensor] = None,
                      **extensions) -> torch.Tensor:
    """LCM txt2img (and latent-mask inpainting when ``reference`` and
    ``mask`` are given) from N(0, 1) noise (LCMScheduler's
    init_noise_sigma is 1): ``initial_noise`` or drawn from
    ``generator``, then lcm_diffuse_latent (extensions: its ControlNet
    and ip keywords)."""
    latent = (initial_noise if initial_noise is not None
              else gen_noise(generator, cond, alphas_cumprod.device))
    return lcm_diffuse_latent(
        unet, cfg, alphas_cumprod, latent, cond, guidance_scale, generator,
        n_steps, 1.0, compute_dtype,
        inpaint=reference is not None and mask is not None,
        reference=reference, mask=mask, use_cfg=use_cfg,
        concat_channels=concat_channels, pin_noise=pin_noise,
        step_noise=step_noise, **extensions)


def lcm_refine_latent(unet: UNet, cfg: DiffuserConfig, alphas_cumprod,
                      latent: torch.Tensor, cond: Conditioning,
                      generator: Optional[torch.Generator],
                      guidance_scale: float = 7.5, strength: float = 0.3,
                      n_steps: int = 4,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      use_cfg: bool = False,
                      noise: Optional[torch.Tensor] = None,
                      step_noise: Optional[torch.Tensor] = None,
                      **extensions) -> torch.Tensor:
    """LCM img2img: the grid windowed by ``strength`` (at most
    int(LCM_ORIGINAL_STEPS * strength) steps), the clean ``latent`` noised to
    its first point with ``noise`` (or a draw from ``generator``), then
    the loop (extensions: its ControlNet and ip keywords)."""
    n_train = alphas_cumprod.shape[0]
    eff_steps = min(n_steps, max(1, int(LCM_ORIGINAL_STEPS * strength)))
    ts = lcm_timesteps(eff_steps, LCM_ORIGINAL_STEPS, n_train, strength)
    if noise is None:
        noise = torch.randn(latent.shape, generator=generator,
                            dtype=torch.float32, device=latent.device)
    a0 = alphas_cumprod[int(ts[0])]
    noised = (latent.float() * torch.sqrt(a0)
              + noise.to(latent.device).float() * torch.sqrt(1.0 - a0))
    return lcm_diffuse_latent(
        unet, cfg, alphas_cumprod, noised, cond, guidance_scale, generator,
        eff_steps, strength, compute_dtype, use_cfg=use_cfg,
        step_noise=step_noise, **extensions)


# ---------------------------------------------------------------------------
# DDIM inversion
# ---------------------------------------------------------------------------

@torch.no_grad()
def ddim_invert_latent(unet: UNet, cfg: DiffuserConfig,
                       alphas_cumprod: torch.Tensor, latent: torch.Tensor,
                       cond: Conditioning, guidance_scale: float = 1.0,
                       n_steps: int = 50,
                       compute_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    """DDIM inversion (diffusers' DDIMInverseScheduler, the null-text
    inversion loop, arXiv:2211.09794): the sampling grid ascending; at
    each point t the model's eps at t steps from alpha(t - step_size) up
    to alpha(t): x0 = (x - sqrt(1 - a_src) eps) / sqrt(a_src), x =
    sqrt(a_dst) x0 + sqrt(1 - a_dst) eps. Exact when eps is constant in
    x; txt2img(initial_latent=...) with the same n_steps and DDIM then
    regenerates the image. guidance_scale != 1 inverts the guided field
    (the CFG pair); 1, the faithful setting, the conditional rows alone."""
    n_train = alphas_cumprod.shape[0]
    if cfg.n_steps != n_train:
        raise ValueError(
            f"DiffuserConfig.n_steps={cfg.n_steps} does not match the "
            f"alphas_cumprod table length {n_train}")
    step_size = n_train // n_steps
    device = alphas_cumprod.device
    ts = torch.as_tensor(ddim_timesteps(0, n_steps, n_train)[::-1].copy(),
                         dtype=torch.long, device=device)
    a_dst = alphas_cumprod[ts]
    one = torch.ones((), dtype=alphas_cumprod.dtype, device=device)
    a_src = torch.where(ts >= step_size,
                        alphas_cumprod[(ts - step_size).clamp(min=0)], one)
    lat = latent.float()
    use_cfg = guidance_scale != 1.0
    ctx2, ch2, cross_kv, _ = _guided_setup(unet, cfg, cond, compute_dtype,
                                           use_cfg, None)
    for i in range(len(ts)):
        eps = _cfg_eps(unet, cfg, lat, ts[i], ctx2, ch2, guidance_scale,
                       compute_dtype, cross_kv, use_cfg=use_cfg,
                       alpha_t=a_src[i])
        x0 = (lat - eps * torch.sqrt(1.0 - a_src[i])) / torch.sqrt(a_src[i])
        lat = x0 * torch.sqrt(a_dst[i]) + eps * torch.sqrt(1.0 - a_dst[i])
    return lat
