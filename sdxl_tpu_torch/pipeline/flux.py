"""FLUX.1 pipeline: prompt -> uint8 images through the FLUX.1 transformer
(counterpart of sdxl_tpu/pipeline/flux.py; the public FluxPipeline's
semantics).

- conditioning: T5's final hidden (512 tokens for dev, 256 for schnell)
  as the token stream and CLIP-L's UNPROJECTED pooler_output as the
  pooled vector; no CFG pair by default: dev embeds the guidance scale,
  schnell ignores it. ``true_cfg_scale`` > 1 with a negative prompt runs
  the public pipeline's true CFG, pair-batched, on top of the embedded
  guidance;
- the schedule (``flux_schedule``): sigmas = linspace(1, 1/n, n) under
  the dynamic exp shift, mu linear in the packed token count between
  (256, base_shift) and (4096, max_shift); schnell's static shift 1 is
  the identity;
- img2img, inpainting (the pin_* blending of pipeline/flow_match.py) and
  Kontext in-context editing (``kontext``: the clean reference latent
  rides the sequence after the target tokens with RoPE id axis 0 = 1);
- the 16-channel VAE in f32 without quant convs: decode sees latent /
  0.3611 + 0.1159.

``t5_offload`` keeps T5 parked on the host and moves it to the card for
each conditioning call and back after it (load_flux_pipeline sets it when
the quantized transformer and T5 together exceed the card's budget, the
reference's rule).

Noise, and what is not ported, as in pipeline/sd3.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..configs import (
    CLIP_VIT_L_CONFIG,
    FLUX_BASE_SHIFT,
    FLUX_MAX_SHIFT,
    FLUX_VAE_SCALE,
    FLUX_VAE_SHIFT,
    AutoencoderConfig,
    CLIPConfig,
    FluxConfig,
    T5Config,
)
from ..io.quantize import parse_quantize_spec, quantize_model
from ..models.clip import CLIPTextModel, clip_hidden_pooled
from ..models.flux import Flux, flux_forward
from ..models.layers import init_reference_
from ..models.t5 import T5Encoder, init_t5_, t5_encode
from ..models.vae import VAEDecoder, VAEEncoder
from ..tokenizer import ClipTokenizer
from ..utils import StageTimer, fence, log
from ..utils.memory import memory_budget_bytes, module_device, param_bytes
from .flow_match import (
    FlowPipelineBase,
    _prompts,
    draw_noise,
    euler_loop,
    fm_window,
    sd3_vae_config,
    stub_t5_tokenizer,
)
from .masks import build_latent_mask


def flux_schedule(n_steps: int, image_seq_len: int,
                  base_shift: float = FLUX_BASE_SHIFT,
                  max_shift: float = FLUX_MAX_SHIFT, dynamic: bool = True,
                  shift: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """(timesteps [n] = sigma * 1000, sigmas [n + 1] ending in 0), f32,
    descending."""
    sigmas = np.linspace(1.0, 1.0 / n_steps, n_steps, dtype=np.float64)
    if dynamic:
        m = (max_shift - base_shift) / (4096 - 256)
        b = base_shift - m * 256
        mu = image_seq_len * m + b
        sigmas = np.exp(mu) / (np.exp(mu) + (1.0 / sigmas - 1.0))
    else:
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    timesteps = (sigmas * 1000.0).astype(np.float32)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return timesteps, sigmas


@torch.no_grad()
def flux_diffuse_latent(
    model: Flux,
    latent: torch.Tensor,     # [B, h, w, 16], noise at sigmas[0]
    context: torch.Tensor,    # [B or 2B, T, joint_dim]
    pooled: torch.Tensor,     # [B or 2B, pooled_dim]
    guidance: torch.Tensor,   # [B] guidance scale (ignored by schnell)
    timesteps: np.ndarray,    # [n] sigma * 1000
    sigmas: np.ndarray,       # [n + 1]
    pin_reference: Optional[torch.Tensor] = None,
    pin_mask: Optional[torch.Tensor] = None,
    pin_noise: Optional[torch.Tensor] = None,
    true_cfg_scale: Optional[float] = None,
    cond_latent: Optional[torch.Tensor] = None,  # Kontext reference
) -> torch.Tensor:
    """The FLUX.1 flow-matching Euler run in the transformer's dtype: one
    call a step, or with a ``true_cfg_scale`` one pair-batched call over
    [uncond | cond] context, v = u + (c - u) * true_cfg_scale (the
    embedded guidance applies to both halves)."""
    dtype = model.dtype
    ctx, pld = context.to(dtype), pooled.to(dtype)
    g = (guidance.float() * 1000.0 if model.cfg.guidance_embeds else None)
    cond = cond_latent.to(dtype) if cond_latent is not None else None
    true_cfg = true_cfg_scale is not None
    if true_cfg:
        g = torch.cat([g, g]) if g is not None else None
        cond = torch.cat([cond, cond]) if cond is not None else None
    b = latent.shape[0]

    def velocity(lat, i, t):
        x = torch.cat([lat, lat]) if true_cfg else lat
        t_vec = torch.full((x.shape[0],), t, dtype=torch.float32,
                           device=lat.device)
        v = flux_forward(model, x.to(dtype), t_vec, ctx, pld, guidance=g,
                         cond_latent=cond).float()
        if not true_cfg:
            return v
        vu, vc = v[:b], v[b:]
        return vu + (vc - vu) * true_cfg_scale

    return euler_loop(velocity, latent, timesteps, sigmas, pin_reference,
                      pin_mask, pin_noise)


@dataclass
class FluxPipeline(FlowPipelineBase):
    flux: Flux = None
    clip: CLIPTextModel = None
    t5: T5Encoder = None
    # list[str] -> [B, t5_tokens] int32 ids
    t5_tokenize: Callable = None
    clip_tokenizer: object = None
    t5_tokens: int = 512  # max_sequence_length: 512 dev, 256 schnell
    base_shift: float = FLUX_BASE_SHIFT
    max_shift: float = FLUX_MAX_SHIFT
    dynamic_shifting: bool = True  # schnell: the static shift
    static_shift: float = 1.0
    timer: StageTimer = field(default_factory=StageTimer)
    last_latent: Optional[torch.Tensor] = None
    # T5 parked on the host, on the card only during a conditioning call
    t5_offload: bool = False

    def _encode_prompts(self, texts):
        ids = self._ids(self.clip_tokenizer, texts, self.clip.cfg.n_ctx)
        # CLIPTextModel's pooler_output: no text_projection
        _, pooled = clip_hidden_pooled(self.clip, ids,
                                       self.clip.cfg.n_layer - 1,
                                       project=False)
        if not self.t5_offload:
            return t5_encode(self.t5, self._t5_ids(texts)), pooled
        home = module_device(self.t5)
        self.t5.to(self.device)
        try:
            ctx = t5_encode(self.t5, self._t5_ids(texts))
            fence(ctx)
        finally:
            self.t5.to(home)
        return ctx, pooled

    @torch.no_grad()
    def conditioning(self, prompts, negative_prompt: Optional[str] = None):
        """([B, t5_tokens, 4096] T5 stream, [B, 768] pooled); with a
        negative_prompt (true CFG) both [uncond | cond]."""
        prompts = _prompts(prompts)
        with self.timer.stage("embedder"):
            ctx, pooled = self._encode_prompts(prompts)
            if negative_prompt is not None:
                ctx_u, pool_u = self._encode_prompts(
                    [negative_prompt] * len(prompts))
                ctx = torch.cat([ctx_u, ctx])
                pooled = torch.cat([pool_u, pooled])
            fence(ctx)
        return ctx, pooled

    def _schedule(self, n_steps, h, w):
        return flux_schedule(n_steps, (h // 16) * (w // 16), self.base_shift,
                             self.max_shift, self.dynamic_shifting,
                             self.static_shift)

    def _run(self, lat, ctx, pooled, guidance_scale, ts, sigmas, **kw):
        g = torch.full((lat.shape[0],), float(guidance_scale),
                       dtype=torch.float32, device=self.device)
        with self.timer.stage("diffuser"):
            lat = flux_diffuse_latent(self.flux, lat, ctx, pooled, g, ts,
                                      sigmas, **kw)
            fence(lat)
        return self._decode(lat)

    @staticmethod
    def _true_cfg(negative_prompt, true_cfg_scale) -> Optional[float]:
        """The true-CFG scale, or None: true CFG runs with a negative
        prompt and a scale above 1, as in the public pipeline."""
        if negative_prompt and true_cfg_scale > 1.0:
            return float(true_cfg_scale)
        return None

    @staticmethod
    def _check16(h, w, what):
        if h % 16 or w % 16:
            raise ValueError(f"{what} {h}x{w} must be a multiple of 16 "
                             "(2x2-packed 16-ch latent)")

    def txt2img(self, prompts, resolution: Tuple[int, int] = (1024, 1024),
                n_steps: int = 28, guidance_scale: float = 3.5,
                seed: int = 0, negative_prompt: str = "",
                true_cfg_scale: float = 1.0) -> np.ndarray:
        h, w = resolution
        self._check16(h, w, "resolution")
        prompts = _prompts(prompts)
        tc = self._true_cfg(negative_prompt, true_cfg_scale)
        ctx, pooled = self.conditioning(
            prompts, negative_prompt if tc is not None else None)
        lat = draw_noise((len(prompts), h // 8, w // 8,
                          self.vae.cfg.latent_channels), seed, self.device)
        ts, sigmas = self._schedule(n_steps, h, w)
        return self._run(lat, ctx, pooled, guidance_scale, ts, sigmas,
                         true_cfg_scale=tc)

    def kontext(self, prompts, edit_images: np.ndarray,
                resolution: Optional[Tuple[int, int]] = None,
                n_steps: int = 28, guidance_scale: float = 2.5,
                seed: int = 0, negative_prompt: str = "",
                true_cfg_scale: float = 1.0) -> np.ndarray:
        """FLUX.1 Kontext in-context editing (FluxKontextPipeline): the
        edit image's clean latent joins the sequence after the target
        tokens, its RoPE ids offset (axis 0 = 1), fixed every step; the
        target starts from pure noise at ``resolution`` (default: the
        edit image's size); mu follows the target's token count. Default
        guidance 2.5 (the Kontext release's)."""
        prompts = _prompts(prompts)
        eh, ew = edit_images.shape[1:3]
        self._check16(eh, ew, "edit image")
        h, w = resolution if resolution is not None else (eh, ew)
        self._check16(h, w, "resolution")
        tc = self._true_cfg(negative_prompt, true_cfg_scale)
        ctx, pooled = self.conditioning(
            prompts, negative_prompt if tc is not None else None)
        cond = self._encode(edit_images)
        lat = draw_noise((len(prompts), h // 8, w // 8,
                          self.vae.cfg.latent_channels), seed, self.device)
        if cond.shape[0] == 1 and len(prompts) > 1:
            cond = cond.expand(len(prompts), *cond.shape[1:])
        ts, sigmas = self._schedule(n_steps, h, w)
        return self._run(lat, ctx, pooled, guidance_scale, ts, sigmas,
                         true_cfg_scale=tc, cond_latent=cond)

    def img2img(self, prompts, reference_images: np.ndarray,
                strength: float = 0.6, n_steps: int = 28,
                guidance_scale: float = 3.5, seed: int = 0) -> np.ndarray:
        if not 0.0 < strength <= 1.0:
            raise ValueError("strength must be in (0, 1]")
        prompts = _prompts(prompts)
        ctx, pooled = self.conditioning(prompts)
        lat0 = self._encode(reference_images)
        h, w = reference_images.shape[1:3]
        ts, sigmas = self._schedule(n_steps, h, w)
        start = fm_window(n_steps, strength)
        lat, _ = self._noised(lat0, seed, float(sigmas[start]))
        return self._run(lat, ctx, pooled, guidance_scale, ts[start:],
                         sigmas[start:])

    def inpaint(self, prompts, reference_images: np.ndarray,
                mask_image: Optional[np.ndarray] = None,
                crop_left: Optional[int] = None,
                crop_right: Optional[int] = None,
                crop_top: Optional[int] = None,
                crop_bottom: Optional[int] = None, crop_out: bool = False,
                mask_blur: float = 0.0, strength: float = 1.0,
                n_steps: int = 28, guidance_scale: float = 3.5,
                seed: int = 0) -> np.ndarray:
        """Latent inpainting (FluxInpaintPipeline's blending), with the
        SD3 and SDXL families' mask surface (pipeline/masks.py)."""
        if not 0.0 < strength <= 1.0:
            raise ValueError("strength must be in (0, 1]")
        prompts = _prompts(prompts)
        _, height, width, _ = np.asarray(reference_images).shape
        self._check16(height, width, "reference image")
        mask = build_latent_mask(height, width, mask_image, crop_left,
                                 crop_right, crop_top, crop_bottom,
                                 crop_out, mask_blur=mask_blur)
        ctx, pooled = self.conditioning(prompts)
        lat0 = self._encode(reference_images)
        ts, sigmas = self._schedule(n_steps, height, width)
        start = fm_window(n_steps, strength)
        lat, noise = self._noised(lat0, seed, float(sigmas[start]))
        return self._run(lat, ctx, pooled, guidance_scale, ts[start:],
                         sigmas[start:], pin_reference=lat0,
                         pin_mask=torch.as_tensor(mask, device=self.device),
                         pin_noise=noise)


def random_flux_pipeline(
    seed: int = 0,
    *,
    device="cuda",
    flux_cfg: Optional[FluxConfig] = None,
    clip_cfg: Optional[CLIPConfig] = None,
    vae_cfg: Optional[AutoencoderConfig] = None,
    t5_cfg: Optional[T5Config] = None,
    t5_tokens: int = 512,
    flux_dtype: torch.dtype = torch.bfloat16,
    t5_dtype: torch.dtype = torch.float32,
    with_encoder: bool = True,
    tokenizer_dir: Optional[str] = None,
    quantize: Optional[str] = None,
) -> FluxPipeline:
    """FLUX.1 pipeline with random weights drawn on ``device`` from one
    seeded torch.Generator with the reference's init distributions, in
    this order: the transformer (flux_dtype), CLIP-L, T5 (t5_dtype; the
    reference's random T5 is f32), the VAE decoder and encoder (f32, with
    quant convs as the reference's init has them); the stub T5 tokenizer
    (``stub_t5_tokenizer``). Each module is built on the meta device and
    materialised on ``device`` before its draw. Schnell (guidance_embeds
    False) keeps the dynamic shift here, as the reference's random
    pipeline does. The configs default to FLUX.1-dev's (the transformer,
    CLIP-L, T5-XXL, the 16-channel VAE). quantize="int8"|"int4" then
    quantizes the drawn transformer's block linears (io/quantize.py), as
    the reference's random pipeline does; T5 stays as drawn."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    flux_cfg = flux_cfg or FluxConfig()
    clip_cfg = clip_cfg or CLIP_VIT_L_CONFIG
    vae_cfg = vae_cfg or sd3_vae_config()
    t5_cfg = t5_cfg or T5Config()
    log("initializing random FLUX.1 weights (no checkpoint)")

    def make(module, **kw):
        return init_reference_(module.to_empty(device=device), g, **kw)

    flux = make(Flux(flux_cfg, "meta", flux_dtype))
    if quantize is not None:
        quantize_model(flux, parse_quantize_spec(quantize))
    clip = make(CLIPTextModel(clip_cfg, "meta"))
    t5 = init_t5_(T5Encoder(t5_cfg, "meta", t5_dtype).to_empty(
        device=device), g)
    vae = make(VAEDecoder(vae_cfg, "meta"), conv_scale=0.05)
    encoder = (make(VAEEncoder(vae_cfg, "meta"), conv_scale=0.05)
               if with_encoder else None)
    for m in (flux, clip, t5, vae, encoder):
        if m is not None:
            m.eval().requires_grad_(False)
    return FluxPipeline(
        vae=vae, vae_encoder=encoder, scale_factor=FLUX_VAE_SCALE,
        shift_factor=FLUX_VAE_SHIFT, flux=flux, clip=clip, t5=t5,
        t5_tokenize=stub_t5_tokenizer(t5_tokens, t5_cfg.vocab_size),
        t5_tokens=t5_tokens, clip_tokenizer=ClipTokenizer(tokenizer_dir))


def load_flux_pipeline(
    model_dir: str,
    compute_dtype: torch.dtype = torch.bfloat16,
    tokenizer_dir: Optional[str] = None,
    t5_tokenize: Optional[Callable] = None,
    loras=None,
    quantize: Optional[str] = None,
    device="cuda",
) -> FluxPipeline:
    """Load a diffusers-layout FLUX.1 directory onto ``device``
    (io/flux.py): the transformer and T5 in compute_dtype, CLIP-L and the
    VAE in f32; the scheduler config's shifts. loras: (path, scale)
    files merged into the transformer (diffusers / peft keys, and kohya's
    BFL-named keys split onto the separate projections) and CLIP-L.

    quantize="int8"|"int4" stores the transformer's block linears
    quantized and T5's at int8 (io/quantize.py), after the LoRAs merge.
    Where the quantized transformer, T5, CLIP-L and the VAE together need
    more than the card's budget (utils/memory.py), T5 is parked on the
    host and ``t5_offload`` set."""
    from ..io.flux import load_flux_diffusers_dir

    bits = parse_quantize_spec(quantize)
    log(f"loading Flux diffusers checkpoint from {model_dir}")
    flux, clip, t5, t5_tok, vae, encoder, sched = load_flux_diffusers_dir(
        model_dir, compute_dtype, t5_tokenize, device=torch.device(device))
    if loras:
        from ..io.lora import apply_lora_files

        apply_lora_files(loras, transformer=flux, te1=clip)
    t5_offload = False
    if bits is not None:
        quantize_model(flux, bits)
        quantize_model(t5, 8)
        need = sum(param_bytes(m) for m in (flux, t5, clip, vae, encoder))
        if torch.device(device).type == "cuda" and \
                need > memory_budget_bytes(device):
            t5_offload = True
            t5.to("cpu")
            log(f"quantized towers need {need / 2**30:.1f} GiB > budget "
                f"{memory_budget_bytes(device) / 2**30:.1f} GiB: T5 stays "
                "host-parked and is moved per conditioning call "
                "(t5_offload)")
    return FluxPipeline(
        vae=vae, vae_encoder=encoder, scale_factor=FLUX_VAE_SCALE,
        shift_factor=FLUX_VAE_SHIFT, flux=flux, clip=clip, t5=t5,
        t5_tokenize=t5_tok,
        t5_tokens=512 if flux.cfg.guidance_embeds else 256,
        clip_tokenizer=ClipTokenizer(tokenizer_dir),
        base_shift=sched.get("base_shift", FLUX_BASE_SHIFT),
        max_shift=sched.get("max_shift", FLUX_MAX_SHIFT),
        dynamic_shifting=sched.get("use_dynamic_shifting", True),
        static_shift=sched.get("shift", 1.0), t5_offload=t5_offload)
