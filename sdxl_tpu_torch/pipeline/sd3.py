"""SD3 family pipeline: prompt -> uint8 images through the MMDiT and flow
matching (counterpart of sdxl_tpu/pipeline/sd3.py; the public
StableDiffusion3Pipeline's semantics).

- conditioning: [CLIP-L penultimate hidden (768) ++ CLIP-G penultimate
  hidden (1280)] zero-padded to 4096, then T5's 256 tokens of 4096 (zeros
  without the T5 tower, the public drop-T5 mode); pooled = CLIP-L pooled
  ++ CLIP-G pooled (2048). The towers run in f32, T5 in its own dtype;
- CFG pair-batched ([uncond | cond]) in one MMDiT call; ``no_cfg`` (or a
  guidance scale of 1) runs the cond half alone; skip-layer guidance
  (``slg_scale``) adds the SD3.5 perturbed branch;
- the flow-matching Euler loop of pipeline/flow_match.py in the MMDiT's
  dtype;
- the 16-channel VAE in f32: decode sees latent / 1.5305 + 0.0609, encode
  gives (posterior mean - 0.0609) * 1.5305.

Noise: ``draw_noise(shape, seed, device)`` gives the initial latent noise
(txt2img) or the img2img / inpainting noise; JAX and torch draws differ,
so one seed gives another image than the reference. Per-image seed lists
(module 16), device_output and shard() (module 17) are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import (
    CLIP_VIT_L_CONFIG,
    OPEN_CLIP_BIGG_CONFIG,
    SD3_FLOW_SHIFT,
    SD3_VAE_SCALE,
    SD3_VAE_SHIFT,
    AutoencoderConfig,
    CLIPConfig,
    MMDiTConfig,
    T5Config,
)
from ..io.quantize import parse_quantize_spec, quantize_model
from ..models.clip import CLIPTextModel, clip_hidden_pooled
from ..models.layers import init_reference_
from ..models.mmdit import MMDiT
from ..models.t5 import T5Encoder, init_t5_, t5_encode
from ..models.vae import VAEDecoder, VAEEncoder
from ..tokenizer import ClipTokenizer, OpenClipTokenizer
from ..utils import StageTimer, fence, log
from .flow_match import (
    FlowPipelineBase,
    _prompts,
    draw_noise,
    fm_diffuse_latent,
    fm_schedule,
    fm_window,
    sd3_vae_config,
    stub_t5_tokenizer,
)
from .masks import build_latent_mask

SD3_T5_TOKENS = 256  # the public pipeline's max_sequence_length


@dataclass
class SD3Pipeline(FlowPipelineBase):
    mmdit: MMDiT = None
    clip_l: CLIPTextModel = None
    clip_g: CLIPTextModel = None
    # the T5 tower is optional (the public pipeline's drop-T5 mode)
    t5: Optional[T5Encoder] = None
    # list[str] -> [B, SD3_T5_TOKENS] int32 ids
    t5_tokenize: Optional[Callable] = None
    clip_tokenizer: object = None
    open_clip_tokenizer: object = None
    flow_shift: float = SD3_FLOW_SHIFT
    timer: StageTimer = field(default_factory=StageTimer)
    # final latent [B, h, w, 16] f32 of the last request
    last_latent: Optional[torch.Tensor] = None

    def _encode_prompts(self, texts):
        """[B, 77 + 256, 4096] token stream, [B, 2048] pooled."""
        ids_l = self._ids(self.clip_tokenizer, texts, self.clip_l.cfg.n_ctx)
        ids_g = self._ids(self.open_clip_tokenizer, texts,
                          self.clip_g.cfg.n_ctx)
        h_l, pool_l = clip_hidden_pooled(self.clip_l, ids_l,
                                         self.clip_l.cfg.n_layer - 1)
        h_g, pool_g = clip_hidden_pooled(self.clip_g, ids_g,
                                         self.clip_g.cfg.n_layer - 1)
        clip_ctx = torch.cat([h_l, h_g], -1)
        jdim = self.mmdit.cfg.joint_attention_dim
        clip_ctx = F.pad(clip_ctx, (0, jdim - clip_ctx.shape[-1]))
        if self.t5 is not None:
            if self.t5_tokenize is None:
                raise ValueError("T5 tower loaded but no T5 tokenizer — "
                                 "pass t5_tokenize or drop the tower")
            t5_ctx = t5_encode(self.t5, self._t5_ids(texts))
        else:
            t5_ctx = torch.zeros((clip_ctx.shape[0], SD3_T5_TOKENS, jdim),
                                 dtype=clip_ctx.dtype, device=self.device)
        ctx = torch.cat([clip_ctx, t5_ctx.to(clip_ctx.dtype)], 1)
        return ctx, torch.cat([pool_l, pool_g], -1)

    @torch.no_grad()
    def conditioning(self, prompts, negative_prompt: str = ""):
        """([2B, T, 4096] ctx, [2B, 2048] pooled) as [uncond | cond]."""
        prompts = _prompts(prompts)
        with self.timer.stage("embedder"):
            ctx_c, pool_c = self._encode_prompts(prompts)
            ctx_u, pool_u = self._encode_prompts(
                [negative_prompt] * len(prompts))
            ctx = torch.cat([ctx_u, ctx_c])
            pooled = torch.cat([pool_u, pool_c])
            fence(ctx)
        return ctx, pooled

    def _slg_kwargs(self, scale, layers, start, stop) -> dict:
        """fm_diffuse_latent's SLG keywords: none at scale 0 (the plain
        run); layers (7, 8, 9) by default, diffusers' SD3.5-medium
        recommendation."""
        if not scale:
            return {}
        layers = (7, 8, 9) if layers is None else tuple(layers)
        if any(i >= self.mmdit.cfg.num_layers or i < 0 for i in layers):
            raise ValueError(
                f"slg_layers {layers} out of range for a "
                f"{self.mmdit.cfg.num_layers}-block MMDiT")
        return dict(slg_scale=float(scale), slg_layers=layers,
                    slg_start=float(start), slg_stop=float(stop))

    def _run(self, prompts, lat, guidance_scale, n_steps, negative_prompt,
             no_cfg, slg, start_index=0, **pin) -> np.ndarray:
        use_cfg = not (no_cfg or guidance_scale == 1.0)
        ctx, pooled = self.conditioning(prompts, negative_prompt)
        if not use_cfg:
            b = len(prompts)
            ctx, pooled = ctx[b:], pooled[b:]
        with self.timer.stage("diffuser"):
            lat = fm_diffuse_latent(
                self.mmdit, lat, ctx, pooled, guidance_scale,
                n_steps=n_steps, shift=self.flow_shift, use_cfg=use_cfg,
                start_index=start_index, **pin, **slg)
            fence(lat)
        return self._decode(lat)

    def txt2img(self, prompts, resolution: Tuple[int, int] = (1024, 1024),
                n_steps: int = 28, guidance_scale: float = 7.0,
                seed: int = 0, negative_prompt: str = "",
                no_cfg: bool = False, slg_scale: float = 0.0,
                slg_layers: Optional[Tuple[int, ...]] = None,
                slg_start: float = 0.01, slg_stop: float = 0.2
                ) -> np.ndarray:
        h, w = resolution
        if h % 16 or w % 16:
            raise ValueError(f"resolution {h}x{w} must be a multiple of 16 "
                             "(patchified 16-ch latent)")
        prompts = _prompts(prompts)
        slg = self._slg_kwargs(slg_scale, slg_layers, slg_start, slg_stop)
        lat = draw_noise((len(prompts), h // 8, w // 8,
                          self.mmdit.cfg.in_channels), seed, self.device)
        return self._run(prompts, lat, guidance_scale, n_steps,
                         negative_prompt, no_cfg, slg)

    def img2img(self, prompts, reference_images: np.ndarray,
                strength: float = 0.6, n_steps: int = 28,
                guidance_scale: float = 7.0, seed: int = 0,
                negative_prompt: str = "", no_cfg: bool = False,
                slg_scale: float = 0.0,
                slg_layers: Optional[Tuple[int, ...]] = None,
                slg_start: float = 0.01, slg_stop: float = 0.2
                ) -> np.ndarray:
        if not 0.0 < strength <= 1.0:
            raise ValueError("strength must be in (0, 1]")
        prompts = _prompts(prompts)
        slg = self._slg_kwargs(slg_scale, slg_layers, slg_start, slg_stop)
        lat0 = self._encode(reference_images)
        start = fm_window(n_steps, strength)
        _, sigmas = fm_schedule(n_steps, self.flow_shift)
        lat, _ = self._noised(lat0, seed, float(sigmas[start]))
        return self._run(prompts, lat, guidance_scale, n_steps,
                         negative_prompt, no_cfg, slg, start_index=start)

    def inpaint(self, prompts, reference_images: np.ndarray,
                mask_image: Optional[np.ndarray] = None,
                crop_left: Optional[int] = None,
                crop_right: Optional[int] = None,
                crop_top: Optional[int] = None,
                crop_bottom: Optional[int] = None, crop_out: bool = False,
                mask_blur: float = 0.0, strength: float = 1.0,
                n_steps: int = 28, guidance_scale: float = 7.0,
                seed: int = 0, negative_prompt: str = "",
                no_cfg: bool = False, slg_scale: float = 0.0,
                slg_layers: Optional[Tuple[int, ...]] = None,
                slg_start: float = 0.01, slg_stop: float = 0.2
                ) -> np.ndarray:
        """Latent inpainting: after every Euler step the unmasked region
        is pinned to the reference latent re-noised at the next sigma.
        The mask is a mask image (any >127 pixel in an 8x8 cell marks the
        cell generated) or a pixel crop window, feathered by mask_blur
        (pipeline/masks.py). strength defaults to 1.0 (the whole
        schedule)."""
        if not 0.0 < strength <= 1.0:
            raise ValueError("strength must be in (0, 1]")
        prompts = _prompts(prompts)
        _, height, width, _ = np.asarray(reference_images).shape
        if height % 16 or width % 16:
            raise ValueError(f"reference image {height}x{width} must be a "
                             "multiple of 16 (patchified 16-ch latent)")
        mask = build_latent_mask(height, width, mask_image, crop_left,
                                 crop_right, crop_top, crop_bottom,
                                 crop_out, mask_blur=mask_blur)
        slg = self._slg_kwargs(slg_scale, slg_layers, slg_start, slg_stop)
        lat0 = self._encode(reference_images)
        start = fm_window(n_steps, strength)
        _, sigmas = fm_schedule(n_steps, self.flow_shift)
        lat, noise = self._noised(lat0, seed, float(sigmas[start]))
        return self._run(prompts, lat, guidance_scale, n_steps,
                         negative_prompt, no_cfg, slg, start_index=start,
                         pin_reference=lat0, pin_noise=noise,
                         pin_mask=torch.as_tensor(mask, device=self.device))


def random_sd3_pipeline(
    seed: int = 0,
    *,
    device="cuda",
    mmdit_cfg: Optional[MMDiTConfig] = None,
    clip_l_cfg: Optional[CLIPConfig] = None,
    clip_g_cfg: Optional[CLIPConfig] = None,
    vae_cfg: Optional[AutoencoderConfig] = None,
    t5_cfg: Optional[T5Config] = None,
    mmdit_dtype: torch.dtype = torch.bfloat16,
    t5_dtype: torch.dtype = torch.float32,
    with_encoder: bool = True,
    tokenizer_dir: Optional[str] = None,
) -> SD3Pipeline:
    """SD3 pipeline with random weights drawn on ``device`` (the card
    unless the caller asks for the CPU) from one seeded torch.Generator,
    with the reference's init distributions, in this order: the MMDiT (in
    mmdit_dtype), CLIP-L, CLIP-G, the VAE decoder and encoder (f32), then
    T5 (t5_cfg; the reference's random T5 is f32) with the stub tokenizer
    (``stub_t5_tokenizer``). The configs default to SD3-medium's (MMDiT,
    CLIP-L, CLIP-G, the 16-channel VAE) and no T5. Each module is built on the meta device and
    materialised on ``device`` before its draw."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    mmdit_cfg = mmdit_cfg or MMDiTConfig()
    clip_l_cfg = clip_l_cfg or CLIP_VIT_L_CONFIG
    clip_g_cfg = clip_g_cfg or OPEN_CLIP_BIGG_CONFIG
    vae_cfg = vae_cfg or sd3_vae_config()
    log("initializing random SD3 weights (no checkpoint)")

    def make(module, **kw):
        return init_reference_(module.to_empty(device=device), g, **kw)

    mmdit = make(MMDiT(mmdit_cfg, "meta", mmdit_dtype))
    clip_l = make(CLIPTextModel(clip_l_cfg, "meta"))
    clip_g = make(CLIPTextModel(clip_g_cfg, "meta"))
    vae = make(VAEDecoder(vae_cfg, "meta"), conv_scale=0.05)
    encoder = (make(VAEEncoder(vae_cfg, "meta"), conv_scale=0.05)
               if with_encoder else None)
    t5 = t5_tok = None
    if t5_cfg is not None:
        t5 = init_t5_(T5Encoder(t5_cfg, "meta", t5_dtype).to_empty(
            device=device), g)
        t5_tok = stub_t5_tokenizer(SD3_T5_TOKENS, t5_cfg.vocab_size)
    for m in (mmdit, clip_l, clip_g, vae, encoder, t5):
        if m is not None:
            m.eval().requires_grad_(False)
    return SD3Pipeline(
        vae=vae, vae_encoder=encoder, scale_factor=SD3_VAE_SCALE,
        shift_factor=SD3_VAE_SHIFT, mmdit=mmdit, clip_l=clip_l,
        clip_g=clip_g, t5=t5, t5_tokenize=t5_tok,
        clip_tokenizer=ClipTokenizer(tokenizer_dir),
        open_clip_tokenizer=OpenClipTokenizer(tokenizer_dir))


def load_sd3_pipeline(
    model_dir: str,
    compute_dtype: torch.dtype = torch.bfloat16,
    tokenizer_dir: Optional[str] = None,
    load_t5: bool = True,
    t5_tokenize: Optional[Callable] = None,
    loras=None,
    quantize: Optional[str] = None,
    device="cuda",
) -> SD3Pipeline:
    """Load a diffusers-layout SD3 directory onto ``device`` (io/sd3.py):
    the MMDiT and T5 in compute_dtype, the towers and the VAE in f32.
    load_t5=False drops the T5 tower (its token block becomes zeros). T5
    weights without tokenizer_3/ fail here unless ``t5_tokenize`` is
    given. loras: (path, scale) files merged into the MMDiT and both
    towers. quantize="int8"|"int4" then stores the MMDiT's block linears
    at those bits and T5's at int8 (io/quantize.py): as the reference's
    host=True load, the MMDiT and T5 are built on the host, each eligible
    linear is quantized on ``device`` alone, and only the quantized
    towers reach it."""
    from ..io.sd3 import load_sd3_diffusers_dir

    bits = parse_quantize_spec(quantize)
    device = torch.device(device)
    log(f"loading SD3 diffusers checkpoint from {model_dir}")
    (mmdit, clip_l, clip_g, vae, encoder, t5, t5_tok,
     flow_shift) = load_sd3_diffusers_dir(
        model_dir, compute_dtype, load_t5, device=device,
        towers_device="cpu" if bits is not None else device)
    t5_tok = t5_tok or t5_tokenize
    if t5 is not None and t5_tok is None:
        raise ValueError(
            f"{model_dir}: text_encoder_3/ (T5) weights loaded but "
            "tokenizer_3/ is missing — add the tokenizer directory, pass "
            "t5_tokenize=, or drop the tower (load_t5=False / --no-t5)")
    if loras:
        from ..io.lora import apply_lora_files

        apply_lora_files(loras, transformer=mmdit, te1=clip_l, te2=clip_g)
    if bits is not None:
        mmdit = quantize_model(mmdit, bits, device=device).to(device)
        if t5 is not None:
            t5 = quantize_model(t5, 8, device=device).to(device)
    return SD3Pipeline(
        vae=vae, vae_encoder=encoder, scale_factor=SD3_VAE_SCALE,
        shift_factor=SD3_VAE_SHIFT, mmdit=mmdit, clip_l=clip_l,
        clip_g=clip_g, t5=t5, t5_tokenize=t5_tok,
        clip_tokenizer=ClipTokenizer(tokenizer_dir),
        open_clip_tokenizer=OpenClipTokenizer(tokenizer_dir),
        flow_shift=flow_shift)
