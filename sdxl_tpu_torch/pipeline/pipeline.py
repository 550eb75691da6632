"""SDXL text-to-image pipeline: prompt -> uint8 images
(the txt2img main path of sdxl_tpu/pipeline/pipeline.py).

Stages, as in the reference: dual-CLIP conditioning (f32) -> pair-batched
CFG DDIM over the base UNet (bf16, or f32) -> VAE decode (f32, or bf16 with
``vae_dtype``) -> uint8 RGB.

Precision: building a pipeline sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` so the f32 stages (CLIP, the
DDIM update, the VAE decode) run in full f32 on the GPU; cuDNN would
otherwise run f32 convolutions in TF32.

Ported options of ``txt2img``: prompts, resolution, n_steps,
guidance_scale, seed (one int), negative_prompt, profile_stages and
initial_latent. Every other option of the reference (refiner, inpainting,
the k-samplers, ControlNet, IP-Adapter, ...) raises NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..configs import (
    SDXL_BASE_DIFFUSER,
    SDXL_EMBEDDER,
    AutoencoderConfig,
    DiffuserConfig,
    EmbedderConfig,
)
from ..models.clip import CLIPTextModel
from ..models.layers import init_reference_
from ..models.unet import UNet
from ..models.vae import VAEDecoder, VAEEncoder
from ..tokenizer import ClipTokenizer, OpenClipTokenizer
from ..utils import StageTimer, fence, log
from .conditioning import Conditioning, text_to_conditioning
from .latent import decode_latent_to_images
from .resolutions import validate_resolution
from .sampler import sample_latent, scaled_linear_alphas_cumprod


@dataclass
class SDXLPipeline:
    embedder_cfg: EmbedderConfig
    embedder: nn.ModuleDict  # {"clip": CLIPTextModel, "open_clip": ...}
    diffuser_cfg: DiffuserConfig
    unet: UNet
    alphas_cumprod: torch.Tensor  # on the pipeline's device
    vae_cfg: AutoencoderConfig
    vae: VAEDecoder
    clip_tokenizer: object
    open_clip_tokenizer: object
    # the VAE's encoding half, for training (train/finetune.py); None when
    # the pipeline only samples
    vae_encoder: Optional[VAEEncoder] = None
    scale_factor: float = 0.13025
    # the VAE decode's dtype: f32 as the reference's default; bf16 is its
    # opt-in half-precision decode (decode_latent_to_images)
    vae_dtype: torch.dtype = torch.float32
    timer: StageTimer = field(default_factory=StageTimer)
    # final latent [B, h, w, 4] f32 of the last txt2img call
    last_latent: Optional[torch.Tensor] = None
    # unconditional half of the conditioning, memoised across requests
    # (see text_to_conditioning); clear it when the embedder changes
    _uncond_cache: dict = field(default_factory=dict)

    def __post_init__(self):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    @property
    def device(self) -> torch.device:
        return self.alphas_cumprod.device

    @property
    def compute_dtype(self) -> torch.dtype:
        """The UNet's dtype: its inputs and conditioning are cast to it."""
        return next(self.unet.parameters()).dtype

    def conditioning(self, prompts, resolution: Tuple[int, int],
                     negative_prompt: str = "",
                     profile_stages: bool = True) -> Conditioning:
        with self.timer.stage("embedder"):
            cond = text_to_conditioning(
                self.embedder, self.embedder_cfg, self.clip_tokenizer,
                self.open_clip_tokenizer, prompts, resolution,
                negative_prompt=negative_prompt,
                uncond_cache=self._uncond_cache)
            if profile_stages:
                fence(cond.context_full)
        return cond

    @torch.inference_mode()
    def txt2img(self, prompts, resolution: Tuple[int, int] = (1024, 1024),
                n_steps: int = 30, guidance_scale: float = 7.5, seed: int = 0,
                negative_prompt: str = "", profile_stages: bool = True,
                initial_latent: Optional[torch.Tensor] = None,
                **options) -> np.ndarray:
        """Prompt(s) -> [B, H, W, 3] uint8 images (numpy, on the host).

        initial_latent ([B, h, w, 4], VP space at the first grid timestep)
        replaces the seeded starting noise."""
        if options:
            raise NotImplementedError(
                f"txt2img options not ported yet: {', '.join(sorted(options))}")
        if not isinstance(seed, (int, np.integer)):
            raise NotImplementedError("per-image seed lists are not ported yet")
        h, w = resolution
        if h % 8 or w % 8:
            raise ValueError(f"resolution {h}x{w} must be a multiple of 8")
        if not validate_resolution(h, w):
            log(f"warning: {h}x{w} is not an SDXL-trained resolution bucket")

        cond = self.conditioning(prompts, resolution, negative_prompt,
                                 profile_stages)
        noise = None
        if initial_latent is not None:
            want = (cond.batch, h // 8, w // 8, 4)
            if tuple(initial_latent.shape) != want:
                raise ValueError(f"initial_latent shape "
                                 f"{tuple(initial_latent.shape)}, expected "
                                 f"{want}")
            noise = torch.as_tensor(initial_latent, dtype=torch.float32,
                                    device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(int(seed))

        with self.timer.stage("diffuser"):
            latent = sample_latent(
                self.unet, self.diffuser_cfg, self.alphas_cumprod,
                cond.astype(self.compute_dtype), generator, guidance_scale,
                n_steps, self.compute_dtype, initial_noise=noise)
            if profile_stages:
                fence(latent)
        self.last_latent = latent

        with self.timer.stage("vae_decode"):
            images = decode_latent_to_images(self.vae, latent,
                                             self.scale_factor,
                                             self.vae_dtype)
            fence(images)
        return images.cpu().numpy()


def random_pipeline(
    seed: int = 0,
    *,
    device="cuda",
    embedder_cfg: EmbedderConfig = SDXL_EMBEDDER,
    diffuser_cfg: DiffuserConfig = SDXL_BASE_DIFFUSER,
    vae_cfg: AutoencoderConfig = AutoencoderConfig(),
    unet_dtype: torch.dtype = torch.bfloat16,
    with_encoder: bool = False,
) -> SDXLPipeline:
    """Pipeline with random weights drawn on ``device`` (the card unless
    the caller asks for the CPU) from one seeded torch.Generator, with the
    reference's init distributions (weights N(0, 0.02^2), VAE convs
    N(0, 0.05^2), zero biases, unit norm gains) so activations stay in the
    same range as the JAX bring-up pipeline.
    with_encoder adds the VAE encoder, drawn last, for training."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    log("initializing random weights (no checkpoint)")
    embedder = nn.ModuleDict({
        "clip": init_reference_(
            CLIPTextModel(embedder_cfg.clip_config, device), g),
        "open_clip": init_reference_(
            CLIPTextModel(embedder_cfg.open_clip_config, device), g),
    })
    unet = init_reference_(UNet(diffuser_cfg.unet_config(), device,
                                unet_dtype), g)
    vae = init_reference_(VAEDecoder(vae_cfg, device), g, conv_scale=0.05)
    encoder = (init_reference_(VAEEncoder(vae_cfg, device), g, conv_scale=0.05)
               if with_encoder else None)
    for m in (embedder, unet, vae, encoder):
        if m is not None:
            m.eval().requires_grad_(False)
    return SDXLPipeline(
        embedder_cfg=embedder_cfg,
        embedder=embedder,
        diffuser_cfg=diffuser_cfg,
        unet=unet,
        alphas_cumprod=torch.as_tensor(scaled_linear_alphas_cumprod(),
                                       device=device),
        vae_cfg=vae_cfg,
        vae=vae,
        clip_tokenizer=ClipTokenizer(),
        open_clip_tokenizer=OpenClipTokenizer(),
        vae_encoder=encoder,
    )
