"""SD 1.x / 2.x pipeline (counterpart of sdxl_tpu/pipeline/sd1.py).

The SDXL pipeline's UNet, samplers and VAE serve the earlier Stable
Diffusion family with other knobs (configs.SD15_DIFFUSER, SD2_DIFFUSER,
SD21_768_DIFFUSER):

  - one text tower: CLIP ViT-L (SD 1.x, quick_gelu) or OpenCLIP ViT-H
    (SD 2.x); the conditioning is the final hidden state after the last
    LayerNorm (SD 1.x) or the penultimate hidden (SD 2.x,
    ``penultimate_hidden``); ``clip_skip`` taps earlier blocks (diffusers'
    semantics on the final-LN path: the earlier hidden, LN kept);
  - no pooled or micro-conditioning channel embedding (adm_in_channels =
    0): the conditioning carries None in its OpenCLIP and channel fields;
  - a 4-level UNet, transformers at levels 0-2 of depth 1; SD 1.x fixes 8
    heads at every width (40-, 80- and 160-wide heads, which the flash gate
    leaves on the plain attention), SD 2.x has 64-wide heads;
  - v-prediction for SD 2.1-768 (``prediction_type="v"``, sampler.py);
  - the VAE of the same architecture at scale factor 0.18215, and SD 1.x's
    preview factors and Align-Your-Steps table.

Every entry point of SDXLPipeline (txt2img with every sampler, img2img,
inpaint, outpaint, ddim_invert, txt2img_hires, ip2p, ControlNet,
IP-Adapter, FreeU, PAG, DeepCache, the tiled VAE) runs on it unchanged;
the refiner is an SDXL feature. SD 1.x has no trained aspect buckets:
``strict_resolutions`` is off.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..configs import (
    CLIP_VIT_L_CONFIG,
    SD15_DIFFUSER,
    SD15_VAE_SCALE,
    AutoencoderConfig,
    CLIPConfig,
    DiffuserConfig,
)
from ..models.clip import CLIPTextModel, clip_final_hidden, clip_hidden
from ..models.layers import init_reference_
from ..models.unet import UNet
from ..models.vae import VAEDecoder, VAEEncoder
from ..tokenizer import ClipTokenizer
from ..utils import fence, log
from .conditioning import Conditioning
from .k_samplers import scaled_linear_alphas_cumprod
from .pipeline import SDXLPipeline
from .prompt import apply_prompt_weights, batch_weighted_tokens
from .sampler import SD1_LATENT_RGB


def _sd1_hidden(clip: CLIPTextModel, tokens: torch.Tensor, weights,
                penultimate: bool, clip_skip: int) -> torch.Tensor:
    """One branch: [B, k, 77] chunked ids (and optional weights) ->
    [B, 77k, C] context."""
    b, k, n_ctx = tokens.shape
    flat = tokens.reshape(b * k, n_ctx)
    n_layer = len(clip.blocks)
    if penultimate:  # SD 2.x: one block early, no final LN
        h = clip_hidden(clip, flat, n_layer - 1 - clip_skip)
    elif clip_skip:  # diffusers' clip_skip: an earlier hidden, LN kept
        h = clip.layer_norm(clip_hidden(clip, flat, n_layer - clip_skip))
    else:
        h = clip_final_hidden(clip, flat)
    h = h.reshape(b, k * n_ctx, -1)
    if weights is not None:
        h = apply_prompt_weights(h, weights.reshape(b, k * n_ctx))
    return h


@torch.no_grad()
def text_to_conditioning_sd1(
    clip: CLIPTextModel,
    cfg: CLIPConfig,
    tokenizer,
    prompts,
    resolution: Tuple[int, int],
    negative_prompt: str = "",
    penultimate: bool = False,
    clip_skip: int = 0,
) -> Conditioning:
    """Prompts -> single-tower Conditioning (None in the OpenCLIP and
    channel fields), with the prompt-weight markup and >75-token chunking
    of pipeline/prompt.py."""
    if isinstance(prompts, str):
        prompts = [prompts]
    ids, w, u_ids, uw, weighted, _ = batch_weighted_tokens(
        prompts, negative_prompt, tokenizer, cfg.n_ctx)
    device = clip.token_embedding.device

    def run(a, wts):
        return _sd1_hidden(
            clip, torch.as_tensor(a, dtype=torch.long, device=device),
            torch.as_tensor(wts, device=device) if weighted else None,
            penultimate, clip_skip)

    return Conditioning(
        unconditional_context_full=run(u_ids, uw),
        unconditional_context_open_clip=None,
        context_full=run(ids, w),
        context_open_clip=None,
        unconditional_channel_context=None,
        unconditional_channel_context_refiner=None,
        channel_context=None,
        channel_context_refiner=None,
        resolution=tuple(resolution),
    )


@dataclass
class SD1Pipeline(SDXLPipeline):
    """SDXLPipeline with single-tower conditioning: ``embedder_cfg`` is a
    CLIPConfig and ``embedder`` the bare CLIPTextModel."""

    # SD 2.x taps the penultimate hidden, SD 1.x the final LN's output
    penultimate_hidden: bool = False

    # the published Align-Your-Steps table of SD 1.x / 2.x
    _ays_variant = "ays_sd15"

    def __post_init__(self):
        super().__post_init__()
        if self.preview_factors is None:
            self.preview_factors = SD1_LATENT_RGB

    def add_textual_inversions(self, specs) -> None:
        """Merge textual-inversion files into the one tokenizer and CLIP
        embedding table (io/textual_inversion.py)."""
        from ..io.textual_inversion import apply_textual_inversions

        apply_textual_inversions(
            list(specs), tokenizers=[self.clip_tokenizer],
            embedder={"clip": self.embedder}, tower_keys=["clip"],
            tower_widths=[self.embedder_cfg.n_state])

    def conditioning(self, prompts, resolution: Tuple[int, int],
                     negative_prompt: str = "",
                     profile_stages: bool = True) -> Conditioning:
        with self.timer.stage("embedder"):
            cond = text_to_conditioning_sd1(
                self.embedder, self.embedder_cfg, self.clip_tokenizer,
                prompts, resolution, negative_prompt,
                self.penultimate_hidden, clip_skip=self.clip_skip)
            if profile_stages:
                fence(cond.context_full)
        return cond


def load_sd1_pipeline(
    model_dir: str,
    clip_cfg: CLIPConfig = CLIP_VIT_L_CONFIG,
    diffuser_cfg: DiffuserConfig = SD15_DIFFUSER,
    compute_dtype: torch.dtype = torch.bfloat16,
    tokenizer_dir: Optional[str] = None,
    penultimate_hidden: bool = False,
    loras=None,
    quantize: Optional[str] = None,
    device="cuda",
) -> SD1Pipeline:
    """Load an SD 1.x / 2.x checkpoint onto ``device``: a diffusers
    directory (unet/ vae/ text_encoder/ scheduler/) or a single file in
    the ldm layout (v1-5-pruned.{safetensors,ckpt}, v2-1_768-ema-pruned,
    ...; a legacy .ckpt loads with weights_only; SD 2.x's OpenCLIP tower is
    found by its cond_stage_model.model.* keys). The UNet in
    ``compute_dtype``, the tower and the VAE in f32. The diffuser config
    is the caller's (its in_channels and LCM width corrected from the
    weights): as in the reference, a scheduler's prediction_type is not
    read, so SD 2.1-768 needs SD21_768_DIFFUSER. loras: (path, scale) LoRA
    files merged into the UNet and the tower at load time;
    quantize="int8"|"int4" then quantizes the UNet's block linears
    (io/quantize.py, the UNet rules)."""
    from ..io.quantize import parse_quantize_spec
    from .loader import _autoencoder, _load_module, _tower, quantize_unet

    bits = parse_quantize_spec(quantize)
    device = torch.device(device)
    if os.path.isfile(model_dir):
        from ..io.hf_sdxl import load_sd1_single_file

        log(f"loading SD1.x single-file checkpoint from {model_dir}")
        clip_sd, unet_sd, vae_sd, diffuser_cfg = load_sd1_single_file(
            model_dir, diffuser_cfg, clip_cfg, compute_dtype, device=device)
        alphas = scale = None
    else:
        from ..io.diffusers_sdxl import load_sd1_diffusers_dir

        log(f"loading SD1.x diffusers checkpoint from {model_dir}")
        clip_sd, unet_sd, vae_sd, alphas, scale, diffuser_cfg = \
            load_sd1_diffusers_dir(model_dir, diffuser_cfg, clip_cfg,
                                   compute_dtype, device=device)
    if clip_sd is None:
        raise FileNotFoundError(f"text_encoder missing under {model_dir}")
    vae_cfg = AutoencoderConfig()
    clip = _tower(clip_cfg, clip_sd, "text_encoder", device)
    unet = _load_module(UNet(diffuser_cfg.unet_config(), "meta",
                             compute_dtype), unet_sd, "diffuser", device)
    vae, encoder = _autoencoder(vae_cfg, vae_sd, device)
    del clip_sd, unet_sd, vae_sd
    if loras:
        from ..io.lora import apply_lora_files

        apply_lora_files(loras, unet=unet, te1=clip)
    quantize_unet(unet, bits)
    if alphas is None:
        alphas = scaled_linear_alphas_cumprod(diffuser_cfg.n_steps)
    return SD1Pipeline(
        embedder_cfg=clip_cfg,
        embedder=clip,
        diffuser_cfg=diffuser_cfg,
        unet=unet,
        alphas_cumprod=torch.as_tensor(alphas, dtype=torch.float32,
                                       device=device),
        vae_cfg=vae_cfg,
        vae=vae,
        clip_tokenizer=ClipTokenizer(tokenizer_dir),
        open_clip_tokenizer=None,
        vae_encoder=encoder,
        scale_factor=float(scale or SD15_VAE_SCALE),
        strict_resolutions=False,  # SD 1.x has no SDXL bucket constraint
        penultimate_hidden=penultimate_hidden,
    )


def random_sd1_pipeline(
    seed: int = 0,
    *,
    device="cuda",
    clip_cfg: CLIPConfig = CLIP_VIT_L_CONFIG,
    diffuser_cfg: DiffuserConfig = SD15_DIFFUSER,
    vae_cfg: AutoencoderConfig = AutoencoderConfig(),
    unet_dtype: torch.dtype = torch.bfloat16,
    with_encoder: bool = True,
    tokenizer_dir: Optional[str] = None,
    penultimate_hidden: bool = False,
) -> SD1Pipeline:
    """SD 1.x / 2.x pipeline with random weights drawn on ``device`` (the
    card unless the caller asks for the CPU) from one seeded
    torch.Generator with random_pipeline's init distributions: the tower,
    the UNet (in unet_dtype), the VAE decoder, then its encoder
    (with_encoder, for img2img and inpainting)."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    log("initializing random SD1.x weights (no checkpoint)")
    clip = init_reference_(CLIPTextModel(clip_cfg, device), g)
    unet = init_reference_(UNet(diffuser_cfg.unet_config(), device,
                                unet_dtype), g)
    vae = init_reference_(VAEDecoder(vae_cfg, device), g, conv_scale=0.05)
    encoder = (init_reference_(VAEEncoder(vae_cfg, device), g, conv_scale=0.05)
               if with_encoder else None)
    for m in (clip, unet, vae, encoder):
        if m is not None:
            m.eval().requires_grad_(False)
    return SD1Pipeline(
        embedder_cfg=clip_cfg,
        embedder=clip,
        diffuser_cfg=diffuser_cfg,
        unet=unet,
        alphas_cumprod=torch.as_tensor(
            scaled_linear_alphas_cumprod(diffuser_cfg.n_steps),
            device=device),
        vae_cfg=vae_cfg,
        vae=vae,
        clip_tokenizer=ClipTokenizer(tokenizer_dir),
        open_clip_tokenizer=None,
        vae_encoder=encoder,
        scale_factor=SD15_VAE_SCALE,
        strict_resolutions=False,
        penultimate_hidden=penultimate_hidden,
    )
