"""SDXL pipeline: prompt (and reference image) -> uint8 images
(the DDIM paths of sdxl_tpu/pipeline/pipeline.py).

Stages, as in the reference: dual-CLIP conditioning (f32) -> pair-batched
CFG DDIM over the base UNet (bf16, or f32) -> optional refiner (re-noise at
t = 1000 - refiner_step_start, or the ensemble-of-experts tail after
``denoising_end``) -> VAE decode (f32, or bf16 with ``vae_dtype``) ->
uint8 RGB. Inpainting, img2img and outpaint first encode their reference
images with the VAE encoder (f32).

Precision: building a pipeline sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` so the f32 stages (CLIP, the
DDIM update, the VAE decode) run in full f32 on the GPU; cuDNN would
otherwise run f32 convolutions in TF32.

Ported options of ``txt2img``: prompts, resolution, n_steps,
guidance_scale, seed (one int), negative_prompt, profile_stages,
initial_latent, use_refiner, refiner_step_start, denoising_end,
inpaint_reference and inpaint_mask; ``img2img``, ``inpaint`` and
``outpaint`` take the same keywords. Every other option of the reference
(the k-samplers, ControlNet, IP-Adapter, per-image seed lists, ...)
raises NotImplementedError. The base and the refiner stay resident on the
device: the reference's HBM planner has no work on an 80 GB card.

Noise: one torch.Generator seeded with ``seed`` gives, in this order, the
initial latent noise, the inpainting pin noise of every step, and the
refiner's re-noise (img2img: its re-noise). JAX and torch draws differ, so
the same seed gives another image than the reference.
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
from .latent import decode_latent_to_images, encode_images_to_latent
from .masks import build_latent_mask
from .resolutions import RESOLUTIONS, validate_resolution
from .sampler import (
    expert_head_steps,
    refine_latent,
    sample_latent,
    scaled_linear_alphas_cumprod,
)


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
    # the VAE's encoding half, for inpainting, img2img, outpaint and
    # training (train/finetune.py); None when the pipeline only samples
    vae_encoder: Optional[VAEEncoder] = None
    # the refiner UNet (txt2img's use_refiner), its config and ᾱ table
    # (None: the base's)
    refiner_cfg: Optional[DiffuserConfig] = None
    refiner: Optional[UNet] = None
    refiner_alphas: Optional[torch.Tensor] = None
    # SDXL enforces its trained aspect buckets on inpainting references
    strict_resolutions: bool = True
    scale_factor: float = 0.13025
    # the VAE decode's dtype: f32 as the reference's default; bf16 is its
    # opt-in half-precision decode (decode_latent_to_images)
    vae_dtype: torch.dtype = torch.float32
    timer: StageTimer = field(default_factory=StageTimer)
    # final latent [B, h, w, 4] f32 of the last txt2img / img2img call
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

    def add_textual_inversions(self, specs) -> None:
        """Merge textual-inversion embedding files ('PATH[:word]', in order)
        into both tokenizers and both CLIP embedding tables
        (io/textual_inversion.py)."""
        from ..io.textual_inversion import apply_textual_inversions

        apply_textual_inversions(
            list(specs),
            tokenizers=[self.clip_tokenizer, self.open_clip_tokenizer],
            embedder=self.embedder,
            tower_keys=["clip", "open_clip"],
            tower_widths=[
                self.embedder_cfg.clip_config.n_state,
                self.embedder_cfg.open_clip_config.n_state,
            ],
        )
        self._uncond_cache.clear()  # embedding tables changed

    def _on_device(self, a) -> torch.Tensor:
        """A numpy array or a tensor on any device, as a tensor here."""
        return torch.as_tensor(a if isinstance(a, torch.Tensor)
                               else np.asarray(a), device=self.device)

    def _encode(self, images) -> torch.Tensor:
        """[B, H, W, 3] uint8 (numpy or tensor) -> VAE latent on the
        device, encoded in f32."""
        if self.vae_encoder is None:
            raise ValueError(
                "this pipeline has no VAE encoder (a checkpoint without "
                "encoder weights, or random_pipeline(with_encoder=False))")
        return encode_images_to_latent(self.vae_encoder,
                                       self._on_device(images),
                                       self.scale_factor)

    def _decode(self, latent: torch.Tensor) -> np.ndarray:
        self.last_latent = latent
        with self.timer.stage("vae_decode"):
            images = decode_latent_to_images(self.vae, latent,
                                             self.scale_factor,
                                             self.vae_dtype)
            fence(images)
        return images.cpu().numpy()

    @torch.inference_mode()
    def txt2img(self, prompts, resolution: Tuple[int, int] = (1024, 1024),
                n_steps: int = 30, guidance_scale: float = 7.5, seed: int = 0,
                use_refiner: bool = False, refiner_step_start: int = 800,
                denoising_end: Optional[float] = None,
                negative_prompt: str = "",
                inpaint_reference: Optional[np.ndarray] = None,
                inpaint_mask=None, profile_stages: bool = True,
                initial_latent: Optional[torch.Tensor] = None,
                **options) -> np.ndarray:
        """Prompt(s) -> [B, H, W, 3] uint8 images (numpy, on the host).

        initial_latent ([B, h, w, 4], VP space at the first grid timestep)
        replaces the seeded starting noise.
        use_refiner: after the base, the refiner re-noises the latent at
        t = 1000 - refiner_step_start and runs the grid's tail.
        denoising_end (with use_refiner): the ensemble-of-experts split —
        the base runs the grid entries with t >= round(1000 * (1 -
        denoising_end)) and the refiner the rest, with no re-noise.
        inpaint_reference [1, H, W, 3] uint8 with inpaint_mask [1, h, w, 4]
        (bool, or float in [0, 1]; 1 = generate): on a 4-channel UNet the
        known region is pinned to the re-noised reference latent every
        step; a 9-channel inpainting UNet takes [mask, latent of the
        reference with the masked pixels set to 127] as extra input
        channels instead."""
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
        if initial_latent is not None and (inpaint_reference is not None
                                           or use_refiner):
            raise ValueError("initial_latent is not combinable with "
                             "inpainting or the refiner")
        if inpaint_reference is not None and inpaint_mask is None:
            raise ValueError("inpaint_reference needs an inpaint_mask")
        head_steps = 0
        if denoising_end is not None:
            if not use_refiner:
                raise ValueError(
                    "denoising_end is the ensemble-of-experts base/refiner "
                    "split — it requires use_refiner=True")
            if inpaint_reference is not None:
                raise ValueError("denoising_end is not combinable with "
                                 "inpainting (the refiner tail has no pin "
                                 "path)")
            head_steps, grid_total = expert_head_steps(
                self.alphas_cumprod, n_steps, denoising_end)
            log(f"expert split: base {head_steps} steps, refiner "
                f"{grid_total - head_steps} steps (denoising_end="
                f"{denoising_end})")
        if use_refiner and self.refiner is None:
            raise ValueError("refiner weights not loaded")

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

        reference_latent = mask = concat = None
        if inpaint_reference is not None:
            mask = self._on_device(inpaint_mask)
            with self.timer.stage("vae_encode"):
                if self.diffuser_cfg.in_channels == 9:
                    concat = self._inpaint_channels(inpaint_reference, mask,
                                                    cond.batch)
                    mask = None  # the pin path is for 4-channel UNets
                    out = concat
                else:
                    reference_latent = out = self._encode(inpaint_reference)
                if profile_stages:
                    fence(out)

        with self.timer.stage("diffuser"):
            latent = sample_latent(
                self.unet, self.diffuser_cfg, self.alphas_cumprod,
                cond.astype(self.compute_dtype), generator, guidance_scale,
                n_steps, self.compute_dtype, initial_noise=noise,
                reference=reference_latent, mask=mask,
                concat_channels=concat, head_steps=head_steps)
            if profile_stages:
                fence(latent)

        if use_refiner:
            refiner_alphas = (self.refiner_alphas
                              if self.refiner_alphas is not None
                              else self.alphas_cumprod)
            expert = denoising_end is not None
            if expert and refiner_alphas.shape[0] != \
                    self.alphas_cumprod.shape[0]:
                raise ValueError(
                    "denoising_end needs the base and refiner alpha-bar "
                    "tables to share one schedule (lengths "
                    f"{self.alphas_cumprod.shape[0]} vs "
                    f"{refiner_alphas.shape[0]})")
            with self.timer.stage("refiner"):
                latent = refine_latent(
                    self.refiner, self.refiner_cfg, refiner_alphas, latent,
                    cond.astype(self.compute_dtype), generator,
                    guidance_scale, 0 if expert else refiner_step_start,
                    n_steps, self.compute_dtype, renoise=not expert,
                    tail_from=head_steps if expert else 0)
                if profile_stages:
                    fence(latent)
        return self._decode(latent)

    def _inpaint_channels(self, reference, mask: torch.Tensor,
                          batch: int) -> torch.Tensor:
        """[B, h, w, 5] input channels of a 9-channel inpainting UNet: the
        mask's first channel and the latent of the reference with the
        masked pixels set to mid-gray (127.5, cast to uint8)."""
        m = mask[..., :1].float()  # 1 = generate
        px = m.repeat_interleave(8, dim=1).repeat_interleave(8, dim=2)
        ref = self._on_device(reference).float()
        masked_latent = self._encode((ref * (1.0 - px) + 127.5 * px)
                                     .to(torch.uint8))
        lh, lw = m.shape[1], m.shape[2]
        return torch.cat([m.expand(batch, lh, lw, 1),
                          masked_latent.expand(batch, lh, lw, 4)], dim=-1)

    @torch.inference_mode()
    def img2img(self, prompts, reference_images: np.ndarray,
                strength: float = 0.3, n_steps: int = 30,
                guidance_scale: float = 7.5, seed: int = 0,
                negative_prompt: str = "", **options) -> np.ndarray:
        """Strength-based image-to-image: encode the [B, H, W, 3] uint8
        references, re-noise at t = strength * 1000 and run the rest of the
        DDIM grid with CFG on the base UNet (refine_latent)."""
        if options:
            raise NotImplementedError(
                f"img2img options not ported yet: {', '.join(sorted(options))}")
        if not 0.0 < strength <= 1.0:
            raise ValueError("strength must be in (0, 1]")
        _, height, width, _ = reference_images.shape
        cond = self.conditioning(
            [prompts] if isinstance(prompts, str) else prompts,
            (height, width), negative_prompt=negative_prompt,
        ).astype(self.compute_dtype)
        with self.timer.stage("vae_encode"):
            latent = self._encode(reference_images)
            fence(latent)
        # skip the first (1 - strength) of the schedule
        step_start = int(round((1.0 - strength) * 1000))
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        with self.timer.stage("diffuser"):
            latent = refine_latent(
                self.unet, self.diffuser_cfg, self.alphas_cumprod, latent,
                cond, generator, guidance_scale, step_start, n_steps,
                self.compute_dtype)
        return self._decode(latent)

    def outpaint(self, prompts, reference_images: np.ndarray,
                 pad: Tuple[int, int, int, int] = (0, 0, 0, 0),
                 fill: str = "edge", **kw) -> np.ndarray:
        """Outpainting: extend the canvas by `pad` (left, right, top,
        bottom) pixels and generate everything outside the original image
        (crop_out inpainting of its window). fill: the new region before
        encoding — "edge" (replicated border rows and columns) or "noise"
        (uniform u8 from numpy's default_rng(seed)). The padded canvas must
        be a multiple of 8; its resolution is not held to the buckets."""
        left, right, top, bottom = pad
        if min(pad) < 0 or max(pad) == 0:
            raise ValueError("pad needs at least one positive side "
                             "(left, right, top, bottom)")
        reference_images = np.asarray(reference_images)
        if reference_images.ndim == 3:
            reference_images = reference_images[None]
        b, h, w, _ = reference_images.shape
        nh, nw = h + top + bottom, w + left + right
        if nh % 8 or nw % 8:
            raise ValueError(
                f"padded canvas {nh}x{nw} must be a multiple of 8 "
                "(adjust the pad sizes)")
        if fill == "edge":
            canvas = np.pad(
                reference_images,
                ((0, 0), (top, bottom), (left, right), (0, 0)),
                mode="edge")
        elif fill == "noise":
            rng = np.random.default_rng(int(kw.get("seed", 0)))
            canvas = rng.integers(0, 256, (b, nh, nw, 3), dtype=np.uint8)
            canvas[:, top:top + h, left:left + w] = reference_images
        else:
            raise ValueError(f"unknown fill {fill!r} (edge|noise)")
        saved_strict = self.strict_resolutions
        self.strict_resolutions = False
        try:
            return self.inpaint(
                prompts, canvas,
                crop_left=left, crop_right=left + w,
                crop_top=top, crop_bottom=top + h,
                crop_out=True,  # generate OUTSIDE the original window
                **kw)
        finally:
            self.strict_resolutions = saved_strict

    def inpaint(self, prompts, reference_images: np.ndarray,
                crop_left: Optional[int] = None,
                crop_right: Optional[int] = None,
                crop_top: Optional[int] = None,
                crop_bottom: Optional[int] = None,
                crop_out: bool = False,
                mask_image: Optional[np.ndarray] = None,
                mask_blur: float = 0.0, **kw) -> np.ndarray:
        """Latent inpainting of [1, H, W, 3] uint8 references: a pixel crop
        window (generated inside it, or outside with crop_out) or a mask
        image (any >127 pixel in an 8x8 cell marks the cell generated);
        mask_blur > 0 (gaussian sigma, pixels) feathers the mask and the
        per-step pin blends instead of selecting (masks.build_latent_mask).
        With strict_resolutions the reference must be an SDXL bucket."""
        _, height, width, _ = reference_images.shape
        if not validate_resolution(height, width):
            if self.strict_resolutions:
                raise ValueError(
                    f"Reference image dimensions {height}x{width} are "
                    f"incompatible. Compatible (H, W): {RESOLUTIONS}")
            log(f"warning: {height}x{width} is not an SDXL-trained bucket "
                "(ok for this model family)")
        mask = build_latent_mask(height, width, mask_image, crop_left,
                                 crop_right, crop_top, crop_bottom, crop_out,
                                 mask_blur=mask_blur)
        if mask_blur <= 0:
            mask = mask.astype(bool)  # a hard mask takes the bool pin path
        mask = np.ascontiguousarray(
            np.broadcast_to(mask, (1, height // 8, width // 8, 4)))
        return self.txt2img(prompts, resolution=(height, width),
                            inpaint_reference=reference_images,
                            inpaint_mask=mask, **kw)


def random_pipeline(
    seed: int = 0,
    *,
    device="cuda",
    embedder_cfg: EmbedderConfig = SDXL_EMBEDDER,
    diffuser_cfg: DiffuserConfig = SDXL_BASE_DIFFUSER,
    vae_cfg: AutoencoderConfig = AutoencoderConfig(),
    unet_dtype: torch.dtype = torch.bfloat16,
    with_encoder: bool = False,
    refiner_cfg: Optional[DiffuserConfig] = None,
    tokenizer_dir: Optional[str] = None,
) -> SDXLPipeline:
    """Pipeline with random weights drawn on ``device`` (the card unless
    the caller asks for the CPU) from one seeded torch.Generator, with the
    reference's init distributions (weights N(0, 0.02^2), VAE convs
    N(0, 0.05^2), zero biases, unit norm gains) so activations stay in the
    same range as the JAX bring-up pipeline.
    with_encoder adds the VAE encoder, drawn after the decoder, for
    inpainting, img2img and training; refiner_cfg adds a refiner UNet (in
    unet_dtype), drawn last, so that every other module's weights are
    those of the same seed without it. tokenizer_dir is an external
    tokenizer data directory (tokenizer/bpe.py)."""
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
    refiner = (init_reference_(UNet(refiner_cfg.unet_config(), device,
                                    unet_dtype), g)
               if refiner_cfg is not None else None)
    for m in (embedder, unet, vae, encoder, refiner):
        if m is not None:
            m.eval().requires_grad_(False)
    alphas = torch.as_tensor(scaled_linear_alphas_cumprod(), device=device)
    return SDXLPipeline(
        embedder_cfg=embedder_cfg,
        embedder=embedder,
        diffuser_cfg=diffuser_cfg,
        unet=unet,
        alphas_cumprod=alphas,
        vae_cfg=vae_cfg,
        vae=vae,
        clip_tokenizer=ClipTokenizer(tokenizer_dir),
        open_clip_tokenizer=OpenClipTokenizer(tokenizer_dir),
        vae_encoder=encoder,
        refiner_cfg=refiner_cfg,
        refiner=refiner,
        refiner_alphas=alphas if refiner is not None else None,
    )
