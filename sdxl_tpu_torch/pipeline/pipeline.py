"""SDXL pipeline: prompt (and reference image) -> uint8 images
(sdxl_tpu/pipeline/pipeline.py's SDXL paths).

Stages, as in the reference: dual-CLIP conditioning (f32) -> pair-batched
CFG DDIM, one of the twelve k-samplers or LCM over the base UNet (bf16, or
f32) -> optional refiner with the same sampler (DDIM after LCM; re-noise
at t = 1000 - refiner_step_start, or the ensemble-of-experts tail after
``denoising_end``) -> VAE decode (f32, or bf16 with ``vae_dtype``) ->
uint8 RGB. Inpainting, img2img, outpaint and DDIM inversion first encode
their reference images with the VAE encoder (f32); ``vae_tile`` tiles
both VAE directions (latent.py). ``txt2img_hires`` samples, upscales the
latent and refines it at the target size; ``ip2p`` edits an image with an
8-channel InstructPix2Pix UNet.

Precision: building a pipeline sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` so the f32 stages (CLIP, the
DDIM update, the VAE decode) run in full f32 on the GPU; cuDNN would
otherwise run f32 convolutions in TF32.

Ported options of ``txt2img``: prompts, resolution, n_steps,
guidance_scale, seed (one int), negative_prompt, profile_stages,
initial_latent, use_refiner, refiner_step_start, denoising_end,
inpaint_reference, inpaint_mask, sampler (ddim, any of K_SAMPLERS, or
lcm), schedule, guidance_rescale, no_cfg, ddim_eta, preview_every,
preview_callback, deepcache, pag_scale, control_image, control_scale,
control_start, control_end (the ControlNets of ``load_controlnet``),
ip_adapter_image and ip_adapter_scale (the adapter of
``load_ip_adapter``), with FreeU through ``diffuser_cfg.freeu``;
``inpaint`` and ``outpaint`` take the same keywords, ``img2img`` those
the reference's takes, and ``ddim_invert`` inverts images. The
reference's device_output raises NotImplementedError, and per-image seed
lists too. The base and the refiner stay resident on the device: the
reference's HBM planner has no work on an 80 GB card.

Noise: one torch.Generator seeded with ``seed`` gives, in this order, the
initial latent noise, the inpainting pin noise of every step, the base's
step noise (stochastic k-samplers, LCM, DDIM eta > 0), and the refiner's
re-noise and step noise (img2img: its re-noise and step noise). JAX and
torch draws differ, so the same seed gives another image than the
reference.
"""

from __future__ import annotations

import os
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
from .latent import (
    decode_latent_tiled,
    decode_latent_to_images,
    encode_images_tiled,
    encode_images_to_latent,
)
from .k_samplers import (
    K_SAMPLERS,
    host_table,
    rescale_zero_terminal_snr,
    scaled_linear_alphas_cumprod,
)
from .masks import build_latent_mask
from .resolutions import RESOLUTIONS, validate_resolution
from .sampler import (
    PreviewFn,
    ddim_invert_latent,
    euler_sample_latent,
    expert_head_steps,
    k_refine_latent,
    lcm_refine_latent,
    lcm_sample_latent,
    refine_latent,
    sample_latent,
)

SAMPLERS = ("ddim",) + K_SAMPLERS + ("lcm",)


def _unported(options: dict, what: str) -> None:
    """NotImplementedError for a reference option the port lacks."""
    if options:
        raise NotImplementedError(
            f"{what} options not ported yet: {', '.join(sorted(options))}")


def _check_sampler(sampler: str, schedule: str, ddim_eta: float) -> None:
    """The reference's checks of a request's sampler keywords."""
    if sampler not in SAMPLERS:
        raise ValueError(
            f"unknown sampler {sampler!r} ({'|'.join(SAMPLERS)})")
    if ddim_eta and sampler != "ddim":
        raise ValueError("ddim_eta applies to sampler='ddim' only (the "
                         "k-samplers have their own ancestral variants)")
    if schedule != "linear" and sampler in ("ddim", "lcm"):
        raise ValueError(
            "--schedule applies to the euler/dpmpp samplers; the DDIM "
            "and LCM schedules are fixed by their reference semantics")


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
    # ControlNet (load_controlnet): one trunk or a tuple of them; a request
    # with a control_image runs them
    controlnet: object = None
    # IP-Adapter (load_ip_adapter) and its CLIP vision tower, both f32, each
    # with its config as .cfg; a request with an ip_adapter_image runs them
    ip_adapter: Optional[nn.Module] = None
    ip_vision: Optional[nn.Module] = None
    # tiled VAE decode and encode: the latent tile size (None: whole
    # images)
    vae_tile: Optional[int] = None
    # unconditional half of the conditioning, memoised across requests
    # (see text_to_conditioning); clear it when the embedder changes
    _uncond_cache: dict = field(default_factory=dict)

    # the Align-Your-Steps table of this family (arXiv:2404.14507)
    _ays_variant = "ays"

    def __post_init__(self):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def _resolve_schedule(self, schedule: str) -> str:
        return self._ays_variant if schedule == "ays" else schedule

    def rescale_zsnr(self):
        """Rescale the base's ᾱ table to zero terminal SNR in place
        (k_samplers.rescale_zero_terminal_snr), for checkpoints finetuned
        with the Lin et al. 2023 fix; pair it with schedule="trailing" and
        guidance_rescale > 0. The refiner's table stays as it is (the
        refiner is no ZSNR finetune). Returns self."""
        self.alphas_cumprod = torch.as_tensor(
            rescale_zero_terminal_snr(host_table(self.alphas_cumprod)),
            device=self.device)
        if self.refiner_alphas is not None:
            log("warning: --zsnr leaves the refiner's alpha-bar table "
                "unrescaled (the refiner is not a ZSNR finetune); "
                "combining --zsnr with a refiner is not a published recipe")
        self._uncond_cache.clear()
        return self

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

    def _encode(self, images, scale_factor: Optional[float] = None
                ) -> torch.Tensor:
        """[B, H, W, 3] uint8 (numpy or tensor) -> VAE latent on the
        device, encoded in f32 (tiled with vae_tile) and times
        scale_factor (the pipeline's by default)."""
        if self.vae_encoder is None:
            raise ValueError(
                "this pipeline has no VAE encoder (a checkpoint without "
                "encoder weights, or random_pipeline(with_encoder=False))")
        sf = self.scale_factor if scale_factor is None else scale_factor
        images = self._on_device(images)
        if self.vae_tile is not None:
            return encode_images_tiled(self.vae_encoder, images, sf,
                                       tile=self.vae_tile)
        return encode_images_to_latent(self.vae_encoder, images, sf)

    def _decode(self, latent: torch.Tensor) -> np.ndarray:
        """The final latent -> uint8 images on the host; with vae_tile
        each image is decoded in tiles on its own."""
        self.last_latent = latent
        with self.timer.stage("vae_decode"):
            if self.vae_tile is not None:
                images = torch.cat([
                    decode_latent_tiled(self.vae, latent[i:i + 1],
                                        self.scale_factor, self.vae_dtype,
                                        tile=self.vae_tile)
                    for i in range(latent.shape[0])])
            else:
                images = decode_latent_to_images(self.vae, latent,
                                                 self.scale_factor,
                                                 self.vae_dtype)
            fence(images)
        return images.cpu().numpy()

    def load_controlnet(self, model_dir) -> None:
        """Load diffusers-layout ControlNetModel directories for this
        pipeline's UNet (io/diffusers_sdxl.py) in its dtype: one path, or a
        sequence for multi-ControlNet (diffusers' MultiControlNetModel: the
        residuals summed, each net at its own scale and window). A request
        with a control_image then runs the trunk(s) every step."""
        from ..io.diffusers_sdxl import load_controlnet_dir

        dirs = ([model_dir] if isinstance(model_dir, (str, os.PathLike))
                else list(model_dir))
        loaded = [load_controlnet_dir(d, self.diffuser_cfg,
                                      self.compute_dtype, self.device)
                  for d in dirs]
        self.controlnet = (loaded[0][0] if len(loaded) == 1
                           else tuple(net for net, _ in loaded))
        log(f"controlnet loaded from {', '.join(map(str, dirs))}"
            + (f" ({len(loaded)} nets)" if len(loaded) > 1 else ""))

    def load_ip_adapter(self, adapter_path: str,
                        image_encoder_dir: str) -> None:
        """Load an official IP-Adapter safetensors file and its
        transformers CLIPVisionModelWithProjection directory
        (io/ip_adapter.py), both f32. A request with an ip_adapter_image
        then adds the decoupled image-token attention to the base UNet
        (the refiner's stage runs without it)."""
        from ..io.ip_adapter import load_clip_vision_dir, load_ip_adapter_file

        self.ip_vision, vision_cfg = load_clip_vision_dir(image_encoder_dir,
                                                          self.device)
        self.ip_adapter, cfg = load_ip_adapter_file(
            adapter_path, self.diffuser_cfg.unet_config(), self.device)
        # "proj" reads the projected image embedding; the "plus"
        # Resampler the penultimate hidden states
        enc_dim = (vision_cfg.n_state if cfg.variant == "resampler"
                   else vision_cfg.embed_dim)
        if cfg.clip_embed_dim != enc_dim:
            raise ValueError(
                f"IP-Adapter expects {cfg.clip_embed_dim}-d "
                f"image features but the encoder provides {enc_dim} — "
                "wrong image encoder? (ip-adapter_sdxl pairs with "
                "ViT-bigG, *_vit-h adapters with ViT-H)")
        log(f"ip-adapter loaded from {adapter_path} "
            f"(encoder {image_encoder_dir}, "
            f"{cfg.variant} variant, {cfg.n_tokens} image tokens)")

    def _prep_ip(self, image, scale: float) -> Optional[dict]:
        """ip_adapter_image -> the samplers' ``ip``: the image through the
        vision tower and the adapter's projection once a request, with the
        unconditional rows' tokens (a zero embedding for the proj variant;
        the tower on zero pixels, after normalisation, for plus)."""
        if image is None:
            return None
        if self.ip_adapter is None:
            raise ValueError(
                "ip_adapter_image given but no IP-Adapter is loaded "
                "(pipe.load_ip_adapter / --ip-adapter)")
        from ..models.clip_vision import (
            clip_vision_embed,
            clip_vision_penultimate,
            preprocess_image,
        )
        from ..models.ip_adapter import (
            ip_image_tokens,
            organize_ip_layers,
            resampler_tokens,
        )

        pixels = preprocess_image(image, self.ip_vision.cfg, self.device)
        if self.ip_adapter.cfg.variant == "resampler":
            tokens, utokens = (
                resampler_tokens(self.ip_adapter, clip_vision_penultimate(
                    self.ip_vision, px))
                for px in (pixels, torch.zeros_like(pixels)))
        else:
            embed = clip_vision_embed(self.ip_vision, pixels)
            tokens, utokens = (ip_image_tokens(self.ip_adapter, e)
                               for e in (embed, torch.zeros_like(embed)))
        return {"layers": organize_ip_layers(
                    self.ip_adapter, self.diffuser_cfg.unet_config()),
                "tokens": tokens, "tokens_uncond": utokens,
                "scale": float(scale)}

    @property
    def n_controlnets(self) -> int:
        if self.controlnet is None:
            return 0
        return len(self.controlnet) if isinstance(self.controlnet,
                                                  tuple) else 1

    def _prep_one_control(self, control_image, resolution,
                          batch: int) -> torch.Tensor:
        """A control image ([H, W, 3] or [B, H, W, 3], uint8 or float in
        [0, 1]) at the generation's resolution -> [batch, H, W, 3] f32 in
        [0, 1] on the device."""
        img = np.asarray(control_image)
        if img.ndim == 3:
            img = img[None]
        h, w = resolution
        if img.shape[1:3] != (h, w):
            raise ValueError(
                f"control image is {img.shape[1]}x{img.shape[2]}, generation "
                f"resolution is {h}x{w} — they must match")
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        return img.expand(batch, h, w, 3)

    def _control_kwargs(self, control_image, control_scale, control_start,
                        control_end, resolution, batch: int) -> dict:
        """The samplers' ControlNet keywords: one control image for one net
        (a scale, start and end, or one-item sequences), or a sequence of N
        images for N nets (each of scale, start and end one float for all
        or N)."""
        if control_image is None:
            return {}
        n = self.n_controlnets
        if n == 0:
            raise ValueError(
                "control_image given but no ControlNet is loaded "
                "(pipe.load_controlnet / --controlnet)")
        multi_img = (isinstance(control_image, (list, tuple))
                     or (isinstance(control_image, np.ndarray)
                         and control_image.ndim == 5))

        def per_net(v, name):
            if isinstance(v, (list, tuple)):
                if len(v) != n:
                    raise ValueError(
                        f"{name}: {len(v)} values for {n} ControlNets")
                return tuple(float(x) for x in v)
            return (float(v),) * n

        def first(v):
            return float(v[0] if isinstance(v, (list, tuple)) else v)

        if n == 1 and not multi_img:
            return dict(
                controlnet=self.controlnet,
                control_image=self._prep_one_control(control_image,
                                                     resolution, batch),
                control_scale=first(control_scale),
                control_window=(first(control_start), first(control_end)))
        imgs = list(control_image) if multi_img else [control_image] * n
        if len(imgs) != n:
            raise ValueError(f"{len(imgs)} control images for {n} "
                             "ControlNets")
        nets = (self.controlnet if isinstance(self.controlnet, tuple)
                else (self.controlnet,))
        return dict(
            controlnet=nets,
            control_image=tuple(self._prep_one_control(im, resolution, batch)
                                for im in imgs),
            control_scale=per_net(control_scale, "control_scale"),
            control_window=tuple(zip(per_net(control_start, "control_start"),
                                     per_net(control_end, "control_end"))))

    def _sample(self, cond: Conditioning, generator, guidance_scale: float,
                n_steps: int, sampler: str, schedule: str,
                ddim_eta: float = 0.0, ext: Optional[dict] = None,
                **common) -> torch.Tensor:
        """The base UNet from seeded noise (txt2img, hires-fix's first
        pass, ip2p) with LCM, a k-sampler or DDIM. ``common`` goes to
        each sampler; ``ext`` (the options LCM refuses or ignores) to the
        k-sampler and DDIM loops only."""
        args = (self.unet, self.diffuser_cfg, self.alphas_cumprod, cond,
                generator, guidance_scale, n_steps, self.compute_dtype)
        if sampler == "lcm":
            return lcm_sample_latent(*args, **common)
        if sampler in K_SAMPLERS:
            return euler_sample_latent(*args, method=sampler,
                                       schedule=schedule, **common,
                                       **(ext or {}))
        return sample_latent(*args, ddim_eta=ddim_eta, **common,
                             **(ext or {}))

    def _refine(self, latent: torch.Tensor, cond: Conditioning, generator,
                guidance_scale: float, strength: float, n_steps: int,
                sampler: str, schedule: str, ddim_eta: float = 0.0,
                ext: Optional[dict] = None, **common) -> torch.Tensor:
        """The base UNet from a clean ``latent`` re-noised at
        ``strength`` (img2img, hires-fix's second pass): LCM over its
        grid windowed by strength, a k-sampler or DDIM from step_start =
        round((1 - strength) * 1000). ``common`` and ``ext`` as
        _sample's."""
        args = (self.unet, self.diffuser_cfg, self.alphas_cumprod, latent,
                cond, generator, guidance_scale)
        if sampler == "lcm":
            return lcm_refine_latent(*args, strength, n_steps,
                                     self.compute_dtype, **common)
        step_start = int(round((1.0 - strength) * 1000))
        if sampler in K_SAMPLERS:
            return k_refine_latent(*args, step_start, n_steps,
                                   self.compute_dtype, method=sampler,
                                   schedule=schedule, **common,
                                   **(ext or {}))
        return refine_latent(*args, step_start, n_steps, self.compute_dtype,
                             ddim_eta=ddim_eta, **common, **(ext or {}))

    @torch.inference_mode()
    def txt2img(self, prompts, resolution: Tuple[int, int] = (1024, 1024),
                n_steps: int = 30, guidance_scale: float = 7.5, seed: int = 0,
                use_refiner: bool = False, refiner_step_start: int = 800,
                denoising_end: Optional[float] = None,
                negative_prompt: str = "",
                inpaint_reference: Optional[np.ndarray] = None,
                inpaint_mask=None, profile_stages: bool = True,
                sampler: str = "ddim", schedule: str = "linear",
                guidance_rescale: float = 0.0, no_cfg: bool = False,
                preview_every: Optional[int] = None,
                preview_callback: Optional[PreviewFn] = None,
                deepcache: Optional[Tuple[int, int]] = None,
                pag_scale: float = 0.0,
                initial_latent: Optional[torch.Tensor] = None,
                ddim_eta: float = 0.0, control_image=None,
                control_scale=1.0, control_start=0.0, control_end=1.0,
                ip_adapter_image=None, ip_adapter_scale: float = 0.6,
                **options) -> np.ndarray:
        """Prompt(s) -> [B, H, W, 3] uint8 images (numpy, on the host).

        sampler: "ddim" (the reference's), a k-sampler (K_SAMPLERS) in
        sigma space, on the base and on the refiner stage, or "lcm" (4-8
        steps; an LCM-distilled UNet embeds the guidance and runs without
        CFG; the refiner stage then runs DDIM); schedule (the
        k-samplers'): linear, karras, ays (this family's table),
        trailing, leading. ddim_eta > 0 (DDIM only): stochastic DDIM.
        guidance_rescale > 0: the Lin et al. 2023 std rescale of the
        guided eps. no_cfg, or guidance_scale == 1: the conditional rows
        alone, batch B, half the UNet work.
        preview_every=N: between every N steps of the base stage,
        preview_callback(done, total, [B, h, w, 3] uint8) gets a
        linear-map preview of the latent; the final image is the one
        without previews.
        pag_scale > 0: Perturbed-Attention Guidance, one more conditional
        UNet call a step. deepcache (interval, branch): DeepCache, the
        whole UNet every interval-th step (the refiner stage too). FreeU
        runs when ``diffuser_cfg.freeu`` is set.
        control_image ([H, W, 3] or [B, H, W, 3], uint8 or [0, 1] float,
        the request's size; a sequence of them with several ControlNets):
        the loaded ControlNet(s) every step of the base stage, residuals
        scaled by control_scale inside the (control_start, control_end)
        step-fraction window (each one float, or one per net).
        ip_adapter_image (any size; CLIP-resized): the loaded IP-Adapter's
        image tokens at ip_adapter_scale in every cross-attention of the
        base stage.
        initial_latent ([B, h, w, 4], VP space at the first grid timestep,
        e.g. ddim_invert's; DDIM only) replaces the seeded starting noise.
        use_refiner: after the base, the refiner re-noises the latent at
        t = 1000 - refiner_step_start and runs the grid's tail.
        denoising_end (with use_refiner): the ensemble-of-experts split —
        the base runs the grid entries with t >= round(1000 * (1 -
        denoising_end)) and the refiner the rest, with no re-noise.
        inpaint_reference [1, H, W, 3] uint8 with inpaint_mask [1, h, w, 4]
        (bool, or float in [0, 1]; 1 = generate): on a 4-channel UNet the
        known region is pinned to the re-noised reference every step; a
        9-channel inpainting UNet takes [mask, latent of the reference
        with the masked pixels set to 127] as extra input channels
        instead."""
        _unported(options, "txt2img")
        if not isinstance(seed, (int, np.integer)):
            raise NotImplementedError("per-image seed lists are not ported yet")
        h, w = resolution
        if h % 8 or w % 8:
            raise ValueError(f"resolution {h}x{w} must be a multiple of 8")
        if not validate_resolution(h, w):
            log(f"warning: {h}x{w} is not an SDXL-trained resolution bucket")
        if initial_latent is not None:
            if sampler != "ddim":
                raise ValueError(
                    "initial_latent starts the DDIM chain (ddim_invert's "
                    "output is defined on it) — use sampler='ddim'")
            if (inpaint_reference is not None or use_refiner
                    or preview_every is not None):
                raise ValueError(
                    "initial_latent is not combinable with inpainting, "
                    "the refiner, previews, or per-image seed lists")
            lh, lw = h // 8, w // 8
            if tuple(initial_latent.shape[1:]) != (lh, lw, 4):
                raise ValueError(
                    f"initial_latent shape {tuple(initial_latent.shape)} "
                    f"does not match resolution {h}x{w} "
                    f"(expect [B, {lh}, {lw}, 4])")
        if inpaint_reference is not None and inpaint_mask is None:
            raise ValueError("inpaint_reference needs an inpaint_mask")
        _check_sampler(sampler, schedule, ddim_eta)
        schedule = self._resolve_schedule(schedule)
        use_cfg = not (no_cfg or guidance_scale == 1.0)
        lcm = sampler == "lcm"
        if lcm and self.diffuser_cfg.time_cond_proj_dim:
            # an LCM-distilled UNet embeds the guidance: no CFG pair
            use_cfg = False
        if deepcache is not None and preview_every is not None:
            raise ValueError(
                "deepcache is incompatible with step previews (the "
                "segmented scans do not carry the feature cache)")
        if preview_every is not None and lcm:
            raise ValueError(
                "step previews are not supported with the LCM sampler "
                "(4-8 steps total; preview the final image instead)")
        if pag_scale:
            if preview_every is not None:
                raise ValueError("pag_scale is not supported with step "
                                 "previews")
            if lcm:
                raise ValueError("pag_scale does not apply to the LCM "
                                 "sampler (consistency models embed their "
                                 "own guidance)")
        head_steps = 0
        if denoising_end is not None:
            if not use_refiner:
                raise ValueError(
                    "denoising_end is the ensemble-of-experts base/refiner "
                    "split — it requires use_refiner=True")
            if preview_every is not None or lcm:
                raise ValueError("denoising_end is not combinable with step "
                                 "previews or the LCM sampler")
            if inpaint_reference is not None:
                raise ValueError("denoising_end is not combinable with "
                                 "inpainting (the refiner tail has no pin "
                                 "path)")
            head_steps, grid_total = expert_head_steps(
                self.alphas_cumprod, n_steps, denoising_end, sampler,
                schedule)
            log(f"expert split: base {head_steps} steps, refiner "
                f"{grid_total - head_steps} steps (denoising_end="
                f"{denoising_end})")
        if lcm and deepcache is not None:
            raise ValueError("deepcache is not supported with the LCM "
                             "sampler (few-step by design)")
        if use_refiner and self.refiner is None:
            raise ValueError("refiner weights not loaded")

        cond = self.conditioning(prompts, resolution, negative_prompt,
                                 profile_stages)
        ctl = self._control_kwargs(control_image, control_scale,
                                   control_start, control_end, resolution,
                                   cond.batch)
        ipd = self._prep_ip(ip_adapter_image, ip_adapter_scale)
        noise = None
        if initial_latent is not None:
            noise = torch.as_tensor(initial_latent, dtype=torch.float32,
                                    device=self.device)
            if noise.shape[0] != cond.batch:
                raise ValueError(
                    f"initial_latent batch {noise.shape[0]} for a "
                    f"{cond.batch}-image batch")
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

        common = dict(initial_noise=noise, reference=reference_latent,
                      mask=mask, concat_channels=concat, use_cfg=use_cfg,
                      ip=ipd, **ctl)
        ext = dict(head_steps=head_steps, guidance_rescale=guidance_rescale,
                   deepcache=deepcache, pag_scale=pag_scale,
                   preview_every=preview_every,
                   preview_callback=preview_callback)
        with self.timer.stage("diffuser"):
            latent = self._sample(cond.astype(self.compute_dtype), generator,
                                  guidance_scale, n_steps, sampler, schedule,
                                  ddim_eta, ext, **common)
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
            # the expert tail continues the full grid's suffix from the
            # still-noisy handoff: no re-noise, step_start 0
            stage = dict(renoise=not expert,
                         tail_from=head_steps if expert else 0,
                         deepcache=deepcache)
            with self.timer.stage("refiner"):
                if sampler in K_SAMPLERS:
                    latent = k_refine_latent(
                        self.refiner, self.refiner_cfg, refiner_alphas,
                        latent, cond.astype(self.compute_dtype), generator,
                        guidance_scale, 0 if expert else refiner_step_start,
                        n_steps, self.compute_dtype, method=sampler,
                        schedule=schedule, **stage)
                else:
                    latent = refine_latent(
                        self.refiner, self.refiner_cfg, refiner_alphas,
                        latent, cond.astype(self.compute_dtype), generator,
                        guidance_scale, 0 if expert else refiner_step_start,
                        n_steps, self.compute_dtype, ddim_eta=ddim_eta,
                        **stage)
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
                negative_prompt: str = "", sampler: str = "ddim",
                schedule: str = "linear", guidance_rescale: float = 0.0,
                no_cfg: bool = False,
                deepcache: Optional[Tuple[int, int]] = None,
                pag_scale: float = 0.0, ddim_eta: float = 0.0,
                control_image=None, control_scale=1.0, control_start=0.0,
                control_end=1.0, ip_adapter_image=None,
                ip_adapter_scale: float = 0.6, **options) -> np.ndarray:
        """Strength-based image-to-image: encode the [B, H, W, 3] uint8
        references, re-noise at t = strength * 1000 (a k-sampler: to its
        schedule's first sigma there; LCM: to the first point of its grid
        windowed by strength) and run the rest of the grid with CFG on the
        base UNet (refine_latent, k_refine_latent, lcm_refine_latent). The
        sampler keywords, deepcache, pag_scale, the ControlNet keywords
        (the window over the steps run) and the IP-Adapter's are
        txt2img's."""
        _unported(options, "img2img")
        if not 0.0 < strength <= 1.0:
            raise ValueError("strength must be in (0, 1]")
        _check_sampler(sampler, schedule, ddim_eta)
        schedule = self._resolve_schedule(schedule)
        _, height, width, _ = reference_images.shape
        cond = self.conditioning(
            [prompts] if isinstance(prompts, str) else prompts,
            (height, width), negative_prompt=negative_prompt,
        ).astype(self.compute_dtype)
        with self.timer.stage("vae_encode"):
            latent = self._encode(reference_images)
            fence(latent)
        ctl = self._control_kwargs(control_image, control_scale,
                                   control_start, control_end,
                                   (height, width), cond.batch)
        ipd = self._prep_ip(ip_adapter_image, ip_adapter_scale)
        use_cfg = not (no_cfg or guidance_scale == 1.0)
        if sampler == "lcm" and self.diffuser_cfg.time_cond_proj_dim:
            use_cfg = False
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        if sampler == "lcm":
            if deepcache is not None:
                raise ValueError("deepcache is not supported with the "
                                 "LCM sampler (few-step by design)")
            if pag_scale:
                raise ValueError("pag_scale does not apply to the LCM "
                                 "sampler")
        ext = dict(guidance_rescale=guidance_rescale, deepcache=deepcache,
                   pag_scale=pag_scale)
        with self.timer.stage("diffuser"):
            latent = self._refine(latent, cond, generator, guidance_scale,
                                  strength, n_steps, sampler, schedule,
                                  ddim_eta, ext, use_cfg=use_cfg, ip=ipd,
                                  **ctl)
        return self._decode(latent)

    @torch.inference_mode()
    def txt2img_hires(self, prompts, resolution: Tuple[int, int] = (1024,
                                                                    1024),
                      hires_scale: float = 2.0, hires_strength: float = 0.3,
                      n_steps: int = 30, guidance_scale: float = 7.5,
                      seed: int = 0, negative_prompt: str = "",
                      sampler: str = "ddim", schedule: str = "linear",
                      guidance_rescale: float = 0.0,
                      no_cfg: bool = False, **options) -> np.ndarray:
        """Hires-fix: sample at ``resolution``, upscale the latent by
        hires_scale (bicubic, the size rounded to a multiple of 8 pixels),
        then re-noise at hires_strength and denoise the grid's tail at the
        target size (stage ``hires``) under a second conditioning at that
        size. The generator gives the base's draws, then the hires pass's
        re-noise and step noise."""
        _unported(options, "txt2img_hires")
        h, w = resolution
        hh = int(round(h * hires_scale / 8.0)) * 8
        hw = int(round(w * hires_scale / 8.0)) * 8
        if hires_scale <= 1.0:
            raise ValueError("hires_scale must be > 1")
        if not 0.0 < hires_strength <= 1.0:
            raise ValueError("hires_strength must be in (0, 1]")
        if sampler not in SAMPLERS:
            raise ValueError(
                f"unknown sampler {sampler!r} ({'|'.join(SAMPLERS)})")
        schedule = self._resolve_schedule(schedule)
        use_cfg = not (no_cfg or guidance_scale == 1.0)
        if sampler == "lcm" and self.diffuser_cfg.time_cond_proj_dim:
            use_cfg = False
        ext = dict(guidance_rescale=guidance_rescale)
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        cond = self.conditioning(prompts, resolution,
                                 negative_prompt).astype(self.compute_dtype)
        with self.timer.stage("diffuser"):
            latent = self._sample(cond, generator, guidance_scale, n_steps,
                                  sampler, schedule, ext=ext,
                                  use_cfg=use_cfg)
            fence(latent)
        # the reference's jax.image.resize "cubic": Keys' a = -0.5 (torch's
        # antialiased bicubic; an upscale needs no antialiasing)
        up = torch.nn.functional.interpolate(
            latent.float().permute(0, 3, 1, 2), size=(hh // 8, hw // 8),
            mode="bicubic", align_corners=False, antialias=True
        ).permute(0, 2, 3, 1)
        cond_hi = self.conditioning(prompts, (hh, hw),
                                    negative_prompt).astype(self.compute_dtype)
        with self.timer.stage("hires"):
            latent = self._refine(up, cond_hi, generator, guidance_scale,
                                  hires_strength, n_steps, sampler, schedule,
                                  ext=ext, use_cfg=use_cfg)
            fence(latent)
        return self._decode(latent)

    @torch.inference_mode()
    def ip2p(self, prompts, edit_images: np.ndarray, n_steps: int = 30,
             guidance_scale: float = 7.5, image_guidance_scale: float = 1.5,
             seed: int = 0, negative_prompt: str = "", sampler: str = "ddim",
             schedule: str = "linear", no_cfg: bool = False,
             **options) -> np.ndarray:
        """InstructPix2Pix (Brooks et al. 2023, arXiv:2211.09800) on an
        8-channel edit UNet: the prompt is the edit instruction; sampling
        starts from noise at the image's size with the edit image's
        latents as 4 extra input channels — its posterior mean unscaled
        (scale factor 1.0, the ip2p training convention and diffusers').
        Guidance is the 3-way e_u + s_I (e_img - e_u) + s_T (e_txt -
        e_img), s_T = guidance_scale, s_I = image_guidance_scale; no_cfg
        (or both scales 1) runs the conditional rows alone."""
        _unported(options, "ip2p")
        if not isinstance(seed, (int, np.integer)):
            raise NotImplementedError("per-image seed lists are not ported yet")
        edit_images = np.asarray(edit_images)
        if edit_images.ndim == 3:
            edit_images = edit_images[None]
        _, height, width, _ = edit_images.shape
        if height % 8 or width % 8:
            raise ValueError(f"edit image {height}x{width} must be a "
                             "multiple of 8")
        cond = self.conditioning(
            [prompts] if isinstance(prompts, str) else prompts,
            (height, width), negative_prompt=negative_prompt,
        ).astype(self.compute_dtype)
        with self.timer.stage("vae_encode"):
            edit_latents = self._encode(edit_images, scale_factor=1.0)
            if edit_latents.shape[0] == 1 and cond.batch > 1:
                edit_latents = edit_latents.expand(cond.batch,
                                                   *edit_latents.shape[1:])
            fence(edit_latents)
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r} "
                             f"({'|'.join(SAMPLERS)})")
        if sampler == "lcm":
            raise ValueError("the LCM sampler does not serve ip2p "
                             "checkpoints")
        if schedule != "linear" and sampler == "ddim":
            raise ValueError("--schedule applies to the euler/dpmpp "
                             "samplers")
        schedule = self._resolve_schedule(schedule)
        use_cfg = not (no_cfg or (guidance_scale == 1.0
                                  and image_guidance_scale == 1.0))
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        with self.timer.stage("diffuser"):
            latent = self._sample(cond, generator, guidance_scale, n_steps,
                                  sampler, schedule, use_cfg=use_cfg,
                                  concat_channels=edit_latents, edit=True,
                                  image_guidance_scale=image_guidance_scale)
            fence(latent)
        return self._decode(latent)

    @torch.inference_mode()
    def ddim_invert(self, prompts, images: np.ndarray, n_steps: int = 50,
                    guidance_scale: float = 1.0,
                    negative_prompt: str = "") -> np.ndarray:
        """DDIM inversion (sampler.ddim_invert_latent): VAE-encode
        ``images`` ([B, H, W, 3] uint8, or one [H, W, 3]) and walk the
        deterministic DDIM chain backward under ``prompts``; returns the
        [B, h, w, 4] f32 latent at the grid's first timestep, on the host.
        txt2img(initial_latent=..., sampler="ddim", the same n_steps)
        regenerates the images under the source prompt, or edits them
        under another. guidance_scale 1 (no CFG pair) inverts the
        unguided field, the faithful setting."""
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        _, height, width, _ = images.shape
        cond = self.conditioning(
            [prompts] if isinstance(prompts, str) else prompts,
            (height, width), negative_prompt=negative_prompt,
        ).astype(self.compute_dtype)
        with self.timer.stage("vae_encode"):
            latent = self._encode(images)
            fence(latent)
            b = cond.batch
            if latent.shape[0] == 1 and b > 1:
                latent = latent.expand(b, *latent.shape[1:])
        with self.timer.stage("diffuser"):
            out = ddim_invert_latent(
                self.unet, self.diffuser_cfg, self.alphas_cumprod, latent,
                cond, guidance_scale, n_steps, self.compute_dtype)
            fence(out)
        return out.cpu().numpy()

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
