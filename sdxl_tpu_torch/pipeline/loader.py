"""Assemble an SDXLPipeline from a checkpoint on disk (counterpart of
sdxl_tpu/pipeline/loader.py).

Accepted layouts (auto-detected by ``detect_format``):
  1. reference model dir:  {dir}/{embedder,diffuser,latent_decoder}.{mpk,cfg}
     (sample/main.rs:28-51)
  2. reference npy dump:   {dir}/{embedder,diffuser,latent_decoder}/... tree
     (convert/main.rs:72-121)
  3. native:               {dir}/{embedder,diffuser,latent_decoder}.safetensors
     + .cfg JSON (io/checkpoint.py save_native_pipeline)
  4. diffusers:            {dir}/{unet,vae,text_encoder,text_encoder_2}/...
  5. sgm single file:      sd_xl_*.safetensors / .ckpt, or a path to one

Every reader yields the port's state_dicts on the pipeline's device (the
card unless the caller asks for the CPU). Each module is built on the meta
device and takes its tensors with ``load_state_dict(strict=True,
assign=True)``: a missing or extra key is an error naming it, and no
weight is held twice on the device. An LCM-distilled UNet's
``time_embed.cond_proj`` is such a key: its module has one only when the
layout's config sets time_cond_proj_dim (diffuser.cfg; a diffusers dir's
cond_proj width), so a file and a config that disagree fail the load. LoRA files merge into the loaded
base modules afterwards (io/lora.py). ``use_refiner`` also loads the
refiner UNet: refiner.{safetensors,cfg} (native), refiner.{mpk,cfg},
diffuser/diffuser_refiner (npy), or the sd_xl_refiner_* file beside the
base (sgm); a diffusers dir holds no refiner and raises, as in the
reference. Quantized storage (module 14) raises NotImplementedError; the
reference's transformer stacking and HBM placement are XLA devices the
port does not need: base and refiner stay resident.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import torch
from torch import nn

from ..configs import (
    SDXL_BASE_DIFFUSER,
    SDXL_EMBEDDER,
    SDXL_REFINER_DIFFUSER,
    AutoencoderConfig,
    DiffuserConfig,
    EmbedderConfig,
    LatentDecoderConfig,
    load_cfg,
)
from ..io import checkpoint as ckpt
from ..io.bridge import fuse_qkv
from ..models.clip import CLIPTextModel
from ..models.unet import UNet
from ..models.vae import VAEDecoder, VAEEncoder
from ..tokenizer import ClipTokenizer, OpenClipTokenizer
from ..utils import log
from .k_samplers import scaled_linear_alphas_cumprod
from .pipeline import SDXLPipeline

# the layouts without config files (npy, sgm, and the mpk VAE) hold SDXL
# 1.0 at its published widths
SDXL_VAE = AutoencoderConfig()
_DECODER = ("decoder.", "post_quant_conv.")
_ENCODER = ("encoder.", "quant_conv.")


def detect_format(model_dir: str) -> str:
    if os.path.isfile(model_dir) and model_dir.endswith(
            (".safetensors", ".sft", ".ckpt", ".pt", ".pth")):
        # single-file checkpoint: sgm safetensors or the legacy torch
        # pickle (.ckpt) the A1111 era shipped
        return "sgm_single_file"
    if os.path.isfile(os.path.join(model_dir, "embedder.safetensors")):
        return "native"
    if os.path.isfile(os.path.join(model_dir, "embedder.mpk")):
        return "mpk"
    if os.path.isdir(os.path.join(model_dir, "embedder")):
        return "npy"
    if os.path.isdir(os.path.join(model_dir, "unet")) and (
        os.path.isfile(os.path.join(model_dir, "model_index.json"))
        or os.path.isdir(os.path.join(model_dir, "vae"))
    ):
        return "diffusers"
    single = (glob.glob(os.path.join(model_dir, "sd_xl_*.safetensors"))
              + glob.glob(os.path.join(model_dir, "sd_xl_*.ckpt")))
    if single:
        return "sgm_single_file"
    raise FileNotFoundError(f"no known checkpoint layout in {model_dir}")


def _load_module(module: nn.Module, sd: Dict[str, torch.Tensor], what: str,
                 device) -> nn.Module:
    """Give a meta-device module the tensors of ``sd``, moved to ``device``
    and cast there to each parameter's dtype, strictly: a missing, extra
    or misshapen key is a ValueError naming it."""
    params = dict(module.named_parameters())
    sd = {k: v.to(device).to(params[k].dtype) if k in params else v
          for k, v in sd.items()}
    try:
        module.load_state_dict(sd, strict=True, assign=True)
    except RuntimeError as e:
        raise ValueError(f"{what}: {e}") from None
    return module.eval().requires_grad_(False)


def _tower(cfg, sd: Dict[str, torch.Tensor], what: str,
           device) -> CLIPTextModel:
    """A CLIP tower from its state_dict; the projection is optional (a
    tower read for its hidden states, e.g. HF CLIPTextModel, has none)."""
    model = CLIPTextModel(cfg, "meta")
    if "text_projection" not in sd:
        model.text_projection = None
    return _load_module(model, sd, what, device)


def _embedder(cfg: EmbedderConfig, sds, device) -> nn.ModuleDict:
    return nn.ModuleDict({
        name: _tower(tcfg, sds[name], f"embedder.{name}", device)
        for name, tcfg in (("clip", cfg.clip_config),
                           ("open_clip", cfg.open_clip_config))})


def _autoencoder(cfg: AutoencoderConfig, sd: Dict[str, torch.Tensor],
                 device):
    """(VAEDecoder, VAEEncoder or None) from an autoencoder state_dict."""
    extra = [k for k in sd if not k.startswith(_DECODER + _ENCODER)]
    if extra:
        raise ValueError(f"latent decoder: unexpected key(s) {extra[:5]}")
    dec = _load_module(VAEDecoder(cfg, "meta"),
                       {k: v for k, v in sd.items() if k.startswith(_DECODER)},
                       "latent decoder", device)
    enc_sd = {k: v for k, v in sd.items() if k.startswith(_ENCODER)}
    enc = (_load_module(VAEEncoder(cfg, "meta"), enc_sd, "latent encoder",
                        device) if enc_sd else None)
    return dec, enc


def load_pipeline(
    model_dir: str,
    use_refiner: bool = False,
    compute_dtype=torch.bfloat16,
    tokenizer_dir: Optional[str] = None,
    loras=None,
    quantize: Optional[str] = None,
    device="cuda",
) -> SDXLPipeline:
    """Load any layout ``detect_format`` knows onto ``device``: the UNets
    (base, and the refiner with use_refiner) in ``compute_dtype``, the
    towers and the VAE in f32. loras is a list of (path, scale) LoRA
    safetensors files merged into the base UNet and the text towers at
    load time (io/lora.py)."""
    if quantize is not None:
        raise NotImplementedError("quantized UNet storage is not ported yet "
                                  "(module 14)")
    device = torch.device(device)
    fmt = detect_format(model_dir)
    log(f"loading checkpoint ({fmt}) from {model_dir}")
    if fmt == "diffusers" and use_refiner:
        raise ValueError(
            "refiner weights live in a separate diffusers repo; load them "
            "via a second pipeline or the single-file sgm checkpoint")
    v_cfg = SDXL_VAE
    alphas = scale = None
    # the refiner: its config, state_dict (or reference tree) and alphas
    r_cfg = r_sd = r_alphas = None

    if fmt == "diffusers":
        from ..io.diffusers_sdxl import (
            infer_sdxl_configs_from_diffusers_dir,
            load_sdxl_diffusers_dir,
        )

        # hyperparameters come from the dir's own config.json files
        e_cfg, d_cfg, v_cfg = infer_sdxl_configs_from_diffusers_dir(model_dir)
        e_sds, unet_sd, vae_sd, alphas, scale, d_cfg = \
            load_sdxl_diffusers_dir(model_dir, d_cfg, e_cfg, compute_dtype,
                                    vae_cfg=v_cfg, device=device)
        if e_sds is None:
            raise FileNotFoundError(f"text encoders missing under {model_dir}")
    elif fmt == "sgm_single_file":
        from ..io.hf_sdxl import load_sdxl_safetensors

        if os.path.isfile(model_dir):
            base_path = model_dir
        else:
            paths = sorted(
                glob.glob(os.path.join(model_dir, "sd_xl_*.safetensors"))
                + glob.glob(os.path.join(model_dir, "sd_xl_*.ckpt")))
            base_path = next((p for p in paths if "refiner" not in p),
                             paths[0])
        e_cfg, d_cfg = SDXL_EMBEDDER, SDXL_BASE_DIFFUSER
        e_sds, unet_sd, vae_sd = load_sdxl_safetensors(
            base_path, d_cfg, e_cfg, compute_dtype, device=device)
        if e_sds is None:
            raise FileNotFoundError(
                f"conditioner weights missing in {base_path}")
        if use_refiner:
            refiner_path = None if os.path.isfile(model_dir) else next(
                (p for p in paths if "refiner" in p), None)
            if refiner_path is None:
                raise FileNotFoundError("no sd_xl_refiner_*.safetensors found")
            # a refiner file carries only the bigG tower: no embedder
            r_cfg = SDXL_REFINER_DIFFUSER
            _, r_sd, _ = load_sdxl_safetensors(
                refiner_path, r_cfg, None, compute_dtype, device=device)
    elif fmt == "mpk":
        e_cfg, e_sds = ckpt.load_embedder_mpk(model_dir)
        d_cfg, unet_sd, alphas = ckpt.load_diffuser_mpk(model_dir)
        if use_refiner:
            r_cfg, r_sd, r_alphas = ckpt.load_diffuser_mpk(model_dir,
                                                           "refiner")
        l_cfg, vae_sd = ckpt.load_latent_decoder_mpk(model_dir)
        scale = l_cfg.scale_factor
    elif fmt == "npy":
        e_cfg, d_cfg = SDXL_EMBEDDER, SDXL_BASE_DIFFUSER
        e_sds = ckpt.load_embedder_npy(model_dir, e_cfg)
        unet_sd, alphas = ckpt.load_diffuser_npy(model_dir, d_cfg)
        if use_refiner:
            r_cfg = SDXL_REFINER_DIFFUSER
            r_sd, r_alphas = ckpt.load_diffuser_npy(model_dir, r_cfg,
                                                    is_refiner=True)
        vae_sd, scale = ckpt.load_latent_decoder_npy(model_dir)
    else:  # native
        def path(name):
            return os.path.join(model_dir, name)

        e_cfg = load_cfg(path("embedder.cfg"), EmbedderConfig)
        d_cfg = load_cfg(path("diffuser.cfg"), DiffuserConfig)
        l_cfg = load_cfg(path("latent_decoder.cfg"), LatentDecoderConfig)
        if os.path.isfile(path("autoencoder.cfg")):
            v_cfg = load_cfg(path("autoencoder.cfg"), AutoencoderConfig)
        e_sds = {k: ckpt.native_state_dict(path("embedder.safetensors"),
                                           device=device, prefix=k + ".")
                 for k in ("clip", "open_clip")}
        unet_sd = fuse_qkv(ckpt.native_state_dict(
            path("diffuser.safetensors"), compute_dtype, device))
        if os.path.isfile(path("alphas_cumprod.safetensors")):
            alphas = ckpt.load_native(
                path("alphas_cumprod.safetensors"))["alphas_cumprod"]
        if use_refiner:
            r_cfg = load_cfg(path("refiner.cfg"), DiffuserConfig)
            r_sd = fuse_qkv(ckpt.native_state_dict(
                path("refiner.safetensors"), compute_dtype, device))
        vae_sd = ckpt.native_state_dict(path("latent_decoder.safetensors"),
                                        device=device)
        scale = l_cfg.scale_factor

    if fmt in ("mpk", "npy"):
        # the reference's f32 numpy trees, flattened and streamed to the
        # device a leaf at a time (each name rebound, so that a host leaf
        # is freed once its tensor is made)
        e_sds = {k: ckpt.flatten_pytree(v) for k, v in e_sds.items()}
        e_sds = {k: ckpt.stream_state_dict(v, device=device)
                 for k, v in e_sds.items()}
        unet_sd = ckpt.flatten_pytree(unet_sd)
        unet_sd = fuse_qkv(ckpt.stream_state_dict(unet_sd, compute_dtype,
                                                  device))
        vae_sd = ckpt.flatten_pytree(vae_sd)
        vae_sd = ckpt.stream_state_dict(vae_sd, device=device)
        if r_sd is not None:
            r_sd = ckpt.flatten_pytree(r_sd)
            r_sd = fuse_qkv(ckpt.stream_state_dict(r_sd, compute_dtype,
                                                   device))
    embedder = _embedder(e_cfg, e_sds, device)
    unet = _load_module(UNet(d_cfg.unet_config(), "meta", compute_dtype),
                        unet_sd, "diffuser", device)
    vae, encoder = _autoencoder(v_cfg, vae_sd, device)
    refiner = None
    if r_sd is not None:
        refiner = _load_module(UNet(r_cfg.unet_config(), "meta",
                                    compute_dtype), r_sd, "refiner", device)
    del e_sds, unet_sd, vae_sd, r_sd
    if loras:
        from ..io.lora import apply_lora_files

        apply_lora_files(loras, unet=unet, te1=embedder["clip"],
                         te2=embedder["open_clip"])
    if alphas is None:
        alphas = scaled_linear_alphas_cumprod()
    alphas = torch.as_tensor(alphas, dtype=torch.float32, device=device)
    if refiner is not None:
        # the native and sgm layouts share the base's table
        r_alphas = alphas if r_alphas is None else torch.as_tensor(
            r_alphas, dtype=torch.float32, device=device)
    return SDXLPipeline(
        embedder_cfg=e_cfg,
        embedder=embedder,
        diffuser_cfg=d_cfg,
        unet=unet,
        alphas_cumprod=alphas,
        vae_cfg=v_cfg,
        vae=vae,
        clip_tokenizer=ClipTokenizer(tokenizer_dir),
        open_clip_tokenizer=OpenClipTokenizer(tokenizer_dir),
        vae_encoder=encoder,
        scale_factor=float(scale or 0.13025),
        refiner_cfg=r_cfg,
        refiner=refiner,
        refiner_alphas=r_alphas,
    )
