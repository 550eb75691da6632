"""Import SDXL and SD 1.x / 2.x weights from a diffusers model directory
(counterpart of sdxl_tpu/io/diffusers_sdxl.py).

The `stabilityai/stable-diffusion-xl-base-1.0` repository layout:

    {dir}/unet/diffusion_pytorch_model*.safetensors
    {dir}/vae/diffusion_pytorch_model*.safetensors
    {dir}/text_encoder/model*.safetensors      (CLIP ViT-L, HF layout)
    {dir}/text_encoder_2/model*.safetensors    (bigG, HF *WithProjection*)
    {dir}/scheduler/scheduler_config.json      (beta schedule)

diffusers block indices map onto the reference/ldm block order:
  down_blocks.{L}.resnets.{j}   -> input_blocks[1 + 3L + j]
  down_blocks.{L}.downsamplers  -> input_blocks[3(L+1)]
  up_blocks.{i} (deep->shallow) -> output_blocks[3i .. 3i+2]

As in io/hf_sdxl.py, the files are in torch's layouts already: the
builders return the port's state_dicts of zero-copy views moved to the
device one tensor at a time. An inpainting UNet (conv_in of 9 channels)
loads with its config's in_channels set to 9, an LCM-distilled UNet with
its time_cond_proj_dim set to the width of time_embedding.cond_proj (its
guidance-embedding projection, ``time_embed.cond_proj`` in the port), an
InstructPix2Pix UNet (8 channels) with in_channels 8.

A diffusers ``ControlNetModel`` directory (controlnet-canny-sdxl-1.0's
layout) loads with ``load_controlnet_dir``: the trunk's keys are the
UNet's input side (conv_in, down_blocks, mid_block), plus
controlnet_cond_embedding.*, controlnet_down_blocks.{i} (one zero conv an
input block) and controlnet_mid_block; io/diffusers_write.py writes it.

``load_sd1_diffusers_dir`` reads the single-tower StableDiffusionPipeline
layout (runwayml/stable-diffusion-v1-5, stabilityai/stable-diffusion-2-1):
unet/ (no add_embedding), vae/, text_encoder/ and the scheduler's ᾱ
table. As in the reference, it does not read the scheduler's
prediction_type: SD 2.1-768's v-prediction comes from the caller's config.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict

import numpy as np
import torch

from ..configs import AutoencoderConfig, CLIPConfig, UNetConfig
from ..models.unet import unet_block_plan
from .bridge import fuse_qkv
from .checkpoint import flatten_pytree
from .hf_sdxl import _KeyStore, build_clip_from_hf, cfg_with_conv_in
from .safetensors import load_file


def _load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    files = sorted(
        glob.glob(os.path.join(path, "*.safetensors"))
        + glob.glob(os.path.join(path, "*.sft"))
    )
    if not files:
        raise FileNotFoundError(f"no safetensors under {path}")
    out: Dict[str, torch.Tensor] = {}
    for f in files:
        out.update(load_file(f))
    return out


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------

def _dif_res(ks: _KeyStore, key: str):
    s = ks.sub(key)
    p = {
        "norm_in": s.norm("norm1"),
        "conv_in": s.conv("conv1"),
        "lin_embed": s.linear("time_emb_proj"),
        "norm_out": s.norm("norm2"),
        "conv_out": s.conv("conv2"),
    }
    if s.has("conv_shortcut.weight"):
        p["skip"] = s.conv("conv_shortcut")
    return p


def _dif_attn(ks: _KeyStore, key: str):
    s = ks.sub(key)
    return {
        "q": s.linear("to_q"),
        "k": s.linear("to_k"),
        "v": s.linear("to_v"),
        "out": s.linear("to_out.0"),
    }


def _dif_spatial(ks: _KeyStore, key: str):
    s = ks.sub(key)
    blocks = []
    i = 0
    while s.has(f"transformer_blocks.{i}.norm1.weight"):
        b = s.sub(f"transformer_blocks.{i}")
        blocks.append(
            {
                "norm1": b.norm("norm1"),
                "attn1": _dif_attn(b, "attn1"),
                "norm2": b.norm("norm2"),
                "attn2": _dif_attn(b, "attn2"),
                "norm3": b.norm("norm3"),
                "mlp": {
                    "proj": b.linear("ff.net.0.proj"),
                    "lin": b.linear("ff.net.2"),
                },
            }
        )
        i += 1
    return {
        "norm": s.norm("norm"),
        "proj_in": s.linear("proj_in"),
        "blocks": blocks,
        "proj_out": s.linear("proj_out"),
    }


def _dif_input_side(ks: _KeyStore, n_levels: int):
    """(input blocks, middle block) trees of a UNet or ControlNet trunk."""
    input_blocks = [{"conv": ks.conv("conv_in")}]
    for level in range(n_levels):
        d = ks.sub(f"down_blocks.{level}")
        has_attn = d.has("attentions.0.norm.weight")
        for j in range(2):
            p = {"res": _dif_res(d, f"resnets.{j}")}
            if has_attn:
                p["transformer"] = _dif_spatial(d, f"attentions.{j}")
            input_blocks.append(p)
        if d.has("downsamplers.0.conv.weight"):
            input_blocks.append({"conv": d.conv("downsamplers.0.conv")})

    mid = ks.sub("mid_block")
    middle = {
        "res1": _dif_res(mid, "resnets.0"),
        "transformer": _dif_spatial(mid, "attentions.0"),
        "res2": _dif_res(mid, "resnets.1"),
    }
    return input_blocks, middle


def _dif_embeds(ks: _KeyStore, cfg: UNetConfig) -> dict:
    """time_embed and, for SDXL's micro-conditioning, label_embed."""
    out = {"time_embed": {
        "lin1": ks.linear("time_embedding.linear_1"),
        "lin2": ks.linear("time_embedding.linear_2"),
    }}
    # absent in SD 1.x/2.x checkpoints
    if cfg.adm_in_channels and ks.has("add_embedding.linear_1.weight"):
        out["label_embed"] = {
            "lin1": ks.linear("add_embedding.linear_1"),
            "lin2": ks.linear("add_embedding.linear_2"),
        }
    return out


def build_unet_from_diffusers(
    tensors: Dict[str, torch.Tensor], cfg: UNetConfig, dtype=torch.bfloat16,
    device="cpu",
) -> Dict[str, torch.Tensor]:
    """The port UNet's state_dict (fused self-attention qkv)."""
    ks = _KeyStore(tensors, device=device, dtype=dtype)
    in_plan, _, out_plan = unet_block_plan(cfg)
    n_levels = len(cfg.channel_mults)
    input_blocks, middle = _dif_input_side(ks, n_levels)

    output_blocks = []
    for i in range(n_levels):  # up_blocks are already deep->shallow
        u = ks.sub(f"up_blocks.{i}")
        has_attn = u.has("attentions.0.norm.weight")
        for j in range(3):
            p = {"res": _dif_res(u, f"resnets.{j}")}
            if has_attn:
                p["transformer"] = _dif_spatial(u, f"attentions.{j}")
            if j == 2 and u.has("upsamplers.0.conv.weight"):
                p["upsample"] = u.conv("upsamplers.0.conv")
            output_blocks.append(p)

    params = {
        **_dif_embeds(ks, cfg),
        "input_blocks": input_blocks,
        "middle_block": middle,
        "output_blocks": output_blocks,
        "norm_out": ks.norm("conv_norm_out"),
        "conv_out": ks.conv("conv_out"),
    }
    # LCM-distilled UNets: the guidance-embedding projection (no bias)
    if ks.has("time_embedding.cond_proj.weight"):
        params["time_embed"]["cond_proj"] = ks.linear(
            "time_embedding.cond_proj")

    # structural validation against the generated plan
    if len(input_blocks) != len(in_plan) or len(output_blocks) != len(out_plan):
        raise ValueError(
            f"diffusers UNet block count mismatch: got "
            f"{len(input_blocks)}/{len(output_blocks)}, plan expects "
            f"{len(in_plan)}/{len(out_plan)} — wrong config for these weights?"
        )
    for spec, p in zip(in_plan + out_plan, input_blocks + output_blocks):
        if spec.kind in ("res_t", "res_t_up") and "transformer" not in p:
            raise ValueError(f"plan expects a transformer at a {spec.kind} block")
    return fuse_qkv(flatten_pytree(params))


# ---------------------------------------------------------------------------
# ControlNet (diffusers ControlNetModel layout)
# ---------------------------------------------------------------------------

def build_controlnet_from_diffusers(
    tensors: Dict[str, torch.Tensor], cfg: UNetConfig, dtype=torch.bfloat16,
    device="cpu",
) -> Dict[str, torch.Tensor]:
    """The state_dict of a models/controlnet.py ``ControlNet`` (fused
    self-attention qkv) from a diffusers ControlNetModel's tensors: the
    trunk as the UNet's input side, plus controlnet_cond_embedding.
    {conv_in, blocks.{2i, 2i+1}, conv_out}, controlnet_down_blocks.{i}
    and controlnet_mid_block."""
    ks = _KeyStore(tensors, device=device, dtype=dtype)
    in_plan, _, _ = unet_block_plan(cfg)
    input_blocks, middle = _dif_input_side(ks, len(cfg.channel_mults))
    if len(input_blocks) != len(in_plan):
        raise ValueError(
            f"controlnet trunk block count mismatch: got {len(input_blocks)}, "
            f"plan expects {len(in_plan)} — wrong config for these weights?")
    ce = ks.sub("controlnet_cond_embedding")
    ce_blocks = []
    while ce.has(f"blocks.{2 * len(ce_blocks)}.weight"):
        i = len(ce_blocks)
        ce_blocks.append({"conv1": ce.conv(f"blocks.{2 * i}"),
                          "conv2": ce.conv(f"blocks.{2 * i + 1}")})
    params = {
        **_dif_embeds(ks, cfg),
        "cond_embed": {"conv_in": ce.conv("conv_in"), "blocks": ce_blocks,
                       "conv_out": ce.conv("conv_out")},
        "input_blocks": input_blocks,
        "zero_convs": [ks.conv(f"controlnet_down_blocks.{i}")
                       for i in range(len(in_plan))],
        "middle_block": middle,
        "zero_conv_mid": ks.conv("controlnet_mid_block"),
    }
    return fuse_qkv(flatten_pytree(params))


def load_controlnet_dir(model_dir: str, diffuser_cfg, dtype=torch.bfloat16,
                        device="cuda"):
    """A diffusers ControlNetModel directory (config.json +
    diffusion_pytorch_model*.safetensors) -> (ControlNet on ``device`` in
    ``dtype``, its UNetConfig: the hosting diffuser's unet_config(), its
    4-channel input whatever the UNet's)."""
    from ..models.controlnet import ControlNet

    cfg = dataclasses.replace(diffuser_cfg.unet_config(), in_channels=4,
                              freeu=None, time_cond_proj_dim=0)
    sd = build_controlnet_from_diffusers(
        _load_safetensors_dir(model_dir), cfg, dtype, device)
    return _load_strict(ControlNet(cfg, "meta", dtype), sd, model_dir), cfg


def _load_strict(module, sd: Dict[str, torch.Tensor], path: str):
    """A meta-device module given ``sd``'s tensors strictly: a missing,
    extra or misshapen key is a ValueError naming the file."""
    try:
        module.load_state_dict(sd, strict=True, assign=True)
    except RuntimeError as e:
        raise ValueError(f"{path}: {e}") from None
    return module.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

def _dif_vae_res(ks: _KeyStore, key: str):
    s = ks.sub(key)
    p = {
        "norm1": s.norm("norm1"),
        "conv1": s.conv("conv1"),
        "norm2": s.norm("norm2"),
        "conv2": s.conv("conv2"),
    }
    if s.has("conv_shortcut.weight"):
        p["nin_shortcut"] = s.conv("conv_shortcut")
    return p


def _lin_as_conv1x1(s: _KeyStore, key: str):
    """diffusers VAE attention uses Linear where ldm uses 1x1 convs."""
    p = s.linear(key)
    p["weight"] = p["weight"][:, :, None, None]  # [out, in] -> OIHW
    return p


def _dif_vae_mid(ks: _KeyStore, key: str):
    s = ks.sub(key)
    a = s.sub("attentions.0")
    return {
        "block_1": _dif_vae_res(s, "resnets.0"),
        "attn": {
            "norm": a.norm("group_norm"),
            "q": _lin_as_conv1x1(a, "to_q"),
            "k": _lin_as_conv1x1(a, "to_k"),
            "v": _lin_as_conv1x1(a, "to_v"),
            "proj_out": _lin_as_conv1x1(a, "to_out.0"),
        },
        "block_2": _dif_vae_res(s, "resnets.1"),
    }


def build_vae_from_diffusers(
    tensors: Dict[str, torch.Tensor], cfg=None, dtype=torch.float32,
    device="cpu",
) -> Dict[str, torch.Tensor]:
    cfg = cfg or AutoencoderConfig()
    ks = _KeyStore(tensors, device=device, dtype=dtype)
    n_levels = len(cfg.encoder_channels)

    enc_blocks = []
    for i in range(n_levels):
        s = ks.sub(f"encoder.down_blocks.{i}")
        bp = {
            "res1": _dif_vae_res(s, "resnets.0"),
            "res2": _dif_vae_res(s, "resnets.1"),
        }
        if s.has("downsamplers.0.conv.weight"):
            bp["downsampler"] = s.conv("downsamplers.0.conv")
        enc_blocks.append(bp)

    dec_blocks = []
    for i in range(n_levels):  # up_blocks already deep->shallow
        s = ks.sub(f"decoder.up_blocks.{i}")
        bp = {
            "res1": _dif_vae_res(s, "resnets.0"),
            "res2": _dif_vae_res(s, "resnets.1"),
            "res3": _dif_vae_res(s, "resnets.2"),
        }
        if s.has("upsamplers.0.conv.weight"):
            bp["upsampler"] = s.conv("upsamplers.0.conv")
        dec_blocks.append(bp)

    out = {
        "encoder": {
            "conv_in": ks.conv("encoder.conv_in"),
            "blocks": enc_blocks,
            "mid": _dif_vae_mid(ks, "encoder.mid_block"),
            "norm_out": ks.norm("encoder.conv_norm_out"),
            "conv_out": ks.conv("encoder.conv_out"),
        },
        "decoder": {
            "conv_in": ks.conv("decoder.conv_in"),
            "mid": _dif_vae_mid(ks, "decoder.mid_block"),
            "blocks": dec_blocks,
            "norm_out": ks.norm("decoder.conv_norm_out"),
            "conv_out": ks.conv("decoder.conv_out"),
        },
    }
    # Flux VAEs ship without the quant convs (use_quant_conv: false)
    if ks.has("quant_conv.weight"):
        out["quant_conv"] = ks.conv("quant_conv")
    if ks.has("post_quant_conv.weight"):
        out["post_quant_conv"] = ks.conv("post_quant_conv")
    return flatten_pytree(out)


# ---------------------------------------------------------------------------
# top-level directory loader
# ---------------------------------------------------------------------------

def load_sdxl_diffusers_dir(
    model_dir: str,
    diffuser_cfg,
    embedder_cfg=None,
    unet_dtype=torch.bfloat16,
    vae_cfg=None,
    device="cpu",
):
    """Load a diffusers-layout SDXL directory.

    Returns (embedder state_dicts | None, unet state_dict, autoencoder
    state_dict, alphas_cumprod | None, vae_scale_factor | None,
    diffuser_cfg), tensors on ``device``. The cfg comes back with
    in_channels corrected from the checkpoint's conv_in width (9 for
    inpainting UNets) and time_cond_proj_dim from the width of an
    LCM-distilled UNet's time_embedding.cond_proj (0 without one).
    """
    unet_tensors = _load_safetensors_dir(os.path.join(model_dir, "unet"))
    diffuser_cfg = _corrected_cfg(diffuser_cfg, unet_tensors)
    unet = build_unet_from_diffusers(
        unet_tensors, diffuser_cfg.unet_config(), unet_dtype, device=device)
    vae = build_vae_from_diffusers(
        _load_safetensors_dir(os.path.join(model_dir, "vae")), vae_cfg,
        device=device)

    embedder = None
    te1 = os.path.join(model_dir, "text_encoder")
    te2 = os.path.join(model_dir, "text_encoder_2")
    if embedder_cfg is not None and os.path.isdir(te1) and os.path.isdir(te2):
        embedder = {
            "clip": build_clip_from_hf(
                _load_safetensors_dir(te1), embedder_cfg.clip_config,
                prefix="text_model", device=device,
            ),
            # the bigG tower ships as HF CLIPTextModelWithProjection: same
            # text_model.* layout plus a top-level text_projection
            "open_clip": build_clip_from_hf(
                {
                    (k if k.startswith("text_model") else f"text_model.{k}"): v
                    for k, v in _load_safetensors_dir(te2).items()
                },
                embedder_cfg.open_clip_config,
                prefix="text_model", device=device,
            ),
        }

    return (embedder, unet, vae, _scheduler_alphas(model_dir),
            _vae_scale(model_dir), diffuser_cfg)


def _scheduler_alphas(model_dir: str):
    """The ᾱ table of the directory's scaled-linear scheduler, or None."""
    sc = _read_json(os.path.join(model_dir, "scheduler",
                                 "scheduler_config.json"))
    if sc is None or sc.get("beta_schedule",
                            "scaled_linear") != "scaled_linear":
        return None
    betas = np.linspace(sc.get("beta_start", 0.00085) ** 0.5,
                        sc.get("beta_end", 0.012) ** 0.5,
                        sc.get("num_train_timesteps", 1000),
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def _vae_scale(model_dir: str):
    """vae/config.json's scaling_factor, or None."""
    vm = _read_json(os.path.join(model_dir, "vae", "config.json"))
    return None if vm is None else vm.get("scaling_factor")


def _corrected_cfg(diffuser_cfg, unet_tensors):
    """The diffuser config with in_channels from conv_in's width
    (``cfg_with_conv_in``) and time_cond_proj_dim from an LCM-distilled
    UNet's time_embedding.cond_proj (0 without one)."""
    cp = unet_tensors.get("time_embedding.cond_proj.weight")
    return dataclasses.replace(
        cfg_with_conv_in(diffuser_cfg, unet_tensors["conv_in.weight"]),
        time_cond_proj_dim=0 if cp is None else int(cp.shape[1]))


def load_sd1_diffusers_dir(
    model_dir: str,
    diffuser_cfg,
    clip_cfg,
    unet_dtype=torch.bfloat16,
    device="cpu",
):
    """Load a diffusers-layout SD 1.x / 2.x directory (one text encoder, no
    add_embedding). Returns (tower state_dict | None, unet state_dict,
    autoencoder state_dict, alphas_cumprod | None, vae_scale_factor |
    None, diffuser_cfg), tensors on ``device``, the cfg corrected as
    load_sdxl_diffusers_dir's."""
    unet_tensors = _load_safetensors_dir(os.path.join(model_dir, "unet"))
    diffuser_cfg = _corrected_cfg(diffuser_cfg, unet_tensors)
    unet = build_unet_from_diffusers(
        unet_tensors, diffuser_cfg.unet_config(), unet_dtype, device=device)
    vae = build_vae_from_diffusers(
        _load_safetensors_dir(os.path.join(model_dir, "vae")), device=device)
    clip = None
    te = os.path.join(model_dir, "text_encoder")
    if clip_cfg is not None and os.path.isdir(te):
        clip = build_clip_from_hf(_load_safetensors_dir(te), clip_cfg,
                                  prefix="text_model", device=device)
    return (clip, unet, vae, _scheduler_alphas(model_dir),
            _vae_scale(model_dir), diffuser_cfg)


# ---------------------------------------------------------------------------
# config inference from the directory's own config.json files
# ---------------------------------------------------------------------------


def _read_json(path):
    if os.path.isfile(path):
        with open(path) as f:
            return json.load(f)
    return None


def _clip_cfg_from_hf_meta(meta, default: CLIPConfig) -> CLIPConfig:
    if meta is None:
        return default
    act = meta.get("hidden_act",
                   "quick_gelu" if default.quick_gelu else "gelu")
    return CLIPConfig(
        n_vocab=meta.get("vocab_size", default.n_vocab),
        n_state=meta.get("hidden_size", default.n_state),
        embed_dim=meta.get("projection_dim", default.embed_dim),
        n_head=meta.get("num_attention_heads", default.n_head),
        n_ctx=meta.get("max_position_embeddings", default.n_ctx),
        n_layer=meta.get("num_hidden_layers", default.n_layer),
        quick_gelu=act == "quick_gelu",
    )


def _heads_from_meta(meta, boc):
    """(n_heads, num_head_channels) from a UNet2DConditionModel config.
    diffusers' naming quirk: `attention_head_dim` historically holds the
    HEAD COUNT (SDXL ships [5, 10, 20] = channels/64; SD1.5 ships 8 =
    fixed heads); `num_attention_heads`, when present, wins."""
    heads = meta.get("num_attention_heads")
    if heads is None:
        heads = meta.get("attention_head_dim", 8)
    if isinstance(heads, (list, tuple)):
        widths = {boc[i] // int(h) for i, h in enumerate(heads)}
        if len(widths) != 1:
            raise ValueError(
                f"per-level head counts {heads} imply non-constant head "
                f"widths {sorted(widths)} over channels {boc} — not "
                f"representable by UNetConfig")
        return 0, widths.pop()
    return int(heads), 64


def infer_sdxl_configs_from_diffusers_dir(model_dir: str):
    """(EmbedderConfig, DiffuserConfig, AutoencoderConfig) derived from
    the directory's own config.json files (unet/ vae/ text_encoder*/
    scheduler/), falling back to the SDXL 1.0 presets where a file or
    field is absent. Real stabilityai checkpoints resolve to exactly the
    presets; fine-tuned or down-scaled exports resolve to their true
    hyperparameters."""
    from ..configs import (
        CLIP_VIT_L_CONFIG,
        OPEN_CLIP_BIGG_CONFIG,
        SDXL_BASE_DIFFUSER,
        EmbedderConfig,
    )

    e_cfg = EmbedderConfig(
        clip_config=_clip_cfg_from_hf_meta(
            _read_json(os.path.join(model_dir, "text_encoder",
                                    "config.json")),
            CLIP_VIT_L_CONFIG),
        open_clip_config=_clip_cfg_from_hf_meta(
            _read_json(os.path.join(model_dir, "text_encoder_2",
                                    "config.json")),
            OPEN_CLIP_BIGG_CONFIG),
    )

    d_cfg = SDXL_BASE_DIFFUSER
    um = _read_json(os.path.join(model_dir, "unet", "config.json"))
    if um is not None:
        boc = [int(c) for c in um.get("block_out_channels",
                                      [320, 640, 1280])]
        mc = boc[0]
        mults = tuple(c // mc for c in boc)
        down = um.get("down_block_types") or []
        t_levels = (tuple(i for i, t in enumerate(down) if "CrossAttn" in t)
                    if down else d_cfg.transformer_levels)
        tl = um.get("transformer_layers_per_block", 1)
        depths = (tuple(int(v) for v in tl)
                  if isinstance(tl, (list, tuple)) else (int(tl),) * len(boc))
        n_heads, nhc = _heads_from_meta(um, boc)
        adm = (um.get("projection_class_embeddings_input_dim") or 0
               if um.get("addition_embed_type") == "text_time" else 0)
        d_cfg = dataclasses.replace(
            d_cfg,
            adm_in_channels=int(adm),
            model_channels=mc,
            channel_mults=mults,
            num_head_channels=nhc,
            transformer_depths=depths,
            context_dim=int(um.get("cross_attention_dim",
                                   d_cfg.context_dim)),
            transformer_levels=t_levels,
            n_heads=n_heads,
            in_channels=int(um.get("in_channels", 4)),
            time_cond_proj_dim=int(um.get("time_cond_proj_dim") or 0),
        )

    sm = _read_json(os.path.join(model_dir, "scheduler",
                                 "scheduler_config.json"))
    if sm is not None:
        pred = sm.get("prediction_type", "epsilon")
        d_cfg = dataclasses.replace(
            d_cfg,
            prediction_type="v" if pred == "v_prediction" else "eps",
            n_steps=int(sm.get("num_train_timesteps", d_cfg.n_steps)),
        )

    v_cfg = AutoencoderConfig()
    vm = _read_json(os.path.join(model_dir, "vae", "config.json"))
    if vm is not None:
        boc = [int(c) for c in vm.get("block_out_channels",
                                      [128, 256, 512, 512])]
        rev = list(reversed(boc))
        lc = int(vm.get("latent_channels", 4))
        v_cfg = AutoencoderConfig(
            encoder_channels=tuple(
                (boc[i - 1] if i else boc[0], boc[i])
                for i in range(len(boc))),
            decoder_channels=tuple(
                (rev[j - 1] if j else rev[0], rev[j])
                for j in range(len(rev))),
            n_group=int(vm.get("norm_num_groups", 32)),
            n_channels_out=2 * lc,
            latent_channels=lc,
        )
    return e_cfg, d_cfg, v_cfg
