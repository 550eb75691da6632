"""Import SDXL and SD 1.x / 2.x weights from the official single-file
checkpoints (counterpart of sdxl_tpu/io/hf_sdxl.py).

The standard `sd_xl_base_1.0.safetensors` (sgm/ldm key layout), or the
same keys in a legacy torch-pickle `.ckpt`, load directly into the port's
state_dicts:
  - model.diffusion_model.*      UNet (ldm layout)
  - first_stage_model.*          VAE (ldm layout)
  - conditioner.embedders.0.transformer.text_model.*   CLIP ViT-L (HF)
  - conditioner.embedders.1.model.*                    OpenCLIP bigG

The file is already in torch's layouts (linear [out, in], conv OIHW), so
each tensor is a zero-copy view of the mapped file until it is moved to
the device and cast there; only OpenCLIP's fused in_proj is split into
q/k/v (row views) and HF's text_projection transposed. The builders return
state_dicts under the port's module names (the reference's tree paths with
``weight``/``bias`` leaves).

``load_sd1_single_file`` reads the SD 1.x / 2.x ldm files
(v1-5-pruned.{safetensors,ckpt}, v2-1_768-ema-pruned, ...): the same UNet
layout without label_emb, the VAE, and the one text tower at
cond_stage_model.transformer.text_model (SD 1.x's HF CLIP) or
cond_stage_model.model (SD 2.x's OpenCLIP ViT-H, fused in_proj).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..configs import AutoencoderConfig, CLIPConfig, DiffuserConfig, UNetConfig
from ..models.unet import unet_block_plan
from .bridge import fuse_qkv
from .checkpoint import flatten_pytree


class _KeyStore:
    """Prefixed view of a flat {key: CPU tensor} dict; ``get`` moves a
    tensor to ``device`` and casts it to ``dtype`` (None keeps it)."""

    def __init__(self, tensors: Dict[str, torch.Tensor], prefix: str = "",
                 device="cpu", dtype=None):
        self.t = tensors
        self.prefix = prefix
        self.device = device
        self.dtype = dtype

    def sub(self, prefix: str) -> "_KeyStore":
        return _KeyStore(self.t, f"{self.prefix}{prefix}.", self.device,
                         self.dtype)

    def get(self, key: str) -> torch.Tensor:
        t = self.t[f"{self.prefix}{key}"].to(self.device)
        if self.dtype is not None and t.is_floating_point():
            t = t.to(self.dtype)
        return t

    def has(self, key: str) -> bool:
        return f"{self.prefix}{key}" in self.t

    def linear(self, key: str):
        p = {"weight": self.get(f"{key}.weight")}
        if self.has(f"{key}.bias"):
            p["bias"] = self.get(f"{key}.bias")
        return p

    conv = linear  # OIHW is the port's conv layout too

    def norm(self, key: str):
        return {"weight": self.get(f"{key}.weight"),
                "bias": self.get(f"{key}.bias")}


# ---------------------------------------------------------------------------
# UNet (ldm layout)
# ---------------------------------------------------------------------------

def _ldm_res(ks: _KeyStore, key: str):
    s = ks.sub(key)
    p = {
        "norm_in": s.norm("in_layers.0"),
        "conv_in": s.conv("in_layers.2"),
        "lin_embed": s.linear("emb_layers.1"),
        "norm_out": s.norm("out_layers.0"),
        "conv_out": s.conv("out_layers.3"),
    }
    if s.has("skip_connection.weight"):
        p["skip"] = s.conv("skip_connection")
    return p


def _ldm_attn(ks: _KeyStore, key: str):
    s = ks.sub(key)
    return {
        "q": s.linear("to_q"),
        "k": s.linear("to_k"),
        "v": s.linear("to_v"),
        "out": s.linear("to_out.0"),
    }


def _ldm_spatial(ks: _KeyStore, key: str):
    s = ks.sub(key)
    blocks = []
    i = 0
    while s.has(f"transformer_blocks.{i}.norm1.weight"):
        b = s.sub(f"transformer_blocks.{i}")
        blocks.append(
            {
                "norm1": b.norm("norm1"),
                "attn1": _ldm_attn(b, "attn1"),
                "norm2": b.norm("norm2"),
                "attn2": _ldm_attn(b, "attn2"),
                "norm3": b.norm("norm3"),
                "mlp": {
                    "proj": b.linear("ff.net.0.proj"),
                    "lin": b.linear("ff.net.2"),
                },
            }
        )
        i += 1
    # SDXL uses use_linear_in_transformer=True: proj_in/out are linear
    proj_in, proj_out = s.linear("proj_in"), s.linear("proj_out")
    for p in (proj_in, proj_out):
        if p["weight"].dim() == 4:  # 1x1 convs (SD1.x-style) -> linear
            p["weight"] = p["weight"][:, :, 0, 0]
    return {
        "norm": s.norm("norm"),
        "proj_in": proj_in,
        "blocks": blocks,
        "proj_out": proj_out,
    }


def build_unet_from_ldm(
    tensors: Dict[str, torch.Tensor],
    cfg: UNetConfig,
    dtype=torch.bfloat16,
    prefix: str = "model.diffusion_model",
    device="cpu",
) -> Dict[str, torch.Tensor]:
    """The port UNet's state_dict (fused self-attention qkv)."""
    ks = _KeyStore(tensors, device=device, dtype=dtype).sub(prefix)
    in_plan, _, out_plan = unet_block_plan(cfg)

    def in_block(i: int, spec):
        b = f"input_blocks.{i}"
        if spec.kind == "conv":
            return {"conv": ks.conv(f"{b}.0")}
        if spec.kind == "down":
            return {"conv": ks.conv(f"{b}.0.op")}
        p = {"res": _ldm_res(ks, f"{b}.0")}
        if spec.kind == "res_t":
            p["transformer"] = _ldm_spatial(ks, f"{b}.1")
        return p

    def out_block(i: int, spec):
        b = f"output_blocks.{i}"
        p = {"res": _ldm_res(ks, f"{b}.0")}
        if spec.kind in ("res_t", "res_t_up"):
            p["transformer"] = _ldm_spatial(ks, f"{b}.1")
        if spec.kind == "res_t_up":
            p["upsample"] = ks.conv(f"{b}.2.conv")
        elif spec.kind == "res_up":
            p["upsample"] = ks.conv(f"{b}.1.conv")
        return p

    out = {
        "time_embed": {
            "lin1": ks.linear("time_embed.0"),
            "lin2": ks.linear("time_embed.2"),
        },
        "input_blocks": [in_block(i, s) for i, s in enumerate(in_plan)],
        "middle_block": {
            "res1": _ldm_res(ks, "middle_block.0"),
            "transformer": _ldm_spatial(ks, "middle_block.1"),
            "res2": _ldm_res(ks, "middle_block.2"),
        },
        "output_blocks": [out_block(i, s) for i, s in enumerate(out_plan)],
        "norm_out": ks.norm("out.0"),
        "conv_out": ks.conv("out.2"),
    }
    # SD 1.x/2.x UNets carry no label embedding (adm_in_channels == 0)
    if ks.has("label_emb.0.0.weight"):
        out["label_embed"] = {
            "lin1": ks.linear("label_emb.0.0"),
            "lin2": ks.linear("label_emb.0.2"),
        }
    return fuse_qkv(flatten_pytree(out))


# ---------------------------------------------------------------------------
# VAE (ldm layout)
# ---------------------------------------------------------------------------

def _ldm_vae_res(ks: _KeyStore, key: str):
    s = ks.sub(key)
    p = {
        "norm1": s.norm("norm1"),
        "conv1": s.conv("conv1"),
        "norm2": s.norm("norm2"),
        "conv2": s.conv("conv2"),
    }
    if s.has("nin_shortcut.weight"):
        p["nin_shortcut"] = s.conv("nin_shortcut")
    return p


def _ldm_vae_mid(ks: _KeyStore, key: str):
    s = ks.sub(key)
    a = s.sub("attn_1")
    return {
        "block_1": _ldm_vae_res(s, "block_1"),
        "attn": {
            "norm": a.norm("norm"),
            "q": a.conv("q"),
            "k": a.conv("k"),
            "v": a.conv("v"),
            "proj_out": a.conv("proj_out"),
        },
        "block_2": _ldm_vae_res(s, "block_2"),
    }


def build_vae_from_ldm(
    tensors: Dict[str, torch.Tensor],
    cfg: Optional[AutoencoderConfig] = None,
    dtype=torch.float32,
    prefix: str = "first_stage_model",
    device="cpu",
) -> Dict[str, torch.Tensor]:
    """The autoencoder's state_dict: encoder.*, quant_conv.* (VAEEncoder)
    and decoder.*, post_quant_conv.* (VAEDecoder)."""
    cfg = cfg or AutoencoderConfig()
    ks = _KeyStore(tensors, device=device, dtype=dtype).sub(prefix)
    n_levels = len(cfg.encoder_channels)

    enc_blocks = []
    for i in range(n_levels):
        s = ks.sub(f"encoder.down.{i}")
        bp = {
            "res1": _ldm_vae_res(s, "block.0"),
            "res2": _ldm_vae_res(s, "block.1"),
        }
        if s.has("downsample.conv.weight"):
            bp["downsampler"] = s.conv("downsample.conv")
        enc_blocks.append(bp)

    # ldm decoder up.{i} is indexed shallow->deep; execution order is
    # deep->shallow, so reverse (the reference dump does the same,
    # python/autoencoder.py:56-60)
    dec_blocks = []
    for i in reversed(range(n_levels)):
        s = ks.sub(f"decoder.up.{i}")
        bp = {
            "res1": _ldm_vae_res(s, "block.0"),
            "res2": _ldm_vae_res(s, "block.1"),
            "res3": _ldm_vae_res(s, "block.2"),
        }
        if s.has("upsample.conv.weight"):
            bp["upsampler"] = s.conv("upsample.conv")
        dec_blocks.append(bp)

    return flatten_pytree({
        "encoder": {
            "conv_in": ks.conv("encoder.conv_in"),
            "blocks": enc_blocks,
            "mid": _ldm_vae_mid(ks, "encoder.mid"),
            "norm_out": ks.norm("encoder.norm_out"),
            "conv_out": ks.conv("encoder.conv_out"),
        },
        "decoder": {
            "conv_in": ks.conv("decoder.conv_in"),
            "mid": _ldm_vae_mid(ks, "decoder.mid"),
            "blocks": dec_blocks,
            "norm_out": ks.norm("decoder.norm_out"),
            "conv_out": ks.conv("decoder.conv_out"),
        },
        "quant_conv": ks.conv("quant_conv"),
        "post_quant_conv": ks.conv("post_quant_conv"),
    })


# ---------------------------------------------------------------------------
# CLIP towers
# ---------------------------------------------------------------------------

def build_clip_from_hf(
    tensors: Dict[str, torch.Tensor],
    cfg: CLIPConfig,
    dtype=torch.float32,
    prefix: str = "conditioner.embedders.0.transformer.text_model",
    device="cpu",
) -> Dict[str, torch.Tensor]:
    """HF transformers CLIPTextModel layout (CLIP ViT-L tower)."""
    ks = _KeyStore(tensors, device=device, dtype=dtype).sub(prefix)
    blocks = []
    for i in range(cfg.n_layer):
        s = ks.sub(f"encoder.layers.{i}")
        blocks.append(
            {
                "attn": {
                    "q": s.linear("self_attn.q_proj"),
                    "k": s.linear("self_attn.k_proj"),
                    "v": s.linear("self_attn.v_proj"),
                    "out": s.linear("self_attn.out_proj"),
                },
                "attn_ln": s.norm("layer_norm1"),
                "mlp": {
                    "fc1": s.linear("mlp.fc1"),
                    "fc2": s.linear("mlp.fc2"),
                },
                "mlp_ln": s.norm("layer_norm2"),
            }
        )
    params = {
        "token_embedding": ks.get("embeddings.token_embedding.weight"),
        "position_embedding": ks.get("embeddings.position_embedding.weight"),
        "blocks": blocks,
        "layer_norm": ks.norm("final_layer_norm"),
    }
    # The ViT-L tower only contributes hidden states in SDXL; a projection
    # is present in some exports (HF Linear [embed, d] -> [d, embed])
    if ks.has("text_projection.weight"):
        params["text_projection"] = ks.get(
            "text_projection.weight").t().contiguous()
    return flatten_pytree(params)


def build_clip_from_open_clip(
    tensors: Dict[str, torch.Tensor],
    cfg: CLIPConfig,
    dtype=torch.float32,
    prefix: str = "conditioner.embedders.1.model",
    device="cpu",
) -> Dict[str, torch.Tensor]:
    """open_clip TextTransformer layout (bigG tower): fused in_proj is split
    into q/k/v exactly as the reference dump does (python/clip.py:50-79)."""
    ks = _KeyStore(tensors, device=device, dtype=dtype).sub(prefix)
    d = cfg.n_state
    blocks = []
    for i in range(cfg.n_layer):
        s = ks.sub(f"transformer.resblocks.{i}")
        w = s.get("attn.in_proj_weight")  # [3d, d] torch layout
        bvec = s.get("attn.in_proj_bias")  # [3d]
        blocks.append(
            {
                "attn": {
                    n: {"weight": w[j * d:(j + 1) * d],
                        "bias": bvec[j * d:(j + 1) * d]}
                    for j, n in enumerate("qkv")
                } | {"out": s.linear("attn.out_proj")},
                "attn_ln": s.norm("ln_1"),
                "mlp": {
                    "fc1": s.linear("mlp.c_fc"),
                    "fc2": s.linear("mlp.c_proj"),
                },
                "mlp_ln": s.norm("ln_2"),
            }
        )
    return flatten_pytree({
        "token_embedding": ks.get("token_embedding.weight"),
        "position_embedding": ks.get("positional_embedding"),
        "blocks": blocks,
        "layer_norm": ks.norm("ln_final"),
        # open_clip stores text_projection as [d, embed_dim] already
        "text_projection": ks.get("text_projection"),
    })


# ---------------------------------------------------------------------------
# top-level
# ---------------------------------------------------------------------------

def _load_single_file_tensors(path: str) -> Dict[str, torch.Tensor]:
    """Tensors of a single-file checkpoint, on the CPU: `.safetensors`/
    `.sft` mapped (io/safetensors.py), or the legacy torch-pickle
    `.ckpt`/`.pt`/`.pth` (the A1111-era format) through
    torch.load(weights_only=True — no arbitrary unpickling), memory-mapped
    where the file allows; the usual {"state_dict": ...} nesting unwrapped
    and non-tensor bookkeeping entries (step counters etc.) dropped."""
    if path.endswith((".safetensors", ".sft")):
        from .safetensors import load_file

        return load_file(path)
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True,
                         mmap=True)
    except RuntimeError:  # not a zip archive: no mmap
        obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def load_sdxl_safetensors(
    path: str,
    diffuser_cfg: DiffuserConfig,
    embedder_cfg=None,
    unet_dtype=torch.bfloat16,
    device="cpu",
):
    """Load a single-file sgm checkpoint (sd_xl_base_1.0.safetensors, or
    the equivalent legacy .ckpt torch pickle).

    Returns (embedder state_dicts {"clip", "open_clip"} | None, unet
    state_dict, autoencoder state_dict), tensors on ``device``: the UNet
    in ``unet_dtype``, the towers and the VAE in f32. A refiner checkpoint
    carries only the bigG tower; its embedder slot is None.
    """
    tensors = _load_single_file_tensors(path)

    unet = build_unet_from_ldm(tensors, diffuser_cfg.unet_config(),
                               unet_dtype, device=device)
    vae = build_vae_from_ldm(tensors, device=device)

    embedder = None
    if embedder_cfg is not None and any(
        k.startswith("conditioner.embedders.0.") for k in tensors
    ):
        embedder = {
            "clip": build_clip_from_hf(tensors, embedder_cfg.clip_config,
                                       device=device),
            "open_clip": build_clip_from_open_clip(
                tensors, embedder_cfg.open_clip_config, device=device
            ),
        }
    return embedder, unet, vae


def cfg_with_conv_in(diffuser_cfg: DiffuserConfig,
                     conv_in_weight: torch.Tensor) -> DiffuserConfig:
    """The diffuser config with in_channels from conv_in's width (9 for
    inpainting UNets, 8 for InstructPix2Pix)."""
    return dataclasses.replace(diffuser_cfg,
                               in_channels=int(conv_in_weight.shape[1]))


def load_sd1_single_file(
    path: str,
    diffuser_cfg: DiffuserConfig,
    clip_cfg: CLIPConfig,
    unet_dtype=torch.bfloat16,
    vae_cfg: Optional[AutoencoderConfig] = None,
    device="cpu",
):
    """Load a single-file SD 1.x / 2.x checkpoint in the ldm layout:
    UNet at model.diffusion_model.*, VAE at first_stage_model.*, the text
    tower at cond_stage_model.transformer.* (SD 1.x, HF CLIPTextModel) or
    cond_stage_model.model.* (SD 2.x, open_clip with fused in_proj; found
    by its keys). Returns (tower state_dict, UNet state_dict, autoencoder
    state_dict, diffuser_cfg) on ``device``, the cfg's in_channels read
    from conv_in (9 for the runwayml inpainting checkpoints)."""
    tensors = _load_single_file_tensors(path)
    diffuser_cfg = cfg_with_conv_in(
        diffuser_cfg, tensors["model.diffusion_model.input_blocks.0.0.weight"])
    unet = build_unet_from_ldm(tensors, diffuser_cfg.unet_config(),
                               unet_dtype, device=device)
    vae = build_vae_from_ldm(tensors, vae_cfg, device=device)
    if any(k.startswith("cond_stage_model.model.") for k in tensors):
        clip = build_clip_from_open_clip(tensors, clip_cfg,
                                         prefix="cond_stage_model.model",
                                         device=device)
    else:
        clip = build_clip_from_hf(
            tensors, clip_cfg,
            prefix="cond_stage_model.transformer.text_model", device=device)
    return clip, unet, vae, diffuser_cfg
