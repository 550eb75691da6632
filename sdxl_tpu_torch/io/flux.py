"""Import FLUX.1 weights from a diffusers model directory (counterpart of
sdxl_tpu/io/flux.py), on the port's own safetensors reader.

The `black-forest-labs/FLUX.1-dev` / `FLUX.1-schnell` layout:

    {dir}/transformer/    FluxTransformer2DModel safetensors + config.json
    {dir}/vae/            16-channel VAE without quant convs
    {dir}/text_encoder/   CLIP-L (CLIPTextModel, no projection)
    {dir}/text_encoder_2/ T5-XXL encoder (required: the only token stream)
    {dir}/tokenizer_2/    T5 SentencePiece, read through transformers
    {dir}/scheduler/scheduler_config.json  (base/max shift, dynamic flag)

The tower order differs from SD3's: text_encoder is CLIP-L and
text_encoder_2 is T5. Keys map onto the port's module names (the
reference's tree paths) in torch's layouts.
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import torch

from ..configs import FluxConfig
from .checkpoint import flatten_pytree
from .diffusers_sdxl import _load_safetensors_dir, _read_json
from .hf_sdxl import _KeyStore
from .sd3 import (
    _count,
    _ff,
    _gains,
    _json_in,
    _time_text,
    hf_t5_tokenizer,
    load_clip_dir,
    load_t5_dir,
    load_vae_dir,
)


def flux_config_from_dir(tdir: str, tensors: Dict[str, torch.Tensor]
                         ) -> FluxConfig:
    """FluxConfig from transformer/config.json, with shape-inferred
    fallbacks so a bare safetensors file still loads."""
    cfgj = _json_in(tdir)
    hidden, cin = tensors["x_embedder.weight"].shape
    n_layers = _count(tensors, "transformer_blocks.{}.norm1.linear.weight")
    n_single = _count(tensors,
                      "single_transformer_blocks.{}.norm.linear.weight")
    head_dim = int(cfgj.get(
        "attention_head_dim",
        tensors["transformer_blocks.0.attn.norm_q.weight"].shape[0]))
    axes = tuple(cfgj.get("axes_dims_rope", (16, 56, 56)))
    if sum(axes) != head_dim:  # tiny fixtures without a config.json
        q = head_dim // 4
        axes = (head_dim - 2 * q, q, q)
    return FluxConfig(
        in_channels=int(cfgj.get("in_channels", cin)),
        num_layers=int(cfgj.get("num_layers", n_layers)),
        num_single_layers=int(cfgj.get("num_single_layers", n_single)),
        n_heads=int(cfgj.get("num_attention_heads", hidden // head_dim)),
        head_dim=head_dim,
        joint_attention_dim=int(cfgj.get(
            "joint_attention_dim",
            tensors["context_embedder.weight"].shape[1])),
        pooled_projection_dim=int(cfgj.get(
            "pooled_projection_dim",
            tensors["time_text_embed.text_embedder.linear_1.weight"]
            .shape[1])),
        guidance_embeds=("time_text_embed.guidance_embedder.linear_1.weight"
                         in tensors),
        axes_dims=axes,
        time_sinusoid_dim=int(
            tensors["time_text_embed.timestep_embedder.linear_1.weight"]
            .shape[1]),
    )


def build_flux_from_diffusers(tensors: Dict[str, torch.Tensor],
                              cfg: FluxConfig, dtype=torch.bfloat16,
                              device="cpu") -> Dict[str, torch.Tensor]:
    ks = _KeyStore(tensors, device=device, dtype=dtype)
    params = {
        "x_embedder": ks.linear("x_embedder"),
        "context_embedder": ks.linear("context_embedder"),
        "time_text_embed": _time_text(
            ks, ("timestep", "text")
            + (("guidance",) if cfg.guidance_embeds else ())),
        "norm_out": {"mod": ks.linear("norm_out.linear")},
        "proj_out": ks.linear("proj_out"),
        "blocks": [],
        "single_blocks": [],
    }
    for i in range(cfg.num_layers):
        b = ks.sub(f"transformer_blocks.{i}")
        attn = {nm: b.linear(f"attn.{nm}")
                for nm in ("to_q", "to_k", "to_v", "add_q_proj",
                           "add_k_proj", "add_v_proj", "to_add_out")}
        attn["to_out"] = b.linear("attn.to_out.0")
        attn.update(_gains(b, "attn", ("norm_q", "norm_k", "norm_added_q",
                                       "norm_added_k")))
        params["blocks"].append({
            "norm1": {"mod": b.linear("norm1.linear")},
            "norm1_context": {"mod": b.linear("norm1_context.linear")},
            "attn": attn, "mlp": _ff(b, "ff"),
            "mlp_context": _ff(b, "ff_context")})
    for i in range(cfg.num_single_layers):
        b = ks.sub(f"single_transformer_blocks.{i}")
        attn = {nm: b.linear(f"attn.{nm}") for nm in ("to_q", "to_k", "to_v")}
        attn.update(_gains(b, "attn", ("norm_q", "norm_k")))
        params["single_blocks"].append({
            "norm": {"mod": b.linear("norm.linear")}, "attn": attn,
            "proj_mlp": b.linear("proj_mlp"),
            "proj_out": b.linear("proj_out")})
    return flatten_pytree(params)


def load_flux_diffusers_dir(model_dir: str, dtype=torch.bfloat16,
                            t5_tokenize=None, device="cpu"):
    """Returns (flux, clip, t5, t5_tokenize, vae, vae_encoder,
    scheduler_config): the transformer and T5 in ``dtype``, CLIP-L and the
    VAE in f32, on ``device``. ``t5_tokenize`` (list[str] -> [B, n] int32
    ids) stands in for tokenizer_2/."""
    from ..models.flux import Flux
    from ..pipeline.loader import _load_module

    tdir = os.path.join(model_dir, "transformer")
    tensors = _load_safetensors_dir(tdir)
    cfg = flux_config_from_dir(tdir, tensors)
    flux = _load_module(Flux(cfg, "meta", dtype),
                        build_flux_from_diffusers(tensors, cfg, dtype),
                        tdir, device)
    del tensors
    _, clip = load_clip_dir(os.path.join(model_dir, "text_encoder"), 12,
                            device)

    t5_dir = os.path.join(model_dir, "text_encoder_2")
    if not (os.path.isdir(t5_dir)
            and glob.glob(os.path.join(t5_dir, "*.safetensors"))):
        raise FileNotFoundError(
            f"{model_dir}: text_encoder_2/ (T5) is required for the Flux "
            "family (it is the ONLY token stream — there is no drop-T5 "
            "mode like SD3's)")
    _, t5 = load_t5_dir(t5_dir, dtype, device)
    if t5_tokenize is None:
        tok_dir = os.path.join(model_dir, "tokenizer_2")
        if not os.path.isdir(tok_dir):
            raise ValueError(
                f"{model_dir}: text_encoder_2/ (T5) weights loaded but "
                "tokenizer_2/ is missing — add the tokenizer directory "
                "or pass t5_tokenize=")
        t5_tokenize = hf_t5_tokenizer(tok_dir,
                                      512 if cfg.guidance_embeds else 256)
    _, vae, encoder = load_vae_dir(os.path.join(model_dir, "vae"), device)
    sched = _read_json(os.path.join(model_dir, "scheduler",
                                    "scheduler_config.json")) or {}
    return flux, clip, t5, t5_tokenize, vae, encoder, sched
