"""Import SD3 weights from a diffusers model directory (counterpart of
sdxl_tpu/io/sd3.py), on the port's own safetensors reader.

The `stabilityai/stable-diffusion-3-medium-diffusers` layout:

    {dir}/transformer/   MMDiT safetensors + config.json
    {dir}/vae/           16-channel VAE
    {dir}/text_encoder/  CLIP-L (HF, with projection)
    {dir}/text_encoder_2/ CLIP-G (HF, with projection)
    {dir}/text_encoder_3/ T5-XXL encoder (optional: the drop-T5 mode)
    {dir}/tokenizer_3/   T5 SentencePiece, read through transformers
    {dir}/scheduler/scheduler_config.json  (the flow shift)

The builders return state_dicts under the port's module names (the
reference's tree paths), in torch's layouts: diffusers' [out, in] linears
as they are, ``pos_embed.proj``'s conv [hidden, C, p, p] as the
(ph, pw, c)-ordered p*p*C linear the reference stores. The stored
``pos_embed.pos_embed`` buffer is not read: the grid is recomputed for
every resolution (models/mmdit.py cropped_pos_embed).
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np
import torch

from ..configs import AutoencoderConfig, CLIPConfig, MMDiTConfig, T5Config
from .checkpoint import flatten_pytree
from .diffusers_sdxl import _load_safetensors_dir, _read_json
from .hf_sdxl import _KeyStore


def _json_in(d: str) -> dict:
    path = os.path.join(d, "config.json")
    return _read_json(path) if os.path.isfile(path) else {}


def _count(tensors, fmt: str) -> int:
    n = 0
    while fmt.format(n) in tensors:
        n += 1
    return n


def mmdit_config_from_dir(tdir: str, tensors: Dict[str, torch.Tensor]
                          ) -> MMDiTConfig:
    """MMDiTConfig from transformer/config.json, with shape-inferred
    fallbacks so a bare safetensors file still loads."""
    cfgj = _json_in(tdir)
    hidden, cin, p, _ = tensors["pos_embed.proj.weight"].shape
    n_layers = _count(tensors, "transformer_blocks.{}.norm1.linear.weight")
    head_dim = int(cfgj.get("attention_head_dim", 64))
    return MMDiTConfig(
        patch_size=int(cfgj.get("patch_size", p)),
        in_channels=int(cfgj.get("in_channels", cin)),
        out_channels=int(cfgj.get("out_channels", cin)),
        num_layers=int(cfgj.get("num_layers", n_layers)),
        n_heads=int(cfgj.get("num_attention_heads", hidden // head_dim)),
        head_dim=head_dim,
        joint_attention_dim=int(cfgj.get(
            "joint_attention_dim",
            tensors["context_embedder.weight"].shape[1])),
        pooled_projection_dim=int(cfgj.get(
            "pooled_projection_dim",
            tensors["time_text_embed.text_embedder.linear_1.weight"]
            .shape[1])),
        pos_embed_max_size=int(cfgj.get("pos_embed_max_size", 192)),
        qk_norm=("rms" if "transformer_blocks.0.attn.norm_q.weight"
                 in tensors else ""),
        time_sinusoid_dim=int(
            tensors["time_text_embed.timestep_embedder.linear_1.weight"]
            .shape[1]),
        dual_attention_layers=tuple(cfgj.get(
            "dual_attention_layers",
            [i for i in range(n_layers)
             if f"transformer_blocks.{i}.attn2.to_q.weight" in tensors])),
    )


def _time_text(ks: _KeyStore, names=("timestep", "text")) -> dict:
    return {f"{n}_lin{j}": ks.linear(f"time_text_embed.{n}_embedder.linear_{j}")
            for n in names for j in (1, 2)}


def _ff(b: _KeyStore, key: str) -> dict:
    return {"in": b.linear(f"{key}.net.0.proj"),
            "out": b.linear(f"{key}.net.2")}


def _gains(b: _KeyStore, prefix: str, names) -> dict:
    return {nm: {"weight": b.get(f"{prefix}.{nm}.weight")} for nm in names}


def build_mmdit_from_diffusers(tensors: Dict[str, torch.Tensor],
                               cfg: MMDiTConfig, dtype=torch.bfloat16,
                               device="cpu") -> Dict[str, torch.Tensor]:
    ks = _KeyStore(tensors, device=device, dtype=dtype)
    p = cfg.patch_size
    w = ks.get("pos_embed.proj.weight")  # [hidden, C, p, p]
    params = {
        "pos_embed": {"proj": {
            "weight": w.permute(0, 2, 3, 1).reshape(
                cfg.hidden, p * p * cfg.in_channels).contiguous(),
            "bias": ks.get("pos_embed.proj.bias")}},
        "time_text_embed": _time_text(ks),
        "context_embedder": ks.linear("context_embedder"),
        "norm_out": {"mod": ks.linear("norm_out.linear")},
        "proj_out": ks.linear("proj_out"),
        "blocks": [],
    }
    for i in range(cfg.num_layers):
        b = ks.sub(f"transformer_blocks.{i}")
        pre_only = not b.has("attn.to_add_out.weight")
        if pre_only and i != cfg.num_layers - 1:
            raise ValueError(
                f"context_pre_only block at layer {i} (expected only "
                f"the last, {cfg.num_layers - 1})")
        attn = {nm: b.linear(f"attn.{nm}")
                for nm in ("to_q", "to_k", "to_v", "add_q_proj",
                           "add_k_proj", "add_v_proj")}
        attn["to_out"] = b.linear("attn.to_out.0")
        if not pre_only:
            attn["to_add_out"] = b.linear("attn.to_add_out")
        if cfg.qk_norm == "rms":
            attn.update(_gains(b, "attn", ("norm_q", "norm_k",
                                           "norm_added_q", "norm_added_k")))
        blk = {"norm1": {"mod": b.linear("norm1.linear")},
               "norm1_context": {"mod": b.linear("norm1_context.linear")},
               "attn": attn, "mlp": _ff(b, "ff")}
        if i in cfg.dual_attention_layers:
            attn2 = {nm: b.linear(f"attn2.{nm}")
                     for nm in ("to_q", "to_k", "to_v")}
            attn2["to_out"] = b.linear("attn2.to_out.0")
            if cfg.qk_norm == "rms":
                attn2.update(_gains(b, "attn2", ("norm_q", "norm_k")))
            blk["attn2"] = attn2
        if not pre_only:
            blk["mlp_context"] = _ff(b, "ff_context")
        params["blocks"].append(blk)
    return flatten_pytree(params)


def t5_config_from_dir(tdir: str, tensors: Dict[str, torch.Tensor]
                       ) -> T5Config:
    cfgj = _json_in(tdir)
    vocab, d_model = tensors["shared.weight"].shape
    n_layers = _count(tensors,
                      "encoder.block.{}.layer.0.SelfAttention.q.weight")
    return T5Config(
        vocab_size=int(cfgj.get("vocab_size", vocab)),
        d_model=int(cfgj.get("d_model", d_model)),
        d_kv=int(cfgj.get("d_kv", 64)),
        d_ff=int(cfgj.get("d_ff", tensors[
            "encoder.block.0.layer.1.DenseReluDense.wi_0.weight"].shape[0])),
        n_heads=int(cfgj.get("num_heads", 64)),
        n_layers=int(cfgj.get("num_layers", n_layers)),
        relative_buckets=int(cfgj.get("relative_attention_num_buckets", 32)),
        relative_max_distance=int(
            cfgj.get("relative_attention_max_distance", 128)),
    )


def build_t5_from_hf(tensors: Dict[str, torch.Tensor], cfg: T5Config,
                     dtype=torch.bfloat16, device="cpu"
                     ) -> Dict[str, torch.Tensor]:
    ks = _KeyStore(tensors, device=device, dtype=dtype)
    blocks = []
    for i in range(cfg.n_layers):
        b = ks.sub(f"encoder.block.{i}")
        blocks.append({
            "ln1": b.get("layer.0.layer_norm.weight"),
            "attn": {nm: {"weight": b.get(f"layer.0.SelfAttention.{nm}"
                                          ".weight")}
                     for nm in ("q", "k", "v", "o")},
            "ln2": b.get("layer.1.layer_norm.weight"),
            "ffn": {nm: {"weight": b.get(f"layer.1.DenseReluDense.{nm}"
                                         ".weight")}
                    for nm in ("wi_0", "wi_1", "wo")},
        })
    return flatten_pytree({
        "embed": ks.get("shared.weight"),
        "relative_attention_bias": ks.get(
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias"
            ".weight"),
        "blocks": blocks,
        "final_ln": ks.get("encoder.final_layer_norm.weight"),
    })


def vae_config_from_dir(vdir: str, tensors: Dict[str, torch.Tensor]
                        ) -> AutoencoderConfig:
    """AutoencoderConfig from the weights: channel pairs from the resnet
    conv1 shapes, the latent width from post_quant_conv (or the coder
    convs, for a VAE without quant convs), norm_num_groups from
    config.json (32 when absent)."""
    def pairs(prefix):
        out, i = [], 0
        while f"{prefix}.{i}.resnets.0.conv1.weight" in tensors:
            w = tensors[f"{prefix}.{i}.resnets.0.conv1.weight"]
            out.append((int(w.shape[1]), int(w.shape[0])))
            i += 1
        return tuple(out)

    cfgj = _json_in(vdir)
    if "post_quant_conv.weight" in tensors:
        latent = int(tensors["post_quant_conv.weight"].shape[1])
        n_out = int(tensors["quant_conv.weight"].shape[0])
    else:
        latent = int(tensors["decoder.conv_in.weight"].shape[1])
        n_out = int(tensors["encoder.conv_out.weight"].shape[0])
    return AutoencoderConfig(
        encoder_channels=pairs("encoder.down_blocks"),
        decoder_channels=pairs("decoder.up_blocks"),
        n_group=int(cfgj.get("norm_num_groups", 32)),
        n_channels_out=n_out,
        latent_channels=int(cfgj.get("latent_channels", latent)),
    )


def clip_cfg_from_dir(d: str, default_layers: int) -> CLIPConfig:
    cj = _json_in(d)
    return CLIPConfig(
        n_vocab=int(cj.get("vocab_size", 49408)),
        n_state=int(cj.get("hidden_size", 768)),
        embed_dim=int(cj.get("projection_dim", cj.get("hidden_size", 768))),
        n_head=int(cj.get("num_attention_heads", 12)),
        n_ctx=int(cj.get("max_position_embeddings", 77)),
        n_layer=int(cj.get("num_hidden_layers", default_layers)),
        quick_gelu=cj.get("hidden_act", "quick_gelu") == "quick_gelu",
    )


def load_clip_dir(d: str, default_layers: int, device):
    """(CLIPConfig, CLIPTextModel) of a transformers CLIPTextModel(
    WithProjection) directory, f32 on ``device``."""
    from ..pipeline.loader import _tower
    from .hf_sdxl import build_clip_from_hf

    cfg = clip_cfg_from_dir(d, default_layers)
    tens = {(k if k.startswith("text_model") else f"text_model.{k}"): v
            for k, v in _load_safetensors_dir(d).items()}
    sd = build_clip_from_hf(tens, cfg, prefix="text_model", device=device)
    return cfg, _tower(cfg, sd, d, device)


def load_vae_dir(vdir: str, device):
    """(AutoencoderConfig, VAEDecoder, VAEEncoder or None), f32, strict;
    the quant convs only where the file has them."""
    from ..pipeline.loader import _autoencoder
    from .diffusers_sdxl import build_vae_from_diffusers

    tensors = _load_safetensors_dir(vdir)
    cfg = vae_config_from_dir(vdir, tensors)
    dec, enc = _autoencoder(
        cfg, build_vae_from_diffusers(tensors, cfg, device=device), device)
    return cfg, dec, enc


def hf_t5_tokenizer(tok_dir: str, n_tokens: int):
    """list[str] -> [B, n_tokens] int32 ids through transformers'
    AutoTokenizer of ``tok_dir`` (imported here, and only here)."""
    from transformers import AutoTokenizer

    hf_tok = AutoTokenizer.from_pretrained(tok_dir)

    def tokenize(texts):
        out = hf_tok(texts, padding="max_length", max_length=n_tokens,
                     truncation=True, return_tensors="np")
        return out["input_ids"].astype(np.int32)

    return tokenize


def load_t5_dir(t5_dir: str, dtype, device):
    """(T5Config, T5Encoder) of a transformers T5EncoderModel directory."""
    from ..models.t5 import T5Encoder
    from ..pipeline.loader import _load_module

    tensors = _load_safetensors_dir(t5_dir)
    cfg = t5_config_from_dir(t5_dir, tensors)
    sd = build_t5_from_hf(tensors, cfg, dtype)
    return cfg, _load_module(T5Encoder(cfg, "meta", dtype), sd, t5_dir,
                             device)


def load_sd3_diffusers_dir(model_dir: str, dtype=torch.bfloat16,
                           load_t5: bool = True, device="cpu",
                           towers_device=None):
    """Returns (mmdit, clip_l, clip_g, vae, vae_encoder, t5 | None,
    t5_tokenize | None, flow_shift): the MMDiT and T5 in ``dtype`` on
    ``towers_device`` (default ``device``; the quantizing loader builds
    them on the host), the CLIP towers and the VAE in f32 on ``device``,
    each with its config as ``.cfg``."""
    towers_device = device if towers_device is None else towers_device
    from ..models.mmdit import MMDiT
    from ..pipeline.loader import _load_module
    from ..pipeline.sd3 import SD3_T5_TOKENS

    tdir = os.path.join(model_dir, "transformer")
    tensors = _load_safetensors_dir(tdir)
    cfg = mmdit_config_from_dir(tdir, tensors)
    mmdit = _load_module(MMDiT(cfg, "meta", dtype),
                         build_mmdit_from_diffusers(tensors, cfg, dtype),
                         tdir, towers_device)
    del tensors
    _, clip_l = load_clip_dir(os.path.join(model_dir, "text_encoder"), 12,
                              device)
    _, clip_g = load_clip_dir(os.path.join(model_dir, "text_encoder_2"), 32,
                              device)
    _, vae, encoder = load_vae_dir(os.path.join(model_dir, "vae"), device)

    t5 = t5_tok = None
    t5_dir = os.path.join(model_dir, "text_encoder_3")
    if load_t5 and os.path.isdir(t5_dir) and glob.glob(
            os.path.join(t5_dir, "*.safetensors")):
        _, t5 = load_t5_dir(t5_dir, dtype, towers_device)
        tok_dir = os.path.join(model_dir, "tokenizer_3")
        if os.path.isdir(tok_dir):
            t5_tok = hf_t5_tokenizer(tok_dir, SD3_T5_TOKENS)

    flow_shift = 3.0
    spath = os.path.join(model_dir, "scheduler", "scheduler_config.json")
    if os.path.isfile(spath):
        flow_shift = float(_read_json(spath).get("shift", 3.0))
    return mmdit, clip_l, clip_g, vae, encoder, t5, t5_tok, flow_shift
