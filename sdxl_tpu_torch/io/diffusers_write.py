"""Write a ControlNet in the diffusers ``ControlNetModel`` layout and an
SD 1.x / 2.x pipeline in the ``StableDiffusionPipeline`` layout (the
ControlNet and SD1 parts of sdxl_tpu/io/diffusers_write.py).

``to_diffusers`` renames a ControlNet trunk's or a UNet's state_dict keys
to diffusers' (the exact inverses of
io/diffusers_sdxl.py's builders: the fused self-attention qkv split back
into to_q/to_k/to_v; every tensor is in torch's layout on both sides),
``vae_to_diffusers`` an autoencoder's (its mid-attention 1x1 convs as
diffusers' linears) and ``clip_to_hf`` a text tower's (HF
CLIPTextModel). ``write_diffusers_controlnet_dir`` writes the flat
directory (diffusion_pytorch_model.safetensors + config.json) that
``load_controlnet_dir`` and the ``sample`` CLI's ``--controlnet`` read;
``write_sd1_diffusers_pipeline_dir`` the unet/ vae/ text_encoder/
tokenizer/ scheduler/ directory that ``load_sd1_diffusers_dir`` and the
CLI's ``--family sd1|sd2 --model-dir`` read.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict

import torch
from torch import nn

from ..configs import AutoencoderConfig, CLIPConfig, UNetConfig
from ..models.controlnet import COND_EMBED_CHANNELS, ControlNet
from ..models.unet import unet_block_plan
from .bridge import unfuse_qkv
from .safetensors import save_file

# within a ResBlock, a SpatialTransformer's blocks, and the embeddings
_RES = {"norm_in": "norm1", "conv_in": "conv1", "lin_embed": "time_emb_proj",
        "norm_out": "norm2", "conv_out": "conv2", "skip": "conv_shortcut"}
_BLOCK = {"attn1.q": "attn1.to_q", "attn1.k": "attn1.to_k",
          "attn1.v": "attn1.to_v", "attn1.out": "attn1.to_out.0",
          "attn2.q": "attn2.to_q", "attn2.k": "attn2.to_k",
          "attn2.v": "attn2.to_v", "attn2.out": "attn2.to_out.0",
          "mlp.proj": "ff.net.0.proj", "mlp.lin": "ff.net.2"}
_EMBED = {"time_embed.lin1": "time_embedding.linear_1",
          "time_embed.lin2": "time_embedding.linear_2",
          "time_embed.cond_proj": "time_embedding.cond_proj",
          "norm_out": "conv_norm_out", "conv_out": "conv_out",
          "label_embed.lin1": "add_embedding.linear_1",
          "label_embed.lin2": "add_embedding.linear_2"}


def _res_or_transformer(rest: str) -> str:
    """'res.<part>...' or 'transformer...' inside a block -> diffusers'."""
    kind, _, tail = rest.partition(".")
    if kind == "res":
        part, _, p = tail.partition(".")
        return f"resnets.{{j}}.{_RES[part]}.{p}"
    m = re.match(r"blocks\.(\d+)\.(.*)\.(weight|bias)$", tail)
    if m:
        sub = _BLOCK.get(m.group(2), m.group(2))
        return (f"attentions.{{j}}.transformer_blocks.{m.group(1)}.{sub}."
                f"{m.group(3)}")
    return f"attentions.{{j}}.{tail}"


def _diffusers_key(key: str, where: Dict[int, tuple]) -> str:
    """A trunk's or a UNet's state_dict key (unfused) -> its diffusers
    key; where maps an input block to (level, resnet index) or (level,
    "down")."""
    for a, b in _EMBED.items():
        if key.startswith(a + "."):
            return b + key[len(a):]
    m = re.match(r"cond_embed\.blocks\.(\d+)\.conv([12])\.(.*)$", key)
    if m:
        k = 2 * int(m.group(1)) + int(m.group(2)) - 1
        return f"controlnet_cond_embedding.blocks.{k}.{m.group(3)}"
    if key.startswith("cond_embed."):
        return "controlnet_cond_embedding." + key[len("cond_embed."):]
    m = re.match(r"zero_convs\.(\d+)\.(.*)$", key)
    if m:
        return f"controlnet_down_blocks.{m.group(1)}.{m.group(2)}"
    if key.startswith("zero_conv_mid."):
        return "controlnet_mid_block." + key[len("zero_conv_mid."):]
    m = re.match(r"middle_block\.(res1|res2|transformer)\.(.*)$", key)
    if m:
        name, tail = m.groups()
        j = {"res1": 0, "res2": 1, "transformer": 0}[name]
        rest = ("res." if name != "transformer" else "transformer.") + tail
        return "mid_block." + _res_or_transformer(rest).format(j=j)
    m = re.match(r"output_blocks\.(\d+)\.(.*)$", key)
    if m:  # up_blocks are deep->shallow, three blocks a level
        u, j = divmod(int(m.group(1)), 3)
        rest = m.group(2)
        if rest.startswith("upsample."):
            return (f"up_blocks.{u}.upsamplers.0.conv."
                    + rest.partition(".")[2])
        return f"up_blocks.{u}." + _res_or_transformer(rest).format(j=j)
    m = re.match(r"input_blocks\.(\d+)\.(.*)$", key)
    i, rest = int(m.group(1)), m.group(2)
    if i == 0:
        return "conv_in." + rest.partition(".")[2]
    level, j = where[i]
    if j == "down":
        return (f"down_blocks.{level}.downsamplers.0.conv."
                + rest.partition(".")[2])
    return f"down_blocks.{level}." + _res_or_transformer(rest).format(j=j)


def _input_block_places(cfg: UNetConfig) -> Dict[int, tuple]:
    in_plan, _, _ = unet_block_plan(cfg)
    where, level, j = {}, 0, 0
    for i, spec in enumerate(in_plan[1:], 1):
        if spec.kind == "down":
            where[i] = (level, "down")
            level, j = level + 1, 0
        else:
            where[i] = (level, j)
            j += 1
    return where


def to_diffusers(net: nn.Module) -> Dict[str, torch.Tensor]:
    """{diffusers key: tensor} of a ControlNet or a UNet (ControlNetModel's
    or UNet2DConditionModel's names), on its device."""
    where = _input_block_places(net.cfg)
    sd = unfuse_qkv(dict(net.state_dict()))
    return {_diffusers_key(k, where): v for k, v in sd.items()}


def _heads(cfg: UNetConfig):
    """diffusers' attention_head_dim, which holds the head count: the
    fixed count (SD 1.x's 8) or one a level (SDXL's [5, 10, 20])."""
    return cfg.n_heads or [cfg.model_channels * m // cfg.n_head_channels
                           for m in cfg.channel_mults]


def _vae_key(key: str) -> str:
    """An autoencoder state_dict key -> diffusers AutoencoderKL's: the
    decoder's blocks run deep->shallow in both; res1-3 -> resnets.0-2."""
    m = re.match(r"(encoder|decoder)\.blocks\.(\d+)\.(\w+)\.(.*)$", key)
    if m:
        side, i, part, tail = m.groups()
        where = ("down" if side == "encoder" else "up") + f"_blocks.{i}"
        if part in ("downsampler", "upsampler"):
            return f"{side}.{where}.{part}s.0.conv.{tail}"
        j = int(part[3:]) - 1
        return f"{side}.{where}.resnets.{j}.{_vae_res_key(tail)}"
    m = re.match(r"(encoder|decoder)\.mid\.(\w+)\.(.*)$", key)
    if m:
        side, part, tail = m.groups()
        if part.startswith("block_"):
            return (f"{side}.mid_block.resnets.{int(part[-1]) - 1}."
                    f"{_vae_res_key(tail)}")
        sub, _, leaf = tail.partition(".")
        sub = {"norm": "group_norm", "proj_out": "to_out.0"}.get(
            sub, f"to_{sub}")
        return f"{side}.mid_block.attentions.0.{sub}.{leaf}"
    m = re.match(r"(encoder|decoder)\.(norm_out|conv_in|conv_out)\.(.*)$",
                 key)
    if m:
        side, part, leaf = m.groups()
        part = "conv_norm_out" if part == "norm_out" else part
        return f"{side}.{part}.{leaf}"
    return key  # quant_conv, post_quant_conv


def _vae_res_key(tail: str) -> str:
    return tail.replace("nin_shortcut.", "conv_shortcut.")


def vae_to_diffusers(*modules: nn.Module) -> Dict[str, torch.Tensor]:
    """{diffusers key: tensor} of a VAEDecoder and/or VAEEncoder: the
    inverse of build_vae_from_diffusers (the mid-attention's 1x1 convs
    become linears)."""
    out = {}
    for m in modules:
        for k, v in m.state_dict().items():
            key = _vae_key(k)
            if ".mid_block.attentions.0.to_" in key and v.dim() == 4:
                v = v[:, :, 0, 0]
            out[key] = v.contiguous()
    return out


def clip_to_hf(clip: nn.Module) -> Dict[str, torch.Tensor]:
    """{HF CLIPTextModel key: tensor} of a text tower, the inverse of
    build_clip_from_hf; the tower's text_projection (an OpenCLIP tower's)
    is not part of that class and is left out."""
    names = {"attn.q": "self_attn.q_proj", "attn.k": "self_attn.k_proj",
             "attn.v": "self_attn.v_proj", "attn.out": "self_attn.out_proj",
             "attn_ln": "layer_norm1", "mlp_ln": "layer_norm2",
             "mlp.fc1": "mlp.fc1", "mlp.fc2": "mlp.fc2"}
    out = {}
    for k, v in clip.state_dict().items():
        if k == "text_projection":
            continue
        m = re.match(r"blocks\.(\d+)\.(.*)\.(weight|bias)$", k)
        if m:
            key = (f"encoder.layers.{m.group(1)}.{names[m.group(2)]}."
                   f"{m.group(3)}")
        elif k.startswith("layer_norm."):
            key = "final_layer_norm." + k.partition(".")[2]
        else:  # token_embedding, position_embedding
            key = f"embeddings.{k}.weight"
        out["text_model." + key] = v.contiguous()
    return out


def write_diffusers_controlnet_dir(out_dir: str, net: ControlNet) -> str:
    """Write ``{out_dir}/{diffusion_pytorch_model.safetensors,
    config.json}``, a diffusers ControlNetModel directory in the net's
    dtype."""
    cfg = net.cfg
    flat = to_diffusers(net)
    os.makedirs(out_dir, exist_ok=True)
    save_file(flat, os.path.join(out_dir,
                                 "diffusion_pytorch_model.safetensors"))
    n = len(cfg.channel_mults)
    meta = {
        "_class_name": "ControlNetModel",
        "in_channels": cfg.in_channels,
        "conditioning_channels": 3,
        "conditioning_embedding_out_channels": list(COND_EMBED_CHANNELS),
        "block_out_channels": [cfg.model_channels * m
                               for m in cfg.channel_mults],
        "down_block_types": [("CrossAttnDownBlock2D"
                              if lvl in cfg.transformer_levels
                              else "DownBlock2D") for lvl in range(n)],
        "layers_per_block": 2,
        "transformer_layers_per_block": list(cfg.transformer_depths),
        "cross_attention_dim": cfg.context_dim,
        # diffusers' attention_head_dim holds the head count
        "attention_head_dim": _heads(cfg),
        "addition_embed_type": "text_time" if cfg.adm_in_channels else None,
        "projection_class_embeddings_input_dim":
            cfg.adm_in_channels or None,
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


def _json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def _write_tokenizer_dir(path: str, tokenizer, pad_token: str) -> None:
    """vocab.json + merges.txt (+ the HF sidecar configs) from the
    tokenizer's own BPE tables, the OpenAI merges.txt format diffusers'
    CLIPTokenizer reads."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(tokenizer.encoder, f, ensure_ascii=False)
    merges = sorted(tokenizer.bpe_ranks.items(), key=lambda kv: kv[1])
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
        for (a, b), _ in merges:
            f.write(f"{a} {b}\n")
    with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
        json.dump({"bos_token": "<|startoftext|>",
                   "eos_token": "<|endoftext|>", "pad_token": pad_token,
                   "unk_token": "<|endoftext|>"}, f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"add_prefix_space": False, "do_lower_case": True,
                   "model_max_length": 77,
                   "tokenizer_class": "CLIPTokenizer"}, f)


def _unet_config_json(cfg: UNetConfig) -> dict:
    n = len(cfg.channel_mults)
    attn = [lvl in cfg.transformer_levels for lvl in range(n)]
    return {
        "_class_name": "UNet2DConditionModel",
        "in_channels": cfg.in_channels,
        "out_channels": cfg.out_channels,
        "block_out_channels": [cfg.model_channels * m
                               for m in cfg.channel_mults],
        "down_block_types": ["CrossAttnDownBlock2D" if a else "DownBlock2D"
                             for a in attn],
        "up_block_types": ["CrossAttnUpBlock2D" if a else "UpBlock2D"
                           for a in reversed(attn)],
        "layers_per_block": 2,
        "transformer_layers_per_block": list(cfg.transformer_depths),
        "cross_attention_dim": cfg.context_dim,
        "attention_head_dim": _heads(cfg),
        "addition_embed_type": "text_time" if cfg.adm_in_channels else None,
        "projection_class_embeddings_input_dim": cfg.adm_in_channels or None,
    }


def _vae_config_json(v: AutoencoderConfig, scale: float,
                     sample_size: int) -> dict:
    """AutoencoderKL's config, which carries block_out_channels only:
    diffusers derives the decoder from their reverse, so a decoder plan
    that is not that derivation is refused rather than written wrong."""
    boc = [c[1] for c in v.encoder_channels]
    rev = list(reversed(boc))
    canonical = tuple((rev[j - 1] if j else rev[0], rev[j])
                      for j in range(len(rev)))
    if tuple(v.decoder_channels) != canonical:
        raise ValueError(
            f"decoder_channels {tuple(v.decoder_channels)} is not the "
            f"diffusers-canonical derivation {canonical} of "
            f"block_out_channels {boc}; this VAE cannot export to the "
            f"AutoencoderKL config layout")
    return {
        "_class_name": "AutoencoderKL", "in_channels": 3, "out_channels": 3,
        "latent_channels": v.latent_channels, "block_out_channels": boc,
        "down_block_types": ["DownEncoderBlock2D"] * len(boc),
        "up_block_types": ["UpDecoderBlock2D"] * len(boc),
        "layers_per_block": 2, "norm_num_groups": v.n_group,
        "sample_size": sample_size, "scaling_factor": scale,
    }


def _clip_config_json(c: CLIPConfig) -> dict:
    return {
        "architectures": ["CLIPTextModel"], "model_type": "clip_text_model",
        "hidden_size": c.n_state, "intermediate_size": c.n_state * 4,
        "num_attention_heads": c.n_head, "num_hidden_layers": c.n_layer,
        "max_position_embeddings": c.n_ctx, "vocab_size": c.n_vocab,
        "projection_dim": c.embed_dim,
        "hidden_act": "quick_gelu" if c.quick_gelu else "gelu",
    }


def write_sd1_diffusers_pipeline_dir(out_dir: str, pipe,
                                     sd2: bool = False) -> str:
    """Write an SD1Pipeline (pipeline/sd1.py) in the diffusers
    StableDiffusionPipeline layout: unet/ (its qkv unfused), vae/ (the
    decoder and the encoder), text_encoder/,
    tokenizer/, scheduler/ and model_index.json, every tensor in its own
    dtype. sd2=True marks the SD 2.x family as the reference's
    writer does: the tokenizer directory pads with "!" (id 0), the VAE
    config's sample_size is 768, and the scheduler records the UNet's
    prediction_type."""
    os.makedirs(out_dir, exist_ok=True)

    def part(name: str, flat, weights: str, config: dict) -> None:
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        save_file(flat, os.path.join(d, weights))
        _json(os.path.join(d, "config.json"), config)

    ucfg = pipe.diffuser_cfg.unet_config()
    part("unet", to_diffusers(pipe.unet),
         "diffusion_pytorch_model.safetensors", _unet_config_json(ucfg))
    if pipe.vae_encoder is None:
        raise ValueError("a diffusers AutoencoderKL holds the VAE encoder "
                         "too: this pipeline has none")
    part("vae", vae_to_diffusers(pipe.vae, pipe.vae_encoder),
         "diffusion_pytorch_model.safetensors",
         _vae_config_json(pipe.vae_cfg, float(pipe.scale_factor),
                          768 if sd2 else 512))
    part("text_encoder", clip_to_hf(pipe.embedder), "model.safetensors",
         _clip_config_json(pipe.embedder_cfg))
    _write_tokenizer_dir(os.path.join(out_dir, "tokenizer"),
                         pipe.clip_tokenizer, "!" if sd2 else "<|endoftext|>")
    os.makedirs(os.path.join(out_dir, "scheduler"), exist_ok=True)
    _json(os.path.join(out_dir, "scheduler", "scheduler_config.json"), {
        "_class_name": "EulerDiscreteScheduler",
        "beta_schedule": "scaled_linear", "beta_start": 0.00085,
        "beta_end": 0.012, "num_train_timesteps": pipe.diffuser_cfg.n_steps,
        "prediction_type": ("v_prediction"
                            if pipe.diffuser_cfg.prediction_type == "v"
                            else "epsilon"),
        "steps_offset": 1, "timestep_spacing": "leading",
    })
    _json(os.path.join(out_dir, "model_index.json"), {
        "_class_name": "StableDiffusionPipeline",
        "feature_extractor": [None, None],
        "requires_safety_checker": False, "safety_checker": [None, None],
        "scheduler": ["diffusers", "EulerDiscreteScheduler"],
        "text_encoder": ["transformers", "CLIPTextModel"],
        "tokenizer": ["transformers", "CLIPTokenizer"],
        "unet": ["diffusers", "UNet2DConditionModel"],
        "vae": ["diffusers", "AutoencoderKL"],
    })
    return out_dir
