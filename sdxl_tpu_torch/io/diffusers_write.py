"""Write a ControlNet in the diffusers ``ControlNetModel`` layout (the
ControlNet part of sdxl_tpu/io/diffusers_write.py).

``controlnet_to_diffusers`` renames the trunk's state_dict keys to
diffusers' (the exact inverse of io/diffusers_sdxl.py's
``build_controlnet_from_diffusers``: the fused self-attention qkv split
back into to_q/to_k/to_v; every tensor is in torch's layout on both
sides), and ``write_diffusers_controlnet_dir`` writes the flat directory
(diffusion_pytorch_model.safetensors + config.json) that
``load_controlnet_dir`` and the ``sample`` CLI's ``--controlnet`` read.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict

import torch

from ..configs import UNetConfig
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
    """A trunk state_dict key (unfused) -> its diffusers key; where maps
    an input block to (level, resnet index) or (level, "down")."""
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


def controlnet_to_diffusers(net: ControlNet) -> Dict[str, torch.Tensor]:
    """{diffusers key: tensor} of a ControlNet, on its device."""
    where = _input_block_places(net.cfg)
    sd = unfuse_qkv(dict(net.state_dict()))
    return {_diffusers_key(k, where): v for k, v in sd.items()}


def write_diffusers_controlnet_dir(out_dir: str, net: ControlNet) -> str:
    """Write ``{out_dir}/{diffusion_pytorch_model.safetensors,
    config.json}``, a diffusers ControlNetModel directory in the net's
    dtype."""
    cfg = net.cfg
    flat = controlnet_to_diffusers(net)
    os.makedirs(out_dir, exist_ok=True)
    save_file(flat, os.path.join(out_dir,
                                 "diffusion_pytorch_model.safetensors"))
    n = len(cfg.channel_mults)
    heads = cfg.n_heads or [cfg.model_channels * m // cfg.n_head_channels
                            for m in cfg.channel_mults]
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
        "attention_head_dim": heads,
        "addition_embed_type": "text_time" if cfg.adm_in_channels else None,
        "projection_class_embeddings_input_dim":
            cfg.adm_in_channels or None,
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir
