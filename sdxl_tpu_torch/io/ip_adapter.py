"""IP-Adapter and CLIP vision encoder checkpoints (counterpart of
sdxl_tpu/io/ip_adapter.py), read and written.

- A transformers ``CLIPVisionModelWithProjection`` directory (config.json
  and *.safetensors) <-> models/clip_vision.py's ``CLIPVisionModel``: the
  keys renamed, the patch conv OIHW on both sides, ``visual_projection``
  transposed ([embed_dim, n_state] in the file).
- An official ip-adapter*.safetensors file <-> ``IPAdapter``, whose
  state_dict keys are the file's; the variant and its geometry (tokens,
  widths, the plus Resampler's depth and heads) are read off the tensors'
  shapes, as the reference does.

The writers (``save_clip_vision_dir``, ``save_ip_adapter_file``) are the
readers' inverses, so a random adapter can be written and loaded through
the ``sample`` CLI as a real one would be.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Tuple

import torch

from ..configs import UNetConfig
from ..models.clip_vision import CLIPVisionConfig, CLIPVisionModel
from ..models.ip_adapter import (
    RESAMPLER_DIM_HEAD,
    IPAdapter,
    IPAdapterConfig,
)
from .diffusers_sdxl import _load_safetensors_dir, _load_strict
from .safetensors import load_file, save_file

_VM = "vision_model"
_IP_LAYER_RE = re.compile(r"^ip_adapter\.(\d+)\.to_([kv])_ip\.weight$")


def _clip_vision_names(cfg: CLIPVisionConfig) -> List[Tuple[str, str]]:
    """(transformers key, port key) pairs of a vision tower."""
    e = f"{_VM}.embeddings"
    names = [(f"{e}.class_embedding", "class_embedding"),
             (f"{e}.patch_embedding.weight", "patch_embedding.weight"),
             (f"{e}.position_embedding.weight", "position_embedding"),
             ("visual_projection.weight", "visual_projection")]
    for hf, port in (("pre_layrnorm", "pre_ln"),  # transformers' typo
                     ("post_layernorm", "post_ln")):
        names += [(f"{_VM}.{hf}.{p}", f"{port}.{p}") for p in ("weight",
                                                             "bias")]
    for i in range(cfg.n_layer):
        hf, port = f"{_VM}.encoder.layers.{i}", f"blocks.{i}"
        for a, b in (("self_attn.q_proj", "attn.q"),
                     ("self_attn.k_proj", "attn.k"),
                     ("self_attn.v_proj", "attn.v"),
                     ("self_attn.out_proj", "attn.out"),
                     ("layer_norm1", "attn_ln"), ("mlp.fc1", "mlp.fc1"),
                     ("mlp.fc2", "mlp.fc2"), ("layer_norm2", "mlp_ln")):
            names += [(f"{hf}.{a}.{p}", f"{port}.{b}.{p}")
                      for p in ("weight", "bias")]
    return names


def build_clip_vision_from_tensors(t: Dict[str, torch.Tensor],
                                   cfg: CLIPVisionConfig,
                                   dtype=torch.float32, device="cpu"
                                   ) -> Dict[str, torch.Tensor]:
    """transformers CLIPVisionModelWithProjection tensors -> the state_dict
    of a CLIPVisionModel, on ``device`` one tensor at a time."""
    sd = {}
    for hf, port in _clip_vision_names(cfg):
        x = t[hf]
        if port == "visual_projection":
            x = x.t()
        sd[port] = x.to(device=device, dtype=dtype).contiguous()
    return sd


def _vision_config(raw: dict) -> CLIPVisionConfig:
    # CLIPVisionModelWithProjection keeps the vision fields at the top
    # level; a full CLIPModel config nests them under "vision_config"
    vc = raw.get("vision_config", raw)
    return CLIPVisionConfig(
        image_size=vc.get("image_size", 224),
        patch_size=vc.get("patch_size", 14),
        n_state=vc.get("hidden_size", 1280),
        n_head=vc.get("num_attention_heads", 16),
        n_layer=vc.get("num_hidden_layers", 32),
        embed_dim=raw.get("projection_dim", vc.get("projection_dim", 1024)),
        quick_gelu=vc.get("hidden_act", "gelu") == "quick_gelu")


def load_clip_vision_dir(model_dir: str, device="cuda"
                         ) -> Tuple[CLIPVisionModel, CLIPVisionConfig]:
    """A transformers CLIPVisionModelWithProjection directory -> (the
    tower on ``device`` in f32, its config)."""
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        cfg = _vision_config(json.load(f))
    sd = build_clip_vision_from_tensors(_load_safetensors_dir(model_dir),
                                        cfg, torch.float32, device)
    return _load_strict(CLIPVisionModel(cfg, "meta", torch.float32), sd,
                        model_dir), cfg


def save_clip_vision_dir(out_dir: str, model: CLIPVisionModel) -> str:
    """Write ``model`` as a transformers CLIPVisionModelWithProjection
    directory (config.json, model.safetensors)."""
    cfg = model.cfg
    sd = model.state_dict()
    tensors = {hf: (sd[port].t() if port == "visual_projection"
                    else sd[port]).contiguous()
               for hf, port in _clip_vision_names(cfg)}
    os.makedirs(out_dir, exist_ok=True)
    save_file(tensors, os.path.join(out_dir, "model.safetensors"))
    meta = {"architectures": ["CLIPVisionModelWithProjection"],
            "model_type": "clip_vision_model",
            "hidden_size": cfg.n_state,
            "intermediate_size": 4 * cfg.n_state,
            "num_attention_heads": cfg.n_head,
            "num_hidden_layers": cfg.n_layer,
            "image_size": cfg.image_size, "patch_size": cfg.patch_size,
            "projection_dim": cfg.embed_dim,
            "hidden_act": "quick_gelu" if cfg.quick_gelu else "gelu"}
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


def _adapter_config(t: Dict[str, torch.Tensor], path: str) -> IPAdapterConfig:
    """The adapter's variant and geometry from its tensors' shapes."""
    if "image_proj.latents" in t:
        _, n_queries, dim = t["image_proj.latents"].shape
        depth = 0
        while f"image_proj.layers.{depth}.0.to_q.weight" in t:
            depth += 1
        inner = int(t["image_proj.layers.0.0.to_q.weight"].shape[0])
        return IPAdapterConfig(
            clip_embed_dim=int(t["image_proj.proj_in.weight"].shape[1]),
            context_dim=int(t["image_proj.proj_out.weight"].shape[0]),
            n_tokens=int(n_queries), variant="resampler", dim=int(dim),
            depth=depth, heads=inner // RESAMPLER_DIM_HEAD)
    if "image_proj.proj.weight" in t:
        proj_w = t["image_proj.proj.weight"]  # [n_tokens * ctx, clip_dim]
        ctx = int(t["image_proj.norm.weight"].shape[0])
        return IPAdapterConfig(clip_embed_dim=int(proj_w.shape[1]),
                               context_dim=ctx,
                               n_tokens=int(proj_w.shape[0]) // ctx)
    present = sorted({k.split(".")[0] for k in t})
    raise ValueError(
        f"{path}: not an IP-Adapter checkpoint — neither "
        f"image_proj.proj.weight (ImageProjModel) nor image_proj.latents "
        f"(Resampler/'plus') found (top-level keys: {present})")


def load_ip_adapter_file(path: str, unet_cfg: UNetConfig, device="cuda"
                         ) -> Tuple[IPAdapter, IPAdapterConfig]:
    """An official ip-adapter*.safetensors -> (IPAdapter on ``device`` in
    f32, its config). The ip_adapter.{n} pairs are taken in numeric
    order onto the UNet's cross-attentions (organize_ip_layers)."""
    t = load_file(path)
    cfg = _adapter_config(t, path)
    if cfg.context_dim != unet_cfg.context_dim:
        raise ValueError(
            f"{path}: adapter context dim {cfg.context_dim} != UNet context "
            f"dim {unet_cfg.context_dim} — wrong model family?")
    by_idx: Dict[int, set] = {}
    for key in t:
        m = _IP_LAYER_RE.match(key)
        if m:
            by_idx.setdefault(int(m.group(1)), set()).add(m.group(2))
    for i, kinds in sorted(by_idx.items()):
        if kinds != {"k", "v"}:
            raise ValueError(f"{path}: ip_adapter.{i} missing to_k_ip or "
                             "to_v_ip")
    adapter = IPAdapter(cfg, unet_cfg, sorted(by_idx), "meta", torch.float32)
    sd = {k: v.to(device=device, dtype=torch.float32) for k, v in t.items()}
    return _load_strict(adapter, sd, path), cfg


def save_ip_adapter_file(path: str, adapter: IPAdapter) -> str:
    """Write ``adapter`` as an official ip-adapter*.safetensors file."""
    save_file({k: v.contiguous() for k, v in adapter.state_dict().items()},
              path)
    return path
