"""IP-Adapter (Ye et al. 2023, arXiv:2308.06721), image-prompt conditioning
through decoupled cross-attention (counterpart of
sdxl_tpu/models/ip_adapter.py).

- The CLIP vision tower (models/clip_vision.py) embeds the prompt image;
  ``ip_image_tokens`` (ImageProjModel: Linear -> reshape -> LayerNorm)
  maps the projected embedding to n_tokens context tokens, or, for the
  "plus" adapters, ``resampler_tokens`` (the perceiver Resampler) maps the
  tower's penultimate hidden states. The unconditional rows run a zero
  embedding (proj) or the tower on zero pixels after normalisation (plus).
- Every cross-attention gets ``to_k_ip``/``to_v_ip`` (no bias) over the
  image tokens; its output is attn(q, k, v) + scale * attn(q, k_ip, v_ip)
  before the out projection. The tokens are fixed for a request, so
  ``merge_ip_kv`` computes each site's K/V once, the scale folded into
  v_ip, beside the text K/V of precompute_cross_kv.

``IPAdapter``'s module tree is the official checkpoint's, so its
state_dict keys are the file's: ``image_proj.proj``/``norm`` (or the
Resampler's ``latents``, ``proj_in``, ``layers.{i}.0`` attention and
``layers.{i}.1`` feed-forward, ``proj_out``, ``norm_out``) and
``ip_adapter.{n}.to_{k,v}_ip`` with n = 1, 3, 5, ... over the UNet's
cross-attentions in diffusers' registration order: the down blocks, then
the up blocks, then the middle block (``organize_ip_layers``). A wrong
order still runs; only a parity test finds it.

The reference computes the image K/V in f32 (f32 weights times the
tokens cast to the UNet's dtype) and so carries a bf16 UNet's stream in
f32 after the first adapted attention; the port casts them to the UNet's
dtype. In f32 the two are the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import UNetConfig
from ..ops.attention import qkv_attention
from .layers import LayerNorm, Linear
from .unet import unet_block_plan

# dim_head of every shipped Resampler
RESAMPLER_DIM_HEAD = 64
RESAMPLER_FF_MULT = 4


@dataclass(frozen=True)
class IPAdapterConfig:
    clip_embed_dim: int = 1024   # the vision tower's projection_dim (ViT-H)
    context_dim: int = 2048      # the UNet's cross-attention dim
    n_tokens: int = 4            # extra context tokens
    # "proj": ImageProjModel over the projected embedding; "resampler":
    # the perceiver Resampler over the penultimate hidden states ("plus")
    variant: str = "proj"
    # the Resampler's geometry (variant "resampler")
    dim: int = 0
    depth: int = 0
    heads: int = 0


class ImageProjModel(nn.Module):
    def __init__(self, cfg: IPAdapterConfig, **kw):
        super().__init__()
        self.proj = Linear(cfg.clip_embed_dim,
                           cfg.n_tokens * cfg.context_dim, **kw)
        self.norm = LayerNorm(cfg.context_dim, **kw)


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, heads: int, **kw):
        super().__init__()
        inner = heads * RESAMPLER_DIM_HEAD
        self.heads = heads
        self.norm1 = LayerNorm(dim, **kw)
        self.norm2 = LayerNorm(dim, **kw)
        self.to_q = Linear(dim, inner, bias=False, **kw)
        self.to_kv = Linear(dim, 2 * inner, bias=False, **kw)
        self.to_out = Linear(inner, dim, bias=False, **kw)

    def forward(self, x, latents):
        """Latents query a concat of (input tokens, latents); the official
        (q s)(k s)ᵀ double-sqrt scaling is the standard d^-0.5."""
        xn, ln = self.norm1(x), self.norm2(latents)
        k, v = self.to_kv(torch.cat([xn, ln], dim=1)).chunk(2, dim=-1)
        return self.to_out(qkv_attention(self.to_q(ln), k, v, None,
                                         self.heads))


class Resampler(nn.Module):
    def __init__(self, cfg: IPAdapterConfig, **kw):
        super().__init__()
        d = cfg.dim
        self.latents = nn.Parameter(torch.empty(1, cfg.n_tokens, d,
                                                **kw))
        self.proj_in = Linear(cfg.clip_embed_dim, d, **kw)
        self.layers = nn.ModuleList(nn.ModuleList([
            PerceiverAttention(d, cfg.heads, **kw),
            # official FeedForward: LayerNorm, Linear, GELU, Linear
            nn.Sequential(LayerNorm(d, **kw),
                          Linear(d, RESAMPLER_FF_MULT * d, bias=False, **kw),
                          nn.GELU(),
                          Linear(RESAMPLER_FF_MULT * d, d, bias=False, **kw)),
        ]) for _ in range(cfg.depth))
        self.proj_out = Linear(d, cfg.context_dim, **kw)
        self.norm_out = LayerNorm(cfg.context_dim, **kw)


def cross_attention_widths(ucfg: UNetConfig) -> List[int]:
    """The inner width of each cross-attention in checkpoint order: input
    blocks ascending, output blocks ascending, the middle block last."""
    in_plan, mid_spec, out_plan = unet_block_plan(ucfg)
    sites = ([s for s in in_plan if s.kind in ("res_t", "res_t_up")]
             + [s for s in out_plan if s.kind in ("res_t", "res_t_up")]
             + [mid_spec])
    return [s.ch_out for s in sites for _ in range(s.depth)]


class IPAdapter(nn.Module):
    """An adapter for a UNet config: image_proj and one {to_k_ip, to_v_ip}
    pair a cross-attention, keyed by the checkpoint's index (1, 3, 5, ...
    unless ``indices`` gives the file's)."""

    def __init__(self, cfg: IPAdapterConfig, ucfg: UNetConfig,
                 indices=None, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.image_proj = (Resampler(cfg, **kw) if cfg.variant == "resampler"
                           else ImageProjModel(cfg, **kw))
        widths = cross_attention_widths(ucfg)
        if indices is None:
            indices = [2 * j + 1 for j in range(len(widths))]
        if len(indices) != len(widths):
            raise ValueError(
                f"IP-Adapter layer count mismatch: checkpoint has "
                f"{len(indices)} cross-attention layers, the UNet config "
                f"{len(widths)} — wrong model family?")
        self.ip_adapter = nn.ModuleDict({
            str(i): nn.ModuleDict({
                "to_k_ip": Linear(cfg.context_dim, w, bias=False, **kw),
                "to_v_ip": Linear(cfg.context_dim, w, bias=False, **kw)})
            for i, w in zip(indices, widths)})


def ip_image_tokens(adapter: IPAdapter,
                    image_embeds: torch.Tensor) -> torch.Tensor:
    """ImageProjModel: [B, clip_embed_dim] -> [B, n_tokens, context_dim]."""
    p, cfg = adapter.image_proj, adapter.cfg
    x = p.proj(image_embeds).reshape(-1, cfg.n_tokens, cfg.context_dim)
    return p.norm(x)


def resampler_tokens(adapter: IPAdapter,
                     hidden: torch.Tensor) -> torch.Tensor:
    """The Resampler: [B, T, embedding_dim] penultimate hidden states ->
    [B, n_tokens, context_dim]; learned latents attend to proj_in(hidden)
    and themselves through depth (attention, feed-forward) residual
    pairs, then proj_out and norm_out."""
    p = adapter.image_proj
    x = p.proj_in(hidden)
    lat = p.latents.expand(x.shape[0], -1, -1)
    for attn, ff in p.layers:
        lat = attn(x, lat) + lat
        lat = ff(lat) + lat
    return p.norm_out(p.proj_out(lat))


def organize_ip_layers(adapter: IPAdapter, ucfg: UNetConfig) -> dict:
    """The adapter's {to_k_ip, to_v_ip} pairs in precompute_cross_kv's
    layout ({"input_blocks": {i: [pair] * depth}, "middle_block": [...],
    "output_blocks": {i: [...]}}), assigned in checkpoint order (indices
    ascending): input blocks, then OUTPUT blocks, then the middle block."""
    in_plan, mid_spec, out_plan = unet_block_plan(ucfg)
    it = iter(adapter.ip_adapter[k] for k in sorted(adapter.ip_adapter,
                                                     key=int))

    def sites(plan):
        return {i: [next(it) for _ in range(s.depth)]
                for i, s in enumerate(plan) if s.kind in ("res_t", "res_t_up")}

    out = {"input_blocks": sites(in_plan)}
    out["output_blocks"] = sites(out_plan)
    out["middle_block"] = [next(it) for _ in range(mid_spec.depth)]
    return out


def merge_ip_kv(cross_kv: dict, layers: dict, tokens: torch.Tensor,
                scale: float) -> dict:
    """A precompute_cross_kv tree with each site's ip_k and ip_v (scale
    folded into ip_v) over ``tokens`` [B', n_tokens, context_dim], B' the
    context batch the UNet sees; computed in the adapter's dtype (f32)
    and cast to the tokens' (the UNet's compute dtype)."""
    def site(kv, pair):
        t = tokens.to(pair["to_k_ip"].weight.dtype)
        k = F.linear(t, pair["to_k_ip"].weight)
        v = F.linear(t, pair["to_v_ip"].weight) * scale
        return {**kv, "ip_k": k.to(tokens.dtype), "ip_v": v.to(tokens.dtype)}

    def sites(kvs: Dict[int, list], pairs: Dict[int, list]):
        return {i: [site(kv, p) for kv, p in zip(kv_list, pairs[i])]
                for i, kv_list in kvs.items()}

    return {
        "input_blocks": sites(cross_kv["input_blocks"],
                              layers["input_blocks"]),
        "middle_block": [site(kv, p) for kv, p in zip(
            cross_kv["middle_block"], layers["middle_block"])],
        "output_blocks": sites(cross_kv["output_blocks"],
                               layers["output_blocks"]),
    }
