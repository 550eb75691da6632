"""FLUX.1, the rectified-flow transformer (counterpart of
sdxl_tpu/models/flux.py; diffusers FluxTransformer2DModel semantics).

- tokens are packed 2x2 latent patches (16-ch latent -> 64 wide, channel
  first, then the 2x2 offsets), embedded by x_embedder; the T5 stream by
  context_embedder;
- temb = MLP(timestep sinusoid) [+ MLP(guidance sinusoid), dev] +
  MLP(CLIP-L pooled); the sinusoids see sigma * 1000 and guidance * 1000;
- 3-axis RoPE over (id, row, col) ids, widths (16, 56, 56), theta 10000,
  cos/sin repeated in interleaved pairs; text tokens at position 0, and
  Kontext's reference image on a second grid with id axis 0 = 1;
  ``apply_rope`` rotates in f32 and rounds back to the compute dtype;
- num_layers double blocks: adaLN-Zero per stream (6-way, shift first),
  one attention over [txt ++ img] (TEXT first, the opposite of SD3) with
  per-head RMS q/k norms (norm_added_* on the text half) and RoPE;
- num_single_layers single blocks on [txt ++ img]: 3-way adaLN, the
  attention and a parallel 4x MLP from one normed input, fused back by
  proj_out([attn ++ gelu(mlp)]);
- the final AdaLayerNormContinuous (scale first) + a linear to 64.

Every attention goes through ops.attention.qkv_attention: 24 heads of
128 over 4608 tokens at 1024^2 (512 T5 + 4096 image), which the flash
gate sends to K1. Module names mirror the reference's tree.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import FluxConfig
from ..ops.attention import qkv_attention
from ..ops.embeddings import timestep_embedding
from .layers import Linear, RMSGain
from .mmdit import _mlp, _mod, gelu_mlp, modulate, rms_head, split_heads


def rope_tables(cfg: FluxConfig, gh: int, gw: int, n_txt: int,
                cond_gh: int = 0,
                cond_gw: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) [n_txt + gh*gw (+ cond_gh*cond_gw), head_dim] f32: the
    FluxPosEmbed tables for text ids (all zero), the image ids (axis 1 =
    row, axis 2 = column) and, for Kontext, a second image grid whose id
    axis 0 is 1; per axis of width d the frequencies theta^(-2j/d),
    repeat-interleaved into cos/sin pairs."""
    txt_ids = np.zeros((n_txt, 3), np.float64)
    img_ids = np.zeros((gh, gw, 3), np.float64)
    img_ids[..., 1] += np.arange(gh)[:, None]
    img_ids[..., 2] += np.arange(gw)[None, :]
    ids = np.concatenate([txt_ids, img_ids.reshape(-1, 3)], axis=0)
    if cond_gh and cond_gw:
        cond_ids = np.zeros((cond_gh, cond_gw, 3), np.float64)
        cond_ids[..., 0] = 1.0
        cond_ids[..., 1] += np.arange(cond_gh)[:, None]
        cond_ids[..., 2] += np.arange(cond_gw)[None, :]
        ids = np.concatenate([ids, cond_ids.reshape(-1, 3)], axis=0)
    cos_parts, sin_parts = [], []
    for axis, dim in enumerate(cfg.axes_dims):
        freqs = 1.0 / cfg.rope_theta ** (
            np.arange(0, dim, 2, dtype=np.float64) / dim)
        out = np.outer(ids[:, axis], freqs)
        cos_parts.append(np.repeat(np.cos(out), 2, axis=1))
        sin_parts.append(np.repeat(np.sin(out), 2, axis=1))
    return (np.concatenate(cos_parts, axis=1).astype(np.float32),
            np.concatenate(sin_parts, axis=1).astype(np.float32))


@functools.lru_cache(maxsize=16)
def _rope_tensors(cfg: FluxConfig, gh: int, gw: int, n_txt: int,
                  cond_gh: int, cond_gw: int, device):
    return tuple(torch.as_tensor(t, device=device)
                 for t in rope_tables(cfg, gh, gw, n_txt, cond_gh, cond_gw))


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, hd] rotated pairwise in f32: x * cos + rot(x) * sin,
    rot interleaving (-x_odd, x_even); rounded back to x's dtype."""
    xf = x.float()
    x2 = xf.reshape(*xf.shape[:-1], -1, 2)
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(xf.shape)
    out = xf * cos[None, :, None, :] + rot * sin[None, :, None, :]
    return out.to(x.dtype)


class DoubleAttention(nn.Module):
    def __init__(self, cfg: FluxConfig, **kw):
        super().__init__()
        h = cfg.hidden
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                     "add_v_proj", "to_out", "to_add_out"):
            setattr(self, name, Linear(h, h, **kw))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            setattr(self, name, RMSGain(cfg.head_dim, **kw))


class SingleAttention(nn.Module):
    def __init__(self, cfg: FluxConfig, **kw):
        super().__init__()
        h = cfg.hidden
        for name in ("to_q", "to_k", "to_v"):
            setattr(self, name, Linear(h, h, **kw))
        self.norm_q = RMSGain(cfg.head_dim, **kw)
        self.norm_k = RMSGain(cfg.head_dim, **kw)


class DoubleBlock(nn.Module):
    """FluxTransformerBlock: joint attention over [txt ++ img], per-stream
    adaLN-Zero modulation and MLPs."""

    def __init__(self, cfg: FluxConfig, **kw):
        super().__init__()
        h = cfg.hidden
        self.cfg = cfg
        self.norm1 = _mod(h, 6, **kw)
        self.norm1_context = _mod(h, 6, **kw)
        self.attn = DoubleAttention(cfg, **kw)
        self.mlp = _mlp(h, cfg.mlp_ratio, **kw)
        self.mlp_context = _mlp(h, cfg.mlp_ratio, **kw)

    def forward(self, x, c, temb, cos, sin):
        st = F.silu(temb)
        sh, sc, g, sh2, sc2, g2 = self.norm1["mod"](st).chunk(6, dim=-1)
        csh, csc, cg, csh2, csc2, cg2 = self.norm1_context["mod"](
            st).chunk(6, dim=-1)
        nx, nc = modulate(x, sh, sc), modulate(c, csh, csc)
        a = self.attn
        n, lt = self.cfg.n_heads, c.shape[1]
        q = torch.cat([a.add_q_proj(nc), a.to_q(nx)], 1)
        k = torch.cat([a.add_k_proj(nc), a.to_k(nx)], 1)
        v = torch.cat([a.add_v_proj(nc), a.to_v(nx)], 1)
        qh, kh = split_heads(q, n), split_heads(k, n)
        qh = torch.cat([rms_head(qh[:, :lt], a.norm_added_q.weight),
                        rms_head(qh[:, lt:], a.norm_q.weight)], 1)
        kh = torch.cat([rms_head(kh[:, :lt], a.norm_added_k.weight),
                        rms_head(kh[:, lt:], a.norm_k.weight)], 1)
        qh = apply_rope(qh, cos, sin).reshape(q.shape)
        kh = apply_rope(kh, cos, sin).reshape(k.shape)
        att = qkv_attention(qh, kh, v, None, n)
        x = x + g[:, None] * a.to_out(att[:, lt:])
        x = x + g2[:, None] * gelu_mlp(self.mlp, modulate(x, sh2, sc2))
        c = c + cg[:, None] * a.to_add_out(att[:, :lt])
        c = c + cg2[:, None] * gelu_mlp(self.mlp_context,
                                        modulate(c, csh2, csc2))
        return x, c


class SingleBlock(nn.Module):
    """FluxSingleTransformerBlock: attention and a parallel MLP from one
    normed input, fused by proj_out([attn ++ gelu(mlp)])."""

    def __init__(self, cfg: FluxConfig, **kw):
        super().__init__()
        h = cfg.hidden
        self.cfg = cfg
        self.norm = _mod(h, 3, **kw)
        self.attn = SingleAttention(cfg, **kw)
        self.proj_mlp = Linear(h, cfg.mlp_ratio * h, **kw)
        self.proj_out = Linear((1 + cfg.mlp_ratio) * h, h, **kw)

    def forward(self, x, temb, cos, sin):
        sh, sc, g = self.norm["mod"](F.silu(temb)).chunk(3, dim=-1)
        nx = modulate(x, sh, sc)
        a, n = self.attn, self.cfg.n_heads
        q = rms_head(split_heads(a.to_q(nx), n), a.norm_q.weight)
        k = rms_head(split_heads(a.to_k(nx), n), a.norm_k.weight)
        q = apply_rope(q, cos, sin).reshape(nx.shape)
        k = apply_rope(k, cos, sin).reshape(nx.shape)
        att = qkv_attention(q, k, a.to_v(nx), None, n)
        mlp = F.gelu(self.proj_mlp(nx), approximate="tanh")
        return x + g[:, None] * self.proj_out(torch.cat([att, mlp], -1))


class Flux(nn.Module):
    def __init__(self, cfg: FluxConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden
        self.cfg = cfg
        self.x_embedder = Linear(cfg.in_channels, h, **kw)
        self.context_embedder = Linear(cfg.joint_attention_dim, h, **kw)
        te = {"timestep_lin1": Linear(cfg.time_sinusoid_dim, h, **kw),
              "timestep_lin2": Linear(h, h, **kw),
              "text_lin1": Linear(cfg.pooled_projection_dim, h, **kw),
              "text_lin2": Linear(h, h, **kw)}
        if cfg.guidance_embeds:
            te["guidance_lin1"] = Linear(cfg.time_sinusoid_dim, h, **kw)
            te["guidance_lin2"] = Linear(h, h, **kw)
        self.time_text_embed = nn.ModuleDict(te)
        self.blocks = nn.ModuleList(DoubleBlock(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.single_blocks = nn.ModuleList(
            SingleBlock(cfg, **kw) for _ in range(cfg.num_single_layers))
        self.norm_out = _mod(h, 2, **kw)
        self.proj_out = Linear(h, cfg.in_channels, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.proj_out.weight.dtype


def _pack(lat: torch.Tensor) -> torch.Tensor:
    """[B, h, w, C] -> [B, (h/2)(w/2), 4C] in _pack_latents' (C, 2, 2)
    order."""
    b, h, w, c = lat.shape
    p = lat.reshape(b, h // 2, 2, w // 2, 2, c)
    return p.permute(0, 1, 3, 5, 2, 4).reshape(b, (h // 2) * (w // 2), 4 * c)


def flux_forward(model: Flux, latent: torch.Tensor, timesteps: torch.Tensor,
                 context: torch.Tensor, pooled: torch.Tensor,
                 guidance: Optional[torch.Tensor] = None,
                 cond_latent: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Velocity [B, h, w, 16] of the NHWC latent (compute dtype) at
    timesteps [B] (sigma * 1000), T5 context [B, T, 4096], CLIP-L pooled
    [B, 768] and, on dev, guidance [B] (scale * 1000). ``cond_latent``
    [B, h2, w2, 16] is Kontext's clean reference latent, packed after the
    target tokens with RoPE id axis 0 = 1; only the target rows come
    back."""
    cfg = model.cfg
    dtype = latent.dtype
    b, h, w, ch = latent.shape
    gh, gw = h // 2, w // 2
    xp = _pack(latent)
    n_target = xp.shape[1]
    cond_gh = cond_gw = 0
    if cond_latent is not None:
        cond_gh, cond_gw = cond_latent.shape[1] // 2, cond_latent.shape[2] // 2
        xp = torch.cat([xp, _pack(cond_latent.to(dtype))], 1)
    x = model.x_embedder(xp)
    c = model.context_embedder(context.to(dtype))

    te = model.time_text_embed
    t_sin = timestep_embedding(timesteps, cfg.time_sinusoid_dim).to(dtype)
    temb = te["timestep_lin2"](F.silu(te["timestep_lin1"](t_sin)))
    if cfg.guidance_embeds:
        if guidance is None:
            raise ValueError("this checkpoint is guidance-distilled "
                             "(guidance_embeds): pass guidance")
        g_sin = timestep_embedding(guidance, cfg.time_sinusoid_dim).to(dtype)
        temb = temb + te["guidance_lin2"](F.silu(te["guidance_lin1"](g_sin)))
    temb = temb + te["text_lin2"](F.silu(te["text_lin1"](pooled.to(dtype))))

    cos, sin = _rope_tensors(cfg, gh, gw, context.shape[1], cond_gh, cond_gw,
                             latent.device)
    for blk in model.blocks:
        x, c = blk(x, c, temb, cos, sin)
    lt = c.shape[1]
    xs = torch.cat([c, x], 1)  # text first
    for blk in model.single_blocks:
        xs = blk(xs, temb, cos, sin)
    x = xs[:, lt:lt + n_target]

    sc, sh = model.norm_out["mod"](F.silu(temb)).chunk(2, dim=-1)
    out = model.proj_out(modulate(x, sh, sc))
    out = out.reshape(b, gh, gw, ch, 2, 2)
    return out.permute(0, 1, 4, 2, 5, 3).reshape(b, h, w, ch)
