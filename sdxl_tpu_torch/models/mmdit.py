"""MMDiT, the SD3 family's Multimodal Diffusion Transformer (counterpart
of sdxl_tpu/models/mmdit.py; diffusers SD3Transformer2DModel semantics).

- 2x2 patchify as one linear over (ph, pw, c)-ordered patch vectors, plus
  a fixed 2D sin/cos grid over pos_embed_max_size^2 positions at base
  size 64, centre-cropped to the latent's patch grid (the public code's
  grid[0] carries the W coordinate; kept so a real checkpoint sees the
  grid it was trained with);
- temb = MLP(256-wide cos-first timestep sinusoid of sigma * 1000) +
  MLP(pooled CLIP 2048);
- context_embedder: one linear from the 4096-wide token stream;
- num_layers joint blocks: adaLN-Zero per stream (6-way chunk, SHIFT
  first), one joint self-attention over [x ++ c] (LATENT first) with
  per-stream projections, gated residuals, GELU(tanh) MLPs of ratio 4.
  The last block is context_pre_only: its context stream takes a 2-way
  (SCALE first, AdaLayerNormContinuous) modulation, feeds the attention
  and has no output projection or MLP;
- SD3.5's per-head RMS q/k norm (``qk_norm="rms"``, an f32 island
  rounded back to the compute dtype before its gain);
- SD3.5-medium's ``dual_attention_layers``: a 9-way modulation and an
  extra latent-stream self-attention (attn2);
- the final AdaLayerNormContinuous (scale first), a linear to
  p * p * out_channels and the unpatchify;
- ``skip_layers`` omits whole blocks (skip-layer guidance's perturbed
  branch).

Both attentions go through ops.attention.qkv_attention: the joint one
runs over HW/4 + 333 tokens (4429 at 1024^2) with 64-wide heads, which
the flash gate sends to K1. Activations are [B, T, C]; the latent comes
and goes NHWC, as in the reference. Module names mirror the reference's
tree (io/bridge.py mmdit_state_dict).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import MMDiTConfig
from ..ops.attention import qkv_attention
from ..ops.embeddings import timestep_embedding
from ..ops.norms import layernorm
from .layers import Linear, RMSGain


def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
    omega = 1.0 / 10000.0**omega
    out = np.outer(pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def cropped_pos_embed(cfg: MMDiTConfig, gh: int, gw: int) -> np.ndarray:
    """[gh * gw, hidden] f32: the centre crop of the max-size grid
    (PatchEmbed.cropped_pos_embed, base size 64). Only the cropped
    positions are computed; each value is the same float64 expression as
    the full grid's."""
    m = cfg.pos_embed_max_size
    if gh > m or gw > m:
        raise ValueError(
            f"latent patch grid {gh}x{gw} exceeds pos_embed_max_size {m}")
    top, left = (m - gh) // 2, (m - gw) // 2
    rows = np.arange(top, top + gh, dtype=np.float64) / (m / 64)
    cols = np.arange(left, left + gw, dtype=np.float64) / (m / 64)
    grid_w, grid_h = np.meshgrid(cols, rows)
    d = cfg.hidden
    emb = np.concatenate([_sincos_1d(d // 2, grid_w),   # grid[0]: W
                          _sincos_1d(d // 2, grid_h)],  # grid[1]: H
                         axis=1)
    return emb.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _pos_tensor(cfg: MMDiTConfig, gh: int, gw: int, device,
                dtype) -> torch.Tensor:
    return torch.as_tensor(cropped_pos_embed(cfg, gh, gw),
                           device=device).to(dtype)


def rms_head(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm over the last axis: f32 island, rounded back to
    x's dtype, then the gain."""
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r).to(x.dtype) * w


def split_heads(t: torch.Tensor, n_head: int) -> torch.Tensor:
    b, n, d = t.shape
    return t.reshape(b, n, n_head, d // n_head)


def ln_nomod(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine, eps 1e-6 (f32 island)."""
    return layernorm(x, 1e-6)


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    return ln_nomod(x) * (1 + scale[:, None]) + shift[:, None]


def gelu_mlp(p: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    """FeedForward(activation_fn='gelu-approximate')."""
    return p["out"](F.gelu(p["in"](x), approximate="tanh"))


def _mlp(h: int, ratio: int, **kw) -> nn.ModuleDict:
    return nn.ModuleDict({"in": Linear(h, ratio * h, **kw),
                          "out": Linear(ratio * h, h, **kw)})


def _mod(h: int, n: int, **kw) -> nn.ModuleDict:
    return nn.ModuleDict({"mod": Linear(h, n * h, **kw)})


class JointAttention(nn.Module):
    """Per-stream q/k/v projections, one attention over [x ++ c]."""

    def __init__(self, cfg: MMDiTConfig, pre_only: bool, **kw):
        super().__init__()
        h = cfg.hidden
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                     "add_v_proj", "to_out"):
            setattr(self, name, Linear(h, h, **kw))
        self.to_add_out = None if pre_only else Linear(h, h, **kw)
        if cfg.qk_norm == "rms":
            for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
                setattr(self, name, RMSGain(cfg.head_dim, **kw))
        self.cfg = cfg

    def _norm(self, t: torch.Tensor, gain: str) -> torch.Tensor:
        if self.cfg.qk_norm != "rms":
            return t
        w = getattr(self, gain).weight
        return rms_head(split_heads(t, self.cfg.n_heads), w).reshape(t.shape)

    def forward(self, x: torch.Tensor, c: torch.Tensor):
        q = self._norm(self.to_q(x), "norm_q")
        k = self._norm(self.to_k(x), "norm_k")
        v = self.to_v(x)
        cq = self._norm(self.add_q_proj(c), "norm_added_q")
        ck = self._norm(self.add_k_proj(c), "norm_added_k")
        cv = self.add_v_proj(c)
        lx = x.shape[1]
        att = qkv_attention(torch.cat([q, cq], 1), torch.cat([k, ck], 1),
                            torch.cat([v, cv], 1), None, self.cfg.n_heads)
        out_x = self.to_out(att[:, :lx])
        out_c = (None if self.to_add_out is None
                 else self.to_add_out(att[:, lx:]))
        return out_x, out_c


class SelfAttention(nn.Module):
    """Plain latent-stream self-attention (SD3.5-medium's attn2)."""

    def __init__(self, cfg: MMDiTConfig, **kw):
        super().__init__()
        h = cfg.hidden
        for name in ("to_q", "to_k", "to_v", "to_out"):
            setattr(self, name, Linear(h, h, **kw))
        if cfg.qk_norm == "rms":
            self.norm_q = RMSGain(cfg.head_dim, **kw)
            self.norm_k = RMSGain(cfg.head_dim, **kw)
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.cfg.n_heads
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        if self.cfg.qk_norm == "rms":
            q = rms_head(split_heads(q, n), self.norm_q.weight).reshape(q.shape)
            k = rms_head(split_heads(k, n), self.norm_k.weight).reshape(k.shape)
        return self.to_out(qkv_attention(q, k, v, None, n))


class JointBlock(nn.Module):
    def __init__(self, cfg: MMDiTConfig, pre_only: bool, dual: bool, **kw):
        super().__init__()
        h = cfg.hidden
        self.pre_only, self.dual = pre_only, dual
        self.norm1 = _mod(h, 9 if dual else 6, **kw)
        self.norm1_context = _mod(h, 2 if pre_only else 6, **kw)
        self.attn = JointAttention(cfg, pre_only, **kw)
        self.mlp = _mlp(h, 4, **kw)
        self.attn2 = SelfAttention(cfg, **kw) if dual else None
        self.mlp_context = None if pre_only else _mlp(h, 4, **kw)

    def forward(self, x, c, temb):
        st = F.silu(temb)
        m = self.norm1["mod"](st)
        if self.dual:
            (sh, sc, g, sh2, sc2, g2,
             sh_a2, sc_a2, g_a2) = m.chunk(9, dim=-1)
            nx_a2 = modulate(x, sh_a2, sc_a2)
        else:
            sh, sc, g, sh2, sc2, g2 = m.chunk(6, dim=-1)
        nx = modulate(x, sh, sc)
        mc = self.norm1_context["mod"](st)
        if self.pre_only:
            csc, csh = mc.chunk(2, dim=-1)  # scale first
            nc = modulate(c, csh, csc)
        else:
            c_sh, c_sc, c_g, c_sh2, c_sc2, c_g2 = mc.chunk(6, dim=-1)
            nc = modulate(c, c_sh, c_sc)
        ax, ac = self.attn(nx, nc)
        x = x + g[:, None] * ax
        if self.dual:
            x = x + g_a2[:, None] * self.attn2(nx_a2)
        x = x + g2[:, None] * gelu_mlp(self.mlp, modulate(x, sh2, sc2))
        if self.pre_only:
            return x, None
        c = c + c_g[:, None] * ac
        c = c + c_g2[:, None] * gelu_mlp(self.mlp_context,
                                         modulate(c, c_sh2, c_sc2))
        return x, c


class MMDiT(nn.Module):
    def __init__(self, cfg: MMDiTConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h, p = cfg.hidden, cfg.patch_size
        self.cfg = cfg
        self.pos_embed = nn.ModuleDict({
            "proj": Linear(p * p * cfg.in_channels, h, **kw)})
        self.time_text_embed = nn.ModuleDict({
            "timestep_lin1": Linear(cfg.time_sinusoid_dim, h, **kw),
            "timestep_lin2": Linear(h, h, **kw),
            "text_lin1": Linear(cfg.pooled_projection_dim, h, **kw),
            "text_lin2": Linear(h, h, **kw),
        })
        self.context_embedder = Linear(cfg.joint_attention_dim, h, **kw)
        self.blocks = nn.ModuleList(
            JointBlock(cfg, i == cfg.num_layers - 1,
                       i in cfg.dual_attention_layers, **kw)
            for i in range(cfg.num_layers))
        self.norm_out = _mod(h, 2, **kw)
        self.proj_out = Linear(h, p * p * cfg.out_channels, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.proj_out.weight.dtype


def mmdit_forward(model: MMDiT, x: torch.Tensor, timesteps: torch.Tensor,
                  context: torch.Tensor, pooled: torch.Tensor,
                  skip_layers: Tuple[int, ...] = ()) -> torch.Tensor:
    """Velocity [B, h, w, out_channels] of an NHWC latent x (in the compute
    dtype) at timesteps [B] (sigma * 1000), with context [B, T, 4096] and
    pooled [B, 2048]. ``skip_layers`` omits those blocks (both streams
    pass through unchanged)."""
    cfg = model.cfg
    dtype = x.dtype
    b, h, w, _ = x.shape
    p = cfg.patch_size
    gh, gw = h // p, w // p
    xp = x.reshape(b, gh, p, gw, p, cfg.in_channels).permute(
        0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * cfg.in_channels)
    tokens = model.pos_embed["proj"](xp)
    tokens = tokens + _pos_tensor(cfg, gh, gw, x.device, dtype)[None]

    te = model.time_text_embed
    t_sin = timestep_embedding(timesteps, cfg.time_sinusoid_dim).to(dtype)
    temb = (te["timestep_lin2"](F.silu(te["timestep_lin1"](t_sin)))
            + te["text_lin2"](F.silu(te["text_lin1"](pooled.to(dtype)))))
    c = model.context_embedder(context.to(dtype))

    for i, blk in enumerate(model.blocks):
        if i in skip_layers:
            continue
        tokens, c = blk(tokens, c, temb)

    sc, sh = model.norm_out["mod"](F.silu(temb)).chunk(2, dim=-1)
    out = model.proj_out(modulate(tokens, sh, sc))
    out = out.reshape(b, gh, gw, p, p, cfg.out_channels)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, cfg.out_channels)
