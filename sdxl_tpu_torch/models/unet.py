"""SDXL diffusion UNet (counterpart of sdxl_tpu/models/unet.py).

The same config-driven block plan as the reference (``unet_block_plan``):
transformers at the configured levels, stride-2 conv downsample,
nearest-2x + 3x3 conv upsample, skip-cat U topology. ResBlock: GN -> SiLU
-> conv + time-embedding inject -> GN -> SiLU -> conv (+1x1 skip).
SpatialTransformer: GN -> flatten HW -> proj_in -> pre-LN blocks
(self-attention, cross-attention against the text context, GEGLU MLP) ->
proj_out + residual.

Two layouts of the self-attention projections, as in the reference:
inference fuses q/k/v into one [3C, C] ``qkv`` (``fuse_unet_qkv``);
training keeps separate ``q``/``k``/``v`` (``unfuse_unet_qkv``), the
linears LoRA factors target. Every linear is a ``layers.Linear`` with a
LoRA slot; cross-attention K/V are computed inline from the context, so
factors on ``attn2.k``/``attn2.v`` act there (``precompute_cross_kv`` is
for sampling, where the context is fixed).

The weight-free extensions of the reference's forward: FreeU's backbone
boost and skip filter at the two deepest decoder levels (``freeu``), PAG's
perturbed call with the middle block's self-attentions as the identity
map (``pag_mid``), DeepCache's full call that also returns the deep
feature and its shallow call that splices it back in
(``unet_forward_cached`` / ``unet_forward_shallow``), and an LCM-distilled
UNet's guidance addend to the timestep sinusoid (``t_add``, through the
bias-free ``time_embed.cond_proj`` when ``cfg.time_cond_proj_dim`` is
set).

Layout: ``unet_forward`` takes and returns NHWC latents [B, h, w, C] like
the reference; inside, activations are contiguous NCHW (PyTorch's default
conv layout) and transformer tokens are [B, HW, C]. Parameters and compute
are bf16 in the pipeline; norm statistics and softmax run in f32.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import UNetConfig
from ..ops.attention import qkv_attention
from ..ops.conv import upsample_nearest_2x
from ..ops.embeddings import timestep_embedding
from .layers import Conv2d, GroupNorm, LayerNorm, Linear


# ---------------------------------------------------------------------------
# Block plan (the reference's, unchanged)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BlockSpec:
    kind: str  # conv | res | down | res_t | res_t_up | res_up | res_t_res
    ch_in: int = 0
    ch_out: int = 0
    n_head: int = 0
    depth: int = 0


@functools.lru_cache(maxsize=None)
def unet_block_plan(cfg: UNetConfig) -> Tuple[Tuple[BlockSpec, ...], BlockSpec,
                                              Tuple[BlockSpec, ...]]:
    mc = cfg.model_channels
    mults = cfg.channel_mults
    n_levels = len(mults)
    t_levels = cfg.transformer_levels

    def heads(ch):
        return cfg.n_heads or ch // cfg.n_head_channels

    inputs: List[BlockSpec] = [BlockSpec("conv", cfg.in_channels, mc)]
    for level in range(n_levels):
        ch_in = mults[max(level - 1, 0)] * mc
        ch_out = mults[level] * mc
        if level not in t_levels:
            inputs.append(BlockSpec("res", ch_in, ch_out))
            inputs.append(BlockSpec("res", ch_out, ch_out))
        else:
            d = cfg.transformer_depths[level]
            inputs.append(BlockSpec("res_t", ch_in, ch_out, heads(ch_out), d))
            inputs.append(BlockSpec("res_t", ch_out, ch_out, heads(ch_out), d))
        if level != n_levels - 1:
            inputs.append(BlockSpec("down", ch_out, ch_out))

    ch_mid = mults[-1] * mc
    middle = BlockSpec("res_t_res", ch_mid, ch_mid, heads(ch_mid),
                       cfg.transformer_depths[-1])

    outputs: List[BlockSpec] = []
    for level in reversed(range(n_levels)):
        next_level = level + 1 if level != n_levels - 1 else level
        ch_out = mults[level] * mc
        ch_in1 = mults[next_level] * mc + ch_out
        ch_in2 = 2 * ch_out
        ch_in3 = ch_out + mults[max(level - 1, 0)] * mc
        if level not in t_levels:
            outputs.append(BlockSpec("res", ch_in1, ch_out))
            outputs.append(BlockSpec("res", ch_in2, ch_out))
            outputs.append(BlockSpec("res_up" if level != 0 else "res",
                                     ch_in3, ch_out))
        else:
            d = cfg.transformer_depths[level]
            h = heads(ch_out)
            outputs.append(BlockSpec("res_t", ch_in1, ch_out, h, d))
            outputs.append(BlockSpec("res_t", ch_in2, ch_out, h, d))
            outputs.append(BlockSpec("res_t_up" if level != 0 else "res_t",
                                     ch_in3, ch_out, h, d))

    return tuple(inputs), middle, tuple(outputs)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class ResBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, emb_dim: int, **kw):
        super().__init__()
        self.norm_in = GroupNorm(c_in, **kw)
        self.conv_in = Conv2d(c_in, c_out, 3, **kw)
        self.lin_embed = Linear(emb_dim, c_out, **kw)
        self.norm_out = GroupNorm(c_out, **kw)
        self.conv_out = Conv2d(c_out, c_out, 3, **kw)
        self.skip = Conv2d(c_in, c_out, 1, **kw) if c_in != c_out else None

    def forward(self, x, emb):
        h = self.conv_in(F.silu(self.norm_in(x)))
        h = h + self.lin_embed(F.silu(emb)).to(h.dtype)[:, :, None, None]
        h = self.conv_out(F.silu(self.norm_out(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class SelfAttention(nn.Module):
    """Self-attention: a fused [3C, C] ``qkv`` projection (inference), or
    separate ``q``/``k``/``v`` after ``unfuse_unet_qkv`` (training)."""

    def __init__(self, c: int, **kw):
        super().__init__()
        self.qkv = Linear(c, 3 * c, bias=False, **kw)
        self.out = Linear(c, c, **kw)

    def forward(self, x, n_head, identity: bool = False):
        """identity: PAG's perturbed self-attention (Ahn et al. 2024,
        arXiv:2403.17377), the softmax map replaced by the identity, so
        the output is the out projection of v (no attention kernel)."""
        if hasattr(self, "qkv"):
            q, k, v = self.qkv(x).chunk(3, dim=-1)
        else:
            q, k, v = (None, None, self.v(x)) if identity else (
                self.q(x), self.k(x), self.v(x))
        if identity:
            return self.out(v)
        return self.out(qkv_attention(q, k, v, None, n_head))


class CrossAttention(nn.Module):
    def __init__(self, c: int, ctx_dim: int, **kw):
        super().__init__()
        self.q = Linear(c, c, bias=False, **kw)
        self.k = Linear(ctx_dim, c, bias=False, **kw)
        self.v = Linear(ctx_dim, c, bias=False, **kw)
        self.out = Linear(c, c, **kw)

    def forward(self, x, context, n_head, kv=None):
        """kv: optional precomputed {"k", "v"} of a loop-invariant context
        (precompute_cross_kv)."""
        if kv is None:
            kv = {"k": self.k(context), "v": self.v(context)}
        return self.out(qkv_attention(self.q(x), kv["k"], kv["v"], None,
                                      n_head))


class GEGLU(nn.Module):
    def __init__(self, c: int, **kw):
        super().__init__()
        self.proj = Linear(c, 8 * c, **kw)
        self.lin = Linear(4 * c, c, **kw)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return self.lin(a * F.gelu(gate))


class TransformerBlock(nn.Module):
    def __init__(self, c: int, ctx_dim: int, **kw):
        super().__init__()
        self.norm1 = LayerNorm(c, **kw)
        self.attn1 = SelfAttention(c, **kw)
        self.norm2 = LayerNorm(c, **kw)
        self.attn2 = CrossAttention(c, ctx_dim, **kw)
        self.norm3 = LayerNorm(c, **kw)
        self.mlp = GEGLU(c, **kw)

    def forward(self, x, context, n_head, kv=None, identity_self=False):
        x = x + self.attn1(self.norm1(x), n_head, identity_self)
        x = x + self.attn2(self.norm2(x), context, n_head, kv)
        return x + self.mlp(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, c: int, ctx_dim: int, depth: int, n_head: int, **kw):
        super().__init__()
        self.n_head = n_head
        self.norm = GroupNorm(c, **kw)
        self.proj_in = Linear(c, c, **kw)
        self.blocks = nn.ModuleList(TransformerBlock(c, ctx_dim, **kw)
                                    for _ in range(depth))
        self.proj_out = Linear(c, c, **kw)

    def forward(self, x, context, kv=None, identity_self=False):
        b, c, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.proj_in(y)
        for i, block in enumerate(self.blocks):
            y = block(y, context, self.n_head, None if kv is None else kv[i],
                      identity_self)
        y = self.proj_out(y).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + y


class UNetBlock(nn.Module):
    """One entry of the block plan; submodules named as in the reference's
    parameter tree (conv / res / transformer / upsample)."""

    def __init__(self, spec: BlockSpec, cfg: UNetConfig, **kw):
        super().__init__()
        self.kind = spec.kind
        if spec.kind in ("conv", "down"):
            self.conv = Conv2d(spec.ch_in, spec.ch_out, 3,
                               stride=2 if spec.kind == "down" else 1, **kw)
            return
        self.res = ResBlock(spec.ch_in, spec.ch_out, cfg.time_embed_dim, **kw)
        if spec.kind in ("res_t", "res_t_up"):
            self.transformer = SpatialTransformer(
                spec.ch_out, cfg.context_dim, spec.depth, spec.n_head, **kw)
        if spec.kind in ("res_up", "res_t_up"):
            self.upsample = Conv2d(spec.ch_out, spec.ch_out, 3, **kw)

    def forward(self, x, emb, context, kv=None):
        if self.kind in ("conv", "down"):
            return self.conv(x)
        x = self.res(x, emb)
        if self.kind in ("res_t", "res_t_up"):
            x = self.transformer(x, context, kv)
        if self.kind in ("res_up", "res_t_up"):
            x = self.upsample(upsample_nearest_2x(x))
        return x


def _mlp2(c_in: int, c_out: int, **kw) -> nn.ModuleDict:
    return nn.ModuleDict({"lin1": Linear(c_in, c_out, **kw),
                          "lin2": Linear(c_out, c_out, **kw)})


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        in_plan, mid_spec, out_plan = unet_block_plan(cfg)
        emb_dim = cfg.time_embed_dim
        self.time_embed = _mlp2(cfg.model_channels, emb_dim, **kw)
        if cfg.time_cond_proj_dim:
            # LCM-distilled UNets: the guidance embedding's projection
            self.time_embed["cond_proj"] = Linear(
                cfg.time_cond_proj_dim, cfg.model_channels, bias=False, **kw)
        self.label_embed = (_mlp2(cfg.adm_in_channels, emb_dim, **kw)
                            if cfg.adm_in_channels else None)
        self.input_blocks = nn.ModuleList(UNetBlock(s, cfg, **kw)
                                          for s in in_plan)
        c = mid_spec.ch_out
        self.middle_block = nn.ModuleDict({
            "res1": ResBlock(c, c, emb_dim, **kw),
            "transformer": SpatialTransformer(c, cfg.context_dim,
                                              mid_spec.depth, mid_spec.n_head,
                                              **kw),
            "res2": ResBlock(c, c, emb_dim, **kw),
        })
        self.norm_out = GroupNorm(cfg.model_channels, **kw)
        self.conv_out = Conv2d(cfg.model_channels, cfg.out_channels, 3, **kw)
        self.output_blocks = nn.ModuleList(UNetBlock(s, cfg, **kw)
                                           for s in out_plan)

    def forward(self, x, timesteps, context, label, cross_kv=None):
        return unet_forward(self, x, timesteps, context, label, cross_kv)


def _unet_embed(model: UNet, timesteps, label, dtype, t_add=None):
    """The timestep (+ label) embedding. t_add [1 or B, model_channels]:
    an LCM-distilled UNet's projected guidance embedding, added to the
    sinusoid after its cast to ``dtype`` and before ``lin1`` (diffusers'
    TimestepEmbedding cond_proj slot)."""
    te = model.time_embed
    t_emb = timestep_embedding(timesteps, model.cfg.model_channels).to(dtype)
    if t_add is not None:
        t_emb = t_emb + t_add.to(dtype)
    emb = te["lin2"](F.silu(te["lin1"](t_emb)))
    if model.label_embed is not None:
        le = model.label_embed
        emb = emb + le["lin2"](F.silu(le["lin1"](label.to(dtype))))
    return emb


def freeu_fourier_filter(x: torch.Tensor, threshold: int,
                         scale: float) -> torch.Tensor:
    """FreeU's fourier_filter (the official code, diffusers'
    fourier_filter) over NCHW: an f32 complex FFT over the two spatial
    axes, the centred 2*threshold-wide low-frequency box scaled by
    ``scale``, the inverse FFT's real part cast back to x's dtype."""
    h, w = x.shape[-2:]
    dims = (-2, -1)
    xf = torch.fft.fftshift(torch.fft.fft2(x.float(), dim=dims), dim=dims)
    row = torch.arange(h, device=x.device)
    col = torch.arange(w, device=x.device)
    in_row = (row >= h // 2 - threshold) & (row < h // 2 + threshold)
    in_col = (col >= w // 2 - threshold) & (col < w // 2 + threshold)
    mask = torch.where(in_row[:, None] & in_col[None, :],
                       torch.tensor(float(scale), device=x.device),
                       torch.tensor(1.0, device=x.device))
    out = torch.fft.ifft2(torch.fft.ifftshift(xf * mask, dim=dims),
                          dim=dims).real
    return out.to(x.dtype)


def _input_blocks(model: UNet, x, emb, context, in_kv, n=None):
    """NHWC latent -> (NCHW activation, each input block's output) of the
    first n input blocks (all of them by default)."""
    x = x.permute(0, 3, 1, 2).contiguous()
    saved = []
    for i, block in enumerate(model.input_blocks[:n]):
        x = block(x, emb, context, in_kv.get(i))
        saved.append(x)
    return x, saved


def _output_block(model: UNet, i: int, x, skip, emb, context, out_kv,
                  freeu):
    """Output block i on cat(x, skip). FreeU (arXiv:2309.11497; diffusers
    apply_freeu) at the two deepest decoder levels (three skip-cats a
    level: level i // 3): the backbone's first half of the channels times
    b, the skip's low spatial frequencies times s."""
    if freeu is not None and i // 3 <= 1:
        b1, b2, s1, s2 = freeu
        b, s = (b1, s1) if i // 3 == 0 else (b2, s2)
        half = x.shape[1] // 2
        x = torch.cat([x[:, :half] * b, x[:, half:]], dim=1)
        skip = freeu_fourier_filter(skip, 1, s)
    return model.output_blocks[i](torch.cat([x, skip], dim=1), emb, context,
                                  out_kv.get(i))


def _head(model: UNet, x) -> torch.Tensor:
    return model.conv_out(F.silu(model.norm_out(x))).permute(0, 2, 3, 1)


def _check_branch(model: UNet, branch: int) -> int:
    n_out = len(model.output_blocks)
    if not 1 <= branch <= n_out - 1:
        raise ValueError(f"deepcache branch must be in [1, {n_out - 1}]")
    return n_out


def unet_forward(model: UNet, x: torch.Tensor, timesteps: torch.Tensor,
                 context: torch.Tensor, label: Optional[torch.Tensor],
                 cross_kv=None, t_add=None, pag_mid: bool = False,
                 freeu=None, cache_branch: Optional[int] = None):
    """x: [B, h, w, C_in] NHWC latent -> [B, h, w, C_out] NHWC.

    cross_kv: optional precompute_cross_kv() output (the context is fixed
    for a whole sampling run, so every cross-attention K/V is too).
    t_add: see _unet_embed. pag_mid: the middle block's self-attentions
    as identity maps (PAG's perturbed call; diffusers' "mid" layers).
    freeu: (b1, b2, s1, s2) or None (the sampler passes its
    DiffuserConfig's). cache_branch: also return DeepCache's feature
    (arXiv:2312.00858), as (output, feature): the NCHW input of output
    block n_out - cache_branch before its skip-cat (and before FreeU),
    the deep U a shallow step reuses (unet_forward_shallow)."""
    n_out = len(model.output_blocks)
    if cache_branch is not None:
        _check_branch(model, cache_branch)
    emb = _unet_embed(model, timesteps, label, x.dtype, t_add)
    ckv = cross_kv or {}
    out_kv = ckv.get("output_blocks", {})
    x, saved = _input_blocks(model, x, emb, context,
                             ckv.get("input_blocks", {}))
    mid = model.middle_block
    x = mid["res1"](x, emb)
    x = mid["transformer"](x, context, ckv.get("middle_block"), pag_mid)
    x = mid["res2"](x, emb)
    cache = None
    for i in range(n_out):
        if cache_branch is not None and i == n_out - cache_branch:
            cache = x
        x = _output_block(model, i, x, saved.pop(), emb, context, out_kv,
                          freeu)
    out = _head(model, x)
    return out if cache_branch is None else (out, cache)


def unet_forward_cached(model: UNet, x, timesteps, context, label,
                        cross_kv=None, branch: int = 3, freeu=None):
    """The reference's name for unet_forward(cache_branch=branch):
    (output, DeepCache's feature). ``branch`` counts the input blocks a
    shallow step recomputes; output block n_out - branch consumes skip
    branch - 1."""
    return unet_forward(model, x, timesteps, context, label, cross_kv,
                        freeu=freeu, cache_branch=branch)


def unet_forward_shallow(model: UNet, x, timesteps, context, label, cache,
                         cross_kv=None, branch: int = 3, freeu=None):
    """DeepCache's shallow call: the first ``branch`` input blocks (fresh
    skips) and the last ``branch`` output blocks, with ``cache`` (from
    unet_forward_cached) in place of the deep U."""
    n_out = _check_branch(model, branch)
    emb = _unet_embed(model, timesteps, label, x.dtype)
    ckv = cross_kv or {}
    out_kv = ckv.get("output_blocks", {})
    _, saved = _input_blocks(model, x, emb, context,
                             ckv.get("input_blocks", {}), branch)
    x = cache
    for i in range(n_out - branch, n_out):
        x = _output_block(model, i, x, saved.pop(), emb, context, out_kv,
                          freeu)
    return _head(model, x)


def precompute_cross_kv(model: UNet, context: torch.Tensor):
    """Cross-attention K/V of a fixed context for every transformer block:
    {"input_blocks": {i: [{"k", "v"}] * depth}, "middle_block": [...],
    "output_blocks": {i: [...]}} (the reference's layout)."""

    def st_kv(st: SpatialTransformer):
        return [{"k": blk.attn2.k(context), "v": blk.attn2.v(context)}
                for blk in st.blocks]

    def blocks_kv(blocks):
        return {i: st_kv(b.transformer) for i, b in enumerate(blocks)
                if hasattr(b, "transformer")}

    return {
        "input_blocks": blocks_kv(model.input_blocks),
        "middle_block": st_kv(model.middle_block["transformer"]),
        "output_blocks": blocks_kv(model.output_blocks),
    }


@torch.no_grad()
def unfuse_unet_qkv(model: UNet) -> UNet:
    """Split every fused self-attention ``qkv`` [3C, C] into separate
    q/k/v linears, in place (the reference's ``unfuse_unet_qkv``: row
    blocks of the weight are independent, so the split is exact). The
    training layout: LoRA targets the unfused projections. Idempotent."""
    for m in model.modules():
        if isinstance(m, SelfAttention) and hasattr(m, "qkv"):
            w = m.qkv.weight
            c = w.shape[1]
            for name, part in zip("qkv", w.split(c, dim=0)):
                lin = Linear(c, c, bias=False, device=w.device, dtype=w.dtype)
                lin.weight.copy_(part)
                lin.requires_grad_(w.requires_grad)
                setattr(m, name, lin)
            del m.qkv
    return model
