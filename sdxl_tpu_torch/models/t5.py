"""T5 v1.1 encoder: SD3's third text tower and FLUX.1's token stream
(counterpart of sdxl_tpu/models/t5.py).

- RMS layer norm: no mean subtraction, the variance in f32, the normed
  value cast back to the activation dtype before the learned gain;
- self-attention WITHOUT the 1/sqrt(d) scale, plus a learned relative
  position bias: bucketed relative positions (32 buckets, max distance
  128, bidirectional), embedded per head by block 0 and shared by every
  layer. The bias is additive, so the attention stays plain PyTorch math,
  as XLA runs it in the reference: logits in the activation dtype, then
  f32 with the bias, f32 softmax, weights cast back;
- gated FFN: wo(gelu_tanh(wi_0(x)) * wi_1(x)); no biases anywhere;
- a final RMS norm.

Parameter names mirror the reference's tree: ``embed``,
``relative_attention_bias`` [buckets, heads], ``blocks.{i}.ln1``,
``.attn.{q,k,v,o}``, ``.ln2``, ``.ffn.{wi_0,wi_1,wo}``, ``final_ln``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import T5Config


def t5_layernorm(x: torch.Tensor, w: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


@functools.lru_cache(maxsize=8)
def _relative_buckets(n_tokens: int, num_buckets: int,
                      max_distance: int) -> np.ndarray:
    """[T, T] int32 bucket ids (transformers' _relative_position_bucket,
    bidirectional)."""
    ctx = np.arange(n_tokens)[:, None]
    mem = np.arange(n_tokens)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    ret = (rel > 0).astype(np.int64) * nb
    n = np.abs(rel)
    max_exact = nb // 2
    is_small = n < max_exact
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    ret = ret + np.where(is_small, n, large)
    return ret.astype(np.int32)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, **kw):
        super().__init__()
        inner = cfg.n_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False, **kw)
        self.k = nn.Linear(cfg.d_model, inner, bias=False, **kw)
        self.v = nn.Linear(cfg.d_model, inner, bias=False, **kw)
        self.o = nn.Linear(inner, cfg.d_model, bias=False, **kw)
        self.n_heads, self.d_kv = cfg.n_heads, cfg.d_kv

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape

        def heads(y):
            return y.reshape(b, t, self.n_heads, self.d_kv).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        logits = (q @ k.transpose(-1, -2)).float() + bias.float()
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        att = (w @ v).transpose(1, 2).reshape(b, t, -1)
        return self.o(att)


class T5FFN(nn.Module):
    def __init__(self, cfg: T5Config, **kw):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **kw)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **kw)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = F.gelu(self.wi_0(x), approximate="tanh")
        return self.wo(gate * self.wi_1(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, **kw):
        super().__init__()
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, **kw))
        self.attn = T5Attention(cfg, **kw)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, **kw))
        self.ffn = T5FFN(cfg, **kw)


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              **kw))
        self.relative_attention_bias = nn.Parameter(
            torch.empty(cfg.relative_buckets, cfg.n_heads, **kw))
        self.blocks = nn.ModuleList(T5Block(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.final_ln = nn.Parameter(torch.ones(cfg.d_model, **kw))

    def position_bias(self, n_tokens: int) -> torch.Tensor:
        """[1, heads, T, T] bias from block 0's relative_attention_bias."""
        buckets = torch.as_tensor(
            _relative_buckets(n_tokens, self.cfg.relative_buckets,
                              self.cfg.relative_max_distance),
            dtype=torch.long, device=self.embed.device)
        return self.relative_attention_bias[buckets].permute(2, 0, 1)[None]


def t5_encode(model: T5Encoder, tokens: torch.Tensor) -> torch.Tensor:
    """[B, T] token ids -> [B, T, d_model] final hidden states."""
    x = model.embed[tokens]
    bias = model.position_bias(tokens.shape[1]).to(x.dtype)
    for blk in model.blocks:
        x = x + blk.attn(t5_layernorm(x, blk.ln1), bias)
        x = x + blk.ffn(t5_layernorm(x, blk.ln2))
    return t5_layernorm(x, model.final_ln)


@torch.no_grad()
def init_t5_(model: T5Encoder, generator: torch.Generator) -> T5Encoder:
    """The reference's init (init_t5): every matrix ~ N(0, 0.02^2), the RMS
    gains 1."""
    for name, p in model.named_parameters():
        if name.rpartition(".")[2] in ("ln1", "ln2", "final_ln"):
            p.fill_(1.0)
        else:
            p.normal_(0.0, 0.02, generator=generator)
    return model
