"""Multi-head attention core (counterpart of sdxl_tpu/ops/attention.py).

q, k, v arrive as [B, T, C], are split into heads and re-merged. Long
unmasked self-attention (``use_flash``) goes to the flash-attention kernel
(ops/flash_attention.py); the rest (77-token cross-attention, masked CLIP
attention) runs the plain math the reference leaves to XLA: q scaled in
its own dtype, f32 logits, f32 softmax, weights cast to v's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention_bhtd, use_flash


def causal_mask(seq_len: int, device=None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Additive mask: 0 on and below the diagonal, -inf above."""
    i = torch.arange(seq_len, device=device)
    m = torch.zeros((seq_len, seq_len), dtype=dtype, device=device)
    return m.masked_fill(i[None, :] > i[:, None], float("-inf"))


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, c = x.shape
    return x.reshape(b, t, n_head, c // n_head).transpose(1, 2)


def qkv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  n_head: int = 1) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(d) + mask) v over heads; [B, T, C] in and out."""
    b, tq, c = q.shape
    tk = k.shape[1]
    d = c // n_head
    qh, kh, vh = (_split_heads(x, n_head) for x in (q, k, v))
    if use_flash(tq, tk, d, mask is not None):
        o = flash_attention_bhtd(qh.contiguous(), kh.contiguous(),
                                 vh.contiguous())
    else:
        logits = (qh * d ** -0.5).float() @ kh.float().transpose(-1, -2)
        if mask is not None:
            logits = logits + mask[:tq, :tk]
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        o = w @ vh
    return o.transpose(1, 2).reshape(b, tq, c)
