"""Multi-head attention core (counterpart of sdxl_tpu/ops/attention.py).

q, k, v arrive as [B, T, C], are split into heads and re-merged. Long
unmasked self-attention (``use_flash``) goes to the flash-attention kernels
(ops/flash_attention.py); the rest (77-token cross-attention, masked CLIP
attention) runs the plain math the reference leaves to XLA: q scaled in
its own dtype, f32 logits, f32 softmax, weights cast to v's dtype.

Under autograd the flash route is ``FlashSDPA``, the counterpart of the
reference's ``_flash_sdpa`` custom VJP: its forward runs K2 and keeps
(q, k, v, o, lse), its backward runs K3a/K3b. Heads wider than 128 run K1
forward and differentiate the plain math backward, as the reference does.
Grad-free calls (sampling, VAE encode and decode) run K1.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import (
    flash_attention_bhtd,
    flash_attention_bwd,
    flash_attention_lse,
    use_flash,
)


def causal_mask(seq_len: int, device=None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Additive mask: 0 on and below the diagonal, -inf above."""
    i = torch.arange(seq_len, device=device)
    m = torch.zeros((seq_len, seq_len), dtype=dtype, device=device)
    return m.masked_fill(i[None, :] > i[:, None], float("-inf"))


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, c = x.shape
    return x.reshape(b, t, n_head, c // n_head).transpose(1, 2)


def _plain_sdpa_bhtd(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's plain attention over [B, H, T, D]: q scaled in its
    dtype, f32 logits (+ mask) and softmax, weights cast to v's dtype.
    Unmasked, it is the math the flash kernels compute, and the wide-head
    flash backward differentiates it (``_xla_sdpa_bhtd``)."""
    tq, tk = qh.shape[2], kh.shape[2]
    logits = (qh * qh.shape[-1] ** -0.5).float() @ kh.float().transpose(-1, -2)
    if mask is not None:
        logits = logits + mask[:tq, :tk]
    w = torch.softmax(logits, dim=-1).to(vh.dtype)
    return w @ vh


class FlashSDPA(torch.autograd.Function):
    """Flash attention over [B, H, T, D] with the flash backward."""

    @staticmethod
    def forward(ctx, qh, kh, vh):
        if qh.shape[-1] <= 128:
            o, lse = flash_attention_lse(qh, kh, vh)
            ctx.save_for_backward(qh, kh, vh, o, lse)
        else:
            o = flash_attention_bhtd(qh, kh, vh)
            ctx.save_for_backward(qh, kh, vh)
        return o

    @staticmethod
    def backward(ctx, do):
        saved = ctx.saved_tensors
        if len(saved) == 5:
            return flash_attention_bwd(*saved, do)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in saved]
            o = _plain_sdpa_bhtd(*leaves)
        return torch.autograd.grad(o, leaves, do)


def qkv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  n_head: int = 1) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(d) + mask) v over heads; [B, T, C] in and out."""
    b, tq, c = q.shape
    tk = k.shape[1]
    d = c // n_head
    qh, kh, vh = (_split_heads(x, n_head) for x in (q, k, v))
    if use_flash(tq, tk, d, mask is not None):
        qh, kh, vh = qh.contiguous(), kh.contiguous(), vh.contiguous()
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (qh, kh, vh)):
            o = FlashSDPA.apply(qh, kh, vh)
        else:
            o = flash_attention_bhtd(qh, kh, vh)
    else:
        o = _plain_sdpa_bhtd(qh, kh, vh, mask)
    return o.transpose(1, 2).reshape(b, tq, c)
