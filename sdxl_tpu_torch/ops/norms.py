"""Normalisation ops (counterpart of sdxl_tpu/ops/norms.py).

Biased variance with eps inside the sqrt, statistics always in float32
whatever the activation dtype (the bf16 UNet); the normalised value is cast
back to the input dtype before the affine, as in the reference.

``groupnorm`` takes channels on axis 1 ([B, C, *spatial], NCHW), the
PyTorch layout the port's models run in.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Unscaled layernorm over the last axis."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


def layernorm_affine(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    return layernorm(x, eps) * gamma + beta


def groupnorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              n_group: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over [B, C, *spatial]: per (batch, group) statistics over
    the group's channels and all spatial positions."""
    y = F.group_norm(x.float(), n_group, eps=eps).to(x.dtype)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return y * gamma.view(shape) + beta.view(shape)
