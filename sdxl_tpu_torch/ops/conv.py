"""2D convolutions in NCHW with OIHW weights (counterpart of sdxl_tpu/ops/conv.py).

The reference runs NHWC/HWIO and folds each UNet upsample conv into four
2x2 phase kernels (a TPU layout trick); the port loads the plain 3x3
kernel (io/bridge.py unfolds it) and runs nearest-2x followed by the conv.
``conv2d_pad_br`` is the VAE encoder's stride-2 downsample with PyTorch's
(0, 1, 0, 1) padding: one zero row below and one zero column right
(the reference's ((0, 1), (0, 1))).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 1) -> torch.Tensor:
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def conv2d_pad_br(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None,
                  stride: int = 2) -> torch.Tensor:
    """Conv after zero-padding one row at the bottom and one column at the
    right only (models/vae.py's encoder downsample)."""
    return F.conv2d(F.pad(x, (0, 1, 0, 1)), w, b, stride=stride)


def conv1x1(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1x1 convolution, w [C_out, C_in, 1, 1]."""
    return F.conv2d(x, w, b)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of [B, C, H, W]."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
