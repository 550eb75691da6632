"""2D convolutions in NCHW with OIHW weights (counterpart of sdxl_tpu/ops/conv.py).

The reference runs NHWC/HWIO and folds each UNet upsample conv into four
2x2 phase kernels (a TPU layout trick); the port loads the plain 3x3
kernel (io/bridge.py unfolds it) and runs nearest-2x followed by the conv.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 1) -> torch.Tensor:
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def conv1x1(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1x1 convolution, w [C_out, C_in, 1, 1]."""
    return F.conv2d(x, w, b)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of [B, C, H, W]."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
