"""Linear layers (counterpart of sdxl_tpu/ops/linear.py).

Weights are PyTorch's [d_out, d_in]; io/bridge.py transposes the
reference's [d_in, d_out] once at load. Quantised weights and runtime LoRA
are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    return F.linear(x, w, b)


def linear_nobias(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return F.linear(x, w)
