"""Linear layers (counterpart of sdxl_tpu/ops/linear.py).

Weights are PyTorch's [d_out, d_in]; io/bridge.py transposes the
reference's [d_in, d_out] once at load. A weight stored quantized goes
through K4 instead (ops/quant.py ``quant_linear``, models/layers.py
``QuantLinear``).

``lora`` is an optional UNMERGED LoRA factor pair (down [d_in, r],
up [r, d_out], the reference's orientation), applied at the use site as
``y += (x @ down) @ up`` with the factors cast to x's dtype, so the base
weight stays frozen and gradients flow only into the factors (the
training path; train/lora.py installs the pairs).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

LoRA = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _lora(x: torch.Tensor, y: torch.Tensor, lora: LoRA) -> torch.Tensor:
    if lora is None:
        return y
    down, up = lora
    return y + ((x @ down.to(x.dtype)) @ up.to(x.dtype)).to(y.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           lora: LoRA = None) -> torch.Tensor:
    return _lora(x, F.linear(x, w, b), lora)


def linear_nobias(x: torch.Tensor, w: torch.Tensor,
                  lora: LoRA = None) -> torch.Tensor:
    return _lora(x, F.linear(x, w), lora)
