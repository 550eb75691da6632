"""nn.Module shells over the port's ops, shared by the models.

Each holds its parameters under PyTorch's usual names (``weight``,
``bias``) so io/bridge.py can map the reference's parameter trees onto
``state_dict`` keys, and its forward calls the plain op in ops/.
``Linear`` also carries a slot for an unmerged LoRA factor pair.
``init_reference_`` redraws every parameter with the reference's random
init (normal weights at a fixed scale, zero biases, unit norm gains, the
RMS gains of ``RMSGain`` too).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.conv import conv2d
from ..ops.linear import LoRA, linear
from ..ops.norms import groupnorm, layernorm_affine


class Linear(nn.Linear):
    """nn.Linear through ops.linear. ``lora`` is None or an unmerged
    (down [d_in, r], up [r, d_out]) factor pair added at the use site;
    train/lora.py sets it. It is a plain attribute, not a parameter, so it
    is not in the state_dict and the base weight stays frozen."""

    lora: LoRA = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self.lora)


class Conv2d(nn.Conv2d):
    """Square-kernel conv with symmetric padding of (kernel - 1) // 2."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3,
                 stride: int = 1, **kw):
        super().__init__(c_in, c_out, kernel, stride=stride,
                         padding=(kernel - 1) // 2, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.stride[0],
                      self.padding[0])


class GroupNorm(nn.Module):
    def __init__(self, c: int, n_group: int = 32, eps: float = 1e-5,
                 device=None, dtype=None):
        super().__init__()
        self.n_group, self.eps = n_group, eps
        self.weight = nn.Parameter(torch.ones(c, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(c, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return groupnorm(x, self.weight, self.bias, self.n_group, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, c: int, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(c, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm_affine(x, self.weight, self.bias, self.eps)


class RMSGain(nn.Module):
    """The learned gain of a per-head RMS norm (SD3.5's and FLUX.1's q/k
    norms): the reference's ``{"w": [head_dim]}``, applied by the model."""

    def __init__(self, c: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device, dtype=dtype))


@torch.no_grad()
def init_reference_(model: nn.Module, generator: torch.Generator,
                    conv_scale: float = 0.02) -> nn.Module:
    """The reference's init (models/{clip,unet,vae}.py init_*): conv
    weights ~ N(0, conv_scale^2), every other weight (linears, embeddings,
    projections) ~ N(0, 0.02^2), biases 0, norm gains 1 and shifts 0."""
    for module in model.modules():
        if isinstance(module, (GroupNorm, LayerNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
            continue
        if isinstance(module, RMSGain):
            module.weight.fill_(1.0)
            continue
        scale = conv_scale if isinstance(module, nn.Conv2d) else 0.02
        for name, p in module.named_parameters(recurse=False):
            if name == "bias":
                p.zero_()
            else:
                p.normal_(0.0, scale, generator=generator)
    return model
