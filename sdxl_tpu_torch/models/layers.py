"""nn.Module shells over the port's ops, shared by the models.

Each holds its parameters under PyTorch's usual names (``weight``,
``bias``) so io/bridge.py can map the reference's parameter trees onto
``state_dict`` keys, and its forward calls the plain op in ops/.
``Linear`` also carries a slot for an unmerged LoRA factor pair;
``QuantLinear`` is its weight-quantized form (io/quantize.py puts it in a
Linear's place), applied through K4 (ops/quant.py). ``init_reference_``
redraws every parameter with the reference's random init (normal weights
at a fixed scale, zero biases, unit norm gains, the RMS gains of
``RMSGain`` too).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.conv import conv2d
from ..ops.linear import LoRA, _lora, linear
from ..ops.norms import groupnorm, layernorm_affine
from ..ops.quant import INT4_GROUP, quant_linear


class Linear(nn.Linear):
    """nn.Linear through ops.linear. ``lora`` is None or an unmerged
    (down [d_in, r], up [r, d_out]) factor pair added at the use site;
    train/lora.py sets it. It is a plain attribute, not a parameter, so it
    is not in the state_dict and the base weight stays frozen."""

    lora: LoRA = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self.lora)


class QuantLinear(nn.Module):
    """A linear whose weight is stored quantized (ops/quant.py): buffers
    ``qw`` int8 [d_out, d_in] and ``qs`` f32 [d_out] (bits 8), or ``qw4``
    uint8 [d_out, d_in/2] and ``qs`` f32 [d_out, d_in/group] (bits 4), and
    ``bias`` [d_out] in the model's dtype or None. Its forward is K4. The
    ``lora`` slot is kept, but no gradient flows through K4: QLoRA
    training is module 15."""

    lora: LoRA = None

    def __init__(self, d_in: int, d_out: int, bits: int, bias: bool = True,
                 group: int = INT4_GROUP, device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features, self.bits = d_in, d_out, bits
        if bits == 8:
            self.register_buffer("qw", torch.empty(
                d_out, d_in, dtype=torch.int8, device=device))
            self.register_buffer("qs", torch.empty(
                d_out, dtype=torch.float32, device=device))
        elif bits == 4:
            self.register_buffer("qw4", torch.empty(
                d_out, d_in // 2, dtype=torch.uint8, device=device))
            self.register_buffer("qs", torch.empty(
                d_out, d_in // group, dtype=torch.float32, device=device))
        else:
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        self.bias = (nn.Parameter(torch.zeros(d_out, device=device,
                                              dtype=dtype))
                     if bias else None)

    @property
    def quantized(self) -> dict:
        """The weight dict ops/quant.py takes: {"qw" | "qw4", "qs"}."""
        key = "qw" if self.bits == 8 else "qw4"
        return {key: getattr(self, key), "qs": self.qs}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lora = self.lora
        if torch.is_grad_enabled() and (
                x.requires_grad or (lora is not None and any(
                    t.requires_grad for t in lora))):
            raise NotImplementedError(
                "no gradient flows through the quantized linear: QLoRA "
                "(LoRA training over a quantized model) is module 15")
        return _lora(x, quant_linear(x, self.quantized, self.bias), lora)


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
