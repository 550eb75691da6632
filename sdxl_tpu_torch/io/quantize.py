"""Quantize a model's block linears in place for low-memory deployment
(counterpart of sdxl_tpu/io/quantize.py).

``quantize_model`` walks ``named_modules()`` and puts a ``QuantLinear``
(models/layers.py; its forward is K4, ops/quant.py) in the place of each
eligible linear, by the reference's rules, read on the module paths,
which mirror the reference's tree paths:

- only linears (``nn.Linear``, ``layers.Linear``) whose weight has
  min(shape) >= min_dim (default 1024) — norms, biases and small
  projections stay full precision;
- only under a path segment in ``within`` (the block lists: "blocks" /
  "single_blocks" for FLUX.1, the MMDiT and T5; ``UNET_WITHIN`` for the
  UNets) — embedders and heads outside the block stacks stay;
- a linear whose own name is in ``keep8`` (modulation ``mod``, and the
  UNets' ``lin_embed``) stays int8 in int4 mode;
- int4 with a d_in that is odd or whose half ``group`` does not divide
  falls back to int8.

Each full-precision weight is freed as its replacement is made, so the
peak is the model plus one linear. Given a target ``device``, each
eligible weight is staged there alone and quantized there, so that a
model built on the host reaches the card quantized: the card holds one
full-precision linear at a time (the loaders of the transformer
families load this way, as the reference's ``host=True`` loads do).
``quantized_bytes`` gives a model's bytes after quantization without
quantizing it. On a meta-device model the walk gives
the quantized layout alone; ``random_quantized_like`` materialises that
with random quantized weights, never allocating the eligible linears'
full-precision ones.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..models.layers import QuantLinear
from ..ops.quant import INT4_GROUP, quantize_weight
from ..utils import log
from ..utils.memory import param_bytes

# path segments under which linears are quantized, by model family
DEFAULT_WITHIN = ("blocks", "single_blocks")
# linear names kept at >= 8 bits even when int4 is requested
DEFAULT_KEEP8 = ("mod",)
# the UNet families (SDXL, SD 1.x / 2.x): the block stacks' linears, with
# the per-resblock timestep projection clamped to int8 like "mod"
UNET_WITHIN = ("input_blocks", "middle_block", "output_blocks")
UNET_KEEP8 = ("mod", "lin_embed")

# the reference's defaults (its SDXL_TPU_QUANT_MIN_DIM / _GROUP switches
# are arguments here; tests lower these to quantize tiny models)
MIN_DIM = 1024
GROUP = INT4_GROUP


def parse_quantize_spec(spec: Optional[str]) -> Optional[int]:
    """CLI '--quantize int8|int4' -> bits (None passes through)."""
    if spec is None or spec == "none":
        return None
    table = {"int8": 8, "8": 8, "int4": 4, "4": 4}
    if spec not in table:
        raise ValueError(f"--quantize must be int8 or int4, got {spec!r}")
    return table[spec]


def eligible_linears(module: nn.Module, bits: int,
                     min_dim: Optional[int] = None,
                     group: Optional[int] = None,
                     within: Sequence[str] = DEFAULT_WITHIN,
                     keep8: Sequence[str] = DEFAULT_KEEP8) -> dict:
    """{module path: bits} of the linears ``quantize_model`` replaces, by
    the reference's rules."""
    min_dim = MIN_DIM if min_dim is None else min_dim
    group = GROUP if group is None else group
    within, keep8 = set(within), set(keep8)
    out = {}
    for name, m in module.named_modules():
        path = name.split(".")
        if (not isinstance(m, nn.Linear) or not within.intersection(path)
                or min(m.in_features, m.out_features) < min_dim):
            continue
        b = max(bits, 8) if path[-1] in keep8 else bits
        d_in = m.in_features
        if b == 4 and (d_in % 2 or (d_in // 2) % group):
            b = 8  # ragged input dim: per-channel int8
        out[name] = b
    return out


def _stage(w: torch.Tensor, device) -> torch.Tensor:
    """One full-precision weight moved to the device it is quantized on."""
    return w.to(device)


@torch.no_grad()
def quantize_model(module: nn.Module, bits: int = 8,
                   min_dim: Optional[int] = None,
                   group: Optional[int] = None,
                   within: Sequence[str] = DEFAULT_WITHIN,
                   keep8: Sequence[str] = DEFAULT_KEEP8,
                   device=None) -> nn.Module:
    """Replace ``module``'s eligible linears with ``QuantLinear``s in
    place, each quantized from its weight on ``device`` (default: the
    weight's own), staged there alone and freed as it goes; the quantized
    buffers stay on that device, the bias and any LoRA pair are carried
    over where they are. Logs the reference's stats line (the quantized
    weights' bytes before and after). Returns ``module``."""
    group = GROUP if group is None else group
    plan = eligible_linears(module, bits, min_dim, group, within, keep8)
    orig = qbytes = 0
    for name, b in plan.items():
        lin = module.get_submodule(name)
        q = QuantLinear(lin.in_features, lin.out_features, b, bias=False,
                        group=group, device="meta")
        w = lin.weight if device is None else _stage(lin.weight, device)
        for key, t in quantize_weight(w, b, group).items():
            setattr(q, key, t)
            qbytes += t.numel() * t.element_size()
        orig += w.numel() * w.element_size()
        q.bias, q.lora = lin.bias, getattr(lin, "lora", None)
        parent, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(parent), leaf, q.train(lin.training))
        del lin, w
    if plan:
        log(f"quantized {len(plan)} linears (int{bits}, mods>=int8): "
            f"{orig / 2**30:.2f} GiB -> {qbytes / 2**30:.2f} GiB")
    return module


def quantized_bytes(module: nn.Module, bits: int) -> int:
    """``param_bytes`` of ``module`` once ``quantize_model(module, bits)``
    has run, computed from the shapes alone."""
    total = param_bytes(module)
    for name, b in eligible_linears(module, bits).items():
        w = module.get_submodule(name).weight
        total -= w.numel() * w.element_size()
        total += sum(t.numel() * t.element_size() for t in quantize_weight(
            w.to("meta"), b, GROUP).values())
    return total


@torch.no_grad()
def random_quantized_like(module: nn.Module, bits: int = 8,
                          generator: Optional[torch.Generator] = None,
                          device="cuda", min_dim: Optional[int] = None,
                          group: Optional[int] = None,
                          within: Sequence[str] = DEFAULT_WITHIN,
                          keep8: Sequence[str] = DEFAULT_KEEP8) -> nn.Module:
    """A meta-device ``module`` quantized by ``quantize_model``'s rules
    (the quantized layout alone: no weight is computed) and materialised
    on ``device``, its ``QuantLinear``s holding random quantized buffers
    (qw uniform in [-127, 127], qw4 bytes uniform in [0, 255], every scale
    0.02 / 127, biases 0); the full-precision weights of those linears are
    never allocated. Every other tensor is left empty for the caller's
    init (``init_reference_`` leaves the buffers as they are). Returns
    ``module``."""
    quantize_model(module, bits, min_dim, group, within, keep8)
    module.to_empty(device=device)
    for q in module.modules():
        if not isinstance(q, QuantLinear):
            continue
        buf = q.qw if q.bits == 8 else q.qw4
        lo, hi = (-127, 128) if q.bits == 8 else (0, 256)
        buf.copy_(torch.randint(lo, hi, buf.shape, generator=generator,
                                device=buf.device, dtype=torch.int32))
        q.qs.fill_(0.02 / 127.0)
        if q.bias is not None:
            q.bias.zero_()
    return module
