"""LoRA factors on the frozen UNet (counterpart of sdxl_tpu/train/lora.py).

Factors are a FLAT dict ``{"<module path>.lora_down": [d_in, r],
"<module path>.lora_up": [r, d_out]}`` of f32 tensors, the trainable
state; the module paths are the reference's tree paths. ``set_factors``
puts each pair in the slot of its ``layers.Linear`` (the role of the
reference's ``set_leaves``), where ops/linear.py adds
``(x @ down) @ up`` unmerged; the base weights never change. Init as the
reference's code does it: down ~ N(0, 1) / rank (a std of 1/rank), up = 0,
so the model starts exactly at the base function.

Export to ecosystem adapter files waits for a later slice.
"""

from __future__ import annotations

import re
from typing import Dict, List

import torch
from torch import nn

from ..models.layers import Linear

# target presets: regex over the dotted module path ("attn": every
# attention projection; "all-linear" adds the GEGLU MLPs and the
# transformer in/out projections)
_ATTN = (r"(^|\.)(attn2?|attn1)\."
         r"(q|k|v|out|o|to_q|to_k|to_v|to_out|"
         r"add_q_proj|add_k_proj|add_v_proj|to_add_out)$")
PRESETS: Dict[str, re.Pattern] = {
    "attn": re.compile(_ATTN),
    "all-linear": re.compile(
        _ATTN + r"|(^|\.)mlp(_context)?\.(proj|lin|in|out|fc1|fc2)$"
        r"|(^|\.)(proj_in|proj_out|proj_mlp)$"),
}


def _path_key(path: str):
    return tuple(int(p) if p.isdigit() else p for p in path.split("."))


def lora_target_paths(model: nn.Module, targets: str = "attn") -> List[str]:
    """Module paths of the linears a preset selects, in the reference's
    order (dict keys sorted, list entries by index). A fused ``qkv`` is
    never targeted: train the unfused layout."""
    rx = PRESETS[targets]
    paths = [name for name, m in model.named_modules()
             if isinstance(m, nn.Linear) and not name.endswith(".qkv")
             and rx.search(name) is not None]
    return sorted(paths, key=_path_key)


def init_lora(model: nn.Module, rank: int, generator: torch.Generator,
              targets: str = "attn") -> Dict[str, torch.Tensor]:
    """Fresh f32 factors for every targeted linear, on the model's device:
    down ~ N(0, 1) / rank, up = 0."""
    paths = lora_target_paths(model, targets)
    if not paths:
        raise ValueError(f"no LoRA targets matched preset {targets!r}")
    flat: Dict[str, torch.Tensor] = {}
    for path in paths:
        w = model.get_submodule(path).weight
        d_out, d_in = w.shape
        flat[path + ".lora_down"] = torch.randn(
            (d_in, rank), generator=generator, device=w.device) / rank
        flat[path + ".lora_up"] = torch.zeros((rank, d_out), device=w.device)
    return flat


def set_factors(model: nn.Module, flat: Dict[str, torch.Tensor]) -> None:
    """Put each (down, up) pair of ``flat`` in its linear's LoRA slot."""
    for key, down in flat.items():
        if key.endswith(".lora_down"):
            path = key[: -len(".lora_down")]
            lin = model.get_submodule(path)
            if not isinstance(lin, Linear):
                raise TypeError(f"{path} is not a LoRA-capable Linear")
            lin.lora = (down, flat[path + ".lora_up"])


def clear_factors(model: nn.Module) -> None:
    """Empty every LoRA slot: the model is the base model again."""
    for m in model.modules():
        if isinstance(m, Linear):
            m.lora = None
