"""Device memory accounting for the loaders (counterpart of the parts of
sdxl_tpu/utils/memory.py that module 14's loaders use: ``param_bytes``,
the budget, and parking a module on the host).

The reference's HBM planner (scan workspace estimates, the refiner's
stage-scoped placement) is not ported here.
"""

from __future__ import annotations

import torch
from torch import nn

# fraction of the card's memory the loaders count on (the reference's)
USABLE_FRACTION = 0.9


def param_bytes(module) -> int:
    """Bytes of a module's parameters and buffers (quantized weights and
    their scales included); None counts 0."""
    if module is None:
        return 0
    return sum(t.numel() * t.element_size()
               for t in (*module.parameters(), *module.buffers()))


def memory_budget_bytes(device=None) -> int:
    """Usable card memory: the card's total memory times
    ``USABLE_FRACTION``."""
    total = torch.cuda.get_device_properties(
        torch.device("cuda") if device is None else torch.device(device)
    ).total_memory
    return int(total * USABLE_FRACTION)


def module_device(module: nn.Module) -> torch.device:
    """The device of a module's first parameter or buffer."""
    for t in (*module.parameters(), *module.buffers()):
        return t.device
    return torch.device("cpu")
