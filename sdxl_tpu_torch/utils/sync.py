"""Device synchronisation helper (counterpart of sdxl_tpu/utils/sync.py).

PyTorch returns before the GPU finishes; ``fence`` waits for every queued
kernel on the tensor's CUDA device so a host clock around it measures
device work. CPU tensors are already complete.
"""

from __future__ import annotations

import torch


def fence(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
