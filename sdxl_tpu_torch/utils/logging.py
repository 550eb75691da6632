"""Per-stage wall-clock timing and logging (counterpart of sdxl_tpu/utils/logging.py)."""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict


def log(msg: str) -> None:
    print(f"[sdxl_tpu_torch] {msg}", file=sys.stderr, flush=True)


class StageTimer:
    """Collects per-stage wall clock. The caller fences (utils.sync.fence)
    inside a stage when its time must cover the device work it queued."""

    def __init__(self):
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.stages[name] = self.stages.get(name, 0.0) + dt
        log(f"{name}: {dt:.3f}s")

    def total(self) -> float:
        return sum(self.stages.values())

    def summary(self) -> str:
        parts = [f"{k}={v:.3f}s" for k, v in self.stages.items()]
        return " ".join(parts) + f" total={self.total():.3f}s"
