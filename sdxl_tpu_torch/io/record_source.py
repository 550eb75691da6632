"""Format-agnostic access to a reference checkpoint's record tree (the
port's copy of sdxl_tpu/io/record_source.py).

Two on-disk formats ship reference weights:
  - the .npy dump tree written by python/dump.py (one file per leaf
    tensor, shape-prefixed flat f32; the Rust reference's
    src/model/load.rs:15-60)
  - burn's NamedMpkFileRecorder .mpk (MessagePack named records at half
    precision; written by convert/main.rs:65-70)

Both trees mirror the reference's Rust module field names, so one set of
parameter builders (params_builder.py) can consume either through this
small RecordSource interface.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class RecordSource:
    """A node in the record tree."""

    def child(self, name: str) -> "RecordSource":
        raise NotImplementedError

    def opt_child(self, name: str) -> Optional["RecordSource"]:
        raise NotImplementedError

    def tensor(self, name: str, ndim: int) -> np.ndarray:
        """Leaf tensor under this node, as float32."""
        raise NotImplementedError

    def opt_tensor(self, name: str, ndim: int) -> Optional[np.ndarray]:
        try:
            return self.tensor(name, ndim)
        except (KeyError, FileNotFoundError):
            return None

    def tensor_any(self, names: Sequence[str], ndim: int) -> np.ndarray:
        for n in names:
            t = self.opt_tensor(n, ndim)
            if t is not None:
                return t
        raise KeyError(f"none of {names} found")

    def seq(self, name: str, alias: Optional[str] = None) -> List["RecordSource"]:
        """Ordered children of a Vec field.

        `alias` covers npy naming quirks: SpatialTransformer's Vec field is
        "blocks" in the record but dumped as sibling dirs "transformer_{i}"
        (unet/load.rs:120-122).
        """
        raise NotImplementedError

    def scalar(self, name: str) -> Optional[float]:
        """Optional scalar metadata (npy trees only; constants are not in
        .mpk records)."""
        return None
