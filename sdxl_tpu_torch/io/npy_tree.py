"""Reader (and test-side writer) for the reference's .npy dump tree (the
port's copy of sdxl_tpu/io/npy_tree.py).

Format (python/save.py:7-18 + model/load.rs:15-60):
  - every leaf is a 1-D float32 .npy whose FIRST D entries are the shape
    and the rest is the flattened data; D is fixed by the consumer
  - scalars are stored as [1.0, value]
  - linear weights were transposed to [d_in, d_out] at export (save.py:23)
  - conv dirs carry weight/bias plus stride/kernel_size/dilation/n_group/
    n_channels_in/n_channels_out/padding metadata files (model/load.rs:119-156)
  - UNet block dirs carry a type.txt tag (unet/load.rs:296-307)
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .record_source import RecordSource


def read_shape_prefixed(path: str, ndim: int) -> np.ndarray:
    flat = np.load(path)
    if flat.dtype != np.float32:
        flat = flat.astype(np.float32)
    shape = [int(v) for v in flat[:ndim]]
    data = flat[ndim:]
    return data.reshape(shape)


def write_shape_prefixed(path: str, arr: np.ndarray) -> None:
    arr = np.asarray(arr, np.float32)
    flat = np.concatenate([np.asarray(arr.shape, np.float32), arr.reshape(-1)])
    np.save(path, flat)


def write_scalar(path: str, value: float) -> None:
    np.save(path, np.array([1.0, value], np.float32))


class NpyTreeSource(RecordSource):
    def __init__(self, path: str):
        self.path = path

    def child(self, name: str) -> "NpyTreeSource":
        p = os.path.join(self.path, name)
        if not os.path.isdir(p):
            raise FileNotFoundError(p)
        return NpyTreeSource(p)

    def opt_child(self, name: str) -> Optional["NpyTreeSource"]:
        p = os.path.join(self.path, name)
        return NpyTreeSource(p) if os.path.isdir(p) else None

    def tensor(self, name: str, ndim: int) -> np.ndarray:
        p = os.path.join(self.path, f"{name}.npy")
        if not os.path.isfile(p):
            raise FileNotFoundError(p)
        return read_shape_prefixed(p, ndim)

    def seq(self, name: str, alias: Optional[str] = None) -> List["NpyTreeSource"]:
        sub = os.path.join(self.path, name)
        if os.path.isdir(sub):
            # numbered child dirs under e.g. blocks/{i} (clip/load.rs:96-104)
            idxs = sorted(int(d) for d in os.listdir(sub) if d.isdigit())
            return [NpyTreeSource(os.path.join(sub, str(i))) for i in idxs]
        if alias is not None:
            # sibling dirs alias_{i} (unet/load.rs:120-122)
            out = []
            i = 0
            while os.path.isdir(os.path.join(self.path, f"{alias}_{i}")):
                out.append(NpyTreeSource(os.path.join(self.path, f"{alias}_{i}")))
                i += 1
            return out
        raise FileNotFoundError(sub)

    def scalar(self, name: str) -> Optional[float]:
        p = os.path.join(self.path, f"{name}.npy")
        if not os.path.isfile(p):
            return None
        return float(read_shape_prefixed(p, 1)[0])

    def block_type(self) -> str:
        """UNet block type tag (unet/load.rs:296)."""
        with open(os.path.join(self.path, "type.txt"), "r") as f:
            return f.read().strip()
