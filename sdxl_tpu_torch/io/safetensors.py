"""Reader and writer for the safetensors file layout, on numpy and torch
alone (no ``safetensors`` package, no ``ml_dtypes``).

Layout: an 8-byte little-endian header length N, then N bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}, and an optional
"__metadata__": {str: str}}), then the data block; offsets are relative to
the data block's start.

The reader maps the file (``np.memmap``, copy-on-write) and returns one
zero-copy CPU tensor per entry: a caller moves each to its device and dtype
one at a time, so no second host copy of a checkpoint is ever made. BF16
is mapped as uint16 and viewed as ``torch.bfloat16``, never widened.
The writer streams one tensor at a time from its device to the file.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# safetensors dtype tag -> (torch dtype, numpy dtype of the mapped bytes)
DTYPES = {
    "F64": (torch.float64, np.float64),
    "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16),
    "BF16": (torch.bfloat16, np.uint16),
    "I64": (torch.int64, np.int64),
    "I32": (torch.int32, np.int32),
    "I16": (torch.int16, np.int16),
    "I8": (torch.int8, np.int8),
    "U8": (torch.uint8, np.uint8),
    "BOOL": (torch.bool, np.bool_),
}
_TAGS = {t: tag for tag, (t, _) in DTYPES.items()}


def read_header(path: str) -> Tuple[dict, int]:
    """(the JSON header, the data block's byte offset in the file)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", raw)
        header = f.read(n)
    if len(header) != n:
        raise ValueError(f"{path}: truncated safetensors header")
    try:
        return json.loads(header), 8 + n
    except ValueError as e:
        raise ValueError(f"{path}: bad safetensors header: {e}") from None


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor}, each a view of the mapped file (writes stay
    private to the process)."""
    header, start = read_header(path)
    entries = {k: v for k, v in header.items() if k != "__metadata__"}
    size = max((v["data_offsets"][1] for v in entries.values()), default=0)
    if size == 0:
        return {k: torch.empty([int(s) for s in v["shape"]],
                               dtype=DTYPES[v["dtype"]][0])
                for k, v in entries.items()}
    data = np.memmap(path, dtype=np.uint8, mode="c", offset=start,
                     shape=(size,))
    out: Dict[str, torch.Tensor] = {}
    for name, v in entries.items():
        if v["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype "
                             f"{v['dtype']}")
        dtype, np_dtype = DTYPES[v["dtype"]]
        shape = [int(s) for s in v["shape"]]
        begin, end = (int(o) for o in v["data_offsets"])
        item = np.dtype(np_dtype).itemsize
        if end - begin != item * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: {name} holds {end - begin} bytes, "
                             f"not {shape} x {v['dtype']}")
        chunk = data[begin:end]
        if begin % item:  # unaligned: copy rather than view
            chunk = np.array(chunk)
        arr = chunk.view(np_dtype).reshape(shape)
        t = torch.from_numpy(arr)
        out[name] = t.view(torch.bfloat16) if v["dtype"] == "BF16" else t
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write {name: tensor} (any device) as one safetensors file; entries
    ordered by element size, largest first, then by name (the package's
    order, which keeps every entry aligned)."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _TAGS:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach().contiguous().cpu().reshape(-1)
            if t.numel():
                f.write(memoryview(t.view(torch.uint8).numpy()))
