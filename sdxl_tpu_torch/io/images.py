"""PNG output (counterpart of sdxl_tpu/io/images.py's save_images), on a
writer of the port's own: ``zlib`` and ``struct``, no PIL.

Images are written as {basepath}{i}.png (sample/main.rs:341-348): 8-bit
RGB, every row with filter type 0, one IDAT chunk. Metadata travels as
one text chunk per key, before the image data: tEXt when key and value are
Latin-1 (PIL's rule), iTXt (UTF-8, uncompressed) otherwise. Reading images
(``load_images``) waits for module 9, the first to need it.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xffffffff))


def _text_chunk(key: str, value: str) -> bytes:
    try:
        return _chunk(b"tEXt", key.encode("latin-1") + b"\0"
                      + value.encode("latin-1"))
    except UnicodeEncodeError:
        # keyword, compression flag 0, method 0, no language tag or
        # translated keyword, UTF-8 text
        return _chunk(b"iTXt", key.encode("latin-1", "replace") + b"\0\0\0"
                      + b"\0\0" + value.encode("utf-8"))


def encode_png(img: np.ndarray, metadata: dict | None = None) -> bytes:
    """[H, W, 3] uint8 -> the bytes of an 8-bit RGB PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {img.shape}")
    h, w, _ = img.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0 per row
    rows[:, 1:] = img.reshape(h, 3 * w)
    out = [_SIGNATURE,
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))]
    for k, v in (metadata or {}).items():
        out.append(_text_chunk(str(k), str(v)))
    out.append(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def save_images(images: np.ndarray, basepath: str,
                metadata: dict | None = None) -> List[str]:
    """Save [N, H, W, 3] uint8 as {basepath}{i}.png (sample/main.rs:341-348).

    metadata: generation parameters embedded as PNG text chunks, under
    the A1111-convention key "parameters" plus one chunk per extra key."""
    parent = os.path.dirname(basepath)
    if parent:
        os.makedirs(parent, exist_ok=True)
    out = []
    for i, img in enumerate(np.asarray(images)):
        path = f"{basepath}{i}.png"
        with open(path, "wb") as f:
            f.write(encode_png(img, metadata))
        out.append(path)
    return out
