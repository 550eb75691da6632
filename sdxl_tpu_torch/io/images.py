"""PNG input and output (counterpart of sdxl_tpu/io/images.py), on a
reader and a writer of the port's own: ``zlib`` and ``struct``, no PIL.

Images are written as {basepath}{i}.png (sample/main.rs:341-348): 8-bit
RGB, every row with filter type 0, one IDAT chunk. Metadata travels as
one text chunk per key, before the image data: tEXt when key and value are
Latin-1 (PIL's rule), iTXt (UTF-8, uncompressed) otherwise.

``read_png`` decodes a non-interlaced 8-bit PNG of colour type 0 (gray), 2
(RGB), 3 (palette), 4 (gray + alpha) or 6 (RGBA), and gray or palette at
1, 2 or 4 bits (as PIL writes small palettes), every row filter (0-4,
Paeth included), to RGB as PIL's ``convert("RGB")`` gives it: alpha
dropped, the palette expanded, gray replicated. Any other file (16-bit,
interlaced, not a PNG) is a ValueError naming it.
``load_images`` stacks such files into one batch.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


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


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    """The [h, stride] samples of filtered scanlines (one filter byte
    each). Filters 0 and 2 are vectorised, 1 a running sum; 3 and 4 run a
    byte at a time, each byte depending on its left neighbour."""
    if len(data) < h * (stride + 1):
        raise ValueError(f"{path}: image data is truncated")
    raw = np.frombuffer(data, np.uint8)[: h * (stride + 1)].reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:]
        if f == 0:
            row = line.copy()
        elif f == 1:
            row = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64)
                   % 256).astype(np.uint8).reshape(-1)
        elif f == 2:
            row = line + prior  # uint8 arithmetic wraps mod 256
        elif f in (3, 4):
            row = bytearray(line.tobytes())
            up = prior.tolist()
            for i in range(stride):
                left = row[i - bpp] if i >= bpp else 0
                if f == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                row[i] = (row[i] + pred) & 0xFF
            row = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has an unknown filter {f}")
        out[y] = row
        prior = out[y]
    return out


def _text(kind: bytes, body: bytes) -> Tuple[str, str]:
    key, rest = body.split(b"\0", 1)
    if kind == b"tEXt":
        return key.decode("latin-1"), rest.decode("latin-1")
    if kind == b"zTXt":
        return key.decode("latin-1"), zlib.decompress(rest[1:]).decode(
            "latin-1")
    # iTXt: compression flag and method, language tag, translated keyword
    flag = rest[0]
    _, _, rest = rest[2:].split(b"\0", 2)
    return key.decode("latin-1"), (zlib.decompress(rest) if flag
                                   else rest).decode("utf-8")


def read_png(path: str) -> Tuple[np.ndarray, Dict[str, str]]:
    """(pixels [H, W, 3] uint8 RGB, {key: text} of its text chunks) of a
    PNG file; see the module docstring for the files it takes."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, text, header, palette = 8, [], {}, None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind in (b"tEXt", b"zTXt", b"iTXt"):
            key, value = _text(kind, body)
            text[key] = value
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS or not (
            depth == 8 or (depth in (1, 2, 4) and color in (0, 3))):
        raise ValueError(f"{path}: bit depth {depth}, colour type {color}: "
                         f"only 8-bit gray, RGB, palette, gray+alpha and "
                         f"RGBA PNGs, and gray or palette at 1, 2 or 4 "
                         f"bits, are read")
    if interlace:
        raise ValueError(f"{path}: an interlaced PNG is not read")
    ch = _CHANNELS[color]
    data = zlib.decompress(b"".join(idat))
    if depth == 8:
        px = _unfilter(data, h, w * ch, ch, path).reshape(h, w, ch)
    else:  # packed samples, most significant bits first
        rows = _unfilter(data, h, (w * depth + 7) // 8, 1, path)
        bits = np.unpackbits(rows, axis=1)[:, : w * depth].reshape(
            h, w, depth)
        px = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
            axis=-1, dtype=np.uint8)[..., None]
        if color == 0:  # gray scaled to 8 bits
            px = px * np.uint8(255 // (2 ** depth - 1))
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: a palette image without PLTE")
        if px.max(initial=0) >= len(palette):
            # PIL pads a short palette with black entries
            palette = np.concatenate(
                [palette, np.zeros((256 - len(palette), 3), np.uint8)])
        return palette[px[..., 0]], text
    if ch <= 2:  # gray (+ alpha): replicate the gray sample
        return np.repeat(px[..., :1], 3, axis=-1), text
    return np.ascontiguousarray(px[..., :3]), text


def load_images(paths: Sequence[str]) -> np.ndarray:
    """Load PNGs as one [N, H, W, 3] uint8 batch; dims must match."""
    imgs = [read_png(p)[0] for p in paths]
    if not imgs:
        raise ValueError("no images given")
    shape = imgs[0].shape
    if any(im.shape != shape for im in imgs):
        raise ValueError("images have different dimensions")
    return np.stack(imgs)


# ---------------------------------------------------------------------------
# LANCZOS resize (Pillow's Image.resize(..., Image.LANCZOS) on RGB uint8)
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2  # Pillow's 8-bit fixed point


def _lanczos(x: np.ndarray) -> np.ndarray:
    """Pillow's lanczos_filter: sinc(x) sinc(x / 3) on [-3, 3)."""
    def sinc(v):
        pv = v * np.pi
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(v == 0.0, 1.0, np.sin(pv) / pv)
    return np.where((x >= -3.0) & (x < 3.0), sinc(x) * sinc(x / 3.0), 0.0)


def _lanczos_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] int64 fixed-point weights of one axis, as
    Pillow's precompute_coeffs and normalize_coeffs_8bpc make them."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    w = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        x = np.arange(xmin, xmax)
        k = _lanczos((x - center + 0.5) / filterscale)
        ww = k.sum()
        if ww != 0.0:
            k = k / ww
        scaled = k * (1 << _PRECISION_BITS)
        w[xx, xmin:xmax] = np.where(k < 0, np.trunc(scaled - 0.5),
                                    np.trunc(scaled + 0.5)).astype(np.int64)
    return w


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    # the fixed-point sums stay below 2^53, so float64 products are exact
    w = _lanczos_weights(img.shape[axis], out_size).astype(np.float64)
    x = np.moveaxis(img.astype(np.float64), axis, 0)
    acc = (np.tensordot(w, x, axes=(1, 0)).astype(np.int64)
           + (1 << (_PRECISION_BITS - 1)))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_lanczos(img: np.ndarray, size) -> np.ndarray:
    """[H, W, C] uint8 -> [h, w, C] uint8 for size = (w, h), Pillow's
    LANCZOS resampling in its 8-bit fixed point: a horizontal pass, then a
    vertical one, each rounded to uint8 (an axis whose size stays is not
    resampled)."""
    out_w, out_h = size
    if img.shape[1] != out_w:
        img = _resample_axis(img, out_w, 1)
    if img.shape[0] != out_h:
        img = _resample_axis(img, out_h, 0)
    return img
