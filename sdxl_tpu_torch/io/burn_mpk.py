"""Reader for burn NamedMpkFileRecorder checkpoints (.mpk): the port's copy
of sdxl_tpu/io/burn_mpk.py, on a MessagePack decoder of its own
(``unpackb``; no ``msgpack`` package). ``inspect_mpk`` is not ported yet
(it belongs with the ``convert`` CLI).

The reference stores converted weights as MessagePack named records at half
precision (NamedMpkFileRecorder<HalfPrecisionSettings>, convert/main.rs:65-70;
read back at sample/main.rs:28-51). The record tree mirrors the Rust module
field names; Vec fields are msgpack arrays; the UNet's block enum serializes
externally tagged ({"Conv": {...}}, {"Res": {...}}, ...).

burn 0.13's serde layout has several degrees of freedom (rmp_serde "named"
mode + the burn record item types), all of which this reader tolerates and
all of which are pinned by the fuzz matrix in tests/test_io.py (for this
copy, in tests/test_torch_loader.py against the reference's reader):

  wrapper     BurnRecord {item, metadata} in either key order, or a bare item
  param       ParamSerde {id, param} wrappers, or bare tensor nodes
  tensor      DataSerialize {value, shape}; an extra single-key {data: ...}
              nesting (FloatTensorSerde); raw little-endian "bytes"/"data"
              buffers with an optional "dtype" tag
  f16 bits    HalfPrecisionSettings stores half::f16 as u16 bit patterns
              (integer lists) or as 2-byte raw buffers; BF16 as high-half bits
  enums       externally tagged {"Variant": inner} (rmp_serde named mode)
  Option      None -> msgpack nil; Some -> the value
  constants   ConstantRecord -> nil or empty map (skipped by the builders)

Every parse failure names the exact record path that failed plus the keys
present at that node, so a layout drift in a future burn version produces an
actionable error instead of a downstream shape mismatch.
"""

from __future__ import annotations

import mmap
import struct
from typing import List, NamedTuple, Optional

import numpy as np

from .record_source import RecordSource

_ENUM_TO_TYPE = {
    "Conv": "conv",
    "Res": "resnet",
    "Down": "downsample",
    "ResT": "resnet_transformer",
    "ResTU": "resnet_transformer_upsample",
    "ResU": "resnet_upsample",
}

_DTYPES = {
    "F16": np.float16, "f16": np.float16,
    "F32": np.float32, "f32": np.float32,
    "F64": np.float64, "f64": np.float64,
    "BF16": None, "bf16": None,  # handled specially (numpy has no native bf16)
}


class MpkParseError(ValueError):
    """A burn .mpk record did not match the expected layout.

    Carries the full record path so the failing node is identifiable."""


def _keys_of(node) -> str:
    if isinstance(node, dict):
        return f"map keys {sorted(str(k) for k in node)[:8]}"
    if isinstance(node, (list, tuple)):
        return f"array of {len(node)}"
    return f"{type(node).__name__} value"


def _unwrap(node):
    """Strip BurnRecord/ParamSerde wrappers (order-insensitive keys)."""
    while isinstance(node, dict):
        if "item" in node and set(node.keys()) <= {"item", "metadata"}:
            node = node["item"]
            continue
        if "param" in node and set(node.keys()) <= {"id", "param"}:
            node = node["param"]
            continue
        break
    return node


def _is_tensor_leaf(node) -> bool:
    return isinstance(node, dict) and "shape" in node and (
        "value" in node or "bytes" in node or "data" in node
    )


def _unwrap_tensor(node):
    """Unwrap down to a DataSerialize-shaped leaf, tolerating an extra
    single-key {"data": {...}} nesting (FloatTensorSerde's field)."""
    node = _unwrap(node)
    while (
        isinstance(node, dict)
        and not _is_tensor_leaf(node)
        and len(node) == 1
        and next(iter(node)) in ("data", "tensor", "value")
        and isinstance(next(iter(node.values())), dict)
    ):
        node = _unwrap(next(iter(node.values())))
    return node


def _decode_tensor(node, path: str) -> np.ndarray:
    shape = [int(s) for s in node["shape"]]
    n = int(np.prod(shape)) if shape else 1
    dtype_tag = node.get("dtype")

    raw = node.get("bytes", node.get("data"))
    if isinstance(raw, (bytes, bytearray, memoryview)):
        raw = bytes(raw)
        if dtype_tag in ("BF16", "bf16"):
            u16 = np.frombuffer(raw, dtype="<u2")
            arr = (u16.astype(np.uint32) << 16).view(np.float32)
        elif dtype_tag in _DTYPES and _DTYPES[dtype_tag] is not None:
            arr = np.frombuffer(raw, dtype=_DTYPES[dtype_tag]).astype(np.float32)
        else:
            itemsize = len(raw) // max(n, 1)
            if itemsize not in (2, 4, 8) or len(raw) != itemsize * n:
                raise MpkParseError(
                    f"{path}: raw tensor buffer of {len(raw)} bytes does not "
                    f"match shape {shape} at any of f16/f32/f64"
                )
            dt = {2: np.float16, 4: np.float32, 8: np.float64}[itemsize]
            arr = np.frombuffer(raw, dtype=dt).astype(np.float32)
    else:
        value = node.get("value")
        if value is None:
            raise MpkParseError(
                f"{path}: tensor leaf has neither value nor bytes ({_keys_of(node)})"
            )
        arr = np.asarray(value)
        if arr.dtype.kind in "iu":
            if dtype_tag in ("BF16", "bf16"):
                arr = (arr.astype(np.uint32) << 16).view(np.float32)
            else:
                # HalfPrecisionSettings: half::f16 serializes as u16 bits
                arr = arr.astype(np.uint16, copy=False).view(
                    np.float16).astype(np.float32)
        else:
            arr = arr.astype(np.float32, copy=False)
        arr = arr.reshape(-1)

    if arr.size != n:
        raise MpkParseError(
            f"{path}: tensor payload has {arr.size} elements but shape "
            f"{shape} implies {n}"
        )
    return arr.reshape(shape)


class MpkSource(RecordSource):
    def __init__(self, node, path: str = "$"):
        self.node = _unwrap(node)
        self.path = path

    # -- enum handling (UNet block Vec entries) -------------------------------
    def enum_variant(self) -> Optional[str]:
        if isinstance(self.node, dict) and len(self.node) == 1:
            k = next(iter(self.node))
            if k in _ENUM_TO_TYPE:
                return k
        return None

    def block_type(self) -> str:
        v = self.enum_variant()
        if v is None:
            raise MpkParseError(
                f"{self.path}: expected an externally-tagged block enum "
                f"({'|'.join(_ENUM_TO_TYPE)}), found {_keys_of(self.node)}"
            )
        return _ENUM_TO_TYPE[v]

    def enum_inner(self) -> "MpkSource":
        v = self.enum_variant()
        if v is None:
            raise MpkParseError(
                f"{self.path}: expected an externally-tagged block enum, "
                f"found {_keys_of(self.node)}"
            )
        return MpkSource(self.node[v], f"{self.path}.{v}")

    # -- RecordSource ----------------------------------------------------------
    def child(self, name: str) -> "MpkSource":
        if not isinstance(self.node, dict) or name not in self.node:
            raise KeyError(
                f"{self.path}.{name}: missing record field ({_keys_of(self.node)})"
            )
        return MpkSource(self.node[name], f"{self.path}.{name}")

    def opt_child(self, name: str) -> Optional["MpkSource"]:
        if isinstance(self.node, dict):
            v = self.node.get(name)
            if v is not None:  # Option::None serializes as msgpack nil
                return MpkSource(v, f"{self.path}.{name}")
        return None

    def tensor(self, name: str, ndim: int) -> np.ndarray:
        if not isinstance(self.node, dict) or self.node.get(name) is None:
            raise KeyError(
                f"{self.path}.{name}: missing tensor field ({_keys_of(self.node)})"
            )
        path = f"{self.path}.{name}"
        leaf = _unwrap_tensor(self.node[name])
        if not _is_tensor_leaf(leaf):
            raise MpkParseError(
                f"{path}: not a tensor leaf (need shape + value/bytes, "
                f"found {_keys_of(leaf)})"
            )
        arr = _decode_tensor(leaf, path)
        if arr.ndim != ndim:
            raise MpkParseError(
                f"{path}: expected a {ndim}-d tensor, record shape is "
                f"{list(arr.shape)}"
            )
        return arr

    def seq(self, name: str, alias: Optional[str] = None) -> List["MpkSource"]:
        v = self.node.get(name) if isinstance(self.node, dict) else None
        if not isinstance(v, (list, tuple)):
            raise KeyError(
                f"{self.path}.{name}: missing sequence field ({_keys_of(self.node)})"
            )
        return [
            MpkSource(x, f"{self.path}.{name}[{i}]") for i, x in enumerate(v)
        ]


# ---------------------------------------------------------------------------
# MessagePack decoding
# ---------------------------------------------------------------------------

class ExtType(NamedTuple):
    """A msgpack extension value (burn writes none; kept, not interpreted)."""

    code: int
    data: bytes


# numeric headers that repeat at a fixed stride inside a tensor's value
# array: header byte -> (bytes per element, big-endian payload dtype)
_RUNS = {
    0xcc: (2, ">u1"), 0xcd: (3, ">u2"), 0xce: (5, ">u4"), 0xcf: (9, ">u8"),
    0xd0: (2, ">i1"), 0xd1: (3, ">i2"), 0xd2: (5, ">i4"), 0xd3: (9, ">i8"),
    0xca: (5, ">f4"), 0xcb: (9, ">f8"),
}
_FIXED = {  # header -> (struct format, size) of the scalar that follows
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
    0xca: (">f", 4), 0xcb: (">d", 8),
}
_MIN_RUN = 16


class _Decoder:
    def __init__(self, buf):
        self.buf = buf
        self.u8 = np.frombuffer(buf, np.uint8)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        p = self.pos
        if p + n > len(self.buf):
            raise MpkParseError(f"msgpack data truncated at byte {p}")
        self.pos = p + n
        return self.buf[p:p + n]

    def _unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self._take(n))[0]

    def obj(self):
        h = self._take(1)[0]
        if h <= 0x7f:
            return h
        if h >= 0xe0:
            return h - 0x100
        if 0xa0 <= h <= 0xbf:
            return self._str(h & 0x1f)
        if 0x90 <= h <= 0x9f:
            return self._array(h & 0x0f)
        if 0x80 <= h <= 0x8f:
            return self._map(h & 0x0f)
        if h in _FIXED:
            return self._unpack(*_FIXED[h])
        if h == 0xc0:
            return None
        if h in (0xc2, 0xc3):
            return h == 0xc3
        if h in (0xd9, 0xda, 0xdb):
            return self._str(self._unpack(*_LEN[h]))
        if h in (0xc4, 0xc5, 0xc6):
            return bytes(self._take(self._unpack(*_LEN[h])))
        if h in (0xdc, 0xdd):
            return self._array(self._unpack(*_LEN[h]))
        if h in (0xde, 0xdf):
            return self._map(self._unpack(*_LEN[h]))
        if h in _FIXEXT:
            code = self._unpack(">b", 1)
            return ExtType(code, bytes(self._take(_FIXEXT[h])))
        if h in (0xc7, 0xc8, 0xc9):
            n = self._unpack(*_LEN[h])
            code = self._unpack(">b", 1)
            return ExtType(code, bytes(self._take(n)))
        raise MpkParseError(f"msgpack: unknown type byte 0x{h:02x} at byte "
                            f"{self.pos - 1}")

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[tuple(k) if isinstance(k, list) else k] = self.obj()
        return out

    def _run(self, h: int, w: int) -> np.ndarray:
        """Up to w numbers from self.pos that share header byte h, in the
        header's own width (fixints as uint8 or int8)."""
        p = self.pos
        if h <= 0x7f or h >= 0xe0:
            seg = self.u8[p:p + w]
            k = _first_false((seg <= 0x7f) if h <= 0x7f else (seg >= 0xe0))
            self.pos = p + k
            return seg[:k].copy() if h <= 0x7f else \
                seg[:k].view(np.int8).copy()
        width, dt = _RUNS[h]
        k = _first_false(self.u8[p:p + width * w:width] == h)
        k = min(k, (len(self.buf) - p) // width)
        if k == 0:
            raise MpkParseError(f"msgpack data truncated at byte {p}")
        rows = self.u8[p:p + width * k].reshape(k, width)[:, 1:]
        self.pos = p + width * k
        vals = np.ascontiguousarray(rows).view(dt).reshape(-1)
        return vals.astype(vals.dtype.newbyteorder("="))

    def _array(self, n: int):
        if n < _MIN_RUN:
            return [self.obj() for _ in range(n)]
        parts: list = []  # numpy runs and single objects, in order
        count = 0
        window = 256
        while count < n:
            h = self.buf[self.pos] if self.pos < len(self.buf) else None
            if h is None or not (h <= 0x7f or h >= 0xe0 or h in _RUNS):
                parts.append([self.obj()])
                count += 1
                continue
            # a run of numbers with the same header: decode it at once
            w = min(n - count, window)
            run = self._run(h, w)
            parts.append(run)
            count += run.size
            window = min(window * 2, 1 << 16) if run.size == w else 256
        joined = _join(parts)
        if joined is not None:
            return joined
        out: list = []
        for part in parts:
            out.extend(part if isinstance(part, list) else part.tolist())
        return out


def _join(parts: list) -> Optional[np.ndarray]:
    """The runs of an array of numbers, all ints or all floats, as one
    numpy array in the narrowest dtype that holds each run exactly (uint16
    for f16 bit patterns, float32 for f32 values); None for any other
    array."""
    if not all(isinstance(p, np.ndarray) for p in parts):
        return None
    kinds = {p.dtype.kind for p in parts}
    if kinds != {"f"} and not kinds <= {"i", "u"}:
        return None
    dt = np.result_type(*parts)
    if dt.kind == "f" and kinds != {"f"}:  # uint64 beside signed runs
        big = max(int(p.max()) for p in parts if p.dtype == np.uint64)
        if big > np.iinfo(np.int64).max:
            return None
        dt = np.dtype(np.int64)
    return np.concatenate(parts).astype(dt, copy=False)


_LEN = {0xd9: (">B", 1), 0xda: (">H", 2), 0xdb: (">I", 4),
        0xc4: (">B", 1), 0xc5: (">H", 2), 0xc6: (">I", 4),
        0xdc: (">H", 2), 0xdd: (">I", 4), 0xde: (">H", 2), 0xdf: (">I", 4),
        0xc7: (">B", 1), 0xc8: (">H", 2), 0xc9: (">I", 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _first_false(mask: np.ndarray) -> int:
    bad = np.flatnonzero(~mask)
    return int(bad[0]) if bad.size else int(mask.size)


def unpackb(data) -> object:
    """Decode one MessagePack object as ``msgpack.unpackb(data, raw=False,
    strict_map_key=False)`` does (str for str, bytes for bin, lists for
    arrays, dicts for maps, ExtType for extensions), except that an array
    of 16 or more numbers, all ints or all floats (a tensor's value list),
    comes back as one numpy array, decoded a run of equal header bytes at
    a time and kept at the width of its widest run: f16 bit patterns as
    uint16, f32 values as float32, never widened to 8 bytes."""
    buf = memoryview(data).cast("B")
    dec = _Decoder(buf)
    out = dec.obj()
    if dec.pos != len(buf):
        raise MpkParseError(f"msgpack: {len(buf) - dec.pos} bytes after the "
                            f"first object")
    return out


def parse_mpk_file(path: str) -> MpkSource:
    with open(path, "rb") as f:
        if not f.seek(0, 2):
            raise MpkParseError(f"{path}: empty file")
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
            with memoryview(m) as buf:
                node = unpackb(buf)
    return MpkSource(node)
