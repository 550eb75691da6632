"""Weight-only int8 / int4 quantization, and K4, the quantized linear
(counterpart of sdxl_tpu/ops/quant.py, and of the dequant that
sdxl_tpu/ops/linear.py:30 leaves XLA to fuse into the matmul).

The math is the reference's, in the port's [d_out, d_in] orientation:

- int8: symmetric per output channel. qs[o] = max|w[o, :]| / 127 (1 for
  a zero row), qw = round(w / qs) in [-127, 127] (round half to even, as
  np.rint);
- int4: symmetric per (output channel, group of ``group`` input rows).
  qs[o, j] = max|w[o, group j]| / 7 (1 where 0), q = round(w / qs) in
  [-8, 7], two signed nibbles a byte: byte i of row o packs input rows i
  (low nibble) and i + d_in/2 (high nibble), so qw4 is [d_out, d_in/2]
  uint8 and qs [d_out, d_in/group] f32;
- the dequant computes q * qs in f32, then casts to the activation's
  dtype, so a weight that is exactly q * qs round-trips bit for bit.

A quantized weight is a dict, the reference's leaf names: {"qw": int8
[d_out, d_in], "qs": f32 [d_out]} or {"qw4": uint8 [d_out, d_in/2],
"qs": f32 [d_out, d_in/group]} (models/layers.py ``QuantLinear`` holds the
same tensors as buffers). The quantizers work on any device.

``quant_linear`` is K4 (csrc/quant_linear.cu; the note there says why a
kernel and what bounds it): y = x · dequant(W)ᵀ + b without the
dequantized weight in device memory. On a CPU tensor it runs the plain
version, ``quant_linear_plain`` (F.linear on ``dequant_weight_plain``);
on a CUDA tensor it launches a kernel or raises. Routes: (x dtype, bits,
form) — bf16 x {8, 4} in two forms, ``k4_form``'s choice from the rows:
a wgmma + TMA GEMM ("gemm", its tile and K split from ``k4_gemm_plan``)
and, for at most ``GEMV_MAX_M`` rows, a byte-bound GEMV ("gemv"); f32 x
{8, 4} on one tiled kernel ("gemm").
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from . import flash_attention as fa

INT4_GROUP = 64  # default input rows per int4 scale group

SOURCE = "quant_linear.cu"
# (x dtype, bits, form) -> exported C function
ROUTES = {
    (torch.bfloat16, 8, "gemm"): "sdxl_quant_linear_bf16_int8",
    (torch.bfloat16, 4, "gemm"): "sdxl_quant_linear_bf16_int4",
    (torch.bfloat16, 8, "gemv"): "sdxl_quant_linear_bf16_int8_gemv",
    (torch.bfloat16, 4, "gemv"): "sdxl_quant_linear_bf16_int4_gemv",
    (torch.float32, 8, "gemm"): "sdxl_quant_linear_f32_int8",
    (torch.float32, 4, "gemm"): "sdxl_quant_linear_f32_int4",
}
# the bf16 GEMMs take a workspace and their tile and split besides
_GEMM_ROUTES = frozenset(ROUTES[torch.bfloat16, b, "gemm"] for b in (8, 4))
# the kernel's K step and the int4 scale groups it takes (csrc note)
K_MULTIPLE, N_MULTIPLE, GROUP_MULTIPLE = 64, 8, 32
# bf16 rows up to which the GEMV form runs: on an H100 the GEMV beats the
# GEMM at FLUX.1's double-block modulation up to 4 rows, by less at each
# row (scripts/time_k4.py; PERF.md)
GEMV_MAX_M = 4
# the GEMM: output channels and weight bytes of a block's tile and stage,
# its tiles' rows of x, the most K splits, and the time model that picks
# them, fitted to H100 readings (scripts/time_k4.py; PERF.md): us a stage
# by (bits, rows), us a block's fill and epilogue by rows, the split sum's
# launch and its bytes' rate
GEMM_CHANNELS, GEMM_BK, GEMM_TILES, GEMM_MAX_SPLITS = 128, 64, (128, 256), 16
_STAGE_US = {(8, 128): 0.51, (8, 256): 0.72, (4, 128): 1.7, (4, 256): 2.1}
_BLOCK_US = {128: 3.8, 256: 6.0}
_SUM_US, _BYTES_PER_US = 2.0, 3.0e6
H100_SMS = 132

# Launches of each route since the last reset_launch_counts(); the wrapper
# adds one exactly where it launches the kernel.
launch_counts = {name: 0 for name in ROUTES.values()}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

def quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[d_out, d_in] float -> {"qw": int8 [d_out, d_in], "qs": f32
    [d_out]}."""
    wf = w.float()
    s = wf.abs().amax(dim=1) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.round(wf / s[:, None]).clamp_(-127, 127).to(torch.int8)
    return {"qw": q, "qs": s}


def _check_int4(d_out: int, d_in: int, group: int) -> None:
    if d_in % 2 or (d_in // 2) % group:
        raise ValueError(f"int4 needs even d_in with group | d_in/2, got "
                         f"{(d_out, d_in)} (group {group})")


def quantize_int4(w: torch.Tensor,
                  group: int = INT4_GROUP) -> Dict[str, torch.Tensor]:
    """[d_out, d_in] float -> {"qw4": uint8 [d_out, d_in/2], "qs": f32
    [d_out, d_in/group]}: byte i packs input rows i (low nibble) and
    i + d_in/2 (high nibble); ``group`` must divide d_in/2, so no group
    straddles the halves."""
    d_out, d_in = w.shape
    _check_int4(d_out, d_in, group)
    wf = w.float().reshape(d_out, d_in // group, group)
    s = wf.abs().amax(dim=2) / 7.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.round(wf / s[..., None]).clamp_(-8, 7).to(torch.int32)
    qu = (q.reshape(d_out, d_in) & 0xF).to(torch.uint8)
    half = d_in // 2
    return {"qw4": (qu[:, half:] << 4) | qu[:, :half], "qs": s}


def quantize_weight(w: torch.Tensor, bits: int,
                    group: int = INT4_GROUP) -> Dict[str, torch.Tensor]:
    """int8 or int4 by ``bits``. A weight on the meta device gives the
    quantized layout's shapes alone (meta tensors), as the reference's
    quantizer does for abstract weights."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if w.is_meta:
        return _meta_quantized(*w.shape, bits, group)
    return quantize_int8(w) if bits == 8 else quantize_int4(w, group)


def _meta_quantized(d_out: int, d_in: int, bits: int,
                    group: int) -> Dict[str, torch.Tensor]:
    def meta(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if bits == 8:
        return {"qw": meta(d_out, d_in, dtype=torch.int8),
                "qs": meta(d_out, dtype=torch.float32)}
    _check_int4(d_out, d_in, group)
    return {"qw4": meta(d_out, d_in // 2, dtype=torch.uint8),
            "qs": meta(d_out, d_in // group, dtype=torch.float32)}


def is_quantized(p) -> bool:
    return isinstance(p, Mapping) and ("qw" in p or "qw4" in p)


def weight_bits(p: Mapping) -> int:
    return 8 if "qw" in p else 4


def int4_group(p: Mapping) -> int:
    """The scale group of an int4 weight: d_in / its scale columns."""
    return 2 * p["qw4"].shape[1] // p["qs"].shape[1]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _nibbles(v: torch.Tensor, scales: torch.Tensor, group: int,
             dtype) -> torch.Tensor:
    """Signed nibbles (0..15 as stored) [d_out, half] times their group's
    scale [d_out, half/group] in f32, cast to dtype."""
    v = v.to(torch.int8)
    v = v - ((v >> 3) << 4)  # sign-extend
    d_out, half = v.shape
    w = v.reshape(d_out, -1, group).float() * scales[..., None]
    return w.reshape(d_out, half).to(dtype)


def dequant_weight_plain(p: Mapping, dtype=torch.bfloat16) -> torch.Tensor:
    """A quantized weight dict -> its [d_out, d_in] weight in ``dtype``:
    q * qs in f32, then cast (sdxl_tpu/ops/quant.py:109-131)."""
    if "qw" in p:
        return (p["qw"].float() * p["qs"][:, None]).to(dtype)
    if "qw4" in p:
        packed, qs = p["qw4"], p["qs"]
        group, n = int4_group(p), qs.shape[1] // 2
        return torch.cat([_nibbles(packed & 0xF, qs[:, :n], group, dtype),
                          _nibbles(packed >> 4, qs[:, n:], group, dtype)],
                         dim=1)
    raise KeyError(f"not a quantized weight (keys {list(p)})")


def quant_linear_plain(x: torch.Tensor, p: Mapping,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K4: F.linear on the weight dequantized to
    x's dtype."""
    return F.linear(x, dequant_weight_plain(p, x.dtype),
                    None if bias is None else bias.to(x.dtype))


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def kernel_takes(d_in: int, d_out: int, bits: int,
                 group: int = INT4_GROUP) -> bool:
    """Whether K4 takes a [d_out, d_in] weight at ``bits`` (its K and N
    multiples; for int4 a group that is a multiple of 32 and divides
    d_in/2)."""
    ok = d_in % K_MULTIPLE == 0 and d_out % N_MULTIPLE == 0
    if bits == 4:
        ok = ok and group % GROUP_MULTIPLE == 0 and (d_in // 2) % group == 0
    return ok


def k4_form(m: int, dtype: torch.dtype, bits: int) -> str:
    """The kernel form K4 runs for ``m`` rows of x: "gemv" for bf16 at up
    to GEMV_MAX_M rows, else "gemm" (f32 has the one form). ``bits`` is
    part of the route, not of the choice."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    return "gemv" if dtype == torch.bfloat16 and m <= GEMV_MAX_M else "gemm"


def k4_route(m: int, dtype: torch.dtype, bits: int) -> str:
    """The exported kernel K4 launches for ``m`` rows of x at (dtype,
    bits)."""
    return ROUTES[dtype, bits, k4_form(m, dtype, bits)]


@functools.lru_cache(maxsize=4096)
def k4_gemm_plan(m: int, n: int, k: int, bits: int,
                 sms: int = H100_SMS) -> Tuple[int, int]:
    """(rows of x a block, K splits) of the bf16 GEMM at [m, k -> n]: the
    pair of least modelled time, waves of blocks over ``sms`` SMs times a
    block's stages and its fill, plus the split sum where K is split
    (only where the output has fewer tiles than SMs)."""
    stages = -(-(k if bits == 8 else k // 2) // GEMM_BK)
    channel_tiles = -(-n // GEMM_CHANNELS)
    best = None
    for nt in GEMM_TILES:
        tiles = channel_tiles * -(-m // nt)
        stage_us, block_us = _STAGE_US[bits, nt], _BLOCK_US[nt]
        # K is split only where the output has fewer tiles than SMs
        most = min(stages, GEMM_MAX_SPLITS) if tiles < sms else 1
        for splits in range(1, most + 1):
            per = -(-stages // splits)
            if -(-stages // per) != splits:
                continue  # an empty split
            us = -(-tiles * splits // sms) * (per * stage_us + block_us)
            if splits > 1:
                us += _SUM_US + 8 * splits * m * n / _BYTES_PER_US
            if best is None or us < best[0]:
                best = (us, nt, splits)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _sm_count(index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(
        torch.device("cuda", index)).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = fa.load_library(SOURCE)
    for name in ROUTES.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        if name in _GEMM_ROUTES:
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
    return lib


def _launch(x2: torch.Tensor, p: Mapping, bias: Optional[torch.Tensor],
            bits: int, d_out: int, form: Optional[str] = None,
            plan: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """K4 on a contiguous [M, K] CUDA x: checks, then one launch (and the
    split sum where the GEMM splits K). ``form`` and ``plan`` (nt,
    splits) default to k4_form's and k4_gemm_plan's choices."""
    m, k = x2.shape
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quantized linear kernel takes x in bf16 or f32, "
                         f"not {x2.dtype}")
    form = form or k4_form(m, x2.dtype, bits)
    name = ROUTES.get((x2.dtype, bits, form))
    if name is None or (form == "gemv" and m > GEMV_MAX_M):
        raise ValueError(f"quantized linear has no {form} form for "
                         f"{x2.dtype} int{bits} at {m} rows")
    q = p["qw"] if bits == 8 else p["qw4"]
    qs = p["qs"]
    group = int4_group(p) if bits == 4 else INT4_GROUP
    want_q = (d_out, k if bits == 8 else k // 2)
    if tuple(q.shape) != want_q or qs.dtype != torch.float32:
        raise ValueError(f"quantized linear: x {tuple(x2.shape)} does not "
                         f"match weight {tuple(q.shape)} / scales "
                         f"{tuple(qs.shape)} {qs.dtype}")
    if not kernel_takes(k, d_out, bits, group):
        raise ValueError(
            f"quantized linear kernel takes d_in a multiple of {K_MULTIPLE}, "
            f"d_out a multiple of {N_MULTIPLE} and an int4 group a multiple "
            f"of {GROUP_MULTIPLE} dividing d_in/2, not [{d_out}, {k}] "
            f"int{bits} (group {group})")
    tensors = [x2, q, qs] + ([] if bias is None else [bias])
    for t in tensors:
        if t.device != x2.device:
            raise ValueError(f"quantized linear: tensors on {x2.device} and "
                             f"{t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("quantized linear kernel needs contiguous, "
                             "16-byte aligned tensors")
    if bias is not None and (bias.shape != (d_out,) or bias.dtype != x2.dtype):
        raise ValueError(f"quantized linear: bias {tuple(bias.shape)} "
                         f"{bias.dtype}, not [{d_out}] {x2.dtype}")
    y = torch.empty((m, d_out), dtype=x2.dtype, device=x2.device)
    fn = getattr(_library(), name)
    ptrs = [x2.data_ptr(), q.data_ptr(), qs.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr()]
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        if name in _GEMM_ROUTES:
            nt, splits = plan or k4_gemm_plan(m, d_out, k, bits,
                                              _sm_count(x2.device.index))
            ws = (torch.empty((splits, m, d_out), dtype=torch.float32,
                              device=x2.device) if splits > 1 else None)
            err = fn(*ptrs, None if ws is None else ws.data_ptr(), m, d_out,
                     k, group, nt, splits, stream)
        else:
            err = fn(*ptrs, m, d_out, k, group, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1
    return y


def quant_linear(x: torch.Tensor, p: Mapping,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: x [..., d_in] · dequant(p)ᵀ + bias -> [..., d_out] in x's
    dtype. A CPU x takes the plain version; a CUDA x launches the kernel
    of ``k4_form``'s form for its rows (x made contiguous first) or
    raises."""
    if x.device.type == "cpu":
        return quant_linear_plain(x, p, bias)
    if x.device.type != "cuda":
        raise ValueError(f"quantized linear has no kernel for {x.device}")
    bits = weight_bits(p)
    d_out = p["qs"].shape[0]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if bias is not None:
        bias = bias.to(x.dtype)
    y = _launch(x2, p, bias, bits, d_out)
    return y.reshape(*x.shape[:-1], d_out)


def weight_bytes(p: Mapping) -> int:
    """Bytes of a quantized weight (its bytes and scales) as stored."""
    return sum(t.numel() * t.element_size() for k, t in p.items()
               if k in ("qw", "qw4", "qs"))
