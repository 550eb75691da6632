"""Flash-attention forward over [B, H, T, D]: the Hopper kernel and its plain version.

Counterpart of sdxl_tpu/ops/flash_attention.py (`flash_attention_bhtd`,
return_lse=False, and `use_flash`). The kernel lives in
``csrc/flash_attention.cu``; it is compiled with nvcc for sm_90a into a
shared library with a plain C interface, at first use, into
``build/kernels/`` at the repo root (keyed by a hash of the source and the
flags), and loaded with ctypes.

``flash_attention_bhtd`` takes the plain PyTorch version for tensors on the
CPU and launches the kernel for CUDA tensors; a CUDA call the kernel does
not take raises. Both follow the reference's numerics: q is pre-scaled by
d^-0.5 * log2(e) and rounded to its dtype, the softmax runs in base 2 over
f32 logits, and p is rounded to v's dtype before P.V.

Kernel routes on CUDA: bf16 with d in (64, 128) (UNet self-attention) and
f32 with d = 512 (VAE mid-block attention).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_LOG2E = math.log2(math.e)

# Smallest self-attention token count routed to the kernel: the smallest
# level-2 SDXL bucket (704x1344 -> 22x42 = 924 tokens). Same rule and value
# as the reference gate; not re-derived for the H100 yet.
FLASH_MIN_T = 924

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype -> (head dims the kernel takes, exported C function)
_ROUTES = {
    torch.bfloat16: ((64, 128), "sdxl_flash_attention_bf16"),
    torch.float32: ((512,), "sdxl_flash_attention_f32"),
}

# Launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one exactly where it launches its kernel.
launch_counts = {"sdxl_flash_attention_bf16": 0, "sdxl_flash_attention_f32": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def use_flash(tq: int, tk: int, d: int, has_mask: bool) -> bool:
    """The reference's routing rule: long unmasked self-attention (UNet
    levels 1-2 at 924..4096 tokens, the VAE mid-attention at >= 3696
    tokens with a 512-wide head) goes to the kernel; cross-attention and
    masked CLIP attention stay on the plain path."""
    return (
        not has_mask
        and tq == tk
        and tq >= FLASH_MIN_T
        and (d in (64, 128) or (tq >= 3696 and d <= 512 and d % 128 == 0))
    )


def _prescale_q(q: torch.Tensor) -> torch.Tensor:
    d = q.shape[-1]
    return (q.float() * (d ** -0.5 * _LOG2E)).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: base-2 logits from the rounded
    pre-scaled q in f32, f32 softmax, p cast to v's dtype, f32 accumulate."""
    s = _prescale_q(q).float() @ k.float().transpose(-1, -2)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    return (p.float() @ v.float()).to(v.dtype)


@functools.lru_cache(maxsize=None)
def load_library() -> tuple:
    """Build (once per source hash) and load the kernel library.

    Returns (ctypes library, build seconds, nvcc/ptxas log); the log and
    seconds are those of this process's build, or empty/0 when the library
    was already built."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"flash_attention-{key}.so"
    seconds, log = 0.0, ""
    if not lib_path.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the flash-attention kernel "
                               "is built from source with the CUDA toolkit")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {SOURCE.name}:\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for _, name in _ROUTES.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
    return lib, seconds, log


def flash_attention_bhtd(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Unmasked softmax(q kᵀ / sqrt(D)) v over [B, H, T, D]; any Tq, Tk >= 1."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention has no kernel for {q.device}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if (k.shape != (b, h, tk, d) or v.shape != k.shape
            or not (q.dtype == k.dtype == v.dtype)
            or not (q.device == k.device == v.device)):
        raise ValueError(
            f"flash attention: mismatched q/k/v {tuple(q.shape)} "
            f"{tuple(k.shape)} {tuple(v.shape)} {q.dtype} {k.dtype} {v.dtype}")
    route = _ROUTES.get(q.dtype)
    if route is None or d not in route[0]:
        raise ValueError(f"flash attention kernel takes bf16 with d in "
                         f"(64, 128) or f32 with d = 512, not {q.dtype} d={d}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash attention kernel needs contiguous, "
                             "16-byte aligned q/k/v")
    if tq == 0 or tk == 0:
        raise ValueError("flash attention needs at least one query and key")
    name = route[1]
    lib = load_library()[0]
    out = torch.empty_like(q)
    scale = d ** -0.5 * _LOG2E
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), b * h, tq, tk, d, scale,
                                 stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1
    return out
