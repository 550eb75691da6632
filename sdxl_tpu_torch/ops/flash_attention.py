"""Flash attention over [B, H, T, D]: the Hopper kernels and their plain versions.

Counterpart of sdxl_tpu/ops/flash_attention.py:

- ``flash_attention_bhtd``: K1, the forward (return_lse=False);
- ``flash_attention_lse``: K2, the forward that also returns the base-2
  row log-sum-exp (return_lse=True), the residual of the backward;
- ``flash_attention_bwd``: K3a and K3b, the FlashAttention-2 backward
  (``flash_attention_bwd_bhtd``: dq, then dk and dv);
- ``use_flash``, the reference's routing rule.

The kernels live in ``csrc/`` (flash_hopper.cu: K1's bf16 routes and K2's
bf16 route on wgmma and TMA, K1's and K2's f32 d 64 and 128 routes and K1's
f32 d=512 route on TF32 tensor cores; flash_fwd_wgmma.cuh: the bf16 d
64/128 forward kernel of K1 and K2, which flash_experiments.cu instantiates
for the experiments X1 and X2 too, and flash_pipelined.cu for X3 with its
pipelined schedule; flash_hopper_bwd.cu: K3a and K3b bf16
and f32 (d 64 and 128) on wgmma and TMA; hopper_common.cuh: the TMA,
mbarrier and wgmma helpers and the f32 routes' TF32 split and pre-pass,
which both share; the experiments' wrappers live in
``sdxl_tpu_torch/scripts/``). Each source is compiled
with nvcc for sm_90a into a shared library with a plain C interface, at
first use, into ``build/kernels/`` at the repo root (keyed by a hash of
the sources and the flags), and loaded with ctypes; ``build_kernels``
compiles every source at once, one nvcc each, K4's quant_linear.cu too
(its wrapper is ops/quant.py).

Each wrapper takes the plain PyTorch version for tensors on the CPU and
launches its kernel for CUDA tensors; a CUDA call the kernel does not take
raises, as does any other device. Both follow the reference's numerics: q
is pre-scaled by d^-0.5 * log2(e) and rounded to its dtype, the softmax
runs in base 2 over f32 logits, p is rounded to v's dtype before P.V, and
the backward recomputes p from the same rounded q (formed once by
``flash_attention_bwd`` in torch, ``_prescale_q``, and read by both of its
kernels) and the forward's lse.

Kernel routes on CUDA (``_ROUTES`` for K1, ``_TRAIN_ROUTES`` for K2, K3a
and K3b):

- K1, bf16 with d in (64, 128) (the bf16 UNet's self-attention) and d =
  512 (the bf16 VAE decode's mid-block attention): bf16 tensor cores
  (wgmma), K, V by TMA through an mbarrier ring;
- K1, K2, K3a and K3b, f32 with d in (64, 128) (the f32 UNet's
  self-attention and its training forward and backward at d = 64; Flux's
  head width, an f32 Flux forward's and the f32 trainer's, at d = 128):
  TF32 tensor cores (wgmma, operands by TMA) in three passes. One TF32
  product rounds each operand to 10 mantissa bits, about 4e-4 of relative
  L2 error over an attention output, past the f32 bound of 1e-4; split
  into a high and a low TF32 part, a b = a_hi b_hi + a_hi b_lo + a_lo b_hi
  keeps about 2^-21 of each product
  (tests/test_torch_flash_attention.py and
  tests/test_torch_flash_backward.py pin this on the CPU). A pre-pass
  splits (and for the backward transposes) the operands into scratch the
  wrapper allocates (``_tf32_scratch``, ``_bwd_tf32_scratch``);
- K1, f32 with d = 512 (the f32 VAE's mid-block attention, in every f32
  decode and in the training set's encode): TF32 tensor cores in three
  passes on mma.sync, the head dim split over eight warps;
- K2, bf16 with d in (64, 128): K1's bf16 kernel with an lse store;
- K3a and K3b, bf16 with d in (64, 128) (the bf16 trainer): bf16 tensor
  cores (wgmma), the resident rows and the streamed tiles by TMA through
  an mbarrier ring.
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
from typing import Dict, Tuple

import torch

_LOG2E = math.log2(math.e)

# Smallest self-attention token count routed to the kernel: the smallest
# level-2 SDXL bucket (704x1344 -> 22x42 = 924 tokens). Same rule and value
# as the reference gate; not re-derived for the H100 yet.
FLASH_MIN_T = 924

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("flash_hopper.cu", "flash_hopper_bwd.cu", "flash_experiments.cu",
           "flash_pipelined.cu", "quant_linear.cu")
HEADERS = ("flash_common.cuh", "hopper_common.cuh", "flash_fwd_wgmma.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# exported C function -> (source, pointer arguments, float arguments); every
# function then takes (bh, tq, tk, d) ints, the floats, and the stream
_KERNELS = {
    "sdxl_flash_attention_bf16": ("flash_hopper.cu", 4, 1),
    "sdxl_flash_attention_bf16_d512": ("flash_hopper.cu", 4, 1),
    "sdxl_flash_attention_f32_d64": ("flash_hopper.cu", 5, 1),
    "sdxl_flash_attention_f32_d128": ("flash_hopper.cu", 5, 1),
    "sdxl_flash_attention_f32_d512": ("flash_hopper.cu", 4, 1),
    "sdxl_flash_attention_lse_bf16": ("flash_hopper.cu", 5, 1),
    "sdxl_flash_attention_lse_f32_d64": ("flash_hopper.cu", 6, 1),
    "sdxl_flash_attention_lse_f32_d128": ("flash_hopper.cu", 6, 1),
    "sdxl_flash_attention_bwd_dq_bf16": ("flash_hopper_bwd.cu", 7, 1),
    "sdxl_flash_attention_bwd_dkv_bf16": ("flash_hopper_bwd.cu", 8, 0),
    "sdxl_flash_attention_bwd_dq_f32": ("flash_hopper_bwd.cu", 8, 1),
    "sdxl_flash_attention_bwd_dkv_f32": ("flash_hopper_bwd.cu", 9, 0),
    "sdxl_flash_attention_bwd_dq_f32_d128": ("flash_hopper_bwd.cu", 8, 1),
    "sdxl_flash_attention_bwd_dkv_f32_d128": ("flash_hopper_bwd.cu", 9, 0),
    **{f"sdxl_flash2_bf16_q{bq}_k{bk}": ("flash_experiments.cu", 4, 1)
       for bq in (64, 128, 192) for bk in (64, 128)},
    **{f"sdxl_flash_floor_{mode}_bf16": ("flash_experiments.cu", 4, 1)
       for mode in ("full", "qscaled", "noexp", "mxu_only")},
    **{f"sdxl_flash_pipelined_bf16_q{bq}_k{bk}": ("flash_pipelined.cu", 4, 1)
       for bq in (64, 128) for bk in (64, 128)},
}

# K1: (dtype, head dim) -> exported C function
_ROUTES = {
    (torch.bfloat16, 64): "sdxl_flash_attention_bf16",
    (torch.bfloat16, 128): "sdxl_flash_attention_bf16",
    (torch.bfloat16, 512): "sdxl_flash_attention_bf16_d512",
    (torch.float32, 64): "sdxl_flash_attention_f32_d64",
    (torch.float32, 128): "sdxl_flash_attention_f32_d128",
    (torch.float32, 512): "sdxl_flash_attention_f32_d512",
}
# K2, K3a, K3b: (dtype, head dim) -> their exported C functions
_TRAIN_ROUTES = {
    **{(torch.bfloat16, d): ("sdxl_flash_attention_lse_bf16",
                             "sdxl_flash_attention_bwd_dq_bf16",
                             "sdxl_flash_attention_bwd_dkv_bf16")
       for d in (64, 128)},
    (torch.float32, 64): ("sdxl_flash_attention_lse_f32_d64",
                          "sdxl_flash_attention_bwd_dq_f32",
                          "sdxl_flash_attention_bwd_dkv_f32"),
    (torch.float32, 128): ("sdxl_flash_attention_lse_f32_d128",
                           "sdxl_flash_attention_bwd_dq_f32_d128",
                           "sdxl_flash_attention_bwd_dkv_f32_d128"),
}

# Launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one exactly where it launches its kernel.
launch_counts = {name: 0 for name in _KERNELS}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _tf32_scratch(bh: int, tk: int, d: int, device) -> torch.Tensor:
    """K1's and K2's f32 scratch at head dim d (64 or 128): K_hi, K_lo
    [bh, tk, d] and V^T_hi, V^T_lo [bh, d, tp] f32, tp = tk rounded up to a
    multiple of 8."""
    tp = -(-tk // 8) * 8
    return torch.empty(2 * bh * d * (tk + tp), dtype=torch.float32,
                       device=device)


def _with_tf32_scratch(name: str, tensors: tuple, tk: int) -> tuple:
    """`tensors`, and K1's or K2's f32 scratch where the export `name`
    takes one pointer more than them (its pre-pass's; ``_KERNELS``)."""
    if _KERNELS[name][1] == len(tensors):
        return tensors
    q = tensors[0]
    b, h, _, d = q.shape
    return tensors + (_tf32_scratch(b * h, tk, d, q.device),)


def _bwd_tf32_scratch(bh: int, tq: int, tk: int, d: int, dq: bool,
                      device) -> torch.Tensor:
    """K3a's (dq) or K3b's f32 scratch at head dim d (64 or 128): qf, dO, K
    and V each split into hi and lo, [2, bh, T, d], then the transposed
    copies, [2, bh, d, tp] with tp = T rounded up to a multiple of 8: K^T
    for K3a, qf^T and dO^T for K3b."""
    tp = -(-(tk if dq else tq) // 8) * 8
    n = 4 * bh * d * (tq + tk) + (2 if dq else 4) * bh * d * tp
    return torch.empty(n, dtype=torch.float32, device=device)


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




def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in the plain versions' accumulation dtype: f32, or f64 for f64
    inputs (so autograd's gradcheck can run them)."""
    return x if x.dtype == torch.float64 else x.float()


def _prescale_q(q: torch.Tensor) -> torch.Tensor:
    """qf, the reference's rounded pre-scaled q (flash_attention.py:381):
    q * d^-0.5 * log2(e) in f32, rounded to q's dtype."""
    d = q.shape[-1]
    return (_acc(q) * (d ** -0.5 * _LOG2E)).to(q.dtype)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Plain PyTorch version of K2: base-2 logits from the rounded
    pre-scaled q in f32, f32 softmax, p cast to v's dtype, f32 accumulate.
    Returns (o, lse) with lse = m + log2(l) [B, H, Tq] f32, in the base-2
    units of the pre-scaled q."""
    s = _acc(_prescale_q(q)) @ _acc(k).transpose(-1, -2)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (_acc((p / l).to(v.dtype)) @ _acc(v)).to(v.dtype)
    return o, (m + torch.log2(l)).squeeze(-1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: the output of K2's."""
    return flash_attention_lse_plain(q, k, v)[0]


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version of K3a/K3b, the reference's formulas
    (flash_attention.py:250-269): p from the rounded pre-scaled q and lse,
    delta = rowsum(dO * O) in f32, p rounded to dO's dtype before dv, dz
    rounded to k's (qf's) dtype before dq (dk), f32 accumulation."""
    d = q.shape[-1]
    do = do.to(q.dtype)
    qf = _prescale_q(q)
    p = torch.exp2(_acc(qf) @ _acc(k).transpose(-1, -2) - _acc(lse)[..., None])
    delta = (_acc(do) * _acc(o)).sum(-1, keepdim=True)
    dz = p * (_acc(do) @ _acc(v).transpose(-1, -2) - delta)
    dv = _acc(p.to(do.dtype)).transpose(-1, -2) @ _acc(do)
    dq = (_acc(dz.to(k.dtype)) @ _acc(k)) * d ** -0.5
    dk = (_acc(dz.to(qf.dtype)).transpose(-1, -2) @ _acc(qf)) / _LOG2E
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for name in (source, *HEADERS):
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_log(source: str) -> str:
    """The nvcc/ptxas log (``-Xptxas -v``: registers, spills) of one
    source's library, kept beside it when it was built."""
    return _lib_path(source).with_suffix(".log").read_text()


def build_kernels() -> Dict[str, Tuple[float, str]]:
    """Compile every kernel source not built yet, one nvcc per source, all
    started together. Returns {source: (build seconds, nvcc/ptxas log)}
    for the sources this call built."""
    todo = [src for src in SOURCES if not _lib_path(src).exists()]
    if not todo:
        return {}
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the flash-attention kernels are "
                           "built from source with the CUDA toolkit")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for src in todo:
        tmp = _lib_path(src).with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built, failed = {}, []
    for src, (tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {src}:\n{log}")
            continue
        _lib_path(src).with_suffix(".log").write_text(log)
        os.replace(tmp, _lib_path(src))
        built[src] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """The kernel library of one source, built first if needed."""
    if not _lib_path(source).exists():
        build_kernels()
    lib = ctypes.CDLL(str(_lib_path(source)))
    for name, (src, n_ptr, n_float) in _KERNELS.items():
        if src == source:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                           + [ctypes.c_float] * n_float + [ctypes.c_void_p])
    return lib


def _launch(name: str, tensors, dims, floats) -> None:
    device = tensors[0].device
    fn = getattr(load_library(_KERNELS[name][0]), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), *dims, *floats, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1


def _check_cuda(what: str, tensors, routes) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA
    tensor on one device and the first one's (dtype, head dim) is a key of
    ``routes``."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what} has no kernel for {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} kernel needs contiguous, 16-byte "
                             f"aligned inputs")
    q = tensors[0]
    if (q.dtype, q.shape[-1]) not in routes:
        raise ValueError(f"{what} kernel takes (dtype, d) in "
                         f"{sorted(routes, key=str)}, not ({q.dtype}, "
                         f"{q.shape[-1]})")


def _check_qkv(what: str, q, k, v) -> Tuple[int, int, int, int, int]:
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if (k.shape != (b, h, tk, d) or v.shape != k.shape
            or not (q.dtype == k.dtype == v.dtype)):
        raise ValueError(
            f"{what}: mismatched q/k/v {tuple(q.shape)} {tuple(k.shape)} "
            f"{tuple(v.shape)} {q.dtype} {k.dtype} {v.dtype}")
    if tq == 0 or tk == 0:
        raise ValueError(f"{what} needs at least one query and key")
    return b, h, tq, tk, d


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def flash_attention_bhtd(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """K1: unmasked softmax(q kᵀ / sqrt(D)) v over [B, H, T, D]; any
    Tq, Tk >= 1; on CUDA bf16 or f32 with d in (64, 128, 512)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    b, h, tq, tk, d = _check_qkv("flash attention", q, k, v)
    if d not in (64, 128, 512):
        raise ValueError(f"flash attention kernel takes d in (64, 128, 512), "
                         f"not {d}: use_flash also routes d 256 and 384, but "
                         f"no SDXL path of the port or the reference has "
                         f"such a head")
    _check_cuda("flash attention", (q, k, v), _ROUTES)
    out = torch.empty_like(q)
    name = _ROUTES[q.dtype, d]
    tensors = _with_tf32_scratch(name, (q, k, v, out), tk)
    _launch(name, tensors, (b * h, tq, tk, d), (d ** -0.5 * _LOG2E,))
    return out


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: K1's output and the base-2 row log-sum-exp lse [B, H, Tq] f32;
    on CUDA bf16 or f32 with d in (64, 128)."""
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v)
    b, h, tq, tk, d = _check_qkv("flash attention (lse)", q, k, v)
    _check_cuda("flash attention (lse)", (q, k, v), _TRAIN_ROUTES)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    name = _TRAIN_ROUTES[q.dtype, d][0]
    tensors = _with_tf32_scratch(name, (q, k, v, out, lse), tk)
    _launch(name, tensors, (b * h, tq, tk, d), (d ** -0.5 * _LOG2E,))
    return out, lse


def launch_bwd_dq(qf, k, v, do, lse, delta) -> torch.Tensor:
    """K3a alone (flash_attention_bwd's first launch; exposed to time the
    kernel by itself): dq from the pre-scaled qf (``_prescale_q``), k, v,
    do of one dtype and f32 lse, delta."""
    b, h, tq, tk, d = _check_qkv("flash attention backward", qf, k, v)
    _check_cuda("flash attention backward", (qf, k, v, do, lse, delta),
                _TRAIN_ROUTES)
    dq = torch.empty_like(qf)
    name = _TRAIN_ROUTES[qf.dtype, d][1]
    tensors = (qf, k, v, do, lse, delta, dq)
    if qf.dtype == torch.float32:
        tensors += (_bwd_tf32_scratch(b * h, tq, tk, d, True, qf.device),)
    _launch(name, tensors, (b * h, tq, tk, d), (d ** -0.5,))
    return dq


def launch_bwd_dkv(qf, k, v, do, lse, delta
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3b alone (flash_attention_bwd's second launch): dk and dv from the
    same inputs as ``launch_bwd_dq``."""
    b, h, tq, tk, d = _check_qkv("flash attention backward", qf, k, v)
    _check_cuda("flash attention backward", (qf, k, v, do, lse, delta),
                _TRAIN_ROUTES)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    name = _TRAIN_ROUTES[qf.dtype, d][2]
    tensors = (qf, k, v, do, lse, delta, dk, dv)
    if qf.dtype == torch.float32:
        tensors += (_bwd_tf32_scratch(b * h, tq, tk, d, False, qf.device),)
    _launch(name, tensors, (b * h, tq, tk, d), ())
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3a then K3b: (dq, dk, dv) of unmasked flash attention from the
    forward's inputs, its output o, its lse and the output cotangent do.
    qf (``_prescale_q``) and delta = rowsum(dO * O) are formed here in
    torch, as the reference forms them outside its kernels; both kernels
    read them."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do)
    b, h, tq = q.shape[:3]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, tq):
        raise ValueError(f"flash attention backward: o {tuple(o.shape)}, "
                         f"do {tuple(do.shape)}, lse {tuple(lse.shape)} do "
                         f"not match q {tuple(q.shape)}")
    do = do.to(q.dtype).contiguous()
    lse = lse.float().contiguous()
    delta = (do.float() * o.float()).sum(-1)
    qf = _prescale_q(q)
    dq = launch_bwd_dq(qf, k, v, do, lse, delta)
    return (dq, *launch_bwd_dkv(qf, k, v, do, lse, delta))
