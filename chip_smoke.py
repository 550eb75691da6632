"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Run from the repo root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. the device, and `nvidia-smi` name and power limit;
  2. build the hand-written kernels from sdxl_tpu_torch/csrc, one nvcc per
     source, all started together (with the -Xptxas -v report); then
     `cuobjdump -sass` of flash_hopper.cu's, flash_hopper_bwd.cu's and
     flash_experiments.cu's libraries: K1's bf16 d 64/128 kernel and K2
     (its lse instances) must hold HGMMA (wgmma) and UTMALDG (TMA)
     instructions, K1's bf16 d=512 kernel HGMMA or HMMA, K1's and K2's f32
     d=64 kernel (3xTF32) HGMMA and UTMALDG, K1's f32 d=512 kernel (3xTF32
     on mma.sync) HMMA, K3a's and K3b's bf16 kernels (dq and dk/dv, d 64
     and 128) and their f32 d=64 kernels (3xTF32) HGMMA and UTMALDG, every
     X1 and X2 instance of K1's kernel HGMMA and UTMALDG, and ptxas must
     report no spills for any of them (counts, registers and shared memory
     printed);
  3. each kernel against its plain PyTorch version on the card at the
     main paths' shapes (and K2/K3 at a token count no multiple of 4) —
     K1 on every route (bf16 d 64/128 and 512, f32 d
     64/128 and 512), K2, K3a, K3b in bf16 and in f32: K1 and K2's output
     within the tolerance times min(1, max|plain output|) and a relative
     L2 error within 1e-2 bf16 / 1e-4 f32; K2's lse within 1e-3; K3's dq,
     dk, dv within 2e-2 (bf16) or 1e-3 (f32) of max(1, max|plain|) and a
     relative L2 error within 1e-2 / 1e-4; each reading printed beside its
     limit; every output finite, with the kernels' outputs and scratch
     allocated NaN-filled (an element read or returned unwritten fails).
     The kernel, its plain
     version and torch's scaled_dot_product_attention (forward, and
     backward for K3; a yardstick, never on the path) timed with CUDA
     events after a warm-up, beside the kernel's bound; K2, K3a, K3b (in
     both dtypes) and the f32 d=64 route (and SDPA's forward beside the
     forwards) also inside one CUDA graph of 20 calls, SDPA's backward as
     its kernels' device time (torch.profiler);
  3b. the experiments X1 (every tile), X2 (every mode) and X3 (every
     tile) against their plain versions at [2,10,4096,64] and
     [2,20,1024,64] bf16, timed by `timeit`, `chained_time` and inside one
     CUDA graph, with SDPA where the function is attention, and X2's split
     of the time at K1's tile beside K1's own chained time, each as a
     share of the bound;
  4. the experiment path: the four `sdxl_tpu_torch.scripts` mains
     (exp_flash_exp2, exp_flash_floor, exp_flash_pipelined,
     bench_flash_ragged, whose seven cases must agree with the plain
     attention within 3e-2); every X kernel must have been launched;
  5. the f32 UNet: random_pipeline(unet_dtype=torch.float32,
     with_encoder=True) answers one 1024x1024 request (K1's f32 d=64 route
     in the UNet, its f32 d=512 route in the decode); then one
     pair-batched CFG UNet call through K1 and through the plain
     attention: eps within 2e-3 relative, 70 launches of the f32 d=64
     route;
  5b. the f32 LoRA training path (the reference's `train --f32`) on the
     same pipeline: encode two random 1024x1024 images (K1's f32 d=512
     route), three LoRA steps (rank 16, attn targets, batch 1, remat) —
     time and loss per step, peak memory; the losses must be finite, the
     ups must have moved, and K2's f32 d=64 route, K3a and K3b's f32
     routes and K1's f32 d=512 route must have been launched; then one
     step's factor gradients again with the plain attention: max|dg| /
     max|g| within 2e-3 (the reference's f32 UNet bound); with --profile
     three timed steps and one under torch.profiler, as phase 12; the f32
     pipeline is freed;
  6. the txt2img path: random_pipeline(device="cuda") at SDXL-base widths
     answers three requests (two at 1024x1024, one at 832x1216 for the
     ragged token counts), 30 DDIM steps, CFG 7.5 — latency, stage split
     and peak memory per request; the final latents must be finite, the
     images [B, H, W, 3] uint8, and K1 must have been launched from the
     UNet and from the VAE during these requests (its d 64/128 route 2170
     times in each 1024x1024 request: 31 UNet calls x 70);
  7. the last request's UNet step and VAE decode again with the plain
     attention in place of the kernel: outputs must agree;
  8. the bf16 decode: one 1024x1024 request with vae_dtype=torch.bfloat16
     (K1's bf16 d=512 route); then its decode through K1 and through the
     plain attention: the mid-block attention on the decode's own inputs
     within the bf16 bound, the two images within 1 u8 level on average,
     and the kernel's image as close to the f32 decode of the same latent
     as the plain attention's (max + 1 level, mean + 0.05);
  9. with --profile only: three unfenced 1024x1024 requests, then one
     under torch.profiler — device time by the op that launched each
     kernel, and the device's idle share against the unfenced latency;
     the same for the f32 UNet's 4-step request after phase 5;
  10. the LoRA training path on the same pipeline: encode two random
     1024x1024 images with captions (the VAE encoder launches K1's f32
     d=512 route), then five LoRA steps (rank 16, attn targets, lr 1e-4,
     batch 1, remat) — time and loss per step, peak memory; the losses
     must be finite, the ups must have moved, and K2 must have been
     launched during the steps, K3a and K3b 70 times a step each (one
     backward of each of the UNet's 70 self-attentions);
  11. one training step's factor gradients again with the plain attention
     (forward and backward) in place of the kernels: they must agree;
  12. with --profile only: three timed LoRA steps, then one under
     torch.profiler, reported as in phase 9.
Each path (phases 4, 5, 5b, 6, 8, 10) runs with the launch counts set to
0 just before it and read just after; the JSON record's launches are their
sum. Each phase's seconds are printed. The last two lines are the kernels'
JSON record and {"ok": true, ...}.
"""

import argparse
import contextlib
import ctypes
import functools
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter, defaultdict

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

from sdxl_tpu_torch.models.unet import unet_forward
from sdxl_tpu_torch.ops import attention as attention_mod
from sdxl_tpu_torch.ops import flash_attention as fa
from sdxl_tpu_torch.pipeline.latent import decode_latent_to_images
from sdxl_tpu_torch.pipeline.pipeline import random_pipeline
from sdxl_tpu_torch.pipeline.sampler import _cfg_contexts
from sdxl_tpu_torch.scripts import bench_flash_ragged
from sdxl_tpu_torch.scripts import exp_flash_exp2 as x1
from sdxl_tpu_torch.scripts import exp_flash_floor as x2
from sdxl_tpu_torch.scripts import exp_flash_pipelined as x3
from sdxl_tpu_torch.scripts.timing import chained_time, graph_time, timeit
from sdxl_tpu_torch.train.finetune import (
    FinetuneConfig,
    _encode_items,
    _unet_loss_fn,
    finetune_lora,
    sample_batch,
)
from sdxl_tpu_torch.train.lora import clear_factors
from sdxl_tpu_torch.train.step import (
    TrainState,
    adamw_cosine,
    make_train_step,
    value_and_grad,
)

CSRC = "sdxl_tpu_torch/csrc"
REF = "sdxl_tpu/ops/flash_attention.py"
F32_D64 = "sdxl_flash_attention_f32_d64"
F32_D512 = "sdxl_flash_attention_f32_d512"
# the kernels on TF32 tensor cores in three passes: K1 f32 d 64 and 512,
# K2, K3a and K3b f32 d 64
TF32_KERNELS = (F32_D64, F32_D512, *fa._TRAIN_ROUTES[torch.float32, 64])
# kernel -> (source, the TPU kernel it replaces): K1's routes, then K2,
# K3a and K3b's (the reference's kernel :102, :272, :302)
KERNELS = {
    **{name: (f"{CSRC}/{fa._KERNELS[name][0]}", f"{REF}:140")
       for name in set(fa._ROUTES.values())},
    **{name: (f"{CSRC}/{fa._KERNELS[name][0]}", f"{REF}:{line}")
       for names in fa._TRAIN_ROUTES.values()
       for name, line in zip(names, (102, 272, 302))},
    **{f"sdxl_flash2_bf16_q{bq}_k{bk}": (f"{CSRC}/flash_experiments.cu",
                                         "scripts/exp_flash_exp2.py:71")
       for bq, bk in x1.TILES},
    **{f"sdxl_flash_floor_{m}_bf16": (f"{CSRC}/flash_experiments.cu",
                                      "scripts/exp_flash_floor.py:91")
       for m in x2.MODES},
    **{f"sdxl_flash_pipelined_bf16_q{bq}_k{bk}": (
        f"{CSRC}/flash_pipelined.cu", "scripts/exp_flash_pipelined.py:94")
       for bq, bk in x3.TILES},
}
# (B, H, T, D, dtype, tolerance): K1's shapes on the paths — the bf16 UNet
# (bench.py:53-66) at levels 2 and 1 at 1024x1024, 832x1216 and the
# smallest buckets (924 and 3696 tokens, where 128-row tiles are most
# ragged), the f32 VAE mid-block attention at 1024x1024, the f32 UNet at
# 1024x1024 and 832x1216 (ragged 64-key tiles) and the bf16 VAE decode at
# 1024x1024, 832x1216 and the
# smallest VAE bucket (14336 tokens), the f32 VAE's likewise — plus one
# d=128 case of each dtype,
# routes the SDXL-base paths do not take. The max abs error's limit is the
# tolerance times min(1, max|plain output|): with random inputs each output
# is an average over about a thousand keys or more, 0.01-0.5 in size, so a
# bare 2e-2 would pass an error of several percent of the output. The
# error's L2 norm over the plain output's must also stay under
# K1_REL_TOL, which catches an error of a percent or two spread over
# every row (a sound bf16 kernel reads about 3e-3: both outputs are
# rounded to bf16)
KERNEL_CASES = [
    (2, 20, 1024, 64, torch.bfloat16, 2e-2),
    (2, 10, 4096, 64, torch.bfloat16, 2e-2),
    (2, 10, 3952, 64, torch.bfloat16, 2e-2),
    (2, 20, 988, 64, torch.bfloat16, 2e-2),
    (2, 20, 924, 64, torch.bfloat16, 2e-2),
    (2, 10, 3696, 64, torch.bfloat16, 2e-2),
    (1, 1, 16384, 512, torch.float32, 1e-3),
    (1, 1, 15808, 512, torch.float32, 1e-3),
    (1, 1, 14336, 512, torch.float32, 1e-3),
    (1, 2, 1000, 128, torch.bfloat16, 2e-2),
    (2, 10, 4096, 64, torch.float32, 1e-3),
    (2, 20, 1024, 64, torch.float32, 1e-3),
    (2, 10, 3952, 64, torch.float32, 1e-3),
    (2, 20, 988, 64, torch.float32, 1e-3),
    (1, 2, 1000, 128, torch.float32, 1e-3),
    (1, 1, 16384, 512, torch.bfloat16, 2e-2),
    (1, 1, 15808, 512, torch.bfloat16, 2e-2),
    (1, 1, 14336, 512, torch.bfloat16, 2e-2),
]
K1_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# The kernels of the Hopper sources: for each source, its export that
# gives a kernel's dynamic shared memory (from the kernel's index and the
# first three int template arguments of its symbol, 0 where it has fewer),
# and for each kernel a pattern its symbols must match, how many instances
# it has, its kernel index in that export, and the SASS instructions it
# must contain (one of each tuple). flash_fwd_wgmma<D, NC, BK, LSE, MODE>
# (MODE 0 is K1's q pre-scale, 1-4 X2's full, qscaled, noexp and mxu_only)
# is K1's and K2's kernel and every X1 and X2 instance; flash_fwd_tf32's
# bool is LSE
WGMMA_TMA = (("HGMMA",), ("UTMALDG",))
FWD = r"flash_fwd_wgmmaILi\d+ELi\d+ELi\d+E"
HOPPER_SASS = {
    "flash_hopper.cu": ("flash_hopper_smem_bytes", [
        ("K1 bf16 d 64/128", FWD + "Lb0ELi0E", 2, 0, WGMMA_TMA),
        ("K2 bf16 d 64/128", FWD + "Lb1ELi0E", 2, 0, WGMMA_TMA),
        ("K1 bf16 d 512", r"flash_fwd_d512", 1, 1, (("HGMMA", "HMMA"),)),
        ("K1 f32 d 64 (3xTF32)", r"flash_fwd_tf32ILb0E", 1, 2, WGMMA_TMA),
        ("K2 f32 d 64 (3xTF32)", r"flash_fwd_tf32ILb1E", 1, 2, WGMMA_TMA),
        ("K1 f32 d 512 (3xTF32, mma.sync)", r"flash_fwd_f32_d512", 1, 3,
         (("HMMA",),)),
    ]),
    "flash_hopper_bwd.cu": ("flash_hopper_bwd_smem_bytes", [
        ("K3a bf16 d 64/128", r"flash_bwd_dq_wgmmaILi\d+E", 2, 0, WGMMA_TMA),
        ("K3b bf16 d 64/128", r"flash_bwd_dkv_wgmmaILi\d+E", 2, 1, WGMMA_TMA),
        ("K3a f32 d 64 (3xTF32)", r"flash_bwd_dq_tf32", 1, 2, WGMMA_TMA),
        ("K3b f32 d 64 (3xTF32)", r"flash_bwd_dkv_tf32", 1, 3, WGMMA_TMA),
    ]),
    "flash_experiments.cu": ("flash_experiments_smem_bytes", [
        ("X1 (six tiles) and X2 full", FWD + "Lb0ELi1E", 6, 0, WGMMA_TMA),
        *((f"X2 {mode}", FWD + f"Lb0ELi{i}E", 1, 0, WGMMA_TMA)
          for i, mode in enumerate(("qscaled", "noexp", "mxu_only"), 2)),
    ]),
}
# K2 and K3's shapes on the training path (batch 1), bf16 and f32: UNet
# levels 1 and 2 at 1024x1024 and at 832x1216, one d=128 case, and a
# token count that is no multiple of 4 at B*H > 1 (the second head's rows
# of lse and delta then start off a 16-byte boundary).
# Tolerances (bench.py:53-66): K2's o as K1's (2e-2 / 1e-3 of min(1,
# max|o|), relative L2 1e-2 / 1e-4), lse (f32, base-2 units) 1e-3
# absolute, and the gradients 2e-2 / 1e-3 of max(1, their largest
# magnitude) and relative L2 1e-2 / 1e-4 each
TRAIN_CASES = [
    (1, 10, 4096, 64),
    (1, 20, 1024, 64),
    (1, 10, 3952, 64),
    (1, 20, 988, 64),
    (1, 2, 1000, 128),
    (1, 3, 333, 64),
]
BF16_TOL, LSE_TOL = 2e-2, 1e-3
# dtype -> (o and gradient tolerance, relative L2 tolerance)
TRAIN_TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (1e-3, 1e-4)}
# K2's and the f32 d=64 route's calls are also timed as one CUDA graph of
# GRAPH_CALLS calls (no host launch between them), as is SDPA's forward
GRAPH_CALLS = 20
# the shape each kernel's reported time is taken at (the experiments':
# EXP_SHAPES[0])
TIMED_SHAPE = {"sdxl_flash_attention_bf16": (2, 10, 4096, 64),
               "sdxl_flash_attention_f32_d512": (1, 1, 16384, 512),
               "sdxl_flash_attention_f32_d64": (2, 10, 4096, 64),
               "sdxl_flash_attention_f32_d128": (1, 2, 1000, 128),
               "sdxl_flash_attention_bf16_d512": (1, 1, 16384, 512),
               "sdxl_flash_attention_lse_bf16": (1, 10, 4096, 64),
               "sdxl_flash_attention_bwd_dq_bf16": (1, 10, 4096, 64),
               "sdxl_flash_attention_bwd_dkv_bf16": (1, 10, 4096, 64),
               "sdxl_flash_attention_lse_f32_d64": (1, 10, 4096, 64),
               "sdxl_flash_attention_lse_f32_d128": (1, 2, 1000, 128),
               "sdxl_flash_attention_bwd_dq_f32": (1, 10, 4096, 64),
               "sdxl_flash_attention_bwd_dkv_f32": (1, 10, 4096, 64),
               "sdxl_flash_attention_bwd_dq_f32_d128": (1, 2, 1000, 128),
               "sdxl_flash_attention_bwd_dkv_f32_d128": (1, 2, 1000, 128)}
EXP_SHAPES = [shape for _, shape in x1.SHAPES]
# the H100 SXM's published dense peaks (NVIDIA H100 datasheet): bf16 and
# f32 FMA, and TF32 for TF32_KERNELS, which run three TF32 passes of each
# product
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32_PEAK, TF32_PASSES = 495e12, 3
PEAK_BYTES = 3.35e12
REQUESTS = [((1024, 1024), 1), ((1024, 1024), 2), ((832, 1216), 3)]
# K1 d 64/128 launches in one bf16 1024x1024 request of 30 DDIM steps: 31
# UNet calls (the reference's 31-entry timestep grid) x 70 self-attentions
UNET_LAUNCHES_1024 = 31 * 70
# the f32 pipeline's request: 4 DDIM steps (4 UNet calls) keep its cost
# near one bf16 request's
F32_STEPS = 4
PROMPT = "a photograph of an astronaut riding a horse"
# kernel vs plain attention inside the real path, relative to the output's
# largest magnitude: bf16 UNet eps, f32 VAE image in u8 levels, and the
# LoRA factor gradients of one training step (max |dg| / max |g|)
UNET_REL_TOL = 2e-2
VAE_LEVEL_TOL = 1
# the f32 UNet's eps, kernel vs plain attention: the reference's UNet
# bound (goldens/full_scale). The bf16 decode, kernel vs plain attention:
# bf16 rounds at other places in the two attentions, and the bf16 decoder
# carries a one-ulp change of the mid-block attention to up to 7 u8 levels
# at a pixel (0.64 on average) — as far as two plain attentions with
# different rounding points differ — so the images are held to a mean
# distance and to their distance from the f32 decode, and the attention
# itself to the bf16 bound
F32_UNET_REL_TOL = 2e-3
BF16_VAE_MEAN_TOL = 1.0
BF16_VAE_F32_SLACK = (1, 0.05)  # (max, mean) levels over the plain's
GRAD_REL_TOL = 5e-2
# the f32 trainer's factor gradients, kernels vs plain attention: the
# reference's f32 UNet bound (goldens/full_scale)
F32_GRAD_REL_TOL = 2e-3
TRAIN_RES = 1024
CAPTIONS = ["a photograph of an astronaut riding a horse",
            "a red crab on a sandy beach, (masterpiece:1.2)"]
TRAIN_STEPS = 5
F32_TRAIN_STEPS = 3
# the UNet's self-attentions at 1024x1024 (10 at level 1, 60 at level 2):
# each step runs one backward of each, one launch of K3a and one of K3b
TRAIN_ATTENTIONS = 70
ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = GRAPH_CALLS, iters: int = 5) -> float:
    """ms per call of fn inside one CUDA graph of `calls` calls: the
    device's time with no host launch between the calls."""
    def run():
        for _ in range(calls):
            fn()
    return graph_time(run, iters) * 1e3 / calls


def kernel_ms(fn, iters: int) -> float:
    """ms per call of fn as the device time of the kernels it launches,
    summed from torch.profiler over `iters` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if us == 0:
        fail("the profiler recorded no device time")
    return us / 1e3 / iters


def bound(name: str, shape, dtype) -> tuple:
    """(least ms, "operations" | "bytes") of one call at `shape`: the
    larger of its operations (the reference's counts, 4, 6 and 8 x
    B*H*T^2*D for the forward, dq and dk/dv; three times the forward's
    at the TF32 rate for TF32_KERNELS) over the peak rate for its
    type, and its bytes (each input read once, each output written once)
    over the memory rate."""
    b, h, t, d = shape
    n = b * h * t * d * torch.tensor([], dtype=dtype).element_size()
    rows = b * h * t * 4  # one f32 per row: lse, delta
    # every other kernel is a forward: q, k, v in, o out (X2's variants
    # have the forward's products)
    if "_lse_" in name:
        mult, nbytes = 4, 4 * n + rows
    elif "_bwd_dq_" in name:
        mult, nbytes = 6, 5 * n + 2 * rows
    elif "_bwd_dkv_" in name:
        mult, nbytes = 8, 6 * n + 2 * rows
    else:
        mult, nbytes = 4, 4 * n
    peak = PEAK_FLOPS[dtype]
    if name in TF32_KERNELS:
        mult, peak = mult * TF32_PASSES, TF32_PEAK
    ops_ms = mult * b * h * t * t * d / peak * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def sdpa_backend(q, k, v) -> str:
    """The longest device kernel of one scaled_dot_product_attention call
    (names the backend torch picked)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return "unknown"
    return max(kernels, key=lambda e: e.time_range.elapsed_us()).name[:90]


def record_case(results, name, shape, dtype, err, ms, plain_ms, sdpa_ms,
                chained_ms=None, timed_shape=None, graph=None):
    """Print one case's readings and keep the timed shape's in `results`;
    graph: (kernel, SDPA or None) ms per call inside one CUDA graph."""
    bound_ms, bound_by = bound(name, shape, dtype)
    sdpa = "n/a" if sdpa_ms is None else f"{sdpa_ms:.4f}"
    chained = "" if chained_ms is None else f" chained_ms={chained_ms:.4f}"
    graphed = "" if graph is None else f" graph_ms={graph[0]:.4f}"
    if graph is not None and graph[1] is not None:
        graphed += f" sdpa_graph_ms={graph[1]:.4f}"
    print(f"  {name} shape={shape} max_abs_err={err:.3e} kernel_ms={ms:.4f}"
          f"{chained}{graphed} plain_ms={plain_ms:.4f} sdpa_ms={sdpa} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) "
          f"share_of_bound={bound_ms / ms:.3f}", flush=True)
    r = results.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if shape == (timed_shape or TIMED_SHAPE[name]):
        r.update(ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms,
                 bound_ms=bound_ms, bound_by=bound_by)
        if chained_ms is not None:
            r["chained_ms"] = chained_ms
        if graph is not None:
            r["graph_ms"], r["library_graph_ms"] = graph


@contextlib.contextmanager
def nan_filled_empty():
    """Inside, torch.empty fills floating memory with NaN (deterministic
    mode's fill_uninitialized_memory): an output element or a scratch
    element that a kernel reads (the f32 routes' pre-pass copies, their
    zero padding included) and nothing wrote shows as NaN."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.utils.deterministic.fill_uninitialized_memory = True
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def readings(got, want) -> tuple:
    """(max abs error, relative L2 error, max |want|), in f32."""
    diff = got.float() - want.float()
    return (diff.abs().max().item(), (diff.norm() / want.float().norm()).item(),
            want.float().abs().max().item())


def check_k1(results) -> None:
    for b, h, t, d, dtype, tol in KERNEL_CASES:
        g = torch.Generator(device="cuda").manual_seed(42)
        q, k, v = (torch.randn((b, h, t, d), generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        if not fa.use_flash(t, t, d, False):
            fail(f"use_flash does not route {(b, h, t, d)}")
        with nan_filled_empty():
            out = fa.flash_attention_bhtd(q, k, v)
        ref = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err, rel, ref_max = readings(out, ref)
        limit, rel_tol = tol * min(1.0, ref_max), K1_REL_TOL[dtype]
        finite = bool(torch.isfinite(out).all())
        name = fa._ROUTES[dtype, d]
        print(f"K1 {(b, h, t, d)} {dtype}: max|ref| {ref_max:.4e}, limit "
              f"{limit:.4e} ({tol:g} of min(1, max|ref|)); relative L2 "
              f"error {rel:.4e} (tol {rel_tol:g}); sdpa backend "
              f"{sdpa_backend(q, k, v)}", flush=True)
        if not (finite and err < limit and rel < rel_tol):
            fail(f"{name} at {(b, h, t, d)}: max_abs_err {err} (limit "
                 f"{limit}), relative L2 error {rel} (limit {rel_tol}), "
                 f"finite {finite}")
        iters = 5 if d == 512 or dtype == torch.float32 else 20
        graph = None
        if name == F32_D64:
            graph = (graph_ms(lambda: fa.flash_attention_bhtd(q, k, v)),
                     graph_ms(lambda: F.scaled_dot_product_attention(q, k, v)))
        record_case(
            results, name, (b, h, t, d), dtype, err,
            cuda_ms(lambda: fa.flash_attention_bhtd(q, k, v), iters),
            cuda_ms(lambda: fa.flash_attention_plain(q, k, v), iters),
            cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters),
            graph=graph)


def check_train_kernels(results) -> None:
    """K2, K3a and K3b against their plain versions at TRAIN_CASES, in bf16
    and f32, each reading printed beside its limit; then timed."""
    for dtype, shape in ((dt, sh) for dt in TRAIN_TOL for sh in TRAIN_CASES):
        b, h, t, d = shape
        tol, rel_tol = TRAIN_TOL[dtype]
        k2, k3a, k3b = fa._TRAIN_ROUTES[dtype, d]
        g = torch.Generator(device="cuda").manual_seed(43)
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                       .to(dtype) for _ in range(4))
        ref_o, ref_lse = fa.flash_attention_lse_plain(q, k, v)
        with nan_filled_empty():
            o, lse = fa.flash_attention_lse(q, k, v)
            grads = fa.flash_attention_bwd(q, k, v, ref_o, ref_lse, do)
        ref_grads = fa.flash_attention_bwd_plain(q, k, v, ref_o, ref_lse, do)
        torch.cuda.synchronize()
        err_o, rel_o, max_o = readings(o, ref_o)
        err_lse = (lse - ref_lse).abs().max().item()
        checks = [("o max abs", err_o, tol * min(1.0, max_o)),
                  ("o relative L2", rel_o, rel_tol),
                  ("lse max abs", err_lse, LSE_TOL)]
        errs = []
        for what, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
            err, rel, max_g = readings(got, want)
            errs.append(err)
            checks += [(f"{what} max abs", err, tol * max(1.0, max_g)),
                       (f"{what} relative L2", rel, rel_tol)]
        finite = all(bool(torch.isfinite(x).all())
                     for x in (o, lse, *grads))
        print(f"K2/K3 {shape} {dtype} (reading / limit): " + ", ".join(
            f"{what} {got:.3e} / {lim:.3e}" for what, got, lim in checks),
            flush=True)
        bad = [f"{what} {got} (limit {lim})" for what, got, lim in checks
               if not got < lim]
        if bad or not finite:
            fail(f"K2/K3 {dtype} at {shape}: {', '.join(bad)}; finite "
                 f"{finite}")

        iters = 20
        delta = (do.float() * ref_o.float()).sum(-1)
        qf = fa._prescale_q(q)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        sdpa_o = F.scaled_dot_product_attention(qg, kg, vg)
        # SDPA's backward as the device time of its kernels (the host's
        # autograd work between them left out)
        sdpa_bwd_ms = kernel_ms(lambda: torch.autograd.grad(
            sdpa_o, (qg, kg, vg), do, retain_graph=True), iters)
        plain_bwd_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, ref_o, ref_lse, do), 5)
        record_case(
            results, k2, shape, dtype, max(err_o, err_lse),
            cuda_ms(lambda: fa.flash_attention_lse(q, k, v), iters),
            cuda_ms(lambda: fa.flash_attention_lse_plain(q, k, v), iters),
            cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters),
            graph=(graph_ms(lambda: fa.flash_attention_lse(q, k, v)),
                   graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))))
        # the plain version and torch's backward compute dq, dk and dv
        # together: both rows carry their whole time. K3 is also timed
        # inside a CUDA graph: at level 2 a call's host work (checks, four
        # or six tensor maps) is about as long as the kernel
        args = (qf, k, v, do, ref_lse, delta)
        dq_call = functools.partial(fa.launch_bwd_dq, *args)
        dkv_call = functools.partial(fa.launch_bwd_dkv, *args)
        record_case(results, k3a, shape, dtype, errs[0],
                    cuda_ms(dq_call, iters), plain_bwd_ms, sdpa_bwd_ms,
                    graph=(graph_ms(dq_call), None))
        record_case(results, k3b, shape, dtype, max(errs[1:]),
                    cuda_ms(dkv_call, iters), plain_bwd_ms, sdpa_bwd_ms,
                    graph=(graph_ms(dkv_call), None))


def experiment_kernels():
    """(kernel, wrapper, plain version, mode) of X1-X3; the mode is X2's,
    "attention" for the functions that are attention."""
    kernels = [(f"sdxl_flash2_bf16_q{bq}_k{bk}",
                functools.partial(x1.flash2, block_q=bq, block_k=bk),
                x1.flash2_plain, "attention") for bq, bk in x1.TILES]
    kernels += [(f"sdxl_flash_floor_{m}_bf16",
                 functools.partial(x2.attn, mode=m),
                 functools.partial(x2.attn_plain, mode=m), m)
                for m in x2.MODES]
    kernels += [(f"sdxl_flash_pipelined_bf16_q{bq}_k{bk}",
                 functools.partial(x3.flash_pipelined, bq=bq, bk=bk),
                 fa.flash_attention_plain, "attention") for bq, bk in x3.TILES]
    return kernels


def nan_aware_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Max abs difference, counting NaN where the plain version is NaN as
    agreement and NaN anywhere else as infinitely wrong."""
    d = (out.float() - ref.float()).abs()
    d = torch.where(out.isnan() & ref.isnan(), torch.zeros_like(d), d)
    return torch.nan_to_num(d, nan=float("inf")).max().item()


def check_experiments(results) -> None:
    """X1-X3 against their plain versions, each first call with torch.empty
    NaN-filled (an unstored row, such as a query tile's past T, fails):
    the attention outputs within 2e-2 of min(1, max|ref|) and mxu_only
    within 2e-2 of max|ref|, both with a relative L2 error under K1's
    bf16 limit; noexp NaN everywhere in both. Then timed by timeit,
    chained_time and inside one CUDA graph, and X2's split beside K1's
    chained time."""
    for shape in EXP_SHAPES:
        q, k, v = x1.random_qkv(shape, seed=44)
        sdpa_ms = timeit(F.scaled_dot_product_attention, q, k, v,
                         iters=20) * 1e3
        sdpa_graph_ms = graph_ms(
            lambda: F.scaled_dot_product_attention(q, k, v))
        # K1, and qscaled's kernel alone (its wrapper's pre-scale of q, a
        # torch op, left out): K1 less it is K1's in-kernel pre-scale
        qscaled_kernel = functools.partial(
            x1.launch_tiled, "sdxl_flash_floor_qscaled_bf16", "qscaled",
            block_q=x2.TILE[0], block_k=x2.TILE[1], tiles=(x2.TILE,))
        split = {"K1": chained_time(fa.flash_attention_bhtd, q, k, v) * 1e6,
                 "qscaled kernel": chained_time(
                     qscaled_kernel, fa._prescale_q(q), k, v) * 1e6}
        for name, f, plain, mode in experiment_kernels():
            with nan_filled_empty():
                out = f(q, k, v)
            ref = plain(q, k, v)
            torch.cuda.synchronize()
            err = nan_aware_err(out, ref)
            if mode == "noexp":
                ok = bool(out.isnan().all()) and bool(ref.isnan().all())
                tol = "NaN everywhere in both"
            else:
                _, rel, ref_max = readings(out, ref)
                limit = BF16_TOL * (ref_max if mode == "mxu_only"
                                    else min(1.0, ref_max))
                rel_tol = K1_REL_TOL[torch.bfloat16]
                ok = err < limit and rel < rel_tol
                tol = (f"max abs error {err:.4e} (limit {limit:.4e}), "
                       f"relative L2 error {rel:.4e} (limit {rel_tol:g})")
            print(f"{name} {shape}: {tol}", flush=True)
            if not ok:
                fail(f"{name} at {shape}: max_abs_err {err} against its "
                     f"plain version ({tol})")
            ms = timeit(f, q, k, v, iters=20) * 1e3
            chained_ms = chained_time(f, q, k, v) * 1e3
            plain_ms = timeit(plain, q, k, v, iters=3) * 1e3
            attention = mode in ("attention", "full", "qscaled")
            graph = (graph_ms(lambda: f(q, k, v)),
                     sdpa_graph_ms if attention else None)
            record_case(results, name, shape, torch.bfloat16, err, ms,
                        plain_ms, sdpa_ms if attention else None,
                        chained_ms, timed_shape=EXP_SHAPES[0], graph=graph)
            if mode != "attention":
                split[mode] = chained_ms * 1e3
        full = split["full"]
        bound_us = bound("sdxl_flash_floor_full_bf16", shape,
                         torch.bfloat16)[0] * 1e3
        print(f"X2 split {shape} at K1's tile {x2.TILE} (chained, us/call; "
              f"bound {bound_us:.1f}): " + ", ".join(
                  f"{m} {us:.1f} ({us / full:.1%} of full, "
                  f"{bound_us / us:.1%} of bound)"
                  for m, us in split.items()) +
              f"; exp2 {full - split['noexp']:.1f}, softmax bookkeeping "
              f"{full - split['mxu_only']:.1f}, the logits' scale "
              f"{full - split['qscaled kernel']:.1f}, K1's q pre-scale "
              f"{split['K1'] - split['qscaled kernel']:.1f}, qscaled's torch "
              f"pre-scale {split['qscaled'] - split['qscaled kernel']:.1f}",
              flush=True)


def find_cuobjdump() -> str:
    """The toolkit's cuobjdump, or the copy in Triton's package."""
    paths = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton
        paths.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for path in paths:
        if path and os.path.exists(path):
            return path
    fail("cuobjdump not found")


def check_hopper_build() -> None:
    """The Hopper sources' kernels as compiled: each HOPPER_SASS kernel's
    instances, the SASS instructions each must contain (wgmma, TMA), and
    no spills in ptxas' report."""
    for source, (smem_export, kernels) in HOPPER_SASS.items():
        check_sass(source, smem_export, kernels)


def check_sass(source: str, smem_export: str, kernels) -> None:
    sass = subprocess.run(
        [find_cuobjdump(), "-sass", str(fa._lib_path(source))],
        capture_output=True, text=True, check=True).stdout
    ops, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            ops[fn] = Counter()
        elif fn is not None:
            ops[fn].update(re.findall(r"\b(HGMMA|UTMALDG|HMMA)\b", line))
    ptxas = {m[1]: (int(m[2]), int(m[3]), int(m[4])) for m in re.finditer(
        r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores, "
        r"(\d+) bytes spill loads.*?Used (\d+) registers",
        fa.build_log(source), re.S)}
    smem = getattr(fa.load_library(source), smem_export)
    smem.restype = ctypes.c_int
    smem.argtypes = [ctypes.c_int] * 4
    for label, pattern, count, kernel, required in kernels:
        found = [f for f in ops if re.search(pattern, f)]
        if len(found) != count:
            fail(f"{label}: {len(found)} instances of {pattern} in the SASS "
                 f"of {source}, not {count}")
        for f in found:
            targs = [int(x) for x in re.findall(r"Li(\d+)E", f)] + [0] * 3
            stores, loads, regs = ptxas.get(f, (None, None, None))
            print(f"{label} {f}: SASS {dict(ops[f])}; ptxas {regs} registers "
                  f"a thread at launch (setmaxnreg then moves them from the "
                  f"producer to the consumers), spill stores {stores}, spill "
                  f"loads {loads}; dynamic shared memory "
                  f"{smem(kernel, *targs[:3])} bytes", flush=True)
            for names in required:
                if not any(ops[f][n] for n in names):
                    fail(f"{label} ({f}) has no {' or '.join(names)} "
                         f"instruction")
            if regs is None or stores or loads:
                fail(f"{label} ({f}): ptxas reports spills or no report")


def run_path(label: str, drive, must, total) -> object:
    """Drive one path with every launch count set to 0 just before it;
    fail unless each kernel in `must` was launched; add the counts to
    `total`. Returns what drive returned."""
    fa.reset_launch_counts()
    out = drive()
    torch.cuda.synchronize()
    launches = {k: n for k, n in fa.launch_counts.items() if n}
    print(f"launches during {label}: {launches}", flush=True)
    for name in must:
        if not launches.get(name):
            fail(f"{name} was not launched on the {label} path")
    for name, n in launches.items():
        total[name] += n
    return out


def experiment_path():
    """The four experiment scripts' mains, as a user runs them."""
    for mod in (x1, x2, x3):
        print(f"-- python -m {mod.__name__}", flush=True)
        mod.main()
    print(f"-- python -m {bench_flash_ragged.__name__}", flush=True)
    return bench_flash_ragged.main()


def run_requests(pipe, requests=REQUESTS, n_steps=30) -> None:
    for (height, width), seed in requests:
        pipe.timer.stages.clear()
        torch.cuda.reset_peak_memory_stats()
        before = dict(fa.launch_counts)
        t0 = time.perf_counter()
        images = pipe.txt2img(PROMPT, resolution=(height, width),
                              n_steps=n_steps, guidance_scale=7.5, seed=seed)
        latency = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        latent = pipe.last_latent
        stages = " ".join(f"{k}={v:.3f}s" for k, v in pipe.timer.stages.items())
        launches = {k: n - before[k] for k, n in fa.launch_counts.items()
                    if n != before[k]}
        print(f"request {height}x{width} seed={seed}: latency={latency:.3f}s "
              f"{stages} peak_mem={peak_gib:.2f}GiB launches={launches}",
              flush=True)
        n = launches.get("sdxl_flash_attention_bf16", 0)
        if ((height, width) == (1024, 1024) and n_steps == 30
                and pipe.compute_dtype == torch.bfloat16
                and n != UNET_LAUNCHES_1024):
            fail(f"a bf16 1024x1024 request launched K1's d 64/128 route "
                 f"{n} times, not {UNET_LAUNCHES_1024}")
        if tuple(latent.shape) != (1, height // 8, width // 8, 4):
            fail(f"latent shape {tuple(latent.shape)}")
        if not bool(torch.isfinite(latent).all()):
            fail(f"non-finite latent at {height}x{width}")
        if images.shape != (1, height, width, 3) or images.dtype.name != "uint8":
            fail(f"images {images.shape} {images.dtype}")
        if images.std() == 0:
            fail("constant image")


def with_attention(fn, attn=fa.flash_attention_plain):
    """fn() with attn (the plain attention by default) in ops.attention."""
    attention_mod.flash_attention_bhtd = attn
    try:
        return fn()
    finally:
        attention_mod.flash_attention_bhtd = fa.flash_attention_bhtd


@torch.inference_mode()
def check_f32_unet(pipe) -> None:
    """One pair-batched CFG call of the f32 UNet at 1024x1024 through K1
    (70 launches of its f32 d=64 route) and through the plain attention."""
    cond = pipe.conditioning(PROMPT, (1024, 1024)).astype(torch.float32)
    ctx2, ch2 = _cfg_contexts(pipe.diffuser_cfg, cond, torch.float32)
    x2_ = torch.cat([pipe.last_latent] * 2).float()
    t2 = torch.full((2,), 999, device=pipe.device)
    fa.reset_launch_counts()
    eps_k = unet_forward(pipe.unet, x2_, t2, ctx2, ch2)
    torch.cuda.synchronize()
    n = fa.launch_counts["sdxl_flash_attention_f32_d64"]
    eps_p = with_attention(
        lambda: unet_forward(pipe.unet, x2_, t2, ctx2, ch2))
    rel = ((eps_k - eps_p).abs().max() / eps_p.abs().max()).item()
    print(f"f32 UNet call 1024x1024 B=2: f32 d=64 launches {n}; eps "
          f"rel_err={rel:.3e} (tol {F32_UNET_REL_TOL:g}); TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    if n != 70:
        fail(f"the f32 UNet call launched K1's f32 d=64 route {n} times, "
             f"not 70")
    if not (bool(torch.isfinite(eps_k).all()) and rel < F32_UNET_REL_TOL):
        fail("the f32 UNet through K1 disagrees with the plain attention")


def bf16_decode_request(pipe) -> None:
    pipe.vae_dtype = torch.bfloat16
    try:
        run_requests(pipe, [((1024, 1024), 4)])
    finally:
        pipe.vae_dtype = torch.float32


@torch.inference_mode()
def check_bf16_decode(pipe) -> None:
    """The bf16 decode of the last latent through K1 and through the plain
    attention: the mid-block attention on the decode's own inputs, and the
    two images against each other and against the f32 decode; printed
    beside them, how far two plain attentions with different rounding
    points (K1's plain version and bench_flash_ragged's plain_ref) move
    the bf16 image."""
    latent = pipe.last_latent
    seen = []

    def kernel(q, k, v):
        seen.append((q, k, v))
        return fa.flash_attention_bhtd(q, k, v)

    def decode(dtype=torch.bfloat16):
        return decode_latent_to_images(pipe.vae, latent, pipe.scale_factor,
                                       dtype).int()

    img_k = with_attention(decode, kernel)
    img_p = with_attention(decode)
    img_r = with_attention(decode, bench_flash_ragged.plain_ref)
    img_f = decode(torch.float32)
    (q, k, v), = seen  # the mid-block's one attention
    ref = fa.flash_attention_plain(q, k, v).float()
    attn_err = ((fa.flash_attention_bhtd(q, k, v).float() - ref).abs().max()
                / ref.abs().max().clamp(min=1.0)).item()
    kp, kf, pf, pr = ((a - b).abs().float() for a, b in
                      ((img_k, img_p), (img_k, img_f), (img_p, img_f),
                       (img_p, img_r)))
    slack_max, slack_mean = BF16_VAE_F32_SLACK
    print(f"bf16 decode 1024x1024: mid-block attention {tuple(q.shape)} "
          f"kernel vs plain {attn_err:.3e} of max(1, |o|) (tol {BF16_TOL:g}); "
          f"image kernel vs plain mean {kp.mean().item():.4f} (tol "
          f"{BF16_VAE_MEAN_TOL:g}) max {kp.max().item():.0f} levels; vs the "
          f"f32 decode: kernel mean {kf.mean().item():.4f} max "
          f"{kf.max().item():.0f}, plain mean {pf.mean().item():.4f} max "
          f"{pf.max().item():.0f} levels; the two plain attentions "
          f"(flash_attention_plain, plain_ref) mean {pr.mean().item():.4f} "
          f"max {pr.max().item():.0f} levels apart", flush=True)
    if not (attn_err < BF16_TOL and kp.mean() <= BF16_VAE_MEAN_TOL
            and kf.max() <= pf.max() + slack_max
            and kf.mean() <= pf.mean() + slack_mean):
        fail("the bf16 decode through K1 disagrees with the plain attention")


@torch.inference_mode()
def check_path_against_plain(pipe) -> None:
    """The last request's final UNet step and decode, with the kernel and
    with the plain attention swapped into ops.attention."""
    height, width = REQUESTS[-1][0]
    cond = pipe.conditioning(PROMPT, (height, width)).astype(pipe.compute_dtype)
    ctx2, ch2 = _cfg_contexts(pipe.diffuser_cfg, cond, pipe.compute_dtype)
    x2 = torch.cat([pipe.last_latent] * 2).to(pipe.compute_dtype)
    t2 = torch.full((2,), 999, device=pipe.device)
    latent = pipe.last_latent

    def run():
        eps = unet_forward(pipe.unet, x2, t2, ctx2, ch2).float()
        img = decode_latent_to_images(pipe.vae, latent, pipe.scale_factor)
        return eps, img.int()

    eps_k, img_k = run()
    eps_p, img_p = with_attention(run)
    rel = ((eps_k - eps_p).abs().max() / eps_p.abs().max()).item()
    levels = (img_k - img_p).abs().max().item()
    print(f"path check {height}x{width}: unet eps rel_err={rel:.3e} "
          f"(tol {UNET_REL_TOL:g}), vae image max diff={levels} levels "
          f"(tol {VAE_LEVEL_TOL})", flush=True)
    if not rel < UNET_REL_TOL or levels > VAE_LEVEL_TOL:
        fail("the kernel path disagrees with the plain attention path")


def device_time_by_op(events) -> dict:
    """{row: [device us, kernels]} over a profile's events. A kernel counts
    under the innermost op that launched it; one launched outside any op
    (the hand-written kernels are) under its own name."""
    rows = defaultdict(lambda: [0.0, 0])
    unowned = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.device_type == DeviceType.CUDA:
            unowned[e.name][0] += e.time_range.elapsed_us()
            unowned[e.name][1] += 1
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        for kern in e.kernels:
            rows[e.name][0] += kern.duration
            rows[e.name][1] += 1
            unowned[kern.name][0] -= kern.duration
            unowned[kern.name][1] -= 1
    for name, (us, n) in unowned.items():
        if n > 0:
            rows[f"kernel {name[:70]}"] = [us, n]
    return dict(rows)


def print_profile(what: str, prof, wall: float, latencies) -> None:
    rows = device_time_by_op(prof.events())
    device_s = sum(us for us, _ in rows.values()) / 1e6
    if device_s == 0:
        fail("the profiler recorded no device time")
    median = statistics.median(latencies)
    print(f"profile {what}: unfenced latencies {latencies} s; profiled wall "
          f"{wall} s; device kernel time {device_s} s; idle share against "
          f"the median unfenced latency {1 - device_s / median}", flush=True)
    for name, (us, n) in sorted(rows.items(), key=lambda r: -r[1][0])[:20]:
        print(f"  {us / 1e3:10.3f} ms {us / 1e6 / device_s:7.2%} "
              f"{n:7d}  {name}", flush=True)


@torch.inference_mode()
def profile_request(pipe, n_steps: int = 30) -> None:
    resolution = REQUESTS[0][0]
    latencies = []
    for seed in (10, 11, 12):
        t0 = time.perf_counter()
        pipe.txt2img(PROMPT, resolution, n_steps=n_steps, seed=seed,
                     profile_stages=False)
        latencies.append(time.perf_counter() - t0)
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        t0 = time.perf_counter()
        pipe.txt2img(PROMPT, resolution, n_steps=n_steps, seed=13,
                     profile_stages=False)
        wall = time.perf_counter() - t0
    print_profile(f"{resolution[0]}x{resolution[1]} {pipe.compute_dtype} "
                  f"request, {n_steps} steps", prof, wall, latencies)


def profile_training_step(pipe, data, cfg, factors) -> None:
    """Three timed LoRA steps, then one under torch.profiler."""
    tx = adamw_cosine(cfg.lr, cfg.steps)
    state = TrainState.create(factors, tx)
    step = make_train_step(_unet_loss_fn(pipe, cfg), tx)
    batch = {k: torch.as_tensor(v, device=pipe.device) for k, v in
             sample_batch(data, 1, np.random.default_rng(1)).items()}
    gen = torch.Generator(device=pipe.device).manual_seed(3)
    latencies = []
    try:
        for _ in range(3):
            t0 = time.perf_counter()
            state, loss = step(state, batch, gen)
            float(loss)
            latencies.append(time.perf_counter() - t0)
        with torch.profiler.profile(activities=ACTIVITIES) as prof:
            t0 = time.perf_counter()
            state, loss = step(state, batch, gen)
            float(loss)
            wall = time.perf_counter() - t0
    finally:
        clear_factors(pipe.unet)
    print_profile("LoRA step", prof, wall, latencies)


def run_training(pipe, steps, must):
    """Encode two random images, then `steps` LoRA steps; fail unless each
    kernel in `must` was launched and K3a and K3b of the UNet's dtype
    (d = 64) were launched TRAIN_ATTENTIONS times a step. Returns (dataset,
    config, trained factors, launches on this path)."""
    g = torch.Generator(device=pipe.device).manual_seed(7)
    images = torch.randint(0, 256, (len(CAPTIONS), TRAIN_RES, TRAIN_RES, 3),
                           generator=g, device=pipe.device,
                           dtype=torch.uint8).cpu().numpy()
    cfg = FinetuneConfig(rank=16, targets="attn", steps=steps, lr=1e-4,
                         batch_size=1, log_every=0)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    data = _encode_items(pipe, images, CAPTIONS)
    torch.cuda.synchronize()
    print(f"train encode {len(CAPTIONS)} images at {TRAIN_RES}x{TRAIN_RES}: "
          f"{time.perf_counter() - t0:.3f}s latents "
          f"{tuple(data.latents.shape)}; launches {dict(fa.launch_counts)}",
          flush=True)
    losses, last = [], [time.perf_counter()]

    def on_step(i, state, loss):
        now = time.perf_counter()  # float(loss) synchronised the step
        print(f"train step {i}: {now - last[0]:.3f}s loss={loss}", flush=True)
        losses.append(loss)
        last[0] = now

    factors, _ = finetune_lora(pipe, data, cfg, on_step=on_step)
    launches = dict(fa.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    up_max = max(v.abs().max().item() for k, v in factors.items()
                 if k.endswith("lora_up"))
    print(f"train {pipe.compute_dtype}: {len(factors) // 2} LoRA sites, "
          f"peak_mem={peak_gib:.2f}GiB, max |up| {up_max:.3e}; launches "
          f"(encode + steps) { {k: n for k, n in launches.items() if n} }",
          flush=True)
    if len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"training losses {losses}")
    if up_max == 0:
        fail("the LoRA ups did not move")
    for name in must:
        if launches[name] == 0:
            fail(f"{name} was not launched on the training path")
    for name in fa._TRAIN_ROUTES[pipe.compute_dtype, 64][1:]:
        if launches[name] != TRAIN_ATTENTIONS * steps:
            fail(f"{name} was launched {launches[name]} times in {steps} "
                 f"steps, not {TRAIN_ATTENTIONS} a step")
    return data, cfg, factors, launches


def check_training_grads(pipe, data, cfg, factors, tol) -> None:
    """One step's factor gradients with the kernels and with the plain
    attention (K2's and K3's plain versions) swapped into ops.attention:
    max|dg| / max|g| within tol."""
    batch = {k: torch.as_tensor(v, device=pipe.device) for k, v in
             sample_batch(data, 1, np.random.default_rng(0)).items()}
    g = torch.Generator(device=pipe.device).manual_seed(11)
    draw = {"t": torch.tensor([500], device=pipe.device),
            "noise": torch.randn(batch["latents"].shape, generator=g,
                                 device=pipe.device)}
    loss_fn = _unet_loss_fn(pipe, cfg)
    swaps = {"flash_attention_lse": fa.flash_attention_lse_plain,
             "flash_attention_bwd": fa.flash_attention_bwd_plain}
    try:
        loss_k, g_k = value_and_grad(loss_fn, factors, batch, draw)
        for name, plain in swaps.items():
            setattr(attention_mod, name, plain)
        loss_p, g_p = value_and_grad(loss_fn, factors, batch, draw)
    finally:
        for name in swaps:
            setattr(attention_mod, name, getattr(fa, name))
        clear_factors(pipe.unet)
    diff = max((g_k[k] - g_p[k]).abs().max().item() for k in g_k)
    scale = max(v.abs().max().item() for v in g_p.values())
    print(f"training grad check {pipe.compute_dtype}: loss {loss_k.item()} "
          f"vs {loss_p.item()}; max|dg| / max|g| = {diff / scale:.3e} (tol "
          f"{tol:g})", flush=True)
    if not diff / scale < tol:
        fail("the kernels' factor gradients disagree with the plain path")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="add the profiled requests (phase 9) and "
                        "training step (phase 12)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {kind} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    clock = [time.perf_counter()]

    def phase_done(label: str) -> None:
        now = time.perf_counter()
        print(f"phase {label}: {now - clock[0]:.1f}s", flush=True)
        clock[0] = now

    built = fa.build_kernels()
    print(f"build: {time.perf_counter() - clock[0]:.1f}s", flush=True)
    for source, (seconds, log) in built.items():
        print(f"{source}: {seconds:.1f}s\n{log}", flush=True)
    check_hopper_build()
    phase_done("2 (build, SASS)")

    results = {}
    check_k1(results)
    check_train_kernels(results)
    phase_done("3 (K1, K2, K3)")
    check_experiments(results)
    phase_done("3b (X1-X3)")
    x_names = [name for name, *_ in experiment_kernels()]
    path = defaultdict(int)  # launches on the paths, summed over them

    rows = run_path("the experiments", experiment_path,
                    x_names + ["sdxl_flash_attention_bf16",
                               "sdxl_flash_attention_bf16_d512"], path)
    by_t = {row["case"][2]: row for row in rows}
    print("bench_flash_ragged speed-ups (plain / K1): " + ", ".join(
        f"T={t} {by_t[t]['speedup']:.2f}x" for t in sorted(by_t)),
        flush=True)
    phase_done("4 (experiment path)")

    t0 = time.perf_counter()
    pipe32 = random_pipeline(device="cuda", unet_dtype=torch.float32,
                             with_encoder=True)
    torch.cuda.synchronize()
    print(f"random_pipeline(unet_dtype=float32, with_encoder=True): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    run_path("the f32 UNet request",
             lambda: run_requests(pipe32, REQUESTS[:1], F32_STEPS),
             [F32_D64, F32_D512], path)
    check_f32_unet(pipe32)
    if args.profile:
        profile_request(pipe32, F32_STEPS)
    phase_done("5 (f32 UNet)")
    data, cfg, factors, train_launches = run_training(
        pipe32, F32_TRAIN_STEPS,
        [F32_D512, *fa._TRAIN_ROUTES[torch.float32, 64]])
    for name, n in train_launches.items():
        path[name] += n
    check_training_grads(pipe32, data, cfg, factors, F32_GRAD_REL_TOL)
    if args.profile:
        profile_training_step(pipe32, data, cfg, factors)
    del pipe32, data, factors
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("5b (f32 LoRA training)")

    t0 = time.perf_counter()
    pipe = random_pipeline(device="cuda", with_encoder=True)
    torch.cuda.synchronize()
    print(f"random_pipeline: {time.perf_counter() - t0:.1f}s", flush=True)
    run_path("the txt2img requests", lambda: run_requests(pipe),
             ["sdxl_flash_attention_bf16", F32_D512], path)
    check_path_against_plain(pipe)
    phase_done("6-7 (txt2img)")
    run_path("the bf16-decode request", lambda: bf16_decode_request(pipe),
             ["sdxl_flash_attention_bf16", "sdxl_flash_attention_bf16_d512"],
             path)
    check_bf16_decode(pipe)
    if args.profile:
        profile_request(pipe)
    phase_done("8-9 (bf16 decode, profile)")

    data, cfg, factors, train_launches = run_training(
        pipe, TRAIN_STEPS, [F32_D512, *fa._TRAIN_ROUTES[torch.bfloat16, 64]])
    for name, n in train_launches.items():
        path[name] += n
    check_training_grads(pipe, data, cfg, factors, GRAD_REL_TOL)
    if args.profile:
        profile_training_step(pipe, data, cfg, factors)
    phase_done("10-12 (LoRA training)")
    loaded = [m for m in sys.modules if m in ("jax", "sdxl_tpu")
              or m.startswith(("jax.", "sdxl_tpu."))]
    if loaded:
        fail(f"imported {loaded}")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1],
         "launches": path[name], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         **{k: r[k] for k in ("chained_ms", "graph_ms", "library_graph_ms")
            if k in r}}
        for name, r in results.items()]}
    if set(results) != set(KERNELS):
        fail(f"kernels not checked: {sorted(set(KERNELS) - set(results))}")
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
