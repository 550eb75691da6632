"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Run from the repo root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. the device, and `nvidia-smi` name and power limit;
  2. build the hand-written kernels from sdxl_tpu_torch/csrc, one nvcc per
     source, all started together (with the -Xptxas -v report); then
     `cuobjdump -sass` of flash_hopper.cu's, flash_hopper_bwd.cu's,
     flash_experiments.cu's and flash_pipelined.cu's libraries: K1's bf16
     d 64/128 kernel and K2 (its lse instances) must hold HGMMA (wgmma)
     and UTMALDG (TMA) instructions, K1's bf16 d=512 kernel HGMMA or HMMA,
     K1's and K2's f32 d 64/128 kernel (3xTF32; its four instances) HGMMA
     and UTMALDG, K1's f32 d=512 kernel (3xTF32 on mma.sync) HMMA, K3a's
     and K3b's bf16 kernels
     (dq and dk/dv, d 64 and 128) and their f32 kernels (3xTF32, d 64 and
     128) HGMMA and UTMALDG, every X1, X2 and X3 instance of K1's kernel HGMMA
     and UTMALDG, and ptxas must report no spills for any of them (counts,
     registers and shared memory printed, and X3's blocks an SM); ptxas'
     "wgmma.mma_async instructions are serialized" message fails the run
     for an X3 instance (whose point is wgmma in flight under the softmax)
     and is printed for any other;
  3. each kernel against its plain PyTorch version on the card at the
     main paths' shapes (the refiner's [1,12,4096,64] and [1,24,1024,64]
     bf16 among K1's, those two also inside one CUDA graph; K1/K2/K3 at a
     token count no multiple of 4, and at Flux-dev's joint attention,
     [1,24,4608,128]) —
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
     both dtypes) and the f32 d 64 and 128 routes (and SDPA's forward
     beside the forwards) also inside one CUDA graph of 20 calls, SDPA's
     backward as its kernels' device time (torch.profiler);
  3b. the experiments X1 (every tile), X2 (every mode) and X3 (every
     tile) against their plain versions at [2,10,4096,64] and
     [2,20,1024,64] bf16, timed by `timeit`, `chained_time` and inside one
     CUDA graph, with SDPA where the function is attention, X2's split
     of the time at K1's tile beside K1's own chained time, and each X3
     tile's chained time (and its kernel's alone, without the wrapper's
     torch pre-scale of q) beside X1's at the same tile and K1's, each as
     a share of the bound;
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
  6. the txt2img path: random_pipeline(device="cuda", with_encoder=True,
     refiner_cfg=SDXL_REFINER_DIFFUSER) at SDXL widths (the refiner drawn
     last, so the base's weights are those without it) answers three
     requests (two at 1024x1024, one at 832x1216 for the
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
  8b. module 9 on the same pipeline, each request 1024x1024, 30 steps,
     CFG 7.5, with latency, stage split, peak memory and K1's launches
     asserted: base + refiner (2170 + 280), denoising_end=0.8 (25 base
     and 6 refiner calls: 1990), img2img at strength 0.3 (700, and 2 at
     d=512: encode and decode), a crop-window inpaint, an outpaint of the
     first image cropped to 1024x832 and padded 96 left and right, and an
     inpaint through a random 9-channel base UNet sharing the towers and
     the VAE (2170 + 2 each; the 9-channel UNet freed after); then one
     refiner UNet call through K1 (40 launches) and through the plain
     attention: eps within 2e-2 relative;
  9b. checkpoint loading and the sample CLI: the same full-width
     pipeline, refiner included, written with save_native_pipeline
     (UNets bf16, the rest f32) into build/checkpoint (free space checked
     first, removed at the end); the kernel asked to drop its pages
     (posix_fadvise); then `sdxl_tpu_torch.cli.sample.main` with
     --model-dir on it, one prompt, 1024x1024, 30 steps, CFG 7.5, seed 0,
     three times: txt2img, --use-refiner, and --reference-img (the first
     request's PNG) with --mask-img (a PNG written by save_images). Each
     time the pipeline the CLI loaded must be bitwise equal to the
     in-memory one (CLIP towers, UNet, VAE decoder and encoder,
     alphas_cumprod, and the refiner with --use-refiner), K1 launched as
     counted (2170 + 1, 2450 + 1, 2170 + 2), and the PNG it wrote (decoded
     with io/images.py read_png) within 1 u8 level of the in-memory
     pipeline's image (the count of differing pixels printed); bytes
     written, seconds to write, and seconds for the loads printed, the
     first called cold only if the page cache fell by the files' size;
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
Each path (phases 4, 5, 5b, 6, 8, 8b, 9b, 10) runs with the launch counts set to
0 just before it and read just after; the JSON record's launches are their
sum. Each phase's seconds are printed. The last two lines are the kernels'
JSON record and {"ok": true, ...}.
"""

import argparse
import contextlib
import ctypes
import dataclasses
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

from sdxl_tpu_torch.cli import sample as sample_cli
from sdxl_tpu_torch.configs import SDXL_BASE_DIFFUSER, SDXL_REFINER_DIFFUSER
from sdxl_tpu_torch.io.checkpoint import save_native_pipeline
from sdxl_tpu_torch.io.images import read_png, save_images
from sdxl_tpu_torch.models.layers import init_reference_
from sdxl_tpu_torch.models.unet import UNet, unet_forward
from sdxl_tpu_torch.ops import attention as attention_mod
from sdxl_tpu_torch.ops import flash_attention as fa
from sdxl_tpu_torch.pipeline import loader as loader_mod
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
F32_D128 = "sdxl_flash_attention_f32_d128"
F32_D512 = "sdxl_flash_attention_f32_d512"
# the kernels on TF32 tensor cores in three passes: K1 f32 d 64, 128 and
# 512, and K2, K3a and K3b f32 d 64 and 128
TF32_KERNELS = (F32_D64, F32_D128, F32_D512,
                *fa._TRAIN_ROUTES[torch.float32, 64],
                *fa._TRAIN_ROUTES[torch.float32, 128])
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
# ragged), the bf16 refiner's (batch 1, unguided) at levels 1 and 2 at
# 1024x1024, the f32 VAE mid-block attention at 1024x1024, the f32 UNet at
# 1024x1024 and 832x1216 (ragged 64-key tiles) and the bf16 VAE decode at
# 1024x1024, 832x1216 and the
# smallest VAE bucket (14336 tokens), the f32 VAE's likewise — plus one
# d=128 case of each dtype and f32 d=128 at Flux-dev's joint attention at
# 1024x1024 (4096 image and 512 T5 tokens, 24 heads of 128), routes the
# SDXL-base paths do not take. The max abs error's limit is the
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
    (1, 12, 4096, 64, torch.bfloat16, 2e-2),
    (1, 24, 1024, 64, torch.bfloat16, 2e-2),
    (1, 1, 16384, 512, torch.float32, 1e-3),
    (1, 1, 15808, 512, torch.float32, 1e-3),
    (1, 1, 14336, 512, torch.float32, 1e-3),
    (1, 2, 1000, 128, torch.bfloat16, 2e-2),
    (2, 10, 4096, 64, torch.float32, 1e-3),
    (2, 20, 1024, 64, torch.float32, 1e-3),
    (2, 10, 3952, 64, torch.float32, 1e-3),
    (2, 20, 988, 64, torch.float32, 1e-3),
    (1, 2, 1000, 128, torch.float32, 1e-3),
    (1, 24, 4608, 128, torch.float32, 1e-3),
    (1, 1, 16384, 512, torch.bfloat16, 2e-2),
    (1, 1, 15808, 512, torch.bfloat16, 2e-2),
    (1, 1, 14336, 512, torch.bfloat16, 2e-2),
]
# K1 at a ragged edge no path takes (use_flash routes none of them, so they
# are not held to its gate): a token count that is no multiple of 8 at
# B*H > 1, held to the same limits
K1_EDGE_CASES = [
    (1, 3, 333, 128, torch.float32, 1e-3),
]
K1_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# K1 cases also timed inside one CUDA graph: the refiner's shapes (at
# [1,24,1024,64] 192-row tiles give 6 x 24 = 144 blocks for 132 SMs)
K1_GRAPHED = {(1, 12, 4096, 64), (1, 24, 1024, 64)}
# The kernels of the Hopper sources: for each source, its export that
# gives a kernel's dynamic shared memory (from the kernel's index and the
# first three int template arguments of its symbol, 0 where it has fewer),
# and for each kernel a pattern its symbols must match, how many instances
# it has, its kernel index in that export, and the SASS instructions it
# must contain (one of each tuple). flash_fwd_wgmma<D, NC, BK, LSE, MODE,
# PIPE> (MODE 0 is K1's q pre-scale, 1-4 X2's full, qscaled, noexp and
# mxu_only; PIPE 0 K1's schedule, n >= 2 X3's pipelined one on an n-stage
# ring) is K1's and K2's kernel and every X1, X2 and X3 instance;
# flash_fwd_tf32<D, LSE>'s bool is LSE
WGMMA_TMA = (("HGMMA",), ("UTMALDG",))
FWD = r"flash_fwd_wgmmaILi\d+ELi\d+ELi\d+E"
HOPPER_SASS = {
    "flash_hopper.cu": ("flash_hopper_smem_bytes", [
        ("K1 bf16 d 64/128", FWD + "Lb0ELi0E", 2, 0, WGMMA_TMA),
        ("K2 bf16 d 64/128", FWD + "Lb1ELi0E", 2, 0, WGMMA_TMA),
        ("K1 bf16 d 512", r"flash_fwd_d512", 1, 1, (("HGMMA", "HMMA"),)),
        ("K1 f32 d 64/128 (3xTF32)", r"flash_fwd_tf32ILi\d+ELb0E", 2, 2,
         WGMMA_TMA),
        ("K2 f32 d 64/128 (3xTF32)", r"flash_fwd_tf32ILi\d+ELb1E", 2, 2,
         WGMMA_TMA),
        ("K1 f32 d 512 (3xTF32, mma.sync)", r"flash_fwd_f32_d512", 1, 3,
         (("HMMA",),)),
    ]),
    "flash_hopper_bwd.cu": ("flash_hopper_bwd_smem_bytes", [
        ("K3a bf16 d 64/128", r"flash_bwd_dq_wgmmaILi\d+E", 2, 0, WGMMA_TMA),
        ("K3b bf16 d 64/128", r"flash_bwd_dkv_wgmmaILi\d+E", 2, 1, WGMMA_TMA),
        ("K3a f32 d 64/128 (3xTF32)", r"flash_bwd_dq_tf32ILi\d+E", 2, 2,
         WGMMA_TMA),
        ("K3b f32 d 64/128 (3xTF32)", r"flash_bwd_dkv_tf32ILi\d+E", 2, 3,
         WGMMA_TMA),
    ]),
    "flash_experiments.cu": ("flash_experiments_smem_bytes", [
        ("X1 (six tiles) and X2 full", FWD + "Lb0ELi1E", 6, 0, WGMMA_TMA),
        *((f"X2 {mode}", FWD + f"Lb0ELi{i}E", 1, 0, WGMMA_TMA)
          for i, mode in enumerate(("qscaled", "noexp", "mxu_only"), 2)),
    ]),
    "flash_pipelined.cu": ("flash_pipelined_smem_bytes", [
        ("X3 (four tiles, pipelined)", FWD + r"Lb0ELi2ELi[2-9]E", 4, 0,
         WGMMA_TMA),
    ]),
}
# the sources whose every instance keeps its wgmma in flight under the
# softmax: ptxas' serialisation message fails them
UNSERIALIZED = ("flash_pipelined.cu",)
# source -> its export of an instance's blocks an SM (from NC and BK)
OCCUPANCY = {"flash_pipelined.cu": "flash_pipelined_blocks_per_sm"}
# K2 and K3's shapes on the training path (batch 1), bf16 and f32: UNet
# levels 1 and 2 at 1024x1024 and at 832x1216, one d=128 case, a token
# count that is no multiple of 4 at B*H > 1 (the second head's rows of lse
# and delta then start off a 16-byte boundary) at d 64 and 128, and
# Flux-dev's joint attention at 1024x1024 (4096 image and 512 T5 tokens,
# 24 heads of 128: the reference's f32 trainer, train --f32, also trains
# Flux).
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
    (1, 24, 4608, 128),
    (1, 3, 333, 128),
]
BF16_TOL, LSE_TOL = 2e-2, 1e-3
# dtype -> (o and gradient tolerance, relative L2 tolerance)
TRAIN_TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (1e-3, 1e-4)}
# K2's and the f32 d 64 and 128 routes' calls are also timed as one CUDA
# graph of GRAPH_CALLS calls (no host launch between them), as is SDPA's
# forward
GRAPH_CALLS = 20
# the shape each kernel's reported time is taken at (the experiments':
# EXP_SHAPES[0])
TIMED_SHAPE = {"sdxl_flash_attention_bf16": (2, 10, 4096, 64),
               "sdxl_flash_attention_f32_d512": (1, 1, 16384, 512),
               "sdxl_flash_attention_f32_d64": (2, 10, 4096, 64),
               "sdxl_flash_attention_f32_d128": (1, 24, 4608, 128),
               "sdxl_flash_attention_bf16_d512": (1, 1, 16384, 512),
               "sdxl_flash_attention_lse_bf16": (1, 10, 4096, 64),
               "sdxl_flash_attention_bwd_dq_bf16": (1, 10, 4096, 64),
               "sdxl_flash_attention_bwd_dkv_bf16": (1, 10, 4096, 64),
               "sdxl_flash_attention_lse_f32_d64": (1, 10, 4096, 64),
               "sdxl_flash_attention_lse_f32_d128": (1, 24, 4608, 128),
               "sdxl_flash_attention_bwd_dq_f32": (1, 10, 4096, 64),
               "sdxl_flash_attention_bwd_dkv_f32": (1, 10, 4096, 64),
               "sdxl_flash_attention_bwd_dq_f32_d128": (1, 24, 4608, 128),
               "sdxl_flash_attention_bwd_dkv_f32_d128": (1, 24, 4608, 128)}
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
# the refiner's K1 d 64/128 launches a call at 1024x1024: 40
# self-attentions at levels 1 and 2 (12 heads at 4096 tokens, 24 at 1024;
# the middle block's 256 tokens are under the kernel's gate); its grid from
# refiner_step_start 800 has 7 entries (t = 199, 166, ..., 1)
REFINER_ATTENTIONS = 40
REFINER_LAUNCHES = 7 * REFINER_ATTENTIONS
# phase 8b: the crop window (pixels) of the inpainting requests, and the
# outpaint request's crop of the first image's width and its pads
CROP_WINDOW = dict(crop_left=256, crop_right=768, crop_top=256,
                   crop_bottom=768)
OUTPAINT_PAD = 96
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
# phase 9b: where the native checkpoint is written (build/ is
# git-ignored), and the free space it needs beyond the weights' bytes
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "checkpoint")
CKPT_SLACK = 2 << 30
CLI_LEVEL_TOL = 1
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
    for case in KERNEL_CASES + K1_EDGE_CASES:
        b, h, t, d, dtype, tol = case
        g = torch.Generator(device="cuda").manual_seed(42)
        q, k, v = (torch.randn((b, h, t, d), generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        if case in KERNEL_CASES and not fa.use_flash(t, t, d, False):
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
        if name in (F32_D64, F32_D128) or (b, h, t, d) in K1_GRAPHED:
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
    chained time and X3 at each tile beside X1 at that tile and K1."""
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
        chained_us = {}
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
            chained_us[name] = chained_ms * 1e3
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
        compare_x3(chained_us, split["K1"], bound_us, q, k, v)


def compare_x3(chained_us, k1_us, bound_us, q, k, v) -> None:
    """Each X3 tile's chained time, and its kernel's alone (on q
    pre-scaled once: the wrapper's torch pre-scale left out, as K1 scales
    q inside its kernel), beside X1's at the same tile (K1's schedule, one
    FMUL an element more) and K1's, each as a share of the bound."""
    qf = fa._prescale_q(q)

    def us(t):
        return f"{t:.1f} ({bound_us / t:.1%})"

    for bq, bk in x3.TILES:
        name = f"sdxl_flash_pipelined_bf16_q{bq}_k{bk}"
        alone = chained_time(functools.partial(
            x1.launch_tiled, name, "flash_pipelined", block_q=bq,
            block_k=bk, tiles=x3.TILES), qf, k, v) * 1e6
        x1_us = chained_us[f"sdxl_flash2_bf16_q{bq}_k{bk}"]
        print(f"X3 {tuple(q.shape)} {bq}x{bk} (chained, us/call; bound "
              f"{bound_us:.1f}): X3 {us(chained_us[name])}, its kernel "
              f"alone {us(alone)}, X1 at {bq}x{bk} {us(x1_us)}, K1 "
              f"{us(k1_us)}; X3's kernel / X1 {alone / x1_us:.3f}, / K1 "
              f"{alone / k1_us:.3f}", flush=True)


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


def serialized(log: str) -> dict:
    """{function: ptxas' message} for each "wgmma.mma_async instructions
    are serialized" line of a build log; None for a line that names no
    function."""
    found = {}
    for line in log.splitlines():
        if "wgmma.mma_async instructions are serialized" in line:
            m = re.search(r"function '(\S+?)'", line)
            found[m[1] if m else None] = line.strip()
    return found


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
    log = fa.build_log(source)
    ptxas = {m[1]: (int(m[2]), int(m[3]), int(m[4])) for m in re.finditer(
        r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores, "
        r"(\d+) bytes spill loads.*?Used (\d+) registers", log, re.S)}
    serial = serialized(log)
    if None in serial:
        print(f"{source}: ptxas: {serial[None]}", flush=True)
        if source in UNSERIALIZED:
            fail(f"{source}: ptxas serialises wgmma: {serial[None]}")
    lib = fa.load_library(source)
    smem = getattr(lib, smem_export)
    smem.restype = ctypes.c_int
    smem.argtypes = [ctypes.c_int] * 4
    occupancy = None
    if source in OCCUPANCY:
        occupancy = getattr(lib, OCCUPANCY[source])
        occupancy.restype = ctypes.c_int
        occupancy.argtypes = [ctypes.c_int] * 2
    for label, pattern, count, kernel, required in kernels:
        found = [f for f in ops if re.search(pattern, f)]
        if len(found) != count:
            fail(f"{label}: {len(found)} instances of {pattern} in the SASS "
                 f"of {source}, not {count}")
        for f in found:
            targs = [int(x) for x in re.findall(r"Li(\d+)E", f)] + [0] * 3
            stores, loads, regs = ptxas.get(f, (None, None, None))
            blocks = ("" if occupancy is None else
                      f"; {occupancy(*targs[1:3])} blocks an SM")
            print(f"{label} {f}: SASS {dict(ops[f])}; ptxas {regs} registers "
                  f"a thread at launch (setmaxnreg then moves them from the "
                  f"producer to the consumers), spill stores {stores}, spill "
                  f"loads {loads}; dynamic shared memory "
                  f"{smem(kernel, *targs[:3])} bytes{blocks}", flush=True)
            if f in serial:
                print(f"  ptxas: {serial[f]}", flush=True)
                if source in UNSERIALIZED:
                    fail(f"{label} ({f}): ptxas serialises its wgmma")
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
            fail(f"{name} was not launched on {label}")
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


def module9_request(pipe, label: str, fn, want_unet: int, want_vae: int):
    """One module-9 request: latency, stage split, peak memory and K1
    launches printed; fail unless K1's d 64/128 and f32 d=512 routes were
    launched want_unet and want_vae times and the image is sound."""
    pipe.timer.stages.clear()
    torch.cuda.reset_peak_memory_stats()
    before = dict(fa.launch_counts)
    t0 = time.perf_counter()
    images = fn()
    latency = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    stages = " ".join(f"{k}={v:.3f}s" for k, v in pipe.timer.stages.items())
    launches = {k: n - before[k] for k, n in fa.launch_counts.items()
                if n != before[k]}
    print(f"request {label}: latency={latency:.3f}s {stages} "
          f"peak_mem={peak_gib:.2f}GiB launches={launches}", flush=True)
    got = (launches.get("sdxl_flash_attention_bf16", 0),
           launches.get(F32_D512, 0))
    if got != (want_unet, want_vae):
        fail(f"{label} launched K1 {got[0]} (bf16 d 64/128) and {got[1]} "
             f"(f32 d=512) times, not {want_unet} and {want_vae}")
    if not bool(torch.isfinite(pipe.last_latent).all()):
        fail(f"non-finite latent in {label}")
    if (images.shape != (1, 1024, 1024, 3) or images.dtype.name != "uint8"
            or images.std() == 0):
        fail(f"{label}: images {images.shape} {images.dtype}")
    return images


def module9_requests(pipe) -> None:
    """Phase 8b: the refiner, the ensemble-of-experts split, img2img,
    crop-window inpainting, outpaint and a 9-channel inpainting UNet, each
    1024x1024, 30 steps, CFG 7.5, on the bf16 pipeline."""
    kw = dict(n_steps=30, guidance_scale=7.5)
    per_call = UNET_LAUNCHES_1024 // 31
    first = module9_request(
        pipe, "base + refiner", lambda: pipe.txt2img(
            PROMPT, (1024, 1024), seed=5, use_refiner=True, **kw),
        UNET_LAUNCHES_1024 + REFINER_LAUNCHES, 1)
    module9_request(
        pipe, "denoising_end=0.8", lambda: pipe.txt2img(
            PROMPT, (1024, 1024), seed=6, use_refiner=True,
            denoising_end=0.8, **kw),
        25 * per_call + 6 * REFINER_ATTENTIONS, 1)
    module9_request(
        pipe, "img2img strength 0.3", lambda: pipe.img2img(
            PROMPT, first, strength=0.3, seed=7, **kw), 10 * per_call, 2)
    module9_request(
        pipe, "crop-window inpaint", lambda: pipe.inpaint(
            PROMPT, first, seed=8, **CROP_WINDOW, **kw), UNET_LAUNCHES_1024, 2)
    narrow = first[:, :, OUTPAINT_PAD:1024 - OUTPAINT_PAD]
    module9_request(
        pipe, f"outpaint of {narrow.shape[1]}x{narrow.shape[2]}",
        lambda: pipe.outpaint(PROMPT, narrow, pad=(OUTPAINT_PAD,
                                                   OUTPAINT_PAD, 0, 0),
                              seed=9, **kw), UNET_LAUNCHES_1024, 2)
    t0 = time.perf_counter()
    cfg9 = dataclasses.replace(SDXL_BASE_DIFFUSER, in_channels=9)
    g = torch.Generator(device=pipe.device).manual_seed(9)
    unet9 = init_reference_(UNet(cfg9.unet_config(), pipe.device,
                                 pipe.compute_dtype), g)
    unet9.eval().requires_grad_(False)
    pipe9 = dataclasses.replace(pipe, diffuser_cfg=cfg9, unet=unet9)
    torch.cuda.synchronize()
    print(f"9-channel UNet drawn: {time.perf_counter() - t0:.1f}s",
          flush=True)
    module9_request(
        pipe9, "9-channel inpaint", lambda: pipe9.inpaint(
            PROMPT, first, seed=10, **CROP_WINDOW, **kw),
        UNET_LAUNCHES_1024, 2)
    del pipe9, unet9
    gc.collect()
    torch.cuda.empty_cache()


@torch.inference_mode()
def check_refiner_against_plain(pipe) -> None:
    """One refiner UNet call at 1024x1024 (t = 199, the last latent)
    through K1 (40 launches) and through the plain attention."""
    cond = pipe.conditioning(PROMPT, (1024, 1024)).astype(pipe.compute_dtype)
    ctx, ch = _cfg_contexts(pipe.refiner_cfg, cond, pipe.compute_dtype)
    x = pipe.last_latent.to(pipe.compute_dtype)
    t = torch.full((1,), 199, device=pipe.device)
    fa.reset_launch_counts()
    eps_k = unet_forward(pipe.refiner, x, t, ctx, ch).float()
    torch.cuda.synchronize()
    n = fa.launch_counts["sdxl_flash_attention_bf16"]
    eps_p = with_attention(
        lambda: unet_forward(pipe.refiner, x, t, ctx, ch)).float()
    rel = ((eps_k - eps_p).abs().max() / eps_p.abs().max()).item()
    print(f"refiner UNet call 1024x1024 B=1: bf16 d 64/128 launches {n}; "
          f"eps rel_err={rel:.3e} (tol {UNET_REL_TOL:g})", flush=True)
    if n != REFINER_ATTENTIONS:
        fail(f"the refiner call launched K1 {n} times, not "
             f"{REFINER_ATTENTIONS}")
    if not (bool(torch.isfinite(eps_k).all()) and rel < UNET_REL_TOL):
        fail("the refiner through K1 disagrees with the plain attention")


def drop_page_cache(paths) -> None:
    """Ask the kernel to evict the files' pages (clean after fsync), so the
    next read comes from the disk."""
    for path in paths:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def page_cache_bytes() -> int:
    """The kernel's page cache (/proc/meminfo Cached)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("Cached:"):
                return int(line.split()[1]) * 1024
    return -1


def mount_of(path: str) -> str:
    """'<filesystem type> <device>' of the mount that holds path."""
    best = ("", "?", "?")
    with open("/proc/mounts") as f:
        for line in f:
            dev, point, fstype = line.split()[:3]
            if path.startswith(point) and len(point) > len(best[0]):
                best = (point, fstype, dev)
    return f"{best[1]} {best[2]} at {best[0]}"


def check_loaded_state(pipe, loaded, refiner: bool = False) -> None:
    """Every tensor of the loaded pipeline bitwise equal to the in-memory
    one's, the refiner's too when it was asked for (and none loaded when
    not)."""
    pairs = [("embedder", pipe.embedder, loaded.embedder),
             ("unet", pipe.unet, loaded.unet), ("vae", pipe.vae, loaded.vae),
             ("vae_encoder", pipe.vae_encoder, loaded.vae_encoder)]
    if (loaded.refiner is not None) != refiner:
        fail(f"the CLI loaded {'no ' if refiner else 'a '}refiner")
    if refiner:
        pairs.append(("refiner", pipe.refiner, loaded.refiner))
        if not torch.equal(pipe.refiner_alphas, loaded.refiner_alphas):
            fail("loaded refiner_alphas differs")
    n = 0
    for what, a, b in pairs:
        sa, sb = a.state_dict(), b.state_dict()
        if sorted(sa) != sorted(sb):
            fail(f"loaded {what}: keys differ "
                 f"{sorted(set(sa) ^ set(sb))[:5]}")
        for k in sa:
            if sa[k].dtype != sb[k].dtype or not torch.equal(sa[k], sb[k]):
                fail(f"loaded {what}.{k} differs from the in-memory tensor")
            n += sa[k].numel()
    if not torch.equal(pipe.alphas_cumprod, loaded.alphas_cumprod):
        fail("loaded alphas_cumprod differs")
    print(f"loaded pipeline: {n} parameters bitwise equal to the in-memory "
          f"pipeline's ({', '.join(w for w, _, _ in pairs)})", flush=True)


def check_png(label: str, path: str, want: np.ndarray) -> None:
    """The PNG the CLI wrote (decoded by the port's reader) within
    CLI_LEVEL_TOL of the in-memory pipeline's image, with its parameters
    text chunk."""
    got, text = read_png(path)
    if got.shape != want.shape:
        fail(f"{label}: PNG {got.shape}, in-memory image {want.shape}")
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"{label} vs the in-memory pipeline: "
          f"{int((diff > 0).any(-1).sum())} of {diff.shape[0] * diff.shape[1]}"
          f" pixels differ, max {int(diff.max())} levels (tol "
          f"{CLI_LEVEL_TOL}); parameters: {text.get('parameters', '')!r}",
          flush=True)
    if diff.max() > CLI_LEVEL_TOL:
        fail(f"{label} disagrees with the in-memory pipeline's image")
    if "Backend: sdxl_tpu_torch" not in text.get("parameters", ""):
        fail(f"{label}: the PNG lacks the parameters text chunk")


def checkpoint_cli_phase(pipe, total) -> None:
    """Phase 9b: write the pipeline, refiner included, as a native
    checkpoint; answer three requests through the sample CLI from it (a
    txt2img, one with --use-refiner, and an inpaint of the first one's PNG
    with a mask PNG), and hold each load and image against the in-memory
    pipeline."""
    modules = [pipe.embedder, pipe.unet, pipe.vae, pipe.vae_encoder,
               pipe.refiner]
    need = sum(p.numel() * p.element_size() for m in modules
               for p in m.parameters())
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    free = shutil.disk_usage(CKPT_DIR).free
    print(f"checkpoint dir {CKPT_DIR} ({mount_of(CKPT_DIR)}): {free} bytes "
          f"free, the weights need {need}", flush=True)
    if free < need + CKPT_SLACK:
        fail(f"{free} bytes free under {CKPT_DIR}, need {need} + "
             f"{CKPT_SLACK}")
    loads = []
    real_load = loader_mod.load_pipeline

    def timed_load(*args, **kw):
        t0 = time.perf_counter()
        out = real_load(*args, **kw)
        torch.cuda.synchronize()
        loads.append((time.perf_counter() - t0, out))
        return out

    def cli_request(label, argv, want_unet, want_vae, refiner=False):
        """Run the CLI on argv; fail unless it returned 0, launched K1's
        routes want_unet and want_vae times and loaded the in-memory
        state. Returns the load's seconds."""
        print(f"-- python -m sdxl_tpu_torch.cli.sample {' '.join(argv)}",
              flush=True)
        loader_mod.load_pipeline = timed_load
        try:
            rc = run_path(label, lambda: sample_cli.main(argv),
                          ["sdxl_flash_attention_bf16", F32_D512], total)
        finally:
            loader_mod.load_pipeline = real_load
        got = (fa.launch_counts["sdxl_flash_attention_bf16"],
               fa.launch_counts[F32_D512])
        if rc != 0:
            fail(f"the sample CLI returned {rc} in {label}")
        if got != (want_unet, want_vae):
            fail(f"{label} launched K1 {got[0]} (bf16 d 64/128) and {got[1]}"
                 f" (f32 d=512) times, not {want_unet} and {want_vae}")
        (load_s, loaded), = loads
        loads.clear()
        check_loaded_state(pipe, loaded, refiner)
        del loaded
        gc.collect()
        torch.cuda.empty_cache()
        return load_s

    try:
        ckpt = os.path.join(CKPT_DIR, "sdxl")
        t0 = time.perf_counter()
        save_native_pipeline(ckpt, pipe)
        files = [os.path.join(ckpt, f) for f in sorted(os.listdir(ckpt))]
        for f in files:  # on the disk, not only in the page cache
            fd = os.open(f, os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
        write_s = time.perf_counter() - t0
        written = sum(os.path.getsize(f) for f in files)
        # what a load without the refiner reads
        base_bytes = written - sum(os.path.getsize(f) for f in files
                                   if "refiner" in os.path.basename(f))
        print(f"checkpoint written: {written} bytes in {write_s:.3f}s "
              f"({written / write_s / 1e9:.3f} GB/s): " + ", ".join(
                  f"{os.path.basename(f)} {os.path.getsize(f)}"
                  for f in files), flush=True)

        before = page_cache_bytes()
        drop_page_cache(files)
        after = page_cache_bytes()
        # the first load reads from the disk only if the kernel let the
        # files' pages go; some filesystems ignore the advice
        evicted = before - after
        first = ("cold: the page cache fell by " if evicted >= 0.9 * written
                 else "not evicted: the page cache fell by only ") + \
            f"{evicted} of the files' {written} bytes"
        print(f"page cache: {before} bytes before posix_fadvise(DONTNEED) "
              f"on the files, {after} after ({first})", flush=True)
        out = os.path.join(CKPT_DIR, "out", "img")
        argv = ["--model-dir", ckpt, "--prompt", PROMPT, "--height", "1024",
                "--width", "1024", "-steps", "30", "-gs", "7.5", "--seed",
                "0", "--output-dir", out]
        first_s = cli_request("the sample CLI request", argv,
                              UNET_LAUNCHES_1024, 1)
        timed_load(ckpt)
        warm_s = loads.pop()[0]
        gc.collect()
        torch.cuda.empty_cache()
        print(f"load_pipeline (disk -> card, {base_bytes} bytes): "
              f"{first_s:.3f}s on the first load ({first}), "
              f"{warm_s:.3f}s on the second, with the files in the page "
              f"cache", flush=True)
        check_png("the CLI's image", out + "0.png",
                  pipe.txt2img(PROMPT, resolution=(1024, 1024), n_steps=30,
                               guidance_scale=7.5, seed=0)[0])

        out_r = os.path.join(CKPT_DIR, "out", "refined")
        refiner_s = cli_request(
            "the sample CLI --use-refiner request",
            argv[:-1] + [out_r, "--use-refiner"],
            UNET_LAUNCHES_1024 + REFINER_LAUNCHES, 1, refiner=True)
        print(f"load_pipeline(use_refiner=True) (disk -> card, {written} "
              f"bytes): {refiner_s:.3f}s", flush=True)
        check_png("the CLI's --use-refiner image", out_r + "0.png",
                  pipe.txt2img(PROMPT, resolution=(1024, 1024), n_steps=30,
                               guidance_scale=7.5, seed=0,
                               use_refiner=True)[0])

        mask = np.zeros((1, 1024, 1024, 3), np.uint8)
        mask[:, 256:768, 384:896] = 255
        mask_png, = save_images(mask, os.path.join(CKPT_DIR, "out", "mask"))
        out_i = os.path.join(CKPT_DIR, "out", "inpainted")
        cli_request(
            "the sample CLI --reference-img --mask-img request",
            ["--model-dir", ckpt, "--prompt", PROMPT, "-steps", "30", "-gs",
             "7.5", "--seed", "0", "--reference-img", out + "0.png",
             "--mask-img", mask_png, "--output-dir", out_i],
            UNET_LAUNCHES_1024, 2)
        check_png("the CLI's inpainted image", out_i + "0.png",
                  pipe.inpaint(PROMPT, read_png(out + "0.png")[0][None],
                               mask_image=mask[0], n_steps=30,
                               guidance_scale=7.5, seed=0)[0])
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


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
    # the refiner is drawn last: every other weight is as without it
    pipe = random_pipeline(device="cuda", with_encoder=True,
                           refiner_cfg=SDXL_REFINER_DIFFUSER)
    torch.cuda.synchronize()
    print(f"random_pipeline(with_encoder=True, refiner_cfg="
          f"SDXL_REFINER_DIFFUSER): {time.perf_counter() - t0:.1f}s",
          flush=True)
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
    run_path("the module-9 requests", lambda: module9_requests(pipe),
             ["sdxl_flash_attention_bf16", F32_D512], path)
    check_refiner_against_plain(pipe)
    phase_done("8b (refiner, inpainting, img2img, outpaint)")
    checkpoint_cli_phase(pipe, path)
    phase_done("9b (checkpoint, sample CLI)")

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
