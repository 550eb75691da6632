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
     and is printed for any other; K4's (quant_linear.cu): HMMA in its two
     bf16 instances (int8, int4), its two f32 (FFMA) instances, no spills
     in any, registers and shared memory printed;
  3. each kernel against its plain PyTorch version on the card at the
     main paths' shapes (the refiner's [1,12,4096,64] and [1,24,1024,64]
     bf16 and the no-CFG base's [1,10,4096,64] and [1,20,1024,64] among
     K1's, those four also inside one CUDA graph; K1/K2/K3 at a
     token count no multiple of 4, and at Flux-dev's joint attention,
     [1,24,4608,128]; module 11's ip2p batch-3 [3,10,4096,64] and
     [3,20,1024,64] bf16 (both also in a CUDA graph), hires-fix's
     [2,10,9216,64] and [2,20,2304,64] bf16 and [1,1,36864,512] f32, and
     a tiled VAE's [1,1,9216,512] f32; module 12's SD 2.x pairs at 512²,
     [2,5,4096,64] and [2,10,1024,64], and at 768², [2,5,9216,64] and
     [2,10,2304,64] bf16 (all four also in a CUDA graph), and the SD
     VAE's [1,1,4096,512] f32 at 512²; module 13's SD3 pairs
     [2,24,4429,64] and [2,38,4429,64], SD3.5-medium's attn2
     [2,24,4096,64], FLUX.1's [1,24,4608,128], schnell's [1,24,4352,128],
     true CFG's [2,24,4608,128] and Kontext's [1,24,8704,128] bf16 (the
     d=128 ones also in a CUDA graph); the plain versions in query
     chunks where their f32 logits pass 4 GiB) —
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
     K4 on its four routes (bf16 x int8 / int4, f32 x int8 / int4)
     against quant_linear_plain at K4_CASES (FLUX.1's linears at 1024x1024
     and its M = 1 modulation matvecs, T5-XXL's in f32 at 512 tokens,
     SDXL's 1280 level, SD3-medium's 1536-wide block, a ragged M of 333
     and M = 1 on each route), weights quantized on the card, the first
     output NaN-filled: max abs error within 2e-2 (bf16) / 1e-3 (f32) of
     max(1, max|y|), relative L2 within 1e-2 / 1e-4; each case timed
     beside its bound, the plain version and one F.linear on the weight
     dequantized ahead of time (the yardstick), with the weight bytes;
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
     the same for the f32 UNet's 4-step request after phase 5, and for
     the dpmpp + karras request with and without CFG after phase 8c;
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
  8c. module 10a on the same pipeline, each request 1024x1024, CFG 7.5,
     with latency, stage split, UNet evaluations (counted at the
     samplers' UNet call), K1's launches and peak memory printed, and the
     evaluations and launches asserted against the counts the code's
     schedules give (70 launches a base evaluation, 40 a refiner's, one
     d=512 launch a decode or encode; heun and the mid methods evaluate
     twice a step but once on the last): dpmpp + karras, 30 steps, three
     times (30 evaluations); each other k-sampler at 10 steps (10, or 19
     for heun, dpm2, dpm2_a, dpmpp_2s_a); euler_a with the refiner (30 + 6);
     dpmpp + karras split at denoising_end=0.8 (19 + 11); img2img at 0.3
     with dpmpp_sde (9); a crop-window inpaint with euler_a (30); euler on
     the zero-terminal-SNR table, trailing, guidance_rescale 0.7 (30, the
     table restored after); dpmpp + ays at 10 steps; dpmpp + karras with
     no_cfg (batch-1 UNet calls); DDIM with eta 1 (31); every latent
     finite; then one pair-batched base UNet call at a karras fractional
     timestep and one at zsnr's first sigma (about 4096) through K1 and
     through the plain attention: eps within 2e-2 relative;
  8d. module 10b and module 11's weight-free extensions on the same
     pipeline, 1024x1024, CFG 7.5 unless stated, each request with
     latency, stage split, UNet evaluations counted by kind at the
     sampler's UNet calls (full, PAG's perturbed, DeepCache's cached and
     shallow), K1's launches and peak memory printed, and the evaluations
     and launches asserted against the code's counts (70 a full or cached
     call, 60 a PAG call, unet_block_plan's count for a shallow call: 0
     at branch 3; one d=512 launch a decode or encode): a random
     LCM-distilled base (time_cond_proj_dim 256, sharing the towers and
     the VAE) answers LCM txt2img at 4 steps and guidance 8 (batch-1
     calls) three times, img2img at strength 0.5 and a crop-window
     inpaint; LCM at CFG 1.5 on the standard base; dpmpp + karras and
     DDIM at 30 steps with preview_every=10, each callback's previews
     [1, 128, 128, 3] uint8 at the code's steps, and the final latent
     against the same request without previews (the max difference
     printed); ddim_invert of phase 6's first image at 30 steps, gs 1,
     then DDIM from the inverted latent (the round trip's mean u8 error
     printed); FreeU at SDXL's settings with dpmpp + karras; PAG 3.0
     through DDIM with CFG and through euler without; DeepCache (3, 3)
     through DDIM and dpmpp; every latent finite; then a PAG perturbed
     call (60 launches), a FreeU pair-batched call and the distilled
     UNet's call with its t_add (70 each) through K1 and through the
     plain attention: eps within 2e-2 relative;
  8e. the rest of module 11 on the same pipeline, 1024x1024, 30 steps,
     CFG 7.5, each request's latency, stage split, evaluations by kind
     (ControlNet trunk calls too), K1's launches by route and peak memory
     printed, and the evaluations and launches held to the code's counts
     (70 a UNet call at any batch and size, 34 a trunk call, a trunk not
     run at a step whose window scale is 0; one d=512 launch a decode or
     encode, four a tiled one at tile 96): two random full-width
     ControlNets (zero convs drawn like every conv) drawn with the ViT-H
     tower, the proj (4 tokens) and plus (Resampler, 16 tokens)
     IP-Adapters and an 8-channel InstructPix2Pix UNet of the base's
     width; ControlNet through DDIM with windows (0, 1) and (0, 0.5), two
     ControlNets through dpmpp + karras, ControlNet img2img at 0.3, the
     proj and plus IP-Adapters (a 768 x 640 image prompt), ip2p through
     DDIM and euler_a (batch-3 calls), hires-fix 1.5x (1536x1536) through
     DDIM and dpmpp, a txt2img with vae_tile=96 and an img2img with tiled
     encode and decode, each printed against the untiled image (mean and
     max u8 difference, no bound); then a ControlNet-guided pair call
     (104 launches), ip2p's batch-3 call, an IP-Adapter pair call and a
     1536x1536 pair call (70 each) through K1 and through the plain
     attention: eps within 2e-2 relative; the second net and the plus
     adapter freed;
  8f. module 12: random full-width SD 1.5 (CLIP ViT-L's final LN, 8
     fixed heads, no K1 route) and SD 2.1-768 (OpenCLIP ViT-H's
     penultimate hidden, v-prediction) pipelines, bf16 UNets and f32 VAEs
     with encoders, a full-width ControlNet of SD 2.x's 4-level trunk,
     and SD 2-base (SD2_DIFFUSER, eps) on the SD 2.x weights; SD 1.5 at
     512x512, 30 steps, CFG 7.5: DDIM, dpmpp + karras, dpmpp + ays (the
     SD 1.x table, 10 steps), img2img at 0.5, an off-bucket crop-window
     inpaint, clip_skip 1; SD 2.1-768 at 768x768: DDIM, euler, DeepCache
     (3, 3), the ControlNet, clip_skip 1 on the penultimate hidden; SD
     2-base DDIM at 512x512 — each request's evaluations by kind and K1's
     launches held to the code's counts (unet_attentions: 0 an SD 1.5
     call, 10 an SD 2.x call, 5 a shallow one, 4 a trunk call; one d=512
     launch a decode or encode); then SD 2.1-768's v-prediction pair call
     (its raw v output, then its eps) through K1 and the plain attention
     within 2e-2 relative,
     and an f32 SD 1.5 decode through both within 1 u8 level;
  9b. checkpoint loading and the sample CLI: the same full-width
     pipeline, refiner included, written with save_native_pipeline
     (UNets bf16, the rest f32) into build/checkpoint (free space checked
     first, removed at the end); the kernel asked to drop its pages
     (posix_fadvise); then `sdxl_tpu_torch.cli.sample.main` with
     --model-dir on it, one prompt, 1024x1024, 30 steps, CFG 7.5, seed 0,
     five times: txt2img, --use-refiner, --reference-img (the first
     request's PNG) with --mask-img (a PNG written by save_images),
     --sampler dpmpp --schedule karras, --sampler euler_a, --clip-skip
     1, --freeu, --pag-scale 3, --deepcache 3 and --invert-img (the first
     PNG), --controlnet (a directory written by io/diffusers_write.py)
     with --control-image (the first PNG), --ip-adapter with
     --ip-image-encoder (written by io/ip_adapter.py) and --ip-image (the
     first PNG's 768 x 640 crop), --hires-scale 1.5 and --vae-tile 96;
     then the distilled pipeline of phase 8d written in the base's place
     and --sampler lcm -steps 4 -gs 8 from it, then phase 8e's 8-channel
     pipeline in its place and --edit-image (the first PNG), then
     --family sd1 at 512x512 and --family sd2 --clip-skip 1 at 768x768
     from diffusers directories of phase 8f's SD 1.5 and SD 2-base
     pipelines written by io/diffusers_write.py. Each
     time the pipeline the CLI loaded must be bitwise equal to the
     in-memory one (CLIP towers, UNet, VAE decoder and encoder,
     alphas_cumprod, the refiner with --use-refiner, and the ControlNet,
     the adapter and its tower; an SD tower without the projection a
     diffusers text_encoder lacks), K1 launched as counted (2170 + 1,
     2450 + 1, 2170 + 2, 2100 + 1, 2100 + 1, 2170 + 1, 2170 + 1,
     4030 + 1, 770 + 1, 4340 + 2, 3224 + 1, 2170 + 1, 2870 + 1,
     2170 + 4, 280 + 1, 2170 + 2, 0 + 1, 310 + 1), and the
     PNG it wrote (decoded
     with io/images.py read_png) within 1 u8 level of the in-memory
     pipeline's image (the count of differing pixels printed); bytes
     written, seconds to write, and seconds for the loads printed, the
     first called cold only if the page cache fell by the files' size;
     after --use-refiner, --quantize int8 (module 14: the base UNet's
     block linears quantized by quantize_model on load; loaded bitwise as
     a quantized copy of the in-memory UNet, its PNG held to that copy's
     image, K4's bf16 int8 route launched);
  8h (UNets). module 14: phase 8f's SD 1.5 with its UNet quantized in
     place at int4, DDIM at 512x512; then, phase 8f's pipelines freed,
     quantized copies of the base and refiner at int8 (the bf16 UNets
     parked on the host), base + refiner txt2img at 1024x1024, 30 DDIM
     steps, CFG 7.5. Each model's bytes before and after quantization,
     each request's latency, stage split, memory resident before it and
     peak memory beside the unquantized request's, K1 and K4 launches
     printed, K4's launches by route held
     to the code's count (each QuantLinear once a UNet call, the cross
     k/v once a sampling loop); then one pair call of each with every K4
     call held to quant_linear_plain on its own input (phase 3's bounds)
     and the whole eps printed against the plain dequant's, SDXL's held
     within 2e-2 relative;
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
     torch.profiler, reported as in phase 9;
  8g. module 13, after the SDXL and SD 1.x pipelines are freed, one
     family resident at a time: random SD3-medium (MMDiTConfig(): 24
     blocks of 24 heads of 64) with T5-XXL (f32), CLIP-L and CLIP-G at
     1024x1024, 28 flow-match Euler steps, CFG 7: txt2img, no_cfg, without
     T5, img2img at 0.6, a crop inpaint, then one pair call through K1
     and the plain attention (raw velocity within 2e-2 relative); SD3.5-
     large's transformer (38 blocks, 38 heads, RMS q/k norm) in its place:
     one txt2img and one pair call held; SD3.5-medium's (24 blocks, dual
     attention in blocks 0-12, a 384 grid): one txt2img with skip-layer
     guidance 2.8 at layers 7-9 (5 extra calls at 28 steps); random
     FLUX.1-dev (FluxConfig(), T5 at 512 tokens): txt2img at guidance
     3.5, true CFG 4 over a negative prompt, img2img, a crop inpaint and a
     Kontext edit of the txt2img image, then one dev call and one Kontext
     call held to the plain attention, then phase 9b's in-memory twins;
     an f32 FLUX.1 transformer at full width, 2 double and 4 single
     blocks: a 4-step request (K1's f32 d=128 route) and one call held
     within 2e-3; FLUX.1-schnell's transformer (4 steps, 256 T5 tokens,
     the static shift). Each request's latency, stage split, transformer
     calls (counted at flow_match.mmdit_forward and flux.flux_forward,
     SLG's apart) and K1 launches are held to the code's counts
     (mmdit_launches, flux_launches: 24, 38, 37 and 31 with layers 7-9
     skipped, 57; none from T5 or CLIP; one d=512 launch a decode or
     encode);
  8h (transformers). module 14 inside phase 8g: after SD3.5, a quantized
     copy of SD3-medium's MMDiT at int8 with its T5-XXL quantized in
     place at int8, txt2img CFG 7, 28 steps; after the FLUX.1 twins, the
     FLUX.1-dev transformer and T5 quantized in place at int8, txt2img at
     guidance 3.5, 28 steps; t5_offload's conditioning bitwise the
     resident one's, T5 on the host after; a FLUX.1-dev transformer drawn
     at int4 by random_quantized_like, 8 steps with T5 parked on the host
     (t5_offload); after the f32 FLUX.1 request, its transformer
     quantized in place at int4 (`--f32 --quantize int4`: K4's f32 int4
     route), 4 steps. Each request as phase 8h's UNet requests (K4 counts:
     each QuantLinear once a transformer call or T5 encode), one
     transformer call each (and one T5 encode) held per K4 call, the
     whole output printed against the plain dequant's. The later f32
     FLUX.1 and schnell requests run with the int8 T5;
  9b (module 13). --family sd3 --no-t5 from a diffusers directory of the
     SD3-medium pipeline that this script writes (an inverse key map;
     loaded bitwise), in this process; --family flux --random-weights
     plain, with --true-cfg-scale 4 --negative-prompt, and with
     --edit-image of a 1000x744 crop of the FLUX.1 txt2img image (the
     LANCZOS resize to 1184x880), 8 steps, each in a child process that
     prints its launch counts; every PNG within 1 u8 level of the
     in-memory twin. After the first, --family sd3 --no-t5 --quantize
     int4 from the same directory: the MMDiT loaded bitwise as a copy of
     the in-memory one quantized at int4, its PNG held to that copy's
     image.
Each path (phases 4, 5, 5b, 6, 8, 8b, 8c, 8d, 8e, 8f, 9b, 10, each of
8g's and 9b's module-13 requests and each of 8h's) runs with the launch
counts (K1-K3's, X1-X3's and K4's) set to 0 just before it and read just
after; the JSON record's launches are their
sum. Each phase's seconds are printed, then the whole run's. The last two
lines are the kernels' JSON record and {"ok": true, ...}.
"""

import argparse
import contextlib
import copy
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
from sdxl_tpu_torch.configs import (
    FREEU_DEFAULTS,
    OPEN_CLIP_VITH_CONFIG,
    SD2_DIFFUSER,
    SD21_768_DIFFUSER,
    SDXL_BASE_DIFFUSER,
    SDXL_REFINER_DIFFUSER,
    T5_XXL_CONFIG,
    FluxConfig,
    MMDiTConfig,
)
from sdxl_tpu_torch.io.checkpoint import save_native_pipeline
from sdxl_tpu_torch.io.diffusers_write import (
    write_diffusers_controlnet_dir,
    write_sd1_diffusers_pipeline_dir,
)
from sdxl_tpu_torch.io.diffusers_write import clip_to_hf, vae_to_diffusers
from sdxl_tpu_torch.io.images import read_png, save_images
from sdxl_tpu_torch.io.safetensors import save_file
from sdxl_tpu_torch.io.ip_adapter import (
    save_clip_vision_dir,
    save_ip_adapter_file,
)
from sdxl_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
from sdxl_tpu_torch.models.controlnet import (
    ControlNet,
    control_cond_embed,
    controlnet_forward,
)
from sdxl_tpu_torch.models.ip_adapter import IPAdapter, IPAdapterConfig
from sdxl_tpu_torch.io.quantize import quantize_model, random_quantized_like
from sdxl_tpu_torch.utils.memory import param_bytes
from sdxl_tpu_torch.models import layers as layers_mod
from sdxl_tpu_torch.models.layers import QuantLinear, init_reference_
from sdxl_tpu_torch.models.unet import (
    UNet,
    precompute_cross_kv,
    unet_block_plan,
    unet_forward,
)
from sdxl_tpu_torch.ops import attention as attention_mod
from sdxl_tpu_torch.ops import flash_attention as fa
from sdxl_tpu_torch.ops import quant as quant_mod
from sdxl_tpu_torch.pipeline import loader as loader_mod
from sdxl_tpu_torch.pipeline.latent import decode_latent_to_images
from sdxl_tpu_torch.pipeline import sampler as sampler_mod
from sdxl_tpu_torch.pipeline.k_samplers import (
    K_SAMPLERS,
    k_schedule,
    model_evaluations,
    rescale_zero_terminal_snr,
)
from sdxl_tpu_torch.models.flux import Flux, flux_forward
from sdxl_tpu_torch.models.mmdit import MMDiT, mmdit_forward
from sdxl_tpu_torch.models.t5 import t5_encode
from sdxl_tpu_torch.pipeline import flow_match as flow_match_mod
from sdxl_tpu_torch.pipeline import flux as flux_mod
from sdxl_tpu_torch.pipeline import sd1 as sd1_mod
from sdxl_tpu_torch.pipeline import sd3 as sd3_mod
from sdxl_tpu_torch.pipeline.pipeline import random_pipeline
from sdxl_tpu_torch.pipeline.sampler import (
    LCM_ORIGINAL_STEPS,
    _cfg_contexts,
    _cfg_eps,
    _control_window_scales,
    _merge_ip,
    ddim_timesteps,
    expert_head_steps,
    lcm_guidance_add,
    lcm_timesteps,
)
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
    # K4 replaces no Pallas kernel: the reference's dequants, which XLA
    # fuses into the matmul at sdxl_tpu/ops/linear.py:30
    **{name: (f"{CSRC}/{quant_mod.SOURCE}",
              f"sdxl_tpu/ops/quant.py:{109 if bits == 8 else 113}")
       for (_, bits), name in quant_mod.ROUTES.items()},
}
# (B, H, T, D, dtype, tolerance): K1's shapes on the paths — the bf16 UNet
# (bench.py:53-66) at levels 2 and 1 at 1024x1024, 832x1216 and the
# smallest buckets (924 and 3696 tokens, where 128-row tiles are most
# ragged), the bf16 refiner's (batch 1, unguided) at levels 1 and 2 at
# 1024x1024, the bf16 UNet's without CFG (batch 1: no_cfg or guidance
# 1) at 1024x1024, the f32 VAE mid-block attention at 1024x1024, the f32 UNet at
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
    (1, 10, 4096, 64, torch.bfloat16, 2e-2),
    (1, 20, 1024, 64, torch.bfloat16, 2e-2),
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
    # module 11: ip2p's batch-3 call (192-row tiles: 22 x 30 and 6 x 60
    # blocks), hires-fix at 1.5x (1536x1536: 9216 and 2304 tokens, and
    # the f32 decode's 36864), and a tiled VAE's 768x768 tile (tile 96)
    (3, 10, 4096, 64, torch.bfloat16, 2e-2),
    (3, 20, 1024, 64, torch.bfloat16, 2e-2),
    (2, 10, 9216, 64, torch.bfloat16, 2e-2),
    (2, 20, 2304, 64, torch.bfloat16, 2e-2),
    (1, 1, 36864, 512, torch.float32, 1e-3),
    (1, 1, 9216, 512, torch.float32, 1e-3),
    # module 12: SD 2.x's 64-wide heads at 512x512 (levels 0 and 1: 5 heads
    # at 4096 tokens, 10 at 1024) and 768x768 (9216 and 2304 tokens), the
    # CFG pair's batch 2; the SD-family VAE's mid-block attention at
    # 512x512 (4096 tokens, one 512-wide head: 128 blocks, one wave)
    (2, 5, 4096, 64, torch.bfloat16, 2e-2),
    (2, 10, 1024, 64, torch.bfloat16, 2e-2),
    (2, 5, 9216, 64, torch.bfloat16, 2e-2),
    (2, 10, 2304, 64, torch.bfloat16, 2e-2),
    (1, 1, 4096, 512, torch.float32, 1e-3),
    # module 13 at 1024x1024: SD3-medium's and SD3.5-medium's CFG pair over
    # 4096 latent + 333 text tokens, SD3.5-large's (38 heads), SD3.5-medium's
    # attn2 over the latent alone; FLUX.1-dev's 4096 image + 512 T5 tokens,
    # schnell's + 256, true CFG's pair, Kontext's 4096 + 4096 + 512
    (2, 24, 4429, 64, torch.bfloat16, 2e-2),
    (2, 38, 4429, 64, torch.bfloat16, 2e-2),
    (2, 24, 4096, 64, torch.bfloat16, 2e-2),
    (1, 24, 4608, 128, torch.bfloat16, 2e-2),
    (1, 24, 4352, 128, torch.bfloat16, 2e-2),
    (2, 24, 4608, 128, torch.bfloat16, 2e-2),
    (1, 24, 8704, 128, torch.bfloat16, 2e-2),
]
# K1 at a ragged edge no path takes (use_flash routes none of them, so they
# are not held to its gate): a token count that is no multiple of 8 at
# B*H > 1, held to the same limits
K1_EDGE_CASES = [
    (1, 3, 333, 128, torch.float32, 1e-3),
]
K1_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# phase 8g's hold of each K1 call on a path against the plain attention on
# the same q, k, v: max abs error over max|plain output| (the path's
# outputs reach several units, where one bf16 ulp is up to 2^-7 of the
# value)
K1_PATH_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-3}
# K1 cases also timed inside one CUDA graph: the refiner's shapes (at
# [1,24,1024,64] 192-row tiles give 6 x 24 = 144 blocks for 132 SMs) and
# the base's without CFG (no_cfg or guidance 1: batch 1, 220 and 120
# blocks)
K1_GRAPHED = {(1, 12, 4096, 64), (1, 24, 1024, 64), (1, 10, 4096, 64),
              (1, 20, 1024, 64), (3, 10, 4096, 64), (3, 20, 1024, 64),
              (2, 5, 4096, 64), (2, 10, 1024, 64), (2, 5, 9216, 64),
              (2, 10, 2304, 64), (1, 24, 4608, 128), (1, 24, 4352, 128),
              (2, 24, 4608, 128), (1, 24, 8704, 128)}
# the plain version runs in query chunks where its f32 logits would pass
# this (at [2,10,9216,64] they are 6.8 GB, at [1,1,36864,512] 5.4 GB;
# every other shape runs it whole, as before those two)
PLAIN_CHUNK_BYTES = 4 << 30
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
    # K4: the bf16 routes on mma.sync, the f32 routes on FFMA
    quant_mod.SOURCE: ("quant_linear_smem_bytes", [
        ("K4 bf16 int8", r"quant_linear_bf16_kernelILb0E", 1, 0,
         (("HMMA", "HGMMA"),)),
        ("K4 bf16 int4", r"quant_linear_bf16_kernelILb1E", 1, 1,
         (("HMMA", "HGMMA"),)),
        ("K4 f32 int8", r"quant_linear_f32_kernelILb0E", 1, 2, ()),
        ("K4 f32 int4", r"quant_linear_f32_kernelILb1E", 1, 3, ()),
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
# phase 8c: the k-sampler requests' steps (the headline dpmpp + karras
# request, timed HEADLINE_RUNS times, and the refiner, split, img2img,
# inpaint, zsnr, no-CFG and DDIM eta requests: K_STEPS; each other method,
# and ays: K_METHOD_STEPS), zsnr's guidance rescale, and the karras step
# whose fractional timestep the path check takes
K_RES = (1024, 1024)
K_STEPS, K_METHOD_STEPS, HEADLINE_RUNS = 30, 10, 3
ZSNR_RESCALE = 0.7
KARRAS_STEP = 5
# phase 8d: the LCM-distilled base (a 256-wide guidance embedding, as
# latent-consistency/lcm-sdxl's), its requests' steps and guidance (the
# headline txt2img timed LCM_RUNS times), the LCM-LoRA recipe's CFG on
# the standard base, the previews' cadence, PAG's scale, DeepCache's
# (interval, branch), FreeU's SDXL settings, and the img2img strength
LCM_TCP, LCM_STEPS, LCM_GS, LCM_LORA_GS, LCM_RUNS = 256, 4, 8.0, 1.5, 3
LCM_STRENGTH = 0.5
PREVIEW_EVERY = 10
PAG_SCALE = 3.0
DEEPCACHE = (3, 3)
FREEU = FREEU_DEFAULTS["sdxl"]
# phase 8e: module 11. Two random full-width ControlNets (SDXL's trunk,
# zero convs drawn like every conv), the windows of the single-net DDIM
# requests and the two nets' scales and windows (dpmpp + karras); the
# IP-Adapters of h94/IP-Adapter's sdxl_models (ip-adapter_sdxl_vit-h: the
# ViT-H/14 tower, 32 layers 1280 wide, projection 1024, 4 tokens;
# ip-adapter-plus_sdxl_vit-h: the Resampler 1280 wide, depth 4, 20 heads,
# 16 tokens) and their scale; ip2p's image guidance; hires-fix's scale and
# strength; the tiled VAE's tile (latent pixels); the img2img strength
CONTROL_WINDOWS = ((0.0, 1.0), (0.0, 0.5))
MULTI_CONTROL = dict(control_scale=(1.0, 0.6), control_start=(0.0, 0.2),
                     control_end=(1.0, 0.8))
VIT_H = CLIPVisionConfig()
# the SDXL trunk's self-attentions: its input blocks' 24 and the middle
# block's 10 (the UNet's 70 less its output blocks' 36)
TRUNK_ATTENTIONS = 34
IP_PROJ = IPAdapterConfig(clip_embed_dim=VIT_H.embed_dim)
IP_PLUS = IPAdapterConfig(clip_embed_dim=VIT_H.n_state, n_tokens=16,
                          variant="resampler", dim=1280, depth=4, heads=20)
IP_SCALE = 0.6
IP2P_IMAGE_GS = 1.5
HIRES_SCALE, HIRES_STRENGTH = 1.5, 0.3
VAE_TILE = 96
M11_STRENGTH = 0.3
# phase 8f: module 12. Random full-width SD 1.5 (CLIP ViT-L's final LN,
# 8 fixed heads) at 512x512 and SD 2.1-768 (OpenCLIP ViT-H's penultimate
# hidden, v-prediction) at 768x768, bf16 UNets and f32 VAEs with their
# encoders, a full-width ControlNet of SD 2.x's 4-level trunk, and SD
# 2-base (SD2_DIFFUSER: eps) on the SD 2.x weights at 512x512; the
# requests' steps, img2img strength, the off-bucket crop window, the AYS
# request's steps (the table's native 10)
SD1_RES, SD2_RES, SD2_BASE_RES = (512, 512), (768, 768), (512, 512)
M12_STEPS, M12_AYS_STEPS, M12_STRENGTH = 30, 10, 0.5
SD1_CROP = dict(crop_left=128, crop_right=384, crop_top=192, crop_bottom=448)
# phase 8g: module 13. SD3-medium (MMDiTConfig(), the published
# stable-diffusion-3-medium transformer config) with T5-XXL (f32, as the
# reference's random T5), CLIP-L and CLIP-G; SD3.5-large's and
# SD3.5-medium's transformers (the published stable-diffusion-3.5-large
# and -medium configs: 38 heads of 64 over 38 layers with the RMS q/k norm;
# 24 layers, the norm, dual attention in blocks 0-12, a 384 position
# grid) on the same towers; FLUX.1-dev (FluxConfig(), T5 at 512 tokens)
# and FLUX.1-schnell (no guidance embedding, 256 tokens, the static
# shift). The requests' size, steps, guidance, seeds, img2img strength,
# skip-layer guidance's scale, true CFG's scale and negative prompt; the
# f32 Flux check's depth (double, single blocks)
SD35_LARGE = MMDiTConfig(num_layers=38, n_heads=38, head_dim=64,
                         qk_norm="rms")
SD35_MEDIUM = MMDiTConfig(num_layers=24, n_heads=24, head_dim=64,
                          qk_norm="rms", pos_embed_max_size=384,
                          dual_attention_layers=tuple(range(13)))
FLUX_SCHNELL_CFG = FluxConfig(guidance_embeds=False)
M13_RES, M13_STEPS, SCHNELL_STEPS = (1024, 1024), 28, 4
SD3_GS, FLUX_GS, M13_STRENGTH = 7.0, 3.5, 0.6
SLG_SCALE, TRUE_CFG_SCALE = 2.8, 4.0
M13_NEGATIVE = "blurry, low quality"
FLUX_F32_DEPTH = (2, 4)
# phase 9b's module-13 CLI requests: their steps, and the Kontext edit
# PNG's size (H, W), whose sides are not multiples of 16 (the LANCZOS
# resize to 880x1184)
M13_CLI_STEPS = 8
KONTEXT_EDIT_HW = (744, 1000)
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
# phase 8g writes the Kontext edit PNG here; phase 9b's CLI request reads it
KONTEXT_EDIT_DIR = os.path.join(os.path.dirname(CKPT_DIR), "kontext_edit")
CLI_LEVEL_TOL = 1
ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA]
# K4 (phase 3): (what, M, K, N, dtype, bits, bias) at the paths' shapes —
# FLUX.1-dev at 1024x1024 (4096 image, 512 T5 tokens; the single blocks
# over both, 4608; the modulation matvecs at M = 1), T5-XXL in f32 at its
# 512 tokens, SDXL's 1280 level at 1024x1024 (a CFG pair of 1024 tokens:
# the fused qkv, the GEGLU projection and its output, the cross k/v over
# 2 x 77 context rows, lin_embed at the pair), SD3-medium's 1536-wide
# block over a CFG pair of 4429 tokens, and a ragged M (333) and M = 1 on
# each route. Tolerances: max abs error within K4_TOL of max(1, max|y|)
# and relative L2 within K4_REL_TOL (bf16: both outputs rounded to bf16,
# their sums in another order; f32: exact dequant, f32 sums)
BF16, F32 = torch.bfloat16, torch.float32
K4_CASES = [
    ("FLUX.1 to_q", 4096, 3072, 3072, BF16, 8, True),
    ("FLUX.1 to_q int4", 4096, 3072, 3072, BF16, 4, True),
    ("FLUX.1 mlp in", 4096, 3072, 12288, BF16, 8, True),
    ("FLUX.1 mlp out", 4096, 12288, 3072, BF16, 8, True),
    ("FLUX.1 mlp out int4", 4096, 12288, 3072, BF16, 4, True),
    ("FLUX.1 context to_q", 512, 3072, 3072, BF16, 8, True),
    ("FLUX.1 single proj_mlp", 4608, 3072, 12288, BF16, 8, True),
    ("FLUX.1 single proj_out", 4608, 15360, 3072, BF16, 8, True),
    ("FLUX.1 single proj_out int4", 4608, 15360, 3072, BF16, 4, True),
    ("FLUX.1 double mod", 1, 3072, 18432, BF16, 8, True),
    ("FLUX.1 single mod", 1, 3072, 9216, BF16, 8, True),
    ("T5-XXL q", 512, 4096, 4096, F32, 8, False),
    ("T5-XXL wi_0", 512, 4096, 10240, F32, 8, False),
    ("T5-XXL wo", 512, 10240, 4096, F32, 8, False),
    ("T5-XXL wi_0 int4 (--f32 --quantize int4)", 512, 4096, 10240, F32, 4,
     False),
    ("SDXL qkv", 2048, 1280, 3840, BF16, 8, False),
    ("SDXL GEGLU proj", 2048, 1280, 10240, BF16, 8, True),
    ("SDXL GEGLU proj int4", 2048, 1280, 10240, BF16, 4, True),
    ("SDXL ff out", 2048, 5120, 1280, BF16, 8, True),
    ("SDXL cross k", 154, 2048, 1280, BF16, 8, False),
    ("SDXL lin_embed", 2, 1280, 1280, BF16, 8, True),
    ("SD3-medium mlp in", 2 * 4429, 1536, 6144, BF16, 8, True),
    *((f"ragged M {m}", m, 3072, 3072, dt, bits, True)
      for m in (333, 1) for dt in (BF16, F32) for bits in (8, 4)),
]
K4_TOL = {BF16: (2e-2, 1e-2), F32: (1e-3, 1e-4)}
# the case each route's recorded time is taken at
K4_TIMED = {"sdxl_quant_linear_bf16_int8": "FLUX.1 single proj_out",
            "sdxl_quant_linear_bf16_int4": "FLUX.1 single proj_out int4",
            "sdxl_quant_linear_f32_int8": "T5-XXL wi_0",
            "sdxl_quant_linear_f32_int4":
                "T5-XXL wi_0 int4 (--f32 --quantize int4)"}
K4_ITERS = 20
# each request's peak memory (GiB) by label, for phase 8h's prints
PEAKS = {}
# phase 8h: the SDXL request's size and steps (phase 8b's base + refiner
# request's), the int4 FLUX.1-dev request's steps (random quantized weights,
# T5 parked on the host: t5_offload) and its weights' seed
M14_SDXL_RES, M14_SDXL_STEPS = (1024, 1024), 30
M14_INT4_STEPS, M14_INT4_SEED = 8, 36
# the UNets' cross-attention k and v: once a sampling loop
# (precompute_cross_kv), not once a UNet call
K4_KV = (".attn2.k", ".attn2.v")
K4_ROUTE_DTYPE = {name: dtype for (dtype, _), name in
                  quant_mod.ROUTES.items()}
BF16_INT8, BF16_INT4, F32_INT8, F32_INT4 = (
    quant_mod.ROUTES[BF16, 8], quant_mod.ROUTES[BF16, 4],
    quant_mod.ROUTES[F32, 8], quant_mod.ROUTES[F32, 4])


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


def plain_attention(q, k, v) -> torch.Tensor:
    """K1's plain version (fa.flash_attention_plain) over query chunks of
    at most PLAIN_CHUNK_BYTES of f32 logits: the same row-wise math, as
    each output row depends on its own query row alone."""
    b, h, tq, _ = q.shape
    rows = max(1, PLAIN_CHUNK_BYTES // (b * h * k.shape[2] * 4))
    if rows >= tq:
        return fa.flash_attention_plain(q, k, v)
    return torch.cat([fa.flash_attention_plain(q[:, :, i:i + rows], k, v)
                      for i in range(0, tq, rows)], dim=2)


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
        ref = plain_attention(q, k, v)
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
            cuda_ms(lambda: plain_attention(q, k, v), iters),
            cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters),
            graph=graph)
        del q, k, v, out, ref
        torch.cuda.empty_cache()


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


def k4_bound(m: int, k: int, n: int, dtype, p: dict, bias: bool) -> tuple:
    """(least ms, "operations" | "bytes") of one K4 call: 2 M N K over the
    dtype's peak rate, or the bytes (the quantized weight and its scales,
    x, y and the bias, each once) over the memory rate."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = (quant_mod.weight_bytes(p) + m * k * es + m * n * es
              + (n * es if bias else 0))
    ops_ms = 2 * m * n * k / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


@torch.inference_mode()
def check_k4(results) -> None:
    """K4 on its four routes against quant_linear_plain at K4_CASES, the
    weight a random normal one quantized on the card as the loaders do,
    the first call's output allocated NaN-filled; each case timed (CUDA
    events) beside its bound, the plain version and the yardstick, one
    F.linear on the weight dequantized ahead of time (the unquantized
    model's cost; the port never calls it), with the weight bytes the
    kernel reads."""
    print("K4 (quantized linear) against its plain version:", flush=True)
    for label, m, k, n, dtype, bits, has_bias in K4_CASES:
        g = torch.Generator(device="cuda").manual_seed(m * 7 + k + n + bits)
        x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
        w = torch.randn((n, k), generator=g, device="cuda") * 0.02
        p = quant_mod.quantize_weight(w, bits)
        b = (torch.randn((n,), generator=g, device="cuda").to(dtype)
             if has_bias else None)
        del w
        name = quant_mod.ROUTES[dtype, bits]
        with nan_filled_empty():
            out = quant_mod.quant_linear(x, p, b)
        ref = quant_mod.quant_linear_plain(x, p, b)
        torch.cuda.synchronize()
        err, rel, ref_max = readings(out, ref)
        tol, rel_tol = K4_TOL[dtype]
        limit = tol * max(1.0, ref_max)
        w_deq = quant_mod.dequant_weight_plain(p, dtype)
        ms = cuda_ms(lambda: quant_mod.quant_linear(x, p, b), K4_ITERS)
        plain_ms = cuda_ms(lambda: quant_mod.quant_linear_plain(x, p, b),
                           K4_ITERS)
        lib_ms = cuda_ms(lambda: F.linear(x, w_deq, b), K4_ITERS)
        bound_ms, bound_by = k4_bound(m, k, n, dtype, p, has_bias)
        print(f"  {name} {label} [M={m}, K={k}, N={n}] "
              f"weight_bytes={quant_mod.weight_bytes(p)} max_abs_err="
              f"{err:.3e} (limit {limit:.3e}) rel_l2={rel:.3e} (limit "
              f"{rel_tol:g}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by}) share_of_bound={bound_ms / ms:.3f}", flush=True)
        if not (bool(torch.isfinite(out).all()) and err <= limit
                and rel <= rel_tol):
            fail(f"K4 {name} at {label} disagrees with its plain version")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if K4_TIMED[name] == label:
            r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=bound_ms, bound_by=bound_by)
        del x, p, b, out, ref, w_deq
    torch.cuda.empty_cache()


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
    quant_mod.reset_launch_counts()
    out = drive()
    torch.cuda.synchronize()
    launches = {k: n for counts in (fa.launch_counts,
                                    quant_mod.launch_counts)
                for k, n in counts.items() if n}
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


def run_requests(pipe, requests=REQUESTS, n_steps=30) -> list:
    """Answer `requests`; returns their images."""
    answered = []
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
        answered.append(images)
    return answered


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
    peak_gib = PEAKS[label] = torch.cuda.max_memory_allocated() / 2**30
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


@contextlib.contextmanager
def counting_unet_calls():
    """Inside, the samplers' UNet evaluations are counted: calls[0]."""
    calls = [0]
    real = sampler_mod.unet_forward

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    sampler_mod.unet_forward = counted
    try:
        yield calls
    finally:
        sampler_mod.unet_forward = real


def unet_calls(pipe, sampler: str, n_steps: int, schedule: str = "linear",
               step_start: int = 0, tail_from: int = 0,
               alphas=None) -> int:
    """The UNet evaluations a sampler makes, from the schedule the code
    builds (DDIM's grid; k_schedule's with heun's and the mid methods'
    second evaluations, none on the last step)."""
    alphas = pipe.alphas_cumprod if alphas is None else alphas
    if sampler == "ddim":
        return len(ddim_timesteps(step_start, n_steps,
                                  alphas.shape[0])) - tail_from
    sigmas = k_schedule(alphas, step_start, n_steps, schedule)[1]
    return model_evaluations(sampler, sigmas[tail_from:])


def module10_request(pipe, label: str, fn, want_base: int,
                     want_refiner: int, want_vae: int):
    """One module-10 request: latency, stage split, UNet evaluations, K1
    launches and peak memory printed; fail unless the evaluations are
    want_base + want_refiner, K1's d 64/128 route was launched 70 a base
    and REFINER_ATTENTIONS a refiner evaluation and its f32 d=512 route
    want_vae times, and the latent is finite."""
    pipe.timer.stages.clear()
    torch.cuda.reset_peak_memory_stats()
    before = dict(fa.launch_counts)
    with counting_unet_calls() as calls:
        t0 = time.perf_counter()
        images = fn()
        latency = time.perf_counter() - t0
    peak_gib = PEAKS[label] = torch.cuda.max_memory_allocated() / 2**30
    stages = " ".join(f"{k}={v:.3f}s" for k, v in pipe.timer.stages.items())
    launches = {k: n - before[k] for k, n in fa.launch_counts.items()
                if n != before[k]}
    latent = pipe.last_latent
    print(f"request {label}: latency={latency:.3f}s {stages} "
          f"unet_evaluations={calls[0]} (predicted {want_base} base + "
          f"{want_refiner} refiner) peak_mem={peak_gib:.2f}GiB "
          f"launches={launches} max|latent|="
          f"{latent.abs().max().item():.4g}", flush=True)
    per_call = UNET_LAUNCHES_1024 // 31
    want = (per_call * want_base + REFINER_ATTENTIONS * want_refiner,
            want_vae)
    got = (launches.get("sdxl_flash_attention_bf16", 0),
           launches.get(F32_D512, 0))
    if calls[0] != want_base + want_refiner or got != want:
        fail(f"{label}: {calls[0]} UNet evaluations and K1 launched {got[0]}"
             f" (bf16 d 64/128) and {got[1]} (f32 d=512) times, not "
             f"{want_base + want_refiner}, {want[0]} and {want[1]}")
    if not bool(torch.isfinite(latent).all()):
        fail(f"non-finite latent in {label}")
    if (images.shape != (1, *K_RES, 3) or images.dtype.name != "uint8"
            or images.std() == 0):
        fail(f"{label}: images {images.shape} {images.dtype}")
    return images


def module10_requests(pipe) -> None:
    """Phase 8c: the k-samplers at 1024x1024, CFG 7.5, on the bf16
    pipeline: the headline dpmpp + karras request HEADLINE_RUNS times,
    each other method at K_METHOD_STEPS, euler_a with the refiner, dpmpp
    + karras split at denoising_end=0.8, img2img with dpmpp_sde, a
    crop-window inpaint with euler_a, euler on the zero-terminal-SNR table
    with trailing and guidance_rescale (the table restored after), ays,
    no CFG, and DDIM with eta 1."""
    res, kw = K_RES, dict(guidance_scale=7.5)
    headline = unet_calls(pipe, "dpmpp", K_STEPS, "karras")
    first = None
    for run in range(HEADLINE_RUNS):
        images = module10_request(
            pipe, f"dpmpp + karras {K_STEPS} steps (run {run + 1})",
            lambda run=run: pipe.txt2img(
                PROMPT, res, n_steps=K_STEPS, seed=20 + run,
                sampler="dpmpp", schedule="karras", **kw), headline, 0, 1)
        first = images if first is None else first
    for method in K_SAMPLERS:
        if method == "dpmpp":
            continue
        module10_request(
            pipe, f"{method} {K_METHOD_STEPS} steps",
            lambda method=method: pipe.txt2img(
                PROMPT, res, n_steps=K_METHOD_STEPS, seed=23,
                sampler=method, **kw),
            unet_calls(pipe, method, K_METHOD_STEPS), 0, 1)
    module10_request(
        pipe, "euler_a + refiner", lambda: pipe.txt2img(
            PROMPT, res, n_steps=K_STEPS, seed=24, sampler="euler_a",
            use_refiner=True, **kw),
        unet_calls(pipe, "euler_a", K_STEPS),
        unet_calls(pipe, "euler_a", K_STEPS, step_start=800), 1)
    head, _ = expert_head_steps(pipe.alphas_cumprod, K_STEPS, 0.8, "dpmpp",
                                "karras")
    module10_request(
        pipe, f"dpmpp + karras denoising_end=0.8 ({head} base steps)",
        lambda: pipe.txt2img(PROMPT, res, n_steps=K_STEPS, seed=25,
                             sampler="dpmpp", schedule="karras",
                             use_refiner=True, denoising_end=0.8, **kw),
        head, unet_calls(pipe, "dpmpp", K_STEPS, "karras", tail_from=head),
        1)
    module10_request(
        pipe, "img2img strength 0.3 dpmpp_sde", lambda: pipe.img2img(
            PROMPT, first, strength=0.3, n_steps=K_STEPS, seed=26,
            sampler="dpmpp_sde", **kw),
        unet_calls(pipe, "dpmpp_sde", K_STEPS, step_start=700), 0, 2)
    module10_request(
        pipe, "crop-window inpaint euler_a", lambda: pipe.inpaint(
            PROMPT, first, seed=27, n_steps=K_STEPS, sampler="euler_a",
            **CROP_WINDOW, **kw),
        unet_calls(pipe, "euler_a", K_STEPS), 0, 2)
    alphas = pipe.alphas_cumprod
    try:
        pipe.rescale_zsnr()
        module10_request(
            pipe, f"euler + zsnr + trailing + guidance_rescale "
            f"{ZSNR_RESCALE}", lambda: pipe.txt2img(
                PROMPT, res, n_steps=K_STEPS, seed=28, sampler="euler",
                schedule="trailing", guidance_rescale=ZSNR_RESCALE, **kw),
            unet_calls(pipe, "euler", K_STEPS, "trailing"), 0, 1)
    finally:
        pipe.alphas_cumprod = alphas
    module10_request(
        pipe, f"dpmpp + ays {K_METHOD_STEPS} steps", lambda: pipe.txt2img(
            PROMPT, res, n_steps=K_METHOD_STEPS, seed=29, sampler="dpmpp",
            schedule="ays", **kw),
        unet_calls(pipe, "dpmpp", K_METHOD_STEPS, "ays"), 0, 1)
    module10_request(
        pipe, "dpmpp + karras no_cfg (batch-1 UNet)", lambda: pipe.txt2img(
            PROMPT, res, n_steps=K_STEPS, seed=30, sampler="dpmpp",
            schedule="karras", no_cfg=True, **kw), headline, 0, 1)
    module10_request(
        pipe, "ddim eta 1.0", lambda: pipe.txt2img(
            PROMPT, res, n_steps=K_STEPS, seed=31, ddim_eta=1.0, **kw),
        unet_calls(pipe, "ddim", K_STEPS), 0, 1)


@torch.inference_mode()
def check_k_calls_against_plain(pipe) -> None:
    """One pair-batched base UNet call at K_RES through K1 (70 launches)
    and through the plain attention at a karras fractional timestep and
    at zsnr's first sigma (about 4096: the latent scaled by 1/sqrt(sigma^2
    + 1) in f32 before the bf16 cast): its eps within UNET_REL_TOL, as
    phase 7 holds the DDIM path's (the guided eps would scale the
    difference by the guidance)."""
    dtype = pipe.compute_dtype
    cond = pipe.conditioning(PROMPT, K_RES).astype(dtype)
    ctx2, ch2 = _cfg_contexts(pipe.diffuser_cfg, cond, dtype)
    g = torch.Generator(device=pipe.device).manual_seed(12)
    noise = torch.randn((1, K_RES[0] // 8, K_RES[1] // 8, 4), generator=g,
                        device=pipe.device)
    ts, sig = k_schedule(pipe.alphas_cumprod, 0, K_STEPS, "karras")
    zsnr = rescale_zero_terminal_snr(pipe.alphas_cumprod.cpu().numpy())
    ts_z, sig_z = k_schedule(zsnr, 0, K_STEPS, "trailing")
    for label, t, sigma in (
            (f"karras step {KARRAS_STEP}", ts[KARRAS_STEP], sig[KARRAS_STEP]),
            ("zsnr trailing step 0", ts_z[0], sig_z[0])):
        s_dev = torch.tensor(float(sigma), device=pipe.device)
        scaled = noise * s_dev / torch.sqrt(s_dev ** 2 + 1.0)
        x2 = torch.cat([scaled, scaled]).to(dtype)
        t2 = torch.full((2,), float(t), device=pipe.device)

        def eps():
            return unet_forward(pipe.unet, x2, t2, ctx2, ch2).float()

        fa.reset_launch_counts()
        eps_k = eps()
        torch.cuda.synchronize()
        n = fa.launch_counts["sdxl_flash_attention_bf16"]
        eps_p = with_attention(eps)
        rel = ((eps_k - eps_p).abs().max() / eps_p.abs().max()).item()
        print(f"base UNet call {K_RES[0]}x{K_RES[1]} B=2 at {label}: "
              f"t={float(t)!r} "
              f"sigma={float(sigma)!r}; bf16 d 64/128 launches {n}; "
              f"eps rel_err={rel:.3e} (tol {UNET_REL_TOL:g}), max|eps| "
              f"{eps_p.abs().max().item():.4g}", flush=True)
        if n != UNET_LAUNCHES_1024 // 31:
            fail(f"the UNet call at {label} launched K1 {n} times")
        if not (bool(torch.isfinite(eps_k).all()) and rel < UNET_REL_TOL):
            fail(f"the UNet at {label} through K1 disagrees with the plain "
                 f"attention")


def unet_attentions(ucfg, res=K_RES) -> dict:
    """K1 d 64/128 launches of one UNet call at `res` by evaluation kind,
    from unet_block_plan and use_flash's gate: a block's self-attentions
    launch K1 when their level's token count and head width pass the gate
    (SDXL at 1024^2: every transformer level, 70 a call; SD 2.x: levels 0
    and 1 with 64-wide heads, 10 a call; SD 1.5's 40-, 80- and 160-wide
    heads: none). full and cached: every block; pag: less the middle
    block's (its self-attentions are identity maps); shallow: the first
    and last DEEPCACHE-branch blocks (DeepCache); trunk: the input blocks
    and the middle block (a ControlNet)."""
    in_plan, mid, out_plan = unet_block_plan(ucfg)
    branch = DEEPCACHE[1]
    h, w = res[0] // 8, res[1] // 8

    def launches(spec, level):
        if spec.kind not in ("res_t", "res_t_up", "res_t_res"):
            return 0
        t = (h >> level) * (w >> level)
        return spec.depth if fa.use_flash(t, t, spec.ch_out // spec.n_head,
                                          False) else 0

    ins, level = [], 0
    for spec in in_plan:
        ins.append(launches(spec, level))
        level += spec.kind == "down"
    m = launches(mid, level)
    outs = []
    for spec in out_plan:  # the deepest level first; "_up" ends a level
        outs.append(launches(spec, level))
        level -= spec.kind.endswith("_up")
    full = sum(ins) + m + sum(outs)
    return {"full": full, "cached": full, "pag": full - m,
            "shallow": sum(ins[:branch]) + sum(outs[len(outs) - branch:]),
            "trunk": sum(ins) + m}


@contextlib.contextmanager
def counting_evaluations():
    """Inside, the samplers' UNet evaluations are counted by kind: full
    calls, PAG's perturbed calls (pag_mid), DeepCache's cached and
    shallow calls, and ControlNet trunk calls."""
    calls = Counter()
    names = ("unet_forward", "unet_forward_shallow", "controlnet_forward")
    real = {n: getattr(sampler_mod, n) for n in names}

    def counted(name):
        def call(*args, **kw):
            if name == "controlnet_forward":
                calls["trunk"] += 1
            elif name == "unet_forward_shallow":
                calls["shallow"] += 1
            elif kw.get("cache_branch") is not None:
                calls["cached"] += 1
            else:
                calls["pag" if kw.get("pag_mid") else "full"] += 1
            return real[name](*args, **kw)
        return call

    for n in names:
        setattr(sampler_mod, n, counted(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(sampler_mod, n, real[n])


def module10b_request(pipe, label: str, fn, want: dict, want_vae: int,
                      attentions: dict, latent=None, res=K_RES):
    """One phase-8d request: latency, stage split, UNet evaluations by
    kind, K1 launches and peak memory printed; fail unless the evaluations
    are `want`, K1's d 64/128 route was launched as many times as those
    evaluations' attentions add up to and its f32 d=512 route want_vae
    times, and the latent (pipe.last_latent, or latent(result)) is
    finite. Returns fn's result."""
    pipe.timer.stages.clear()
    torch.cuda.reset_peak_memory_stats()
    before = dict(fa.launch_counts)
    with counting_evaluations() as calls:
        t0 = time.perf_counter()
        out = fn()
        latency = time.perf_counter() - t0
    peak_gib = PEAKS[label] = torch.cuda.max_memory_allocated() / 2**30
    stages = " ".join(f"{k}={v:.3f}s" for k, v in pipe.timer.stages.items())
    launches = {k: n - before[k] for k, n in fa.launch_counts.items()
                if n != before[k]}
    lat = pipe.last_latent if latent is None else latent(out)
    lat = torch.as_tensor(lat)
    print(f"request {label}: latency={latency:.3f}s {stages} "
          f"unet_evaluations={dict(calls)} (predicted {want}) "
          f"peak_mem={peak_gib:.2f}GiB launches={launches} max|latent|="
          f"{lat.abs().max().item():.4g}", flush=True)
    want_k1 = sum(attentions[k] * n for k, n in want.items())
    got = (launches.get("sdxl_flash_attention_bf16", 0),
           launches.get(F32_D512, 0))
    if dict(calls) != {k: n for k, n in want.items() if n} or \
            got != (want_k1, want_vae):
        fail(f"{label}: evaluations {dict(calls)} and K1 launched {got[0]} "
             f"(bf16 d 64/128) and {got[1]} (f32 d=512) times, not {want}, "
             f"{want_k1} and {want_vae}")
    if not bool(torch.isfinite(lat).all()):
        fail(f"non-finite latent in {label}")
    if latent is None and (out.shape != (1, *res, 3)
                           or out.dtype.name != "uint8" or out.std() == 0):
        fail(f"{label}: images {out.shape} {out.dtype}")
    return out


def lcm_pipeline(pipe):
    """The pipeline with a random LCM-distilled base UNet (cond_proj of
    width LCM_TCP, drawn from seed 16) in place of the base, sharing the
    towers and the VAE; no refiner."""
    cfg = dataclasses.replace(SDXL_BASE_DIFFUSER, time_cond_proj_dim=LCM_TCP)
    g = torch.Generator(device=pipe.device).manual_seed(16)
    unet = init_reference_(UNet(cfg.unet_config(), pipe.device,
                                pipe.compute_dtype), g)
    unet.eval().requires_grad_(False)
    return dataclasses.replace(pipe, diffuser_cfg=cfg, unet=unet,
                               refiner=None, refiner_cfg=None,
                               refiner_alphas=None)


def module10b_requests(pipe, first: np.ndarray):
    """Phase 8d: LCM on a random distilled base (txt2img LCM_RUNS times,
    img2img, a crop-window inpaint) and on the standard base at CFG
    LCM_LORA_GS; step previews through dpmpp + karras and DDIM, each
    against the same request without them; ddim_invert of `first` (phase
    6's first image) and DDIM from the inverted latent; FreeU; PAG with
    and without CFG; DeepCache through DDIM and dpmpp. 1024x1024, CFG 7.5
    unless stated. Returns the distilled pipeline (phase 9b's CLI
    requests load it from a checkpoint)."""
    att = unet_attentions(pipe.diffuser_cfg.unet_config())
    if att["full"] != UNET_LAUNCHES_1024 // 31:
        fail(f"unet_block_plan gives {att['full']} self-attentions, not 70")
    print(f"K1 launches a base evaluation at {K_RES[0]}x{K_RES[1]}: {att} "
          f"(DeepCache branch {DEEPCACHE[1]})", flush=True)
    res, kw = K_RES, dict(guidance_scale=7.5)
    t0 = time.perf_counter()
    p_lcm = lcm_pipeline(pipe)
    torch.cuda.synchronize()
    print(f"LCM-distilled UNet drawn (time_cond_proj_dim={LCM_TCP}): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    n_lcm = len(lcm_timesteps(LCM_STEPS))
    n_i2i = len(lcm_timesteps(min(LCM_STEPS,
                                  int(LCM_ORIGINAL_STEPS * LCM_STRENGTH)),
                              strength=LCM_STRENGTH))
    for run in range(LCM_RUNS):
        lcm_image = module10b_request(
            p_lcm, f"LCM distilled {LCM_STEPS} steps gs {LCM_GS} (run "
            f"{run + 1}, batch-1 calls)", lambda run=run: p_lcm.txt2img(
                PROMPT, res, n_steps=LCM_STEPS, guidance_scale=LCM_GS,
                seed=40 + run, sampler="lcm"), {"full": n_lcm}, 1, att)
    module10b_request(
        p_lcm, f"LCM distilled img2img strength {LCM_STRENGTH}",
        lambda: p_lcm.img2img(PROMPT, first, strength=LCM_STRENGTH,
                              n_steps=LCM_STEPS, guidance_scale=LCM_GS,
                              seed=43, sampler="lcm"),
        {"full": n_i2i}, 2, att)
    module10b_request(
        p_lcm, "LCM distilled crop-window inpaint", lambda: p_lcm.inpaint(
            PROMPT, lcm_image, seed=44, n_steps=LCM_STEPS,
            guidance_scale=LCM_GS, sampler="lcm", **CROP_WINDOW),
        {"full": n_lcm}, 2, att)
    module10b_request(
        pipe, f"LCM on the standard base, CFG {LCM_LORA_GS}",
        lambda: pipe.txt2img(PROMPT, res, n_steps=LCM_STEPS,
                             guidance_scale=LCM_LORA_GS, seed=45,
                             sampler="lcm"), {"full": n_lcm}, 1, att)

    for sampler, schedule, seed in (("dpmpp", "karras", 46),
                                    ("ddim", "linear", 47)):
        n = unet_calls(pipe, sampler, K_STEPS, schedule)
        seen = []
        req = dict(n_steps=K_STEPS, seed=seed, sampler=sampler,
                   schedule=schedule, **kw)
        label = f"{sampler} + {schedule} {K_STEPS} steps"
        module10b_request(
            pipe, f"{label} preview_every={PREVIEW_EVERY}",
            lambda: pipe.txt2img(
                PROMPT, res, preview_every=PREVIEW_EVERY,
                preview_callback=lambda *a: seen.append(a), **req),
            {"full": n}, 1, att)
        with_previews = pipe.last_latent
        module10b_request(pipe, f"{label} without previews",
                          lambda: pipe.txt2img(PROMPT, res, **req),
                          {"full": n}, 1, att)
        diff = (with_previews - pipe.last_latent).abs().max().item()
        want = [(PREVIEW_EVERY * (i + 1), n)
                for i in range((n - 1) // PREVIEW_EVERY)]
        shapes = {(p.shape, p.dtype.name) for *_, p in seen}
        print(f"{label}: previews {[(d, t) for d, t, _ in seen]} "
              f"{shapes}; final latent vs without previews max diff "
              f"{diff!r}", flush=True)
        if [(d, t) for d, t, _ in seen] != want or shapes != {
                ((1, res[0] // 8, res[1] // 8, 3), "uint8")}:
            fail(f"{label}: previews {[(d, t) for d, t, _ in seen]} "
                 f"{shapes}, not {want}")

    n_ddim = unet_calls(pipe, "ddim", K_STEPS)
    inv = module10b_request(
        pipe, f"ddim_invert {K_STEPS} steps gs 1 (batch-1 calls)",
        lambda: pipe.ddim_invert(PROMPT, first, n_steps=K_STEPS),
        {"full": n_ddim}, 1, att, latent=lambda out: out)
    back = module10b_request(
        pipe, f"DDIM {K_STEPS} steps from the inverted latent",
        lambda: pipe.txt2img(PROMPT, res, n_steps=K_STEPS,
                             initial_latent=inv, **kw),
        {"full": n_ddim}, 1, att)
    print(f"inversion round trip: mean |image - phase 6's| "
          f"{np.abs(back.astype(np.int16) - first.astype(np.int16)).mean():.3f}"
          f" u8 levels (random weights: no bound)", flush=True)

    cfg = pipe.diffuser_cfg
    try:
        pipe.diffuser_cfg = dataclasses.replace(cfg, freeu=FREEU)
        module10b_request(
            pipe, f"FreeU {FREEU} dpmpp + karras {K_STEPS} steps",
            lambda: pipe.txt2img(PROMPT, res, n_steps=K_STEPS, seed=48,
                                 sampler="dpmpp", schedule="karras", **kw),
            {"full": unet_calls(pipe, "dpmpp", K_STEPS, "karras")}, 1, att)
    finally:
        pipe.diffuser_cfg = cfg
    module10b_request(
        pipe, f"PAG {PAG_SCALE} + CFG, DDIM {K_STEPS} steps",
        lambda: pipe.txt2img(PROMPT, res, n_steps=K_STEPS, seed=49,
                             pag_scale=PAG_SCALE, **kw),
        {"full": n_ddim, "pag": n_ddim}, 1, att)
    n_euler = unet_calls(pipe, "euler", K_STEPS)
    module10b_request(
        pipe, f"PAG {PAG_SCALE}, euler {K_STEPS} steps, no CFG",
        lambda: pipe.txt2img(PROMPT, res, n_steps=K_STEPS, seed=50,
                             sampler="euler", no_cfg=True,
                             pag_scale=PAG_SCALE, **kw),
        {"full": n_euler, "pag": n_euler}, 1, att)
    interval = DEEPCACHE[0]
    for sampler, seed in (("ddim", 51), ("dpmpp", 52)):
        n = unet_calls(pipe, sampler, K_STEPS)
        cached = len(range(0, n, interval))
        module10b_request(
            pipe, f"DeepCache {DEEPCACHE} {sampler} {K_STEPS} steps",
            lambda sampler=sampler, seed=seed: pipe.txt2img(
                PROMPT, res, n_steps=K_STEPS, seed=seed, sampler=sampler,
                deepcache=DEEPCACHE, **kw),
            {"cached": cached, "shallow": n - cached}, 1, att)
    return p_lcm


@torch.inference_mode()
def check_extensions_against_plain(pipe, p_lcm) -> None:
    """One PAG perturbed call (B=1, 60 launches), one FreeU pair-batched
    call (70) and one call of the distilled UNet with its t_add (B=1, 70)
    at K_RES, each through K1 and through the plain attention: eps within
    UNET_REL_TOL relative."""
    dtype = pipe.compute_dtype
    att = unet_attentions(pipe.diffuser_cfg.unet_config())
    cond = pipe.conditioning(PROMPT, K_RES).astype(dtype)
    ctx2, ch2 = _cfg_contexts(pipe.diffuser_cfg, cond, dtype)
    ctx, ch = _cfg_contexts(pipe.diffuser_cfg, cond, dtype, use_cfg=False)
    g = torch.Generator(device=pipe.device).manual_seed(13)
    x = torch.randn((1, K_RES[0] // 8, K_RES[1] // 8, 4), generator=g,
                    device=pipe.device).to(dtype)
    t_add = lcm_guidance_add(p_lcm.unet, p_lcm.diffuser_cfg, LCM_GS, dtype)
    checks = [
        ("PAG perturbed call B=1", att["pag"], lambda t: unet_forward(
            pipe.unet, x, t.expand(1), ctx, ch, pag_mid=True)),
        (f"FreeU {FREEU} call B=2", att["full"], lambda t: unet_forward(
            pipe.unet, torch.cat([x, x]), t.expand(2), ctx2, ch2,
            freeu=FREEU)),
        (f"LCM-distilled call B=1 with t_add (gs {LCM_GS})", att["full"],
         lambda t: unet_forward(p_lcm.unet, x, t.expand(1), ctx, ch,
                                t_add=t_add)),
    ]
    t = torch.tensor(float(lcm_timesteps(LCM_STEPS)[1]), device=pipe.device)
    hold_calls_to_plain(checks, t)


def hold_calls_to_plain(checks, t) -> None:
    """Each (label, K1 launches wanted, call(t)) through K1 and through the
    plain attention (in query chunks): K1's d 64/128 route launched as
    wanted, eps within UNET_REL_TOL relative."""
    for label, want_n, call in checks:
        fa.reset_launch_counts()
        eps_k = call(t).float()
        torch.cuda.synchronize()
        n = fa.launch_counts["sdxl_flash_attention_bf16"]
        eps_p = with_attention(lambda: call(t), plain_attention).float()
        rel = ((eps_k - eps_p).abs().max() / eps_p.abs().max()).item()
        print(f"{label} at t={float(t)!r}: bf16 d 64/128 launches {n}; eps "
              f"rel_err={rel:.3e} (tol {UNET_REL_TOL:g}), max|eps| "
              f"{eps_p.abs().max().item():.4g}", flush=True)
        if n != want_n:
            fail(f"the {label} launched K1 {n} times, not {want_n}")
        if not (bool(torch.isfinite(eps_k).all()) and rel < UNET_REL_TOL):
            fail(f"the {label} through K1 disagrees with the plain "
                 f"attention")
        del eps_k, eps_p
        torch.cuda.empty_cache()


def module11_weights(pipe) -> dict:
    """Phase 8e's random weights, drawn on the card from seed 17 with the
    reference's init: two full-width ControlNets of the base's plan (bf16;
    their zero convs drawn like every conv, so nonzero), the ViT-H tower
    and the proj and plus adapters (f32), and an 8-channel InstructPix2Pix
    UNet of the base's width (bf16) in a pipeline sharing the towers and
    the VAE."""
    dev, dtype = pipe.device, pipe.compute_dtype
    g = torch.Generator(device=dev).manual_seed(17)
    ucfg = pipe.diffuser_cfg.unet_config()

    def drawn(module, **kw):
        return init_reference_(module, g, **kw).eval().requires_grad_(False)

    nets = tuple(drawn(ControlNet(ucfg, dev, dtype)) for _ in range(2))
    vision = drawn(CLIPVisionModel(VIT_H, dev))
    adapters = {"proj": drawn(IPAdapter(IP_PROJ, ucfg, device=dev)),
                "plus": drawn(IPAdapter(IP_PLUS, ucfg, device=dev))}
    cfg8 = dataclasses.replace(pipe.diffuser_cfg, in_channels=8)
    edit = dataclasses.replace(
        pipe, diffuser_cfg=cfg8, unet=drawn(UNet(cfg8.unet_config(), dev,
                                                 dtype)),
        refiner=None, refiner_cfg=None, refiner_alphas=None)
    return dict(nets=nets, vision=vision, adapters=adapters, edit=edit)


def with_ip(pipe, w, variant: str):
    return dataclasses.replace(pipe, ip_adapter=w["adapters"][variant],
                               ip_vision=w["vision"])


def module11_requests(pipe, first: np.ndarray, w: dict) -> None:
    """Phase 8e: ControlNet through DDIM in two windows, two ControlNets
    through dpmpp + karras, ControlNet img2img, the proj and plus
    IP-Adapters, ip2p through DDIM and euler_a, hires-fix through DDIM and
    dpmpp, and the tiled VAE's txt2img and img2img beside the untiled
    images. 1024x1024 (hires 1536x1536), 30 steps, CFG 7.5; the control
    images are phase 6's first image and its negative, the image prompt
    its 768 x 640 top-left crop, the edit and img2img image the image."""
    att = unet_attentions(pipe.diffuser_cfg.unet_config())
    if att["trunk"] != TRUNK_ATTENTIONS:
        fail(f"unet_block_plan gives {att['trunk']} trunk self-attentions, "
             f"not {TRUNK_ATTENTIONS}")
    res, kw = K_RES, dict(guidance_scale=7.5, n_steps=K_STEPS)
    ctl = (first[0], 255 - first[0])
    n_ddim = unet_calls(pipe, "ddim", K_STEPS)
    n_i2i = unet_calls(pipe, "ddim", K_STEPS,
                       step_start=int(round((1 - M11_STRENGTH) * 1000)))

    def trunk_calls(n, scale, window):
        return int((_control_window_scales(n, scale, window) != 0).sum())

    pc = dataclasses.replace(pipe, controlnet=w["nets"][0])
    for window in CONTROL_WINDOWS:
        module10b_request(
            pc, f"ControlNet DDIM window {window}",
            lambda window=window: pc.txt2img(
                PROMPT, res, seed=60, control_image=ctl[0],
                control_start=window[0], control_end=window[1], **kw),
            {"full": n_ddim, "trunk": trunk_calls(n_ddim, 1.0, window)}, 1,
            att)
    pm = dataclasses.replace(pipe, controlnet=w["nets"])
    n = unet_calls(pipe, "dpmpp", K_STEPS, "karras")
    module10b_request(
        pm, f"two ControlNets dpmpp + karras {MULTI_CONTROL}",
        lambda: pm.txt2img(PROMPT, res, seed=61, sampler="dpmpp",
                           schedule="karras", control_image=list(ctl),
                           **MULTI_CONTROL, **kw),
        {"full": n, "trunk": trunk_calls(
            n, MULTI_CONTROL["control_scale"],
            tuple(zip(MULTI_CONTROL["control_start"],
                      MULTI_CONTROL["control_end"])))}, 1, att)
    module10b_request(
        pc, f"ControlNet img2img strength {M11_STRENGTH}",
        lambda: pc.img2img(PROMPT, first, strength=M11_STRENGTH, seed=62,
                           control_image=ctl[0], **kw),
        {"full": n_i2i, "trunk": n_i2i}, 2, att)

    for variant in ("proj", "plus"):
        pi = with_ip(pipe, w, variant)
        module10b_request(
            pi, f"IP-Adapter {variant} scale {IP_SCALE}",
            lambda: pi.txt2img(PROMPT, res, seed=63,
                               ip_adapter_image=first[0, :768, :640],
                               ip_adapter_scale=IP_SCALE, **kw),
            {"full": n_ddim}, 1, att)

    edit = w["edit"]
    for sampler in ("ddim", "euler_a"):
        module10b_request(
            edit, f"ip2p {sampler} image guidance {IP2P_IMAGE_GS} (batch-3 "
            f"calls)", lambda sampler=sampler: edit.ip2p(
                PROMPT, first, seed=64, sampler=sampler,
                image_guidance_scale=IP2P_IMAGE_GS, **kw),
            {"full": unet_calls(pipe, sampler, K_STEPS)}, 2, att)

    hires = tuple(round(r * HIRES_SCALE / 8) * 8 for r in res)
    start = int(round((1 - HIRES_STRENGTH) * 1000))
    for sampler in ("ddim", "dpmpp"):
        module10b_request(
            pipe, f"hires-fix {HIRES_SCALE}x {sampler} strength "
            f"{HIRES_STRENGTH} ({hires[0]}x{hires[1]})",
            lambda sampler=sampler: pipe.txt2img_hires(
                PROMPT, res, hires_scale=HIRES_SCALE,
                hires_strength=HIRES_STRENGTH, seed=65, sampler=sampler,
                **kw),
            {"full": unet_calls(pipe, sampler, K_STEPS)
             + unet_calls(pipe, sampler, K_STEPS, step_start=start)}, 1,
            att, res=hires)

    pt = dataclasses.replace(pipe, vae_tile=VAE_TILE)
    tiled = module10b_request(
        pt, f"txt2img vae_tile={VAE_TILE}",
        lambda: pt.txt2img(PROMPT, res, seed=66, **kw),
        {"full": n_ddim}, 4, att)
    whole = decode_latent_to_images(pipe.vae, pt.last_latent,
                                    pipe.scale_factor).cpu().numpy()
    tiled_i2i = module10b_request(
        pt, f"img2img strength {M11_STRENGTH} vae_tile={VAE_TILE} (tiled "
        f"encode and decode)",
        lambda: pt.img2img(PROMPT, first, strength=M11_STRENGTH, seed=67,
                           **kw), {"full": n_i2i}, 8, att)
    untiled_i2i = module10b_request(
        pipe, f"img2img strength {M11_STRENGTH} untiled",
        lambda: pipe.img2img(PROMPT, first, strength=M11_STRENGTH, seed=67,
                             **kw), {"full": n_i2i}, 2, att)
    for label, a, b in (("txt2img", tiled, whole),
                        ("img2img", tiled_i2i, untiled_i2i)):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        print(f"tiled VAE {label} vs untiled: mean {d.mean():.4f} max "
              f"{int(d.max())} u8 levels (random weights: no bound)",
              flush=True)


@torch.inference_mode()
def check_module11_against_plain(pipe, first: np.ndarray, w: dict) -> None:
    """A ControlNet-guided pair call (trunk and UNet: 34 + 70 launches),
    ip2p's batch-3 call, an IP-Adapter pair call (70 each) at K_RES, and a
    pair call at hires-fix's 1536x1536 (70), each through K1 and through
    the plain attention: eps within UNET_REL_TOL relative."""
    dtype, dev = pipe.compute_dtype, pipe.device
    att = unet_attentions(pipe.diffuser_cfg.unet_config())
    cfg = pipe.diffuser_cfg
    g = torch.Generator(device=dev).manual_seed(14)
    hires = tuple(round(r * HIRES_SCALE / 8) * 8 for r in K_RES)

    def pair(res):
        cond = pipe.conditioning(PROMPT, res).astype(dtype)
        ctx2, ch2 = _cfg_contexts(cfg, cond, dtype)
        x = torch.randn((1, res[0] // 8, res[1] // 8, 4), generator=g,
                        device=dev).to(dtype)
        return cond, ctx2, ch2, torch.cat([x, x])

    cond, ctx2, ch2, x2 = pair(K_RES)
    net = w["nets"][0]
    image = torch.as_tensor(first, device=dev).float() / 255.0
    emb = control_cond_embed(net, image)
    emb2, ckv = torch.cat([emb, emb]), precompute_cross_kv(net, ctx2)

    def controlled(t):
        ts = t.expand(2)
        res = controlnet_forward(net, x2, ts, ctx2, ch2, emb2, ckv)
        return unet_forward(pipe.unet, x2, ts, ctx2, ch2,
                            control_residuals=res)

    edit = w["edit"]
    ctx3, ch3 = _cfg_contexts(edit.diffuser_cfg, cond, dtype, rows3=True)
    e = edit._encode(first, scale_factor=1.0).to(dtype)
    x3 = torch.cat([torch.cat([x2[:1]] * 3),
                    torch.cat([torch.zeros_like(e), e, e])], dim=-1)
    ip = with_ip(pipe, w, "proj")._prep_ip(first[0, :768, :640], IP_SCALE)
    ip_kv = _merge_ip(precompute_cross_kv(pipe.unet, ctx2), ip, cfg, cond,
                      dtype, True)
    _, hctx2, hch2, hx2 = pair(hires)
    checks = [
        ("ControlNet-guided call B=2 (trunk and UNet)",
         att["trunk"] + att["full"], controlled),
        ("ip2p call B=3", att["full"], lambda t: unet_forward(
            edit.unet, x3, t.expand(3), ctx3, ch3)),
        ("IP-Adapter call B=2", att["full"], lambda t: unet_forward(
            pipe.unet, x2, t.expand(2), ctx2, ch2, ip_kv)),
        (f"hires-size call B=2 {hires[0]}x{hires[1]}", att["full"],
         lambda t: unet_forward(pipe.unet, hx2, t.expand(2), hctx2, hch2)),
    ]
    hold_calls_to_plain(checks, torch.tensor(500.0, device=dev))


def module12_weights() -> dict:
    """Phase 8f's random pipelines, drawn on the card: SD 1.5 (seed 21)
    and SD 2.1-768 (seed 22, OpenCLIP ViT-H's penultimate hidden,
    v-prediction), each with its VAE encoder; a full-width ControlNet of
    SD 2.x's plan (bf16, seed 23; zero convs drawn like every conv); and
    SD 2-base, SD2_DIFFUSER (eps) on the SD 2.x weights."""
    sd1 = sd1_mod.random_sd1_pipeline(21, device="cuda", with_encoder=True)
    sd2 = sd1_mod.random_sd1_pipeline(
        22, device="cuda", clip_cfg=OPEN_CLIP_VITH_CONFIG,
        diffuser_cfg=SD21_768_DIFFUSER, penultimate_hidden=True,
        with_encoder=True)
    g = torch.Generator(device="cuda").manual_seed(23)
    net = init_reference_(ControlNet(SD21_768_DIFFUSER.unet_config(), "cuda",
                                     torch.bfloat16), g)
    return dict(sd1=sd1, sd2=sd2, net=net.eval().requires_grad_(False),
                sd2_base=dataclasses.replace(sd2, diffuser_cfg=SD2_DIFFUSER))


def module12_requests(w: dict):
    """Phase 8f: SD 1.5 at 512x512 (DDIM, dpmpp + karras, dpmpp + ays
    (the SD 1.x table), img2img, an off-bucket crop-window inpaint,
    clip_skip 1), SD 2.1-768 at 768x768 with v-prediction (DDIM, euler,
    DeepCache, a ControlNet, clip_skip 1 on the penultimate hidden) and SD
    2-base at 512x512 (DDIM), CFG 7.5; each request's evaluations and K1
    launches held to the code's counts. Returns the SD 1.5 DDIM request's
    final latent."""
    sd1, sd2, base = w["sd1"], w["sd2"], w["sd2_base"]
    kw = dict(guidance_scale=7.5, n_steps=M12_STEPS)
    a1 = unet_attentions(sd1.diffuser_cfg.unet_config(), SD1_RES)
    a2 = unet_attentions(sd2.diffuser_cfg.unet_config(), SD2_RES)
    ab = unet_attentions(base.diffuser_cfg.unet_config(), SD2_BASE_RES)
    print(f"K1 launches a UNet call: SD 1.5 {SD1_RES} {a1}; SD 2.1-768 "
          f"{SD2_RES} {a2}; SD 2-base {SD2_BASE_RES} {ab}", flush=True)
    if (a1["full"], a2["full"], ab["full"]) != (0, 10, 10):
        fail("the plans' K1 counts are not SD 1.5's 0 and SD 2.x's 10")
    ays = sd1._resolve_schedule("ays")
    if ays != "ays_sd15":
        fail(f"schedule='ays' resolves to {ays} on an SD1Pipeline")

    def req(pipe, label, fn, want, want_vae, att, res):
        return module10b_request(pipe, label, fn, want, want_vae, att,
                                 res=res)

    n1 = unet_calls(sd1, "ddim", M12_STEPS)
    first = req(sd1, f"SD 1.5 DDIM {M12_STEPS} steps {SD1_RES}",
                lambda: sd1.txt2img(PROMPT, SD1_RES, seed=70, **kw),
                {"full": n1}, 1, a1, SD1_RES)
    latent = sd1.last_latent
    req(sd1, "SD 1.5 dpmpp + karras",
        lambda: sd1.txt2img(PROMPT, SD1_RES, seed=71, sampler="dpmpp",
                            schedule="karras", **kw),
        {"full": unet_calls(sd1, "dpmpp", M12_STEPS, "karras")}, 1, a1,
        SD1_RES)
    req(sd1, f"SD 1.5 dpmpp + ays ({ays}) {M12_AYS_STEPS} steps",
        lambda: sd1.txt2img(PROMPT, SD1_RES, seed=72, sampler="dpmpp",
                            schedule="ays", guidance_scale=7.5,
                            n_steps=M12_AYS_STEPS),
        {"full": unet_calls(sd1, "dpmpp", M12_AYS_STEPS, ays)}, 1, a1,
        SD1_RES)
    n_i2i = unet_calls(sd1, "ddim", M12_STEPS,
                       step_start=int(round((1 - M12_STRENGTH) * 1000)))
    req(sd1, f"SD 1.5 img2img strength {M12_STRENGTH}",
        lambda: sd1.img2img(PROMPT, first, strength=M12_STRENGTH, seed=73,
                            **kw), {"full": n_i2i}, 2, a1, SD1_RES)
    req(sd1, f"SD 1.5 off-bucket crop-window inpaint {SD1_CROP}",
        lambda: sd1.inpaint(PROMPT, first, seed=74, **SD1_CROP, **kw),
        {"full": n1}, 2, a1, SD1_RES)
    skip1 = dataclasses.replace(sd1, clip_skip=1)
    skipped = req(skip1, "SD 1.5 clip_skip=1 DDIM (seed 70)",
                  lambda: skip1.txt2img(PROMPT, SD1_RES, seed=70, **kw),
                  {"full": n1}, 1, a1, SD1_RES)
    print(f"SD 1.5 clip_skip=1 vs 0 at seed 70: mean "
          f"{np.abs(skipped.astype(np.int16) - first).mean():.3f} u8 levels",
          flush=True)

    n2 = unet_calls(sd2, "ddim", M12_STEPS)
    first2 = req(sd2, f"SD 2.1-768 v DDIM {M12_STEPS} steps {SD2_RES}",
                 lambda: sd2.txt2img(PROMPT, SD2_RES, seed=75, **kw),
                 {"full": n2}, 1, a2, SD2_RES)
    req(sd2, "SD 2.1-768 v euler",
        lambda: sd2.txt2img(PROMPT, SD2_RES, seed=76, sampler="euler", **kw),
        {"full": unet_calls(sd2, "euler", M12_STEPS)}, 1, a2, SD2_RES)
    cached = len(range(0, n2, DEEPCACHE[0]))
    req(sd2, f"SD 2.1-768 v DeepCache {DEEPCACHE} DDIM",
        lambda: sd2.txt2img(PROMPT, SD2_RES, seed=77,
                            deepcache=DEEPCACHE, **kw),
        {"cached": cached, "shallow": n2 - cached}, 1, a2, SD2_RES)
    pc = dataclasses.replace(sd2, controlnet=w["net"])
    req(pc, "SD 2.1-768 v ControlNet DDIM (SD 2.x's 4-level trunk)",
        lambda: pc.txt2img(PROMPT, SD2_RES, seed=78,
                           control_image=first2[0], **kw),
        {"full": n2, "trunk": n2}, 1, a2, SD2_RES)
    skip2 = dataclasses.replace(sd2, clip_skip=1)
    req(skip2, "SD 2.1-768 v penultimate hidden clip_skip=1 DDIM",
        lambda: skip2.txt2img(PROMPT, SD2_RES, seed=75, **kw),
        {"full": n2}, 1, a2, SD2_RES)
    req(base, f"SD 2-base (eps) DDIM {SD2_BASE_RES}",
        lambda: base.txt2img(PROMPT, SD2_BASE_RES, seed=79, **kw),
        {"full": unet_calls(base, "ddim", M12_STEPS)}, 1, ab, SD2_BASE_RES)
    return latent


@torch.inference_mode()
def check_module12_against_plain(w: dict, sd1_latent) -> None:
    """SD 2.1-768's pair call at 768x768 (10 K1 launches) through K1 and
    through the plain attention: the UNet's raw v output within
    UNET_REL_TOL relative, as phases 8c-8e hold theirs, then the same
    rows turned into eps at ᾱ_t by _cfg_eps; the f32 SD 1.5 decode of
    sd1_latent (one f32 d=512 launch at [1,1,4096,512]) through both,
    within VAE_LEVEL_TOL."""
    sd1, sd2 = w["sd1"], w["sd2"]
    dtype, dev, cfg = sd2.compute_dtype, sd2.device, sd2.diffuser_cfg
    cond = sd2.conditioning(PROMPT, SD2_RES).astype(dtype)
    ctx2, ch2 = _cfg_contexts(cfg, cond, dtype)
    kv = precompute_cross_kv(sd2.unet, ctx2)
    g = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn((1, SD2_RES[0] // 8, SD2_RES[1] // 8, 4), generator=g,
                    device=dev)
    x2 = torch.cat([x, x]).to(dtype)
    att = unet_attentions(cfg.unet_config(), SD2_RES)
    t = torch.tensor(500, device=dev)
    label = f"SD 2.1-768 v-prediction pair call B=2 {SD2_RES[0]}x{SD2_RES[1]}"

    def pair_eps(t):
        # the pair's rows and contexts as one unguided batch-2 call
        return _cfg_eps(sd2.unet, cfg, x2, t, ctx2, ch2, 1.0, dtype, kv,
                        use_cfg=False, alpha_t=sd2.alphas_cumprod[t])

    hold_calls_to_plain([
        (f"{label} (raw v)", att["full"],
         lambda t: unet_forward(sd2.unet, x2, t.expand(2), ctx2, ch2)),
        (f"{label} (eps at alpha_t)", att["full"], pair_eps)], t)

    def decode():
        return decode_latent_to_images(sd1.vae, sd1_latent,
                                       sd1.scale_factor).int()

    fa.reset_launch_counts()
    img_k = decode()
    torch.cuda.synchronize()
    n = fa.launch_counts[F32_D512]
    img_p = with_attention(decode, plain_attention)
    levels = (img_k - img_p).abs().max().item()
    print(f"SD 1.5 f32 decode {SD1_RES}: f32 d=512 launches {n}; image max "
          f"diff {levels} levels (tol {VAE_LEVEL_TOL})", flush=True)
    if n != 1 or levels > VAE_LEVEL_TOL:
        fail("the SD 1.5 decode through K1 disagrees with the plain "
             "attention")


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
        if what == "embedder" and isinstance(loaded, sd1_mod.SD1Pipeline):
            # a diffusers text_encoder (HF CLIPTextModel) has no projection
            sa.pop("text_projection", None)
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


def checkpoint_cli_phase(pipe, total, p_lcm, m11, m12) -> None:
    """Phase 9b: write the pipeline, refiner included, as a native
    checkpoint; answer requests through the sample CLI from it (a txt2img,
    one with --use-refiner, an inpaint of the first one's PNG with a mask
    PNG, two k-samplers, --clip-skip 1, phase 8d's --freeu, --pag-scale,
    --deepcache and --invert-img, and phase 8e's --controlnet and
    --ip-adapter from files the port's writers made, --hires-scale and
    --vae-tile), then from a native checkpoint of the LCM-distilled
    pipeline p_lcm written in its place (--sampler lcm), then from one of
    phase 8e's 8-channel pipeline (--edit-image), then --family sd1 and
    --family sd2 --clip-skip 1 from diffusers directories of phase 8f's SD
    1.5 and SD 2-base pipelines that the port's writer made, and hold each
    load and image against the in-memory pipeline."""
    modules = [pipe.embedder, pipe.unet, pipe.vae, pipe.vae_encoder,
               pipe.refiner, m11["nets"][0], m11["vision"],
               m11["adapters"]["proj"]]
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
    real_sd1_load = sd1_mod.load_sd1_pipeline

    def timed(load):
        def timed_load(*args, **kw):
            t0 = time.perf_counter()
            out = load(*args, **kw)
            torch.cuda.synchronize()
            loads.append((time.perf_counter() - t0, out))
            return out
        return timed_load

    timed_load = timed(real_load)

    def cli_request(label, argv, want_unet, want_vae, refiner=False,
                    want_pipe=pipe, extras=(), k4=()):
        """Run the CLI on argv; fail unless it returned 0, launched K1's
        routes want_unet and want_vae times (and each K4 route in k4) and
        loaded want_pipe's in-memory state, and each (attribute, module)
        of extras (a ControlNet, an adapter, its tower) bitwise. Returns
        the load's seconds."""
        print(f"-- python -m sdxl_tpu_torch.cli.sample {' '.join(argv)}",
              flush=True)
        loader_mod.load_pipeline = timed_load
        sd1_mod.load_sd1_pipeline = timed(real_sd1_load)
        try:
            rc = run_path(label, lambda: sample_cli.main(argv),
                          ([F32_D512] if want_unet == 0 else
                           ["sdxl_flash_attention_bf16", F32_D512])
                          + list(k4), total)
        finally:
            loader_mod.load_pipeline = real_load
            sd1_mod.load_sd1_pipeline = real_sd1_load
        got = (fa.launch_counts["sdxl_flash_attention_bf16"],
               fa.launch_counts[F32_D512])
        if rc != 0:
            fail(f"the sample CLI returned {rc} in {label}")
        if got != (want_unet, want_vae):
            fail(f"{label} launched K1 {got[0]} (bf16 d 64/128) and {got[1]}"
                 f" (f32 d=512) times, not {want_unet} and {want_vae}")
        (load_s, loaded), = loads
        loads.clear()
        check_loaded_state(want_pipe, loaded, refiner)
        for attr, module in extras:
            sa, sb = module.state_dict(), getattr(loaded, attr).state_dict()
            if sorted(sa) != sorted(sb) or any(
                    sa[k].dtype != sb[k].dtype or not torch.equal(sa[k], sb[k])
                    for k in sa):
                fail(f"{label}: the loaded {attr} differs from the "
                     f"in-memory one")
            print(f"loaded {attr}: {sum(v.numel() for v in sa.values())} "
                  f"parameters bitwise equal", flush=True)
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

        # module 14: the base UNet's block linears at int8, loaded bitwise
        # as quantize_unet leaves a copy of the in-memory one
        unet_q = copy.deepcopy(pipe.unet)
        loader_mod.quantize_unet(unet_q, 8)
        q = dataclasses.replace(pipe, unet=unet_q)
        out_q = os.path.join(CKPT_DIR, "out", "quantized")
        cli_request("the sample CLI --quantize int8 request",
                    argv[:-1] + [out_q, "--quantize", "int8"],
                    UNET_LAUNCHES_1024, 1, want_pipe=q, k4=[BF16_INT8])
        check_png("the CLI's --quantize int8 image", out_q + "0.png",
                  q.txt2img(PROMPT, resolution=(1024, 1024), n_steps=30,
                            guidance_scale=7.5, seed=0)[0])
        del q, unet_q
        gc.collect()
        torch.cuda.empty_cache()

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

        for sampler, schedule in (("dpmpp", "karras"), ("euler_a", "linear")):
            flags = ["--sampler", sampler, "--schedule", schedule]
            out_k = os.path.join(CKPT_DIR, "out", sampler)
            cli_request(f"the sample CLI {' '.join(flags)} request",
                        argv[:-1] + [out_k] + flags,
                        UNET_LAUNCHES_1024 // 31
                        * unet_calls(pipe, sampler, 30, schedule), 1)
            check_png(f"the CLI's {sampler} {schedule} image", out_k + "0.png",
                      pipe.txt2img(PROMPT, resolution=(1024, 1024),
                                   n_steps=30, guidance_scale=7.5, seed=0,
                                   sampler=sampler, schedule=schedule)[0])

        # module 12's --clip-skip on SDXL: both towers one block earlier
        out_c = os.path.join(CKPT_DIR, "out", "clip_skip")
        cli_request("the sample CLI --clip-skip 1 request",
                    argv[:-1] + [out_c, "--clip-skip", "1"],
                    UNET_LAUNCHES_1024, 1)
        pipe.clip_skip = 1
        try:
            want = pipe.txt2img(PROMPT, resolution=(1024, 1024), n_steps=30,
                                guidance_scale=7.5, seed=0)[0]
        finally:
            pipe.clip_skip = 0
        check_png("the CLI's --clip-skip 1 image", out_c + "0.png", want)

        # phase 8d's flags (--deepcache's default branch is DEEPCACHE's)
        att = unet_attentions(pipe.diffuser_cfg.unet_config())
        n = unet_calls(pipe, "ddim", 30)
        cached = len(range(0, n, DEEPCACHE[0]))
        req = dict(resolution=(1024, 1024), n_steps=30, guidance_scale=7.5,
                   seed=0)

        def freeu_image():
            cfg = pipe.diffuser_cfg
            try:
                pipe.diffuser_cfg = dataclasses.replace(cfg, freeu=FREEU)
                return pipe.txt2img(PROMPT, **req)
            finally:
                pipe.diffuser_cfg = cfg

        def inverted_image():
            src = read_png(out + "0.png")[0][None]
            inv = pipe.ddim_invert([""], src, n_steps=30)
            return pipe.txt2img(PROMPT, initial_latent=inv, **req)

        for name, flags, want_unet, want_vae, image in (
                ("freeu", ["--freeu"], n * att["full"], 1, freeu_image),
                ("pag", ["--pag-scale", str(PAG_SCALE)],
                 n * (att["full"] + att["pag"]), 1,
                 lambda: pipe.txt2img(PROMPT, pag_scale=PAG_SCALE, **req)),
                ("deepcache", ["--deepcache", str(DEEPCACHE[0])],
                 cached * att["cached"] + (n - cached) * att["shallow"], 1,
                 lambda: pipe.txt2img(PROMPT, deepcache=DEEPCACHE, **req)),
                ("inverted", ["--invert-img", out + "0.png"],
                 2 * n * att["full"], 2, inverted_image)):
            out_x = os.path.join(CKPT_DIR, "out", name)
            cli_request(f"the sample CLI {' '.join(flags)} request",
                        argv[:-1] + [out_x] + flags, want_unet, want_vae)
            check_png(f"the CLI's {' '.join(flags)} image", out_x + "0.png",
                      image()[0])

        # phase 8e's flags: a ControlNet directory and an IP-Adapter file
        # with its encoder directory from the port's writers
        t0 = time.perf_counter()
        net, vision = m11["nets"][0], m11["vision"]
        adapter = m11["adapters"]["proj"]
        cn_dir = write_diffusers_controlnet_dir(
            os.path.join(CKPT_DIR, "controlnet"), net)
        enc_dir = save_clip_vision_dir(os.path.join(CKPT_DIR, "encoder"),
                                       vision)
        ip_file = save_ip_adapter_file(
            os.path.join(CKPT_DIR, "ip-adapter_sdxl_vit-h.safetensors"),
            adapter)
        ip_png, = save_images(read_png(out + "0.png")[0][None, :768, :640],
                              os.path.join(CKPT_DIR, "out", "ip_image"))
        print(f"ControlNet, IP-Adapter and encoder written in "
              f"{time.perf_counter() - t0:.3f}s", flush=True)
        first_png = read_png(out + "0.png")[0]
        hires = tuple(round(r * HIRES_SCALE / 8) * 8 for r in (1024, 1024))
        n_hires = unet_calls(pipe, "ddim", 30, step_start=int(
            round((1 - HIRES_STRENGTH) * 1000)))
        for name, flags, want_unet, want_vae, extras, image in (
                ("controlnet", ["--controlnet", cn_dir, "--control-image",
                                out + "0.png"],
                 n * (att["full"] + att["trunk"]), 1,
                 (("controlnet", net),),
                 lambda: dataclasses.replace(pipe, controlnet=net).txt2img(
                     PROMPT, control_image=first_png, **req)),
                ("ip_adapter", ["--ip-adapter", ip_file,
                                "--ip-image-encoder", enc_dir,
                                "--ip-image", ip_png],
                 n * att["full"], 1,
                 (("ip_adapter", adapter), ("ip_vision", vision)),
                 lambda: with_ip(pipe, m11, "proj").txt2img(
                     PROMPT, ip_adapter_image=read_png(ip_png)[0],
                     ip_adapter_scale=IP_SCALE, **req)),
                ("hires", ["--hires-scale", str(HIRES_SCALE)],
                 (n + n_hires) * att["full"], 1, (),
                 lambda: pipe.txt2img_hires(
                     PROMPT, hires_scale=HIRES_SCALE,
                     hires_strength=HIRES_STRENGTH, **req)),
                ("tiled", ["--vae-tile", str(VAE_TILE)], n * att["full"], 4,
                 (), lambda: dataclasses.replace(
                     pipe, vae_tile=VAE_TILE).txt2img(PROMPT, **req))):
            out_x = os.path.join(CKPT_DIR, "out", name)
            cli_request(f"the sample CLI {' '.join(flags)} request",
                        argv[:-1] + [out_x] + flags, want_unet, want_vae,
                        extras=extras)
            want = image()[0]
            if name == "hires" and want.shape != (*hires, 3):
                fail(f"the hires-fix image is {want.shape}")
            check_png(f"the CLI's {' '.join(flags[:1])} image",
                      out_x + "0.png", want)

        # the distilled pipeline's checkpoint in the base's place
        shutil.rmtree(ckpt)
        ckpt_lcm = os.path.join(CKPT_DIR, "lcm")
        t0 = time.perf_counter()
        save_native_pipeline(ckpt_lcm, p_lcm)
        print(f"LCM-distilled checkpoint written in "
              f"{time.perf_counter() - t0:.3f}s", flush=True)
        out_l = os.path.join(CKPT_DIR, "out", "lcm")
        steps = len(lcm_timesteps(LCM_STEPS))
        cli_request("the sample CLI --sampler lcm request",
                    ["--model-dir", ckpt_lcm, "--prompt", PROMPT, "-steps",
                     str(LCM_STEPS), "-gs", str(LCM_GS), "--seed", "0",
                     "--sampler", "lcm", "--output-dir", out_l],
                    steps * att["full"], 1, want_pipe=p_lcm)
        check_png("the CLI's --sampler lcm image", out_l + "0.png",
                  p_lcm.txt2img(PROMPT, resolution=(1024, 1024),
                                n_steps=LCM_STEPS, guidance_scale=LCM_GS,
                                seed=0, sampler="lcm")[0])

        # phase 8e's 8-channel InstructPix2Pix pipeline in its place
        shutil.rmtree(ckpt_lcm)
        edit = m11["edit"]
        ckpt_edit = os.path.join(CKPT_DIR, "ip2p")
        t0 = time.perf_counter()
        save_native_pipeline(ckpt_edit, edit)
        print(f"8-channel InstructPix2Pix checkpoint written in "
              f"{time.perf_counter() - t0:.3f}s", flush=True)
        out_e = os.path.join(CKPT_DIR, "out", "edited")
        cli_request("the sample CLI --edit-image request",
                    ["--model-dir", ckpt_edit, "--prompt", PROMPT, "-steps",
                     "30", "-gs", "7.5", "--seed", "0", "--edit-image",
                     out + "0.png", "--output-dir", out_e],
                    n * att["full"], 2, want_pipe=edit)
        check_png("the CLI's --edit-image image", out_e + "0.png",
                  edit.ip2p(PROMPT, first_png[None], n_steps=30,
                            guidance_scale=7.5,
                            image_guidance_scale=IP2P_IMAGE_GS, seed=0)[0])
        shutil.rmtree(ckpt_edit)

        # module 12: SD 1.5 and SD 2-base diffusers directories from the
        # port's writer (sd2=True: the tokenizer directory pads with "!",
        # which the CLIP tokenizer reads as the reference's does: EOT)
        for family, sd, res, flags in (
                ("sd1", m12["sd1"], SD1_RES, []),
                ("sd2", m12["sd2_base"], SD2_RES, ["--clip-skip", "1"])):
            d = os.path.join(CKPT_DIR, family)
            t0 = time.perf_counter()
            write_sd1_diffusers_pipeline_dir(d, sd, sd2=family == "sd2")
            written = sum(os.path.getsize(os.path.join(r, f))
                          for r, _, fs in os.walk(d) for f in fs)
            print(f"{family} diffusers directory written: {written} bytes in "
                  f"{time.perf_counter() - t0:.3f}s", flush=True)
            att = unet_attentions(sd.diffuser_cfg.unet_config(), res)
            out_f = os.path.join(CKPT_DIR, "out", family)
            cli_request(
                f"the sample CLI --family {family} {' '.join(flags)} "
                f"request", ["--family", family, "--model-dir", d,
                             "--prompt", PROMPT, "--height", str(res[0]),
                             "--width", str(res[1]), "-steps", "30", "-gs",
                             "7.5", "--seed", "0", "--output-dir", out_f,
                             *flags],
                unet_calls(sd, "ddim", 30) * att["full"], 1, want_pipe=sd)
            sd.clip_skip = 1 if flags else 0
            try:
                want = sd.txt2img(PROMPT, resolution=res, n_steps=30,
                                  guidance_scale=7.5, seed=0)[0]
            finally:
                sd.clip_skip = 0
            check_png(f"the CLI's --family {family} {' '.join(flags)} image",
                      out_f + "0.png", want)
            shutil.rmtree(d)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 8g: module 13 (SD3 / SD3.5, FLUX.1)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counting_transformer_calls():
    """Inside, the flow-matching loops' transformer calls are counted:
    "full" calls, and skip-layer guidance's "slg" calls (skip_layers
    set)."""
    calls = Counter()
    real = {(flow_match_mod, "mmdit_forward"): mmdit_forward,
            (flux_mod, "flux_forward"): flux_forward}

    def counted(fn):
        def call(*args, **kw):
            calls["slg" if kw.get("skip_layers") else "full"] += 1
            return fn(*args, **kw)
        return call

    for (mod, name), fn in real.items():
        setattr(mod, name, counted(fn))
    try:
        yield calls
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)


def mmdit_launches(cfg: MMDiTConfig, res, batch_tokens: int = 333,
                   skip=()) -> int:
    """K1 launches of one MMDiT call at `res`: each joint attention over
    the latent's patches and the 77 + 256 text tokens, and each
    dual-attention block's attn2 over the patches alone, as use_flash
    routes them; blocks in `skip` run none."""
    n_img = (res[0] // 16) * (res[1] // 16)
    joint = fa.use_flash(n_img + batch_tokens, n_img + batch_tokens,
                         cfg.head_dim, False)
    own = fa.use_flash(n_img, n_img, cfg.head_dim, False)
    return sum(joint + own * (i in cfg.dual_attention_layers)
               for i in range(cfg.num_layers) if i not in skip)


def flux_launches(cfg: FluxConfig, res, n_txt: int, cond_res=None) -> int:
    """K1 launches of one FLUX.1 call: every double and single block's
    attention over the text, the image (and Kontext's reference) tokens,
    as use_flash routes them."""
    t = n_txt + (res[0] // 16) * (res[1] // 16)
    if cond_res is not None:
        t += (cond_res[0] // 16) * (cond_res[1] // 16)
    return fa.use_flash(t, t, cfg.head_dim, False) * (
        cfg.num_layers + cfg.num_single_layers)


def module13_request(pipe, label: str, fn, want_calls: dict, want_k1: int,
                     want_vae: int, res=M13_RES,
                     route: str = "sdxl_flash_attention_bf16"):
    """One phase-8g request: latency, stage split, transformer calls, K1
    launches and peak memory printed; fail unless the calls are
    want_calls, K1's `route` (the transformer's) was launched want_k1
    times and its f32 d=512 route want_vae times (the VAE's decode and
    encode; T5's and CLIP's attentions never reach K1), and the final
    latent is finite and the image uint8 of `res`. Returns the images."""
    pipe.timer.stages.clear()
    torch.cuda.reset_peak_memory_stats()
    before = dict(fa.launch_counts)
    with counting_transformer_calls() as calls:
        t0 = time.perf_counter()
        out = fn()
        latency = time.perf_counter() - t0
    peak_gib = PEAKS[label] = torch.cuda.max_memory_allocated() / 2**30
    stages = " ".join(f"{k}={v:.3f}s" for k, v in pipe.timer.stages.items())
    launches = {k: n - before[k] for k, n in fa.launch_counts.items()
                if n != before[k]}
    lat = pipe.last_latent
    print(f"request {label}: latency={latency:.3f}s {stages} "
          f"transformer_calls={dict(calls)} (predicted {want_calls}) "
          f"peak_mem={peak_gib:.2f}GiB launches={launches} max|latent|="
          f"{lat.abs().max().item():.4g}", flush=True)
    got = (launches.get(route, 0), launches.get(F32_D512, 0))
    if dict(calls) != {k: n for k, n in want_calls.items() if n} or \
            got != (want_k1, want_vae):
        fail(f"{label}: transformer calls {dict(calls)} and K1 launched "
             f"{got[0]} ({route}) and {got[1]} (f32 d=512) times, not "
             f"{want_calls}, {want_k1} and {want_vae}")
    if not bool(torch.isfinite(lat).all()):
        fail(f"non-finite latent in {label}")
    if out.shape != (1, *res, 3) or out.dtype.name != "uint8" or \
            out.std() == 0:
        fail(f"{label}: images {out.shape} {out.dtype}")
    return out


def draw(module, seed: int):
    """A meta-device module materialised on the card and drawn with the
    reference's init from a seeded CUDA generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return init_reference_(module.to_empty(device="cuda"), g).eval(
    ).requires_grad_(False)


def late_norm_attention(q, k, v) -> torch.Tensor:
    """A second plain attention that rounds where K1 does: p = exp2(s - m)
    rounded to v's dtype unnormalised, divided by l after the product (the
    plain version normalises p before it rounds). In query chunks, as
    plain_attention."""
    def attn(q):
        s = fa._prescale_q(q).float() @ k.float().transpose(-1, -2)
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        o = p.to(v.dtype).float() @ v.float()
        return (o / p.sum(dim=-1, keepdim=True)).to(v.dtype)

    b, h, tq, _ = q.shape
    rows = max(1, PLAIN_CHUNK_BYTES // (b * h * k.shape[2] * 4))
    return torch.cat([attn(q[:, :, i:i + rows]) for i in range(0, tq, rows)],
                     dim=2)


def held_attention(worst: list):
    """K1 (ops.attention's flash_attention_bhtd) with each call's output
    also held to the plain attention on the same q, k, v; appends
    (max abs error / max|plain|, relative L2) of every call to worst."""
    def attn(q, k, v):
        out = fa.flash_attention_bhtd(q, k, v)
        err, rel, ref_max = readings(out, plain_attention(q, k, v))
        worst.append((err / ref_max, rel))
        return out
    return attn


def hold_to_plain(label: str, call, route: str, want_n: int,
                  tol: float) -> None:
    """call() through K1 and through the plain attention (in query
    chunks). Three readings:

    - each of K1's want_n launches of `route` on its own q, k, v against
      the plain attention on the same inputs: max abs error within
      K1_PATH_TOL of max|plain output| and relative L2 within K1_REL_TOL
      (phase 3's) — K1's own error at the path's inputs, which a sound
      kernel reads well inside (about one bf16 ulp);
    - the raw output within tol of its largest magnitude, which also
      carries the rounding that builds up over every block after the
      first difference;
    - a control, not held: the raw output through late_norm_attention
      (plain math that rounds at K1's points) against the plain
      attention, how far rounding alone moves the output at this depth.
    """
    worst = []
    fa.reset_launch_counts()
    out_k = with_attention(call, held_attention(worst)).float()
    torch.cuda.synchronize()
    n = fa.launch_counts[route]
    out_p = with_attention(call, plain_attention).float()
    out_c = with_attention(call, late_norm_attention).float()
    big = out_p.abs().max()
    rel = ((out_k - out_p).abs().max() / big).item()
    rel_c = ((out_c - out_p).abs().max() / big).item()
    l2, l2_c = ((out_k - out_p).norm() / out_p.norm()).item(), \
        ((out_c - out_p).norm() / out_p.norm()).item()
    call_max = max(w[0] for w in worst) if worst else float("nan")
    call_l2 = max(w[1] for w in worst) if worst else float("nan")
    dtype = torch.float32 if route in TF32_KERNELS else torch.bfloat16
    print(f"{label}: {route} launches {n}; per call against the plain "
          f"attention on its inputs: worst max_err/max {call_max:.3e} (tol "
          f"{K1_PATH_TOL[dtype]:g}), worst rel_l2 {call_l2:.3e} (tol "
          f"{K1_REL_TOL[dtype]:g}); raw output rel_err={rel:.3e} (tol "
          f"{tol:g}), rel_l2 {l2:.3e}; control (plain math at K1's rounding "
          f"points) rel_err={rel_c:.3e}, rel_l2 {l2_c:.3e}; max|out| "
          f"{big.item():.4g}", flush=True)
    if n != want_n or len(worst) != want_n:
        fail(f"the {label} launched {route} {n} times ({len(worst)} "
             f"attention calls), not {want_n}")
    if not (call_max < K1_PATH_TOL[dtype] and call_l2 < K1_REL_TOL[dtype]):
        fail(f"the {label}: a K1 call disagrees with the plain attention on "
             "its own inputs")
    if not (bool(torch.isfinite(out_k).all()) and rel < tol):
        fail(f"the {label} through K1 disagrees with the plain attention")
    del out_k, out_p, out_c
    torch.cuda.empty_cache()


@torch.inference_mode()
def check_mmdit_against_plain(pipe, label: str, sigma_index: int) -> None:
    """One pair-batched CFG call of the pipeline's MMDiT at 1024x1024 at a
    fractional timestep of the 28-step schedule, through K1 and through
    the plain attention."""
    cfg, dtype = pipe.mmdit.cfg, pipe.mmdit.dtype
    ctx, pooled = pipe.conditioning(PROMPT, M13_NEGATIVE)
    g = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn((1, M13_RES[0] // 8, M13_RES[1] // 8, cfg.in_channels),
                    generator=g, device="cuda")
    t = float(flow_match_mod.fm_schedule(M13_STEPS)[0][sigma_index])
    t2 = torch.full((2,), t, device="cuda")
    hold_to_plain(
        f"{label} pair call B=2 at t={t!r}",
        lambda: mmdit_forward(pipe.mmdit, torch.cat([x, x]).to(dtype), t2,
                              ctx.to(dtype), pooled.to(dtype)),
        "sdxl_flash_attention_bf16", mmdit_launches(cfg, M13_RES),
        UNET_REL_TOL)


@torch.inference_mode()
def check_flux_against_plain(pipe, edit_latent) -> None:
    """One FLUX.1-dev call at 1024x1024 and one Kontext call (with
    edit_latent as the reference stream) through K1 and through the
    plain attention, within UNET_REL_TOL."""
    cfg = pipe.flux.cfg
    ctx, pooled = pipe.conditioning(PROMPT)
    g = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn((1, M13_RES[0] // 8, M13_RES[1] // 8, 16), generator=g,
                    device="cuda")
    ts, _ = pipe._schedule(M13_STEPS, *M13_RES)
    t = torch.full((1,), float(ts[9]), device="cuda")
    gd = torch.full((1,), FLUX_GS * 1000.0, device="cuda")
    bf = torch.bfloat16
    n_txt = ctx.shape[1]
    hold_to_plain(
        f"FLUX.1-dev call at t={float(t)!r}",
        lambda: flux_forward(pipe.flux, x.to(bf), t, ctx.to(bf),
                             pooled.to(bf), gd),
        "sdxl_flash_attention_bf16", flux_launches(cfg, M13_RES, n_txt),
        UNET_REL_TOL)
    hold_to_plain(
        f"FLUX.1-dev Kontext call at t={float(t)!r}",
        lambda: flux_forward(pipe.flux, x.to(bf), t, ctx.to(bf),
                             pooled.to(bf), gd,
                             cond_latent=edit_latent.to(bf)),
        "sdxl_flash_attention_bf16",
        flux_launches(cfg, M13_RES, n_txt, M13_RES), UNET_REL_TOL)


@torch.inference_mode()
def check_f32_flux_against_plain(pipe) -> None:
    """One call of the pipeline's f32 FLUX.1 transformer at 1024x1024
    through K1's f32 d=128 route and through the plain attention, within
    F32_UNET_REL_TOL."""
    cfg = pipe.flux.cfg
    ctx, pooled = pipe.conditioning(PROMPT)
    g = torch.Generator(device="cuda").manual_seed(18)
    x = torch.randn((1, M13_RES[0] // 8, M13_RES[1] // 8, 16), generator=g,
                    device="cuda")
    ts, _ = pipe._schedule(M13_STEPS, *M13_RES)
    t = torch.full((1,), float(ts[9]), device="cuda")
    gd = torch.full((1,), FLUX_GS * 1000.0, device="cuda")
    hold_to_plain(
        f"f32 FLUX.1 call ({cfg.num_layers} double, {cfg.num_single_layers}"
        f" single blocks, full width) at t={float(t)!r}",
        lambda: flux_forward(pipe.flux, x, t, ctx.float(), pooled.float(),
                             gd),
        F32_D128, flux_launches(cfg, M13_RES, ctx.shape[1]),
        F32_UNET_REL_TOL)


def sd3_medium_requests(sd3) -> dict:
    """SD3-medium at 1024x1024, 28 steps, CFG 7: txt2img, no_cfg, without
    T5, img2img at M13_STRENGTH of the first image, a crop-window
    inpaint. Returns the no-T5 request's image and arguments (phase 9b's
    --family sd3 --no-t5 request is held to it)."""
    n = M13_STEPS
    kw = dict(n_steps=n, guidance_scale=SD3_GS, negative_prompt=M13_NEGATIVE)
    a = mmdit_launches(sd3.mmdit.cfg, M13_RES)
    print(f"K1 launches an SD3-medium call at {M13_RES}: {a}", flush=True)
    first = module13_request(
        sd3, f"SD3-medium txt2img CFG {SD3_GS} {n} steps (T5-XXL f32)",
        lambda: sd3.txt2img(PROMPT, M13_RES, seed=80, **kw), {"full": n},
        n * a, 1)
    module13_request(
        sd3, "SD3-medium txt2img no_cfg",
        lambda: sd3.txt2img(PROMPT, M13_RES, seed=81, no_cfg=True, **kw),
        {"full": n}, n * a, 1)
    no_t5 = dataclasses.replace(sd3, t5=None)
    no_t5_kw = dict(seed=82, n_steps=n, guidance_scale=SD3_GS)
    no_t5_image = module13_request(
        no_t5, "SD3-medium txt2img without T5 (zeros)",
        lambda: no_t5.txt2img(PROMPT, M13_RES, **no_t5_kw), {"full": n},
        n * a, 1)
    n_i2i = n - flow_match_mod.fm_window(n, M13_STRENGTH)
    module13_request(
        sd3, f"SD3-medium img2img strength {M13_STRENGTH}",
        lambda: sd3.img2img(PROMPT, first, strength=M13_STRENGTH, seed=83,
                            **kw), {"full": n_i2i}, n_i2i * a, 2)
    module13_request(
        sd3, f"SD3-medium crop-window inpaint {CROP_WINDOW}",
        lambda: sd3.inpaint(PROMPT, first, seed=84, **CROP_WINDOW, **kw),
        {"full": n}, n * a, 2)
    return dict(image=no_t5_image, kw=no_t5_kw)


def sd35_request(pipe, label: str, slg: bool):
    """One SD3.5 txt2img at 1024x1024, 28 steps, CFG 7 (with skip-layer
    guidance at its default layers 7-9 when slg)."""
    n, cfg = M13_STEPS, pipe.mmdit.cfg
    layers = (7, 8, 9)
    on = sum(n * 0.01 < i < n * 0.2 for i in range(n)) if slg else 0
    extra = dict(slg_scale=SLG_SCALE) if slg else {}
    return module13_request(
        pipe, label, lambda: pipe.txt2img(
            PROMPT, M13_RES, n_steps=n, guidance_scale=SD3_GS, seed=85,
            negative_prompt=M13_NEGATIVE, **extra),
        {"full": n, "slg": on},
        n * mmdit_launches(cfg, M13_RES)
        + on * mmdit_launches(cfg, M13_RES, skip=layers), 1)


def flux_dev_requests(flux):
    """FLUX.1-dev at 1024x1024, 28 steps, guidance 3.5: txt2img, true CFG
    over a negative prompt, img2img, a crop-window inpaint and a Kontext
    edit of the txt2img image. Returns the txt2img image."""
    n, cfg = M13_STEPS, flux.flux.cfg
    a = flux_launches(cfg, M13_RES, flux.t5_tokens)
    print(f"K1 launches a FLUX.1-dev call at {M13_RES}: {a}", flush=True)
    kw = dict(n_steps=n, guidance_scale=FLUX_GS)
    first = module13_request(
        flux, f"FLUX.1-dev txt2img guidance {FLUX_GS} {n} steps",
        lambda: flux.txt2img(PROMPT, M13_RES, seed=90, **kw), {"full": n},
        n * a, 1)
    module13_request(
        flux, f"FLUX.1-dev true CFG {TRUE_CFG_SCALE} (negative prompt)",
        lambda: flux.txt2img(PROMPT, M13_RES, seed=91,
                             negative_prompt=M13_NEGATIVE,
                             true_cfg_scale=TRUE_CFG_SCALE, **kw),
        {"full": n}, n * a, 1)
    n_i2i = n - flow_match_mod.fm_window(n, M13_STRENGTH)
    module13_request(
        flux, f"FLUX.1-dev img2img strength {M13_STRENGTH}",
        lambda: flux.img2img(PROMPT, first, strength=M13_STRENGTH, seed=92,
                             **kw), {"full": n_i2i}, n_i2i * a, 2)
    module13_request(
        flux, f"FLUX.1-dev crop-window inpaint {CROP_WINDOW}",
        lambda: flux.inpaint(PROMPT, first, seed=93, **CROP_WINDOW, **kw),
        {"full": n}, n * a, 2)
    module13_request(
        flux, "FLUX.1-dev Kontext edit of the txt2img image (guidance 2.5)",
        lambda: flux.kontext(PROMPT, first, seed=94, n_steps=n,
                             guidance_scale=2.5), {"full": n},
        n * flux_launches(cfg, M13_RES, flux.t5_tokens, M13_RES), 2)
    return first


def flux_cli_twins(flux, first) -> dict:
    """Phase 9b's --family flux CLI requests in memory (M13_CLI_STEPS
    steps: plain, true CFG, Kontext of the KONTEXT_EDIT_HW crop of the
    txt2img image, saved as a PNG under KONTEXT_EDIT_DIR and read back
    through the CLI's own kontext_edit_image, which LANCZOS-resizes it).
    Returns their images, the edit PNG's path and the requests'
    arguments."""
    cfg, m = flux.flux.cfg, M13_CLI_STEPS
    a = flux_launches(cfg, M13_RES, flux.t5_tokens)
    cli = dict(n_steps=m, guidance_scale=FLUX_GS, seed=95)
    eh, ew = KONTEXT_EDIT_HW
    shutil.rmtree(KONTEXT_EDIT_DIR, ignore_errors=True)
    edit_png, = save_images(first[:1, :eh, :ew],
                            os.path.join(KONTEXT_EDIT_DIR, "edit"))
    edit = sample_cli.kontext_edit_image(edit_png)
    ehw = edit.shape[1:3]
    twins = {
        "plain": module13_request(
            flux, f"FLUX.1-dev txt2img {m} steps (the CLI's twin)",
            lambda: flux.txt2img(PROMPT, M13_RES, **cli), {"full": m},
            m * a, 1),
        "true_cfg": module13_request(
            flux, f"FLUX.1-dev true CFG {m} steps (the CLI's twin)",
            lambda: flux.txt2img(PROMPT, M13_RES,
                                 negative_prompt=M13_NEGATIVE,
                                 true_cfg_scale=TRUE_CFG_SCALE, **cli),
            {"full": m}, m * a, 1),
        "kontext": module13_request(
            flux, f"FLUX.1-dev Kontext of the {ew}x{eh} PNG resized to "
            f"{ehw[1]}x{ehw[0]}, {m} steps (the CLI's twin)",
            lambda: flux.kontext(PROMPT, edit, **cli), {"full": m},
            m * flux_launches(cfg, ehw, flux.t5_tokens, ehw), 2, res=ehw),
    }
    return dict(twins=twins, edit_png=edit_png, cli=cli)


def module13_phase(total) -> dict:
    """Phase 8g: the SD3 family (SD3-medium's requests, SD3.5-large's,
    SD3.5-medium's with skip-layer guidance), then FLUX.1 (dev's
    requests, an f32 request at reduced depth, phase 9b's twins,
    schnell's request), one family resident at a time; each request a
    path of its own, the calls held to the plain attention after their
    path. Returns what phase 9b's module-13 requests are held to: the
    SD3-medium pipeline without T5 with its no-T5 image, and the FLUX.1
    twins."""
    t0 = time.perf_counter()
    sd3 = sd3_mod.random_sd3_pipeline(31, device="cuda",
                                      t5_cfg=T5_XXL_CONFIG)
    torch.cuda.synchronize()
    print(f"random_sd3_pipeline(t5_cfg=T5_XXL_CONFIG): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    bf16 = ["sdxl_flash_attention_bf16", F32_D512]
    sd3_out = run_path("the SD3-medium requests",
                       lambda: sd3_medium_requests(sd3), bf16, total)
    check_mmdit_against_plain(sd3, "SD3-medium", 9)
    sd3_out["pipe"] = dataclasses.replace(sd3, t5=None)
    for label, cfg, seed, slg in (
            ("SD3.5-large", SD35_LARGE, 32, False),
            ("SD3.5-medium", SD35_MEDIUM, 33, True)):
        t0 = time.perf_counter()
        p = dataclasses.replace(sd3, mmdit=draw(MMDiT(cfg, "meta"), seed))
        torch.cuda.synchronize()
        print(f"{label} transformer drawn: {time.perf_counter() - t0:.1f}s",
              flush=True)
        run_path(f"the {label} request",
                 lambda: sd35_request(p, f"{label} txt2img CFG {SD3_GS} "
                                      f"{M13_STEPS} steps"
                                      + (f" SLG {SLG_SCALE} layers 7-9"
                                         if slg else ""), slg), bf16, total)
        if not slg:
            check_mmdit_against_plain(p, label, 9)
        del p
        gc.collect()
        torch.cuda.empty_cache()
    module14_sd3(sd3, total)
    del sd3
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    flux = flux_mod.random_flux_pipeline(0, device="cuda")
    torch.cuda.synchronize()
    print(f"random_flux_pipeline(0): {time.perf_counter() - t0:.1f}s",
          flush=True)
    first = run_path("the FLUX.1-dev requests",
                     lambda: flux_dev_requests(flux), bf16, total)
    check_flux_against_plain(flux, flux._encode(first))
    flux_out = run_path("phase 9b's FLUX.1 twins",
                        lambda: flux_cli_twins(flux, first), bf16, total)
    module14_flux(flux, total)
    f32_cfg = dataclasses.replace(FluxConfig(), num_layers=FLUX_F32_DEPTH[0],
                                  num_single_layers=FLUX_F32_DEPTH[1])
    f32 = dataclasses.replace(flux, flux=draw(Flux(f32_cfg, "meta",
                                                   torch.float32), 18))
    s = SCHNELL_STEPS
    run_path("the f32 FLUX.1 request", lambda: module13_request(
        f32, f"f32 FLUX.1 ({f32_cfg.num_layers} double, "
        f"{f32_cfg.num_single_layers} single blocks, full width) txt2img "
        f"{s} steps", lambda: f32.txt2img(PROMPT, M13_RES, n_steps=s,
                                          guidance_scale=FLUX_GS, seed=97),
        {"full": s}, s * flux_launches(f32_cfg, M13_RES, flux.t5_tokens), 1,
        route=F32_D128), [F32_D128, F32_D512], total)
    check_f32_flux_against_plain(f32)
    module14_f32_flux(f32, total)
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    schnell = dataclasses.replace(
        flux, flux=draw(Flux(FLUX_SCHNELL_CFG, "meta"), 34), t5_tokens=256,
        t5_tokenize=flow_match_mod.stub_t5_tokenizer(
            256, flux.t5.cfg.vocab_size),
        dynamic_shifting=False, static_shift=1.0)
    run_path("the FLUX.1-schnell request", lambda: module13_request(
        schnell, f"FLUX.1-schnell txt2img {s} steps (256 T5 tokens, static "
        f"shift)", lambda: schnell.txt2img(PROMPT, M13_RES, seed=96,
                                           n_steps=s),
        {"full": s}, s * flux_launches(FLUX_SCHNELL_CFG, M13_RES, 256), 1),
        bf16, total)
    del schnell, flux
    gc.collect()
    torch.cuda.empty_cache()
    return dict(sd3=sd3_out, flux=flux_out)


# ---------------------------------------------------------------------------
# phase 9b's module-13 requests
# ---------------------------------------------------------------------------

# the MMDiT's module names -> diffusers SD3Transformer2DModel's keys (the
# inverse of io/sd3.py build_mmdit_from_diffusers; neither package has an
# SD3 writer)
MMDIT_TO_DIFFUSERS = [
    (r"^blocks\.", "transformer_blocks."),
    (r"^time_text_embed\.(timestep|text)_lin(\d)\.",
     r"time_text_embed.\1_embedder.linear_\2."),
    (r"\.norm1(_context)?\.mod\.", r".norm1\1.linear."),
    (r"^norm_out\.mod\.", "norm_out.linear."),
    (r"\.(attn2?)\.to_out\.", r".\1.to_out.0."),
    (r"\.mlp\.in\.", ".ff.net.0.proj."),
    (r"\.mlp\.out\.", ".ff.net.2."),
    (r"\.mlp_context\.in\.", ".ff_context.net.0.proj."),
    (r"\.mlp_context\.out\.", ".ff_context.net.2."),
]


def mmdit_to_diffusers(model) -> dict:
    out = {}
    p, c = model.cfg.patch_size, model.cfg.in_channels
    for key, t in model.state_dict().items():
        if key == "pos_embed.proj.weight":  # (ph, pw, c) linear -> conv
            t = t.reshape(t.shape[0], p, p, c).permute(0, 3, 1, 2)
        for rx, rep in MMDIT_TO_DIFFUSERS:
            key = re.sub(rx, rep, key)
        out[key] = t.contiguous()
    return out


def write_sd3_dir(out_dir: str, pipe) -> int:
    """A diffusers stable-diffusion-3-medium-diffusers directory of the
    pipeline (transformer/, text_encoder/, text_encoder_2/, vae/,
    scheduler/; no text_encoder_3/): returns its bytes."""
    def part(name, flat, config):
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        save_file(flat, os.path.join(d, "diffusion_pytorch_model"
                                     ".safetensors"))
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(config, f)

    m = pipe.mmdit.cfg
    part("transformer", mmdit_to_diffusers(pipe.mmdit), {
        "_class_name": "SD3Transformer2DModel", "patch_size": m.patch_size,
        "in_channels": m.in_channels, "out_channels": m.out_channels,
        "num_layers": m.num_layers, "attention_head_dim": m.head_dim,
        "num_attention_heads": m.n_heads,
        "joint_attention_dim": m.joint_attention_dim,
        "pooled_projection_dim": m.pooled_projection_dim,
        "pos_embed_max_size": m.pos_embed_max_size,
        "caption_projection_dim": m.hidden})
    for name, clip in (("text_encoder", pipe.clip_l),
                       ("text_encoder_2", pipe.clip_g)):
        c = clip.cfg
        flat = clip_to_hf(clip)
        flat["text_projection.weight"] = clip.text_projection.t().contiguous()
        part(name, flat, {
            "architectures": ["CLIPTextModelWithProjection"],
            "hidden_size": c.n_state, "projection_dim": c.embed_dim,
            "num_attention_heads": c.n_head, "num_hidden_layers": c.n_layer,
            "max_position_embeddings": c.n_ctx, "vocab_size": c.n_vocab,
            "hidden_act": "quick_gelu" if c.quick_gelu else "gelu"})
    v = pipe.vae.cfg
    part("vae", vae_to_diffusers(pipe.vae, pipe.vae_encoder), {
        "_class_name": "AutoencoderKL", "latent_channels": v.latent_channels,
        "norm_num_groups": v.n_group, "scaling_factor": pipe.scale_factor,
        "shift_factor": pipe.shift_factor})
    os.makedirs(os.path.join(out_dir, "scheduler"), exist_ok=True)
    with open(os.path.join(out_dir, "scheduler", "scheduler_config.json"),
              "w") as f:
        json.dump({"_class_name": "FlowMatchEulerDiscreteScheduler",
                   "shift": pipe.flow_shift, "num_train_timesteps": 1000}, f)
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(out_dir) for f in fs)


def check_same_modules(label: str, pairs) -> None:
    """Each (name, in-memory module, loaded module): every tensor bitwise
    equal, dtype included."""
    n = 0
    for name, a, b in pairs:
        sa, sb = a.state_dict(), b.state_dict()
        if sorted(sa) != sorted(sb):
            fail(f"{label}: loaded {name} keys differ "
                 f"{sorted(set(sa) ^ set(sb))[:5]}")
        for k in sa:
            if sa[k].dtype != sb[k].dtype or not torch.equal(sa[k], sb[k]):
                fail(f"{label}: loaded {name}.{k} differs")
            n += sa[k].numel()
    print(f"{label}: {n} parameters bitwise equal to the in-memory "
          f"pipeline's ({', '.join(p[0] for p in pairs)})", flush=True)


# run in a child process: the CLI's main, then its launch counts
CLI_CHILD = ("import json, sys\n"
             "from sdxl_tpu_torch.cli.sample import main\n"
             "from sdxl_tpu_torch.ops import flash_attention as fa\n"
             "rc = main(sys.argv[1:])\n"
             "print('LAUNCHES ' + json.dumps("
             "{k: n for k, n in fa.launch_counts.items() if n}))\n"
             "sys.exit(rc)\n")


def cli_subprocess(label: str, argv, want_k1: int, want_vae: int,
                   total) -> None:
    """python -m sdxl_tpu_torch.cli.sample argv in a child process (the
    card to itself: the parent holds no transformer); fail unless it
    exits 0 having launched K1's bf16 d 64/128 route want_k1 and its f32
    d=512 route want_vae times; its launches are added to `total`."""
    print(f"-- python -m sdxl_tpu_torch.cli.sample {' '.join(argv)} "
          f"(child process)", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_CHILD, *argv],
                          capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    got = [json.loads(ln[len("LAUNCHES "):]) for ln in lines
           if ln.startswith("LAUNCHES ")]
    summary = [ln for ln in proc.stderr.splitlines()
               if "total=" in ln or "saved" in ln]
    print(f"{label}: exit {proc.returncode} in {wall:.1f}s (the child's "
          f"start, weights and request); launches {got}; "
          f"{' | '.join(summary)}", flush=True)
    if proc.returncode != 0 or not got:
        print(proc.stderr[-4000:], flush=True)
        fail(f"{label}: the CLI child exited {proc.returncode}")
    launches = got[0]
    n = (launches.get("sdxl_flash_attention_bf16", 0),
         launches.get(F32_D512, 0))
    if n != (want_k1, want_vae):
        fail(f"{label} launched K1 {n[0]} (bf16 d 64/128) and {n[1]} (f32 "
             f"d=512) times, not {want_k1} and {want_vae}")
    for name, k in launches.items():
        total[name] += k


def module13_cli_phase(total, m13) -> None:
    """Phase 9b's module-13 requests: --family sd3 --no-t5 from a
    diffusers directory of phase 8g's SD3-medium (written here, loaded
    bitwise), in this process; then --family flux --random-weights plain,
    with --true-cfg-scale over a negative prompt, and with --edit-image of
    a KONTEXT_EDIT_HW PNG (the LANCZOS resize), each in a child process
    with the card to itself; every PNG held to the in-memory image."""
    sd3 = m13["sd3"]["pipe"]
    d = os.path.join(CKPT_DIR, "sd3")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    try:
        t0 = time.perf_counter()
        written = write_sd3_dir(d, sd3)
        print(f"SD3-medium diffusers directory written: {written} bytes in "
              f"{time.perf_counter() - t0:.3f}s", flush=True)
        loads = []
        real_load = sd3_mod.load_sd3_pipeline

        def timed_load(*args, **kw):
            t0 = time.perf_counter()
            out = real_load(*args, **kw)
            torch.cuda.synchronize()
            loads.append((time.perf_counter() - t0, out))
            return out

        out = os.path.join(CKPT_DIR, "out", "sd3")
        kw = m13["sd3"]["kw"]
        argv = ["--family", "sd3", "--no-t5", "--model-dir", d, "--prompt",
                PROMPT, "--height", str(M13_RES[0]), "--width",
                str(M13_RES[1]), "-steps", str(kw["n_steps"]), "-gs",
                str(kw["guidance_scale"]), "--seed", str(kw["seed"]),
                "--output-dir", out]
        print(f"-- python -m sdxl_tpu_torch.cli.sample {' '.join(argv)}",
              flush=True)
        sd3_mod.load_sd3_pipeline = timed_load
        try:
            rc = run_path("the sample CLI --family sd3 --no-t5 request",
                          lambda: sample_cli.main(argv),
                          ["sdxl_flash_attention_bf16", F32_D512], total)
        finally:
            sd3_mod.load_sd3_pipeline = real_load
        if rc != 0:
            fail(f"the sample CLI returned {rc} (--family sd3)")
        (load_s, loaded), = loads
        print(f"load_sd3_pipeline(load_t5=False) (disk -> card, {written} "
              f"bytes): {load_s:.3f}s", flush=True)
        check_same_modules("the --family sd3 --no-t5 load", [
            ("mmdit", sd3.mmdit, loaded.mmdit),
            ("clip_l", sd3.clip_l, loaded.clip_l),
            ("clip_g", sd3.clip_g, loaded.clip_g),
            ("vae", sd3.vae, loaded.vae),
            ("vae_encoder", sd3.vae_encoder, loaded.vae_encoder)])
        if loaded.t5 is not None or loaded.flow_shift != sd3.flow_shift:
            fail("the --no-t5 load kept T5 or changed the flow shift")
        del loaded, loads[:]
        check_png("the CLI's --family sd3 --no-t5 image", out + "0.png",
                  m13["sd3"]["image"][0])

        # module 14: the MMDiT's block linears at int4, as quantize_model
        # leaves a copy of the in-memory one
        mmdit_q = quantize_model(copy.deepcopy(sd3.mmdit), 4)
        out_q = os.path.join(CKPT_DIR, "out", "sd3_int4")
        argv_q = argv[:-1] + [out_q, "--quantize", "int4"]
        print(f"-- python -m sdxl_tpu_torch.cli.sample {' '.join(argv_q)}",
              flush=True)
        sd3_mod.load_sd3_pipeline = timed_load
        try:
            rc = run_path("the sample CLI --family sd3 --no-t5 --quantize "
                          "int4 request", lambda: sample_cli.main(argv_q),
                          ["sdxl_flash_attention_bf16", F32_D512, BF16_INT8,
                           BF16_INT4], total)
        finally:
            sd3_mod.load_sd3_pipeline = real_load
        if rc != 0:
            fail(f"the sample CLI returned {rc} (--family sd3 --quantize "
                 f"int4)")
        (load_s, loaded), = loads
        print(f"load_sd3_pipeline(load_t5=False, quantize='int4'): "
              f"{load_s:.3f}s", flush=True)
        check_same_modules("the --family sd3 --no-t5 --quantize int4 load",
                           [("mmdit", mmdit_q, loaded.mmdit)])
        del loaded, loads[:]
        q = dataclasses.replace(sd3, mmdit=mmdit_q)
        check_png("the CLI's --family sd3 --no-t5 --quantize int4 image",
                  out_q + "0.png", q.txt2img(PROMPT, M13_RES, **kw)[0])
        del q, mmdit_q
        m13["sd3"].clear()
        gc.collect()
        torch.cuda.empty_cache()

        fl = m13["flux"]
        cli = fl["cli"]
        edit_png = fl["edit_png"]
        base = ["--family", "flux", "--random-weights", "--prompt", PROMPT,
                "--height", str(M13_RES[0]), "--width", str(M13_RES[1]),
                "-steps", str(cli["n_steps"]), "-gs",
                str(cli["guidance_scale"]), "--seed", str(cli["seed"])]
        a = flux_launches(FluxConfig(), M13_RES, 512)
        m = cli["n_steps"]
        edit_hw = fl["twins"]["kontext"].shape[1:3]
        for name, flags, want_k1, want_vae in (
                ("plain", [], m * a, 1),
                ("true_cfg", ["--negative-prompt", M13_NEGATIVE,
                              "--true-cfg-scale", str(TRUE_CFG_SCALE)],
                 m * a, 1),
                ("kontext", ["--edit-image", edit_png],
                 m * flux_launches(FluxConfig(), edit_hw, 512, edit_hw), 2)):
            out_f = os.path.join(CKPT_DIR, "out", f"flux_{name}")
            cli_subprocess(f"the sample CLI --family flux {' '.join(flags)} "
                           f"request", base + flags + ["--output-dir",
                                                       out_f],
                           want_k1, want_vae, total)
            check_png(f"the CLI's --family flux {name} image",
                      out_f + "0.png", fl["twins"][name][0])
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        shutil.rmtree(KONTEXT_EDIT_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 8h: module 14, the quantized requests
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counting_model_calls():
    """Inside, the calls the quantized paths make are counted by model:
    calls[id(model), "call"] for the samplers' UNet evaluations, the
    flow-matching loops' transformer calls and the T5 encodes, and
    calls[id(model), "kv"] for the samplers' cross-attention k/v
    precomputes."""
    calls = Counter()
    targets = [(sampler_mod, "unet_forward", "call"),
               (sampler_mod, "precompute_cross_kv", "kv"),
               (flow_match_mod, "mmdit_forward", "call"),
               (flux_mod, "flux_forward", "call"),
               (flux_mod, "t5_encode", "call"),
               (sd3_mod, "t5_encode", "call")]
    real = [getattr(mod, name) for mod, name, _ in targets]

    def counted(fn, kind):
        def call(model, *args, **kw):
            calls[id(model), kind] += 1
            return fn(model, *args, **kw)
        return call

    for (mod, name, kind), fn in zip(targets, real):
        setattr(mod, name, counted(fn, kind))
    try:
        yield calls
    finally:
        for (mod, name, _), fn in zip(targets, real):
            setattr(mod, name, fn)


def k4_expected(models, calls) -> dict:
    """K4's launches by route that `calls` (counting_model_calls) give:
    each QuantLinear that quantize_model put in a model once a call of the
    model, the UNets' cross-attention k and v once a precompute; the route
    from the model's dtype and the linear's bits."""
    want = Counter()
    for model in models:
        dtype = next(model.parameters()).dtype
        for name, m in model.named_modules():
            if isinstance(m, QuantLinear):
                kind = "kv" if name.endswith(K4_KV) else "call"
                want[quant_mod.ROUTES[dtype, m.bits]] += calls[id(model),
                                                               kind]
    return {k: n for k, n in want.items() if n}


def quantize_in_place(label: str, model, bits: int, unet: bool = False):
    """quantize_model(model, bits) by the transformers' rules, or the
    UNets' (loader.quantize_unet) where `unet`, as the loaders quantize;
    the model's bytes before and after and its quantized linears
    printed."""
    before = param_bytes(model)
    if unet:
        loader_mod.quantize_unet(model, bits)
    else:
        quantize_model(model, bits)
    print(f"{label} quantized at int{bits}: {before} -> {param_bytes(model)} "
          f"bytes ({quantized_stats(model)})", flush=True)


def quantized_stats(model) -> str:
    q = [m for m in model.modules() if isinstance(m, QuantLinear)]
    nbytes = sum(b.numel() * b.element_size() for m in q for b in m.buffers())
    by_bits = Counter(m.bits for m in q)
    return (f"{len(q)} quantized linears ({dict(by_bits)} by bits), "
            f"{nbytes} bytes of weights and scales")


def module14_request(pipe, label: str, fn, models, earlier: str, res):
    """One phase-8h request: latency, stage split, peak memory beside the
    unquantized request `earlier`'s, K1 and K4 launches printed; fail
    unless K4's launches by route are k4_expected's from the calls counted
    during the request, and the final latent is finite and the image
    uint8 of `res`. Returns the images."""
    pipe.timer.stages.clear()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    before, k1_before = dict(quant_mod.launch_counts), dict(fa.launch_counts)
    with counting_model_calls() as calls:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        latency = time.perf_counter() - t0
    peak_gib = PEAKS[label] = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: n - before[k] for k, n in quant_mod.launch_counts.items()
                if n != before[k]}
    k1 = {k: n - k1_before[k] for k, n in fa.launch_counts.items()
          if n != k1_before[k]}
    want = k4_expected(models, calls)
    stages = " ".join(f"{k}={v:.3f}s" for k, v in pipe.timer.stages.items())
    unquantized = (f"{PEAKS[earlier]:.2f}GiB" if earlier in PEAKS
                   else "not run")
    print(f"request {label}: latency={latency:.3f}s {stages} resident "
          f"before={resident:.2f}GiB peak_mem={peak_gib:.2f}GiB "
          f"(unquantized, {earlier!r}: {unquantized}) K4 "
          f"launches={launches} (predicted {want}) K1 launches={k1}",
          flush=True)
    if launches != want:
        fail(f"{label}: K4 launched {launches}, not {want}")
    lat = pipe.last_latent
    if not bool(torch.isfinite(lat).all()):
        fail(f"non-finite latent in {label}")
    if out.shape != (1, *res, 3) or out.dtype.name != "uint8" or \
            out.std() == 0:
        fail(f"{label}: images {out.shape} {out.dtype}")
    return out


@contextlib.contextmanager
def k4_linear(fn):
    """Inside, every QuantLinear's forward calls fn in K4's place."""
    real = layers_mod.quant_linear
    layers_mod.quant_linear = fn
    try:
        yield
    finally:
        layers_mod.quant_linear = real


@torch.inference_mode()
def hold_k4(label: str, call, whole_tol=None) -> None:
    """call() with each of its K4 launches held to quant_linear_plain on
    that launch's own input (phase 3's bounds: max abs error within
    K4_TOL of max(1, max|plain|), relative L2 within its limit), then the
    whole output against the same call through the plain dequant:
    printed, and held within whole_tol of its largest magnitude where
    given (the whole output also carries the rounding that builds up over
    every block after the first difference)."""
    worst = defaultdict(lambda: [0.0, 0.0, 0])

    def held(x, p, bias=None):
        out = quant_mod.quant_linear(x, p, bias)
        err, rel, ref_max = readings(
            out, quant_mod.quant_linear_plain(x, p, bias))
        w = worst[quant_mod.ROUTES[x.dtype, quant_mod.weight_bits(p)]]
        w[0], w[1] = max(w[0], err / max(1.0, ref_max)), max(w[1], rel)
        w[2] += 1
        return out

    with k4_linear(held):
        out_k = call().float()
    with k4_linear(quant_mod.quant_linear_plain):
        out_p = call().float()
    big = out_p.abs().max()
    rel = ((out_k - out_p).abs().max() / big).item()
    l2 = ((out_k - out_p).norm() / out_p.norm()).item()
    tol = "" if whole_tol is None else f" (tol {whole_tol:g})"
    print(f"{label}: K4 per call against the plain version on its input: "
          + ", ".join(f"{r} {n} calls worst max_err/max(1,max) {e:.3e} (tol "
                      f"{K4_TOL[K4_ROUTE_DTYPE[r]][0]:g}) worst rel_l2 "
                      f"{l:.3e} (tol {K4_TOL[K4_ROUTE_DTYPE[r]][1]:g})"
                      for r, (e, l, n) in sorted(worst.items()))
          + f"; the whole output against the plain dequant: rel_err="
          f"{rel:.3e}{tol}, rel_l2 {l2:.3e}; max|out| {big.item():.4g}",
          flush=True)
    if not worst:
        fail(f"{label} made no K4 call")
    for r, (e, l, _) in worst.items():
        t, rt = K4_TOL[K4_ROUTE_DTYPE[r]]
        if not (e <= t and l <= rt):
            fail(f"{label}: a {r} call disagrees with its plain version")
    if not bool(torch.isfinite(out_k).all()) or (
            whole_tol is not None and not rel < whole_tol):
        fail(f"{label} through K4 disagrees with the plain dequant")
    del out_k, out_p
    torch.cuda.empty_cache()


def unet_pair_call(pipe, unet, res):
    """A pair-batched CFG call of `unet` (the pipeline's base) at `res` at
    t = 999 on the pipeline's last latent."""
    dtype = pipe.compute_dtype
    cond = pipe.conditioning(PROMPT, res).astype(dtype)
    ctx2, ch2 = _cfg_contexts(pipe.diffuser_cfg, cond, dtype)
    x2 = torch.cat([pipe.last_latent] * 2).to(dtype)
    t2 = torch.full((2,), 999, device=pipe.device)
    return lambda: unet_forward(unet, x2, t2, ctx2, ch2)


def module14_unet_phase(pipe, m12, total) -> None:
    """Phase 8h's UNet requests: phase 8f's SD 1.5 with its UNet quantized
    in place at int4, DDIM at 512x512; then, with phase 8f's pipelines
    freed (m12 cleared), SDXL base + refiner at int8, 30 DDIM steps at
    1024x1024, on quantized copies of the pipeline's UNets with the bf16
    ones parked on the host, so that the card holds what phase 8b's base +
    refiner request held but the UNets quantized. Each request's K4
    launches held to the code's count (each QuantLinear once a UNet call,
    the cross k/v once a sampling loop); one pair call of each held per
    K4 call, the SDXL one whole within UNET_REL_TOL."""
    sd1 = m12["sd1"]
    quantize_in_place("SD 1.5 UNet", sd1.unet, 4, unet=True)
    run_path("the SD 1.5 int4 request", lambda: module14_request(
        sd1, f"SD 1.5 int4 DDIM {M12_STEPS} steps {SD1_RES}",
        lambda: sd1.txt2img(PROMPT, SD1_RES, seed=70, n_steps=M12_STEPS,
                            guidance_scale=7.5), [sd1.unet],
        f"SD 1.5 DDIM {M12_STEPS} steps {SD1_RES}", SD1_RES),
        [F32_D512, BF16_INT8, BF16_INT4], total)
    hold_k4(f"SD 1.5 int4 pair call B=2 at t=999 {SD1_RES}",
            unet_pair_call(sd1, sd1.unet, SD1_RES))
    del sd1
    m12.clear()
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    base, refiner = copy.deepcopy(pipe.unet), copy.deepcopy(pipe.refiner)
    quantize_in_place("SDXL base UNet", base, 8, unet=True)
    quantize_in_place("SDXL refiner", refiner, 8, unet=True)
    pipe.unet.cpu()
    pipe.refiner.cpu()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"quantized copies made, the bf16 UNets parked on the host: "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    q = dataclasses.replace(pipe, unet=base, refiner=refiner)
    res, n = M14_SDXL_RES, M14_SDXL_STEPS
    run_path("the SDXL int8 request", lambda: module14_request(
        q, f"SDXL base + refiner int8 DDIM {n} steps {res}",
        lambda: q.txt2img(PROMPT, res, seed=5, use_refiner=True, n_steps=n,
                          guidance_scale=7.5), [base, refiner],
        "base + refiner", res),
        ["sdxl_flash_attention_bf16", F32_D512, BF16_INT8], total)
    hold_k4(f"SDXL int8 base pair call B=2 at t=999 {res}",
            unet_pair_call(q, base, res), UNET_REL_TOL)
    del q, base, refiner
    gc.collect()
    torch.cuda.empty_cache()
    pipe.unet.to(pipe.device)
    pipe.refiner.to(pipe.device)


def module14_sd3(sd3, total) -> None:
    """Phase 8h's SD3-medium request: a quantized copy of the pipeline's
    MMDiT at int8 (phase 9b writes the bf16 one) and its T5-XXL quantized
    in place at int8 (load_sd3_pipeline's recipe), txt2img CFG 7 at
    1024x1024, 28 steps; one pair call held per K4 call."""
    mmdit = copy.deepcopy(sd3.mmdit)
    quantize_in_place("a copy of SD3-medium's MMDiT", mmdit, 8)
    quantize_in_place("T5-XXL", sd3.t5, 8)
    gc.collect()
    torch.cuda.empty_cache()
    q = dataclasses.replace(sd3, mmdit=mmdit)
    n = M13_STEPS
    run_path("the SD3-medium int8 request", lambda: module14_request(
        q, f"SD3-medium int8 (T5-XXL int8) txt2img CFG {SD3_GS} {n} steps",
        lambda: q.txt2img(PROMPT, M13_RES, seed=80, n_steps=n,
                          guidance_scale=SD3_GS,
                          negative_prompt=M13_NEGATIVE), [mmdit, q.t5],
        f"SD3-medium txt2img CFG {SD3_GS} {n} steps (T5-XXL f32)", M13_RES),
        ["sdxl_flash_attention_bf16", F32_D512, BF16_INT8, F32_INT8], total)
    dev = q.device
    with torch.inference_mode():
        ctx, pooled = q.conditioning(PROMPT, M13_NEGATIVE)
        g = torch.Generator(device=dev).manual_seed(16)
        x = torch.randn((1, M13_RES[0] // 8, M13_RES[1] // 8,
                         mmdit.cfg.in_channels), generator=g, device=dev)
        t = float(flow_match_mod.fm_schedule(n)[0][n // 3])
        t2 = torch.full((2,), t, device=dev)
    hold_k4(f"SD3-medium int8 pair call B=2 at t={t!r}",
            lambda: mmdit_forward(mmdit, torch.cat([x, x]).to(BF16), t2,
                                  ctx.to(BF16), pooled.to(BF16)))
    del q, mmdit
    gc.collect()
    torch.cuda.empty_cache()


def module14_f32_flux(f32, total) -> None:
    """f32 x int4 (`--f32 --quantize int4`): phase 8g's f32 FLUX.1
    transformer (full width, FLUX_F32_DEPTH blocks) quantized in place at
    int4, T5 at int8 from module14_flux: a SCHNELL_STEPS-step request and
    one call held per K4 call."""
    cfg, s = f32.flux.cfg, SCHNELL_STEPS
    quantize_in_place("the f32 FLUX.1 transformer", f32.flux, 4)
    label = (f"f32 FLUX.1 ({cfg.num_layers} double, {cfg.num_single_layers} "
             f"single blocks, full width) txt2img {s} steps")
    run_path("the f32 FLUX.1 int4 request", lambda: module14_request(
        f32, f"{label}, int4", lambda: f32.txt2img(
            PROMPT, M13_RES, n_steps=s, guidance_scale=FLUX_GS, seed=97),
        [f32.flux, f32.t5], label, M13_RES),
        [F32_D128, F32_D512, F32_INT8, F32_INT4], total)
    dev = f32.device
    with torch.inference_mode():
        ctx, pooled = f32.conditioning(PROMPT)
        g = torch.Generator(device=dev).manual_seed(18)
        x = torch.randn((1, M13_RES[0] // 8, M13_RES[1] // 8, 16),
                        generator=g, device=dev)
        ts, _ = f32._schedule(M13_STEPS, *M13_RES)
        t = torch.full((1,), float(ts[M13_STEPS // 3]), device=dev)
        gd = torch.full((1,), FLUX_GS * 1000.0, device=dev)
    hold_k4(f"f32 FLUX.1 int4 call at t={float(t)!r}",
            lambda: flux_forward(f32.flux, x, t, ctx.float(),
                                 pooled.float(), gd))


def module14_flux(flux, total) -> None:
    """Phase 8h's FLUX.1 requests on phase 8g's FLUX.1-dev pipeline, once
    its bf16 transformer has served every phase-8g request that needs it:
    the transformer quantized in place at int8 and T5 at int8 (the
    loader's recipe), txt2img at 1024x1024, 28 steps; one transformer call
    and one T5 encode held per K4 call; t5_offload's conditioning bitwise
    the resident one's, T5 on the host after it; then a transformer drawn
    at int4 by random_quantized_like (no bf16 weights) answering an
    M14_INT4_STEPS-step request with T5 parked on the host (t5_offload).
    T5 stays int8 for phase 8g's later FLUX.1 requests. Leaves
    flux.flux None."""
    n = M13_STEPS
    bf16 = ["sdxl_flash_attention_bf16", F32_D512]
    quantize_in_place("FLUX.1-dev's transformer", flux.flux, 8)
    quantize_in_place("T5-XXL", flux.t5, 8)
    gc.collect()
    torch.cuda.empty_cache()
    run_path("the FLUX.1-dev int8 request", lambda: module14_request(
        flux, f"FLUX.1-dev int8 (T5-XXL int8) txt2img guidance {FLUX_GS} "
        f"{n} steps", lambda: flux.txt2img(PROMPT, M13_RES, seed=90,
                                           n_steps=n, guidance_scale=FLUX_GS),
        [flux.flux, flux.t5], f"FLUX.1-dev txt2img guidance {FLUX_GS} {n} "
        f"steps", M13_RES), bf16 + [BF16_INT8, F32_INT8], total)
    dev = flux.device
    with torch.inference_mode():
        ctx, pooled = flux.conditioning(PROMPT)
        g = torch.Generator(device=dev).manual_seed(17)
        x = torch.randn((1, M13_RES[0] // 8, M13_RES[1] // 8, 16),
                        generator=g, device=dev).to(BF16)
        ts, _ = flux._schedule(n, *M13_RES)
        t = torch.full((1,), float(ts[n // 3]), device=dev)
        gd = torch.full((1,), FLUX_GS * 1000.0, device=dev)
        ids = flux._t5_ids([PROMPT])

    def call():
        return flux_forward(flux.flux, x, t, ctx.to(BF16), pooled.to(BF16),
                            gd)

    hold_k4(f"FLUX.1-dev int8 call at t={float(t)!r}", call)
    hold_k4("T5-XXL int8 encode (f32)", lambda: t5_encode(flux.t5, ids))

    with torch.inference_mode():
        resident = flux.conditioning(PROMPT)
        flux.t5.cpu()
        flux.t5_offload = True
        torch.cuda.empty_cache()
        offloaded = flux.conditioning(PROMPT)
    home = {t.device.type for t in (*flux.t5.parameters(),
                                    *flux.t5.buffers())}
    same = all(torch.equal(a, b) for a, b in zip(resident, offloaded))
    print(f"t5_offload: the conditioning bitwise the resident one's: {same};"
          f" T5 after the call on {sorted(home)}", flush=True)
    if not same or home != {"cpu"}:
        fail("t5_offload's conditioning differs or T5 left the host")

    flux.flux = None
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(M14_INT4_SEED)
    f4 = random_quantized_like(Flux(FluxConfig(), "meta"), 4, g, dev)
    flux.flux = init_reference_(f4, g).eval().requires_grad_(False)
    torch.cuda.synchronize()
    print(f"FLUX.1-dev drawn at int4 by random_quantized_like: "
          f"{param_bytes(f4)} bytes ({quantized_stats(f4)}): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    m = M14_INT4_STEPS
    run_path("the FLUX.1-dev int4 request (t5_offload)",
             lambda: module14_request(
                 flux, f"FLUX.1-dev int4 (T5-XXL int8 on the host, "
                 f"t5_offload) txt2img {m} steps",
                 lambda: flux.txt2img(PROMPT, M13_RES, seed=98, n_steps=m,
                                      guidance_scale=FLUX_GS),
                 [f4, flux.t5], f"FLUX.1-dev txt2img guidance {FLUX_GS} {n} "
                 f"steps", M13_RES), bf16 + [BF16_INT8, BF16_INT4, F32_INT8],
             total)
    hold_k4(f"FLUX.1-dev int4 call at t={float(t)!r}", call)
    flux.t5.to(dev)
    flux.t5_offload = False
    flux.flux = None
    del f4
    gc.collect()
    torch.cuda.empty_cache()


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
def profile_request(pipe, n_steps: int = 30, **options) -> None:
    """Three unfenced requests, then one under torch.profiler; options
    (a sampler, no_cfg, ...) go to txt2img."""
    resolution = REQUESTS[0][0]
    latencies = []
    for seed in (10, 11, 12):
        t0 = time.perf_counter()
        pipe.txt2img(PROMPT, resolution, n_steps=n_steps, seed=seed,
                     profile_stages=False, **options)
        latencies.append(time.perf_counter() - t0)
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        t0 = time.perf_counter()
        pipe.txt2img(PROMPT, resolution, n_steps=n_steps, seed=13,
                     profile_stages=False, **options)
        wall = time.perf_counter() - t0
    print_profile(f"{resolution[0]}x{resolution[1]} {pipe.compute_dtype} "
                  f"request, {n_steps} steps {options or ''}", prof, wall,
                  latencies)


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
    run_start = clock[0]

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
    check_k4(results)
    phase_done("3 (K4)")
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
    phase6 = run_path("the txt2img requests", lambda: run_requests(pipe),
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
    run_path("the module-10 requests", lambda: module10_requests(pipe),
             ["sdxl_flash_attention_bf16", F32_D512], path)
    check_k_calls_against_plain(pipe)
    if args.profile:
        for no_cfg in (False, True):
            profile_request(pipe, K_STEPS, sampler="dpmpp",
                            schedule="karras", no_cfg=no_cfg)
    phase_done("8c (k-samplers, schedules, zsnr, DDIM eta, no CFG)")
    p_lcm = run_path("the module-10b and module-11 extension requests",
                     lambda: module10b_requests(pipe, phase6[0]),
                     ["sdxl_flash_attention_bf16", F32_D512], path)
    check_extensions_against_plain(pipe, p_lcm)
    phase_done("8d (LCM, previews, inversion, FreeU, PAG, DeepCache)")
    t0 = time.perf_counter()
    m11 = module11_weights(pipe)
    torch.cuda.synchronize()
    print(f"module-11 weights drawn (two ControlNets, ViT-H, the proj and "
          f"plus adapters, an 8-channel UNet): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    run_path("the module-11 requests",
             lambda: module11_requests(pipe, phase6[0], m11),
             ["sdxl_flash_attention_bf16", F32_D512], path)
    check_module11_against_plain(pipe, phase6[0], m11)
    # phase 9b's CLI requests use one ControlNet and the proj adapter
    m11["nets"] = m11["nets"][:1]
    del m11["adapters"]["plus"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("8e (ControlNet, IP-Adapter, ip2p, hires-fix, tiled VAE)")
    t0 = time.perf_counter()
    m12 = module12_weights()
    torch.cuda.synchronize()
    print(f"module-12 weights drawn (SD 1.5, SD 2.1-768 and an SD 2.x "
          f"ControlNet): {time.perf_counter() - t0:.1f}s", flush=True)
    sd1_latent = run_path("the module-12 requests",
                          lambda: module12_requests(m12),
                          ["sdxl_flash_attention_bf16", F32_D512], path)
    check_module12_against_plain(m12, sd1_latent)
    del m12["net"], m12["sd2"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("8f (SD 1.5, SD 2.1-768 v-prediction, SD 2-base)")
    checkpoint_cli_phase(pipe, path, p_lcm, m11, m12)
    del p_lcm, m11
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("9b (checkpoint, sample CLI)")
    module14_unet_phase(pipe, m12, path)
    del m12
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("8h (module 14: SD 1.5 int4, SDXL base + refiner int8)")

    data, cfg, factors, train_launches = run_training(
        pipe, TRAIN_STEPS, [F32_D512, *fa._TRAIN_ROUTES[torch.bfloat16, 64]])
    for name, n in train_launches.items():
        path[name] += n
    check_training_grads(pipe, data, cfg, factors, GRAD_REL_TOL)
    if args.profile:
        profile_training_step(pipe, data, cfg, factors)
    del pipe, data, factors
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("10-12 (LoRA training)")
    m13 = module13_phase(path)
    phase_done("8g and 8h (module 13: SD3-medium, SD3.5-large, "
               "SD3.5-medium, FLUX.1-dev, f32 FLUX.1, FLUX.1-schnell; module "
               "14: SD3-medium int8, FLUX.1-dev int8 and int4)")
    module13_cli_phase(path, m13)
    del m13
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("9b (module 13's sample CLI requests)")
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
    print(f"whole run: {time.perf_counter() - run_start:.1f}s (from the "
          f"device check to the record)", flush=True)
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
