"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Run from the repo root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. the device, and `nvidia-smi` name and power limit;
  2. build the hand-written kernels from sdxl_tpu_torch/csrc (nvcc, with
     the -Xptxas -v report);
  3. each kernel against its plain PyTorch version on the card at the
     main path's shapes: max abs error within the stated tolerance, and
     both timed with CUDA events after a warm-up;
  4. the main path: random_pipeline(device="cuda") at SDXL-base widths
     answers three txt2img requests (two at 1024x1024, one at 832x1216 for
     the ragged token counts), 30 DDIM steps, CFG 7.5 — latency, stage
     split and peak memory per request; the final latents must be finite,
     the images [B, H, W, 3] uint8, and the kernels must have been
     launched from the UNet and from the VAE during these requests;
  5. the last request's UNet step and VAE decode again with the plain
     attention in place of the kernel: outputs must agree;
  6. with --profile only: three unfenced 1024x1024 requests, then one
     under torch.profiler — device time by the op that launched each
     kernel, and the device's idle share against the unfenced latency.
The last two lines are the kernels' JSON record and {"ok": true, ...}.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType

from sdxl_tpu_torch.models.unet import unet_forward
from sdxl_tpu_torch.ops import attention as attention_mod
from sdxl_tpu_torch.ops import flash_attention as fa
from sdxl_tpu_torch.pipeline.latent import decode_latent_to_images
from sdxl_tpu_torch.pipeline.pipeline import random_pipeline
from sdxl_tpu_torch.pipeline.sampler import _cfg_contexts

SOURCE = "sdxl_tpu_torch/csrc/flash_attention.cu"
REPLACES = "sdxl_tpu/ops/flash_attention.py:140"
# (B, H, T, D, dtype, tolerance): the main path's attention shapes
# (bench.py:53-66) — UNet levels 2 and 1 at 1024x1024 and at 832x1216,
# and the VAE mid-block attention at 1024x1024 — plus one d=128 case, a
# route of the bf16 kernel the SDXL-base path does not take
KERNEL_CASES = [
    (2, 20, 1024, 64, torch.bfloat16, 2e-2),
    (2, 10, 4096, 64, torch.bfloat16, 2e-2),
    (2, 10, 3952, 64, torch.bfloat16, 2e-2),
    (2, 20, 988, 64, torch.bfloat16, 2e-2),
    (1, 1, 16384, 512, torch.float32, 1e-3),
    (1, 2, 1000, 128, torch.bfloat16, 2e-2),
]
# the shape each kernel's reported time is taken at
TIMED_SHAPE = {"sdxl_flash_attention_bf16": (2, 10, 4096, 64),
               "sdxl_flash_attention_f32": (1, 1, 16384, 512)}
REQUESTS = [((1024, 1024), 1), ((1024, 1024), 2), ((832, 1216), 3)]
PROMPT = "a photograph of an astronaut riding a horse"
# kernel vs plain attention inside the real path, relative to the output's
# largest magnitude: bf16 UNet eps, f32 VAE image in u8 levels
UNET_REL_TOL = 2e-2
VAE_LEVEL_TOL = 1


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


def check_kernels() -> dict:
    results = {}
    for b, h, t, d, dtype, tol in KERNEL_CASES:
        g = torch.Generator(device="cuda").manual_seed(42)
        q, k, v = (torch.randn((b, h, t, d), generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        if not fa.use_flash(t, t, d, False):
            fail(f"use_flash does not route {(b, h, t, d)}")
        out = fa.flash_attention_bhtd(q, k, v)
        ref = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        iters = 5 if d == 512 else 20
        ms = cuda_ms(lambda: fa.flash_attention_bhtd(q, k, v), iters)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), iters)
        name = ("sdxl_flash_attention_bf16" if dtype == torch.bfloat16
                else "sdxl_flash_attention_f32")
        print(f"kernel {name} shape={(b, h, t, d)} max_abs_err={err:.3e} "
              f"tol={tol:g} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}",
              flush=True)
        if not (finite and err < tol):
            fail(f"{name} at {(b, h, t, d)}: max_abs_err {err} >= {tol} "
                 f"or non-finite output")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if (b, h, t, d) == TIMED_SHAPE[name]:
            r["ms"], r["plain_ms"] = ms, plain_ms
    return results


def run_requests(pipe) -> None:
    for (height, width), seed in REQUESTS:
        pipe.timer.stages.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        images = pipe.txt2img(PROMPT, resolution=(height, width), n_steps=30,
                              guidance_scale=7.5, seed=seed)
        latency = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        latent = pipe.last_latent
        stages = " ".join(f"{k}={v:.3f}s" for k, v in pipe.timer.stages.items())
        print(f"request {height}x{width} seed={seed}: latency={latency:.3f}s "
              f"{stages} peak_mem={peak_gib:.2f}GiB", flush=True)
        if tuple(latent.shape) != (1, height // 8, width // 8, 4):
            fail(f"latent shape {tuple(latent.shape)}")
        if not bool(torch.isfinite(latent).all()):
            fail(f"non-finite latent at {height}x{width}")
        if images.shape != (1, height, width, 3) or images.dtype.name != "uint8":
            fail(f"images {images.shape} {images.dtype}")
        if images.std() == 0:
            fail("constant image")


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
    attention_mod.flash_attention_bhtd = fa.flash_attention_plain
    try:
        eps_p, img_p = run()
    finally:
        attention_mod.flash_attention_bhtd = fa.flash_attention_bhtd
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


@torch.inference_mode()
def profile_request(pipe) -> None:
    resolution = REQUESTS[0][0]
    latencies = []
    for seed in (10, 11, 12):
        t0 = time.perf_counter()
        pipe.txt2img(PROMPT, resolution, seed=seed, profile_stages=False)
        latencies.append(time.perf_counter() - t0)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        pipe.txt2img(PROMPT, resolution, seed=13, profile_stages=False)
        wall = time.perf_counter() - t0
    rows = device_time_by_op(prof.events())
    device_s = sum(us for us, _ in rows.values()) / 1e6
    if device_s == 0:
        fail("the profiler recorded no device time")
    median = statistics.median(latencies)
    print(f"profile {resolution[0]}x{resolution[1]}: unfenced latencies "
          f"{latencies} s; profiled wall {wall} s; device kernel time "
          f"{device_s} s; idle share against the median unfenced latency "
          f"{1 - device_s / median}", flush=True)
    for name, (us, n) in sorted(rows.items(), key=lambda r: -r[1][0])[:20]:
        print(f"  {us / 1e3:10.3f} ms {us / 1e6 / device_s:7.2%} "
              f"{n:7d}  {name}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="add phase 6, the profiled request")
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

    _, seconds, log = fa.load_library()
    print(f"build: {seconds:.1f}s\n{log}", flush=True)

    results = check_kernels()

    t0 = time.perf_counter()
    pipe = random_pipeline(device="cuda")
    torch.cuda.synchronize()
    print(f"random_pipeline: {time.perf_counter() - t0:.1f}s", flush=True)
    fa.reset_launch_counts()
    run_requests(pipe)
    launches = dict(fa.launch_counts)
    print(f"launches during the requests: {launches}", flush=True)
    for name, n in launches.items():
        if n == 0:
            fail(f"{name} was not launched on the main path")

    check_path_against_plain(pipe)
    if args.profile:
        profile_request(pipe)
    if "jax" in sys.modules:
        fail("jax was imported")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]}
        for name, r in results.items()]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
