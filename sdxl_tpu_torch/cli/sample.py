"""`sample` CLI: SDXL and SD 1.x / 2.x images from a checkpoint on disk
(counterpart of sdxl_tpu/cli/sample.py).

``build_parser`` is the reference's in full, so every flag of the
reference parses. ``main`` runs ``--family sdxl``, ``sd1`` and ``sd2``:
load (SDXL: any layout pipeline/loader.py detects, the refiner too with
``--use-refiner``; SD 1.x / 2.x: a diffusers directory or an ldm single
file through pipeline/sd1.py, SD15_DIFFUSER with the CLIP ViT-L tower or
SD2_DIFFUSER with the OpenCLIP ViT-H tower's penultimate hidden; or
``--random-weights``), merge ``--lora`` and ``--embedding`` files,
``--zsnr``, ``--vae-tile``, ``--clip-skip`` (checked against the towers'
depth), load ``--controlnet`` directories and an
``--ip-adapter`` with its ``--ip-image-encoder``, then txt2img (with the
refiner, or the ``--denoising-end`` split), hires-fix (``--hires-scale``,
``--hires-strength``), img2img (``--reference-img`` with
``--img2img-strength``), outpaint (``--outpaint``), inpainting of
``--reference-img`` (a crop window, a ``--mask-img``, ``--mask-blur``),
DDIM inversion editing (``--invert-img`` under ``--invert-prompt``), or
InstructPix2Pix (``--edit-image``, ``--image-guidance-scale``), each with
``--sampler`` (DDIM, a k-sampler or LCM), ``--schedule``, ``--ddim-eta``,
``--guidance-rescale``, ``--no-cfg``, ``--freeu``, ``--pag-scale`` and
``--deepcache``, the ControlNet flags (``--control-image``,
``--control-scale``, ``--control-start``, ``--control-end``, one each a
net) and the IP-Adapter's (``--ip-image``, ``--ip-scale``) where the
reference takes them (txt2img also with ``--preview-every``, which writes
{output_dir}preview_{step}_0.png), and write {output_dir}{i}.png with
the reference's generation metadata. The bad combinations of these flags
fail with the reference's messages: an exit 1 where the reference's CLI
checks them, the pipeline's ValueError where the reference's pipeline
does. Any other flag set away from its default, and any other family
(sd3, flux), is an error naming the module that ports it. Runs on the
GPU; the tests pass ``device="cpu"`` to ``main``.

Usage:
  python -m sdxl_tpu_torch.cli.sample --model-dir ./weights \
      --prompt "a crab" --output-dir ./out/crab
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

# the flags main() runs (--family is checked on its own;
# --no-strict-resolution relaxes the inpainting references' bucket check:
# txt2img warns off-bucket either way, as the reference)
_PORTED = {
    "model_dir", "random_weights", "prompt", "batch", "height", "width",
    "unconditional_guidance_scale", "n_diffusion_steps", "seed",
    "negative_prompt", "f32", "vae_bf16", "lora", "embedding",
    "tokenizer_dir", "no_strict_resolution", "output_dir", "family", "help",
    "use_refiner", "denoising_end", "reference_img", "crop_left",
    "crop_right", "crop_top", "crop_bottom", "crop_out", "mask_img",
    "mask_blur", "img2img_strength", "outpaint", "outpaint_fill",
    "sampler", "schedule", "zsnr", "ddim_eta", "guidance_rescale", "no_cfg",
    "preview_every", "invert_img", "invert_prompt", "pag_scale", "freeu",
    "deepcache", "deepcache_branch", "controlnet", "control_image",
    "control_scale", "control_start", "control_end", "ip_adapter",
    "ip_image_encoder", "ip_image", "ip_scale", "edit_image",
    "image_guidance_scale", "hires_scale", "hires_strength", "vae_tile",
    "clip_skip",
}
# every other flag -> the module of ROADMAP Queue 1 that ports it
_WAITS = {
    **dict.fromkeys(["no_t5", "slg_scale", "slg_layers", "true_cfg_scale"],
                    13),
    "quantize": 14,
    **dict.fromkeys(["dp", "tp"], 17),
    **dict.fromkeys(["trace", "debug_nans"], 7),
}
_FAMILY_MODULE = {"sd3": 13, "flux": 13}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Stable Diffusion XL on an NVIDIA GPU (PyTorch/CUDA port)")
    p.add_argument("--model-dir", type=str, default=None,
                   help="Directory of the model weights")
    p.add_argument("--use-refiner", action="store_true",
                   help="Use the refiner model?")
    p.add_argument("--denoising-end", type=float, default=None,
                   help="Ensemble-of-experts split (with --use-refiner): "
                        "the base runs this fraction of the noise range "
                        "(e.g. 0.8) and the refiner continues the "
                        "still-noisy tail with NO re-noise (diffusers' "
                        "denoising_end/denoising_start recipe); default "
                        "keeps the reference's re-noise-at-t=800 mode")
    p.add_argument("--reference-img", type=str, default=None,
                   help="Path of the reference image for inpainting")
    p.add_argument("--crop-left", type=int, default=None,
                   help="Left-most pixel of the crop window")
    p.add_argument("--crop-right", type=int, default=None,
                   help="Right-most pixel of the crop window")
    p.add_argument("--crop-top", type=int, default=None,
                   help="Top-most pixel of the crop window")
    p.add_argument("--crop-bottom", type=int, default=None,
                   help="Bottom-most pixel of the crop window")
    p.add_argument("--crop-out", action="store_true",
                   help="Crop outside or inside the specified crop window?")
    p.add_argument("--mask-img", type=str, default=None, metavar="PNG",
                   help="Inpainting mask IMAGE instead of a crop window "
                        "(any >127 pixel in an 8x8 cell marks the cell "
                        "generated); all families")
    p.add_argument("--mask-blur", type=float, default=0.0, metavar="SIGMA",
                   help="Soft inpainting: gaussian sigma (pixels) to "
                        "feather the mask boundary; the per-step pin "
                        "blends instead of selecting (A1111 mask_blur). "
                        "0 = the reference's exact hard mask")
    p.add_argument("--ddim-eta", type=float, default=0.0,
                   help="Stochastic DDIM (diffusers DDIMScheduler eta; "
                        "1.0 ~ DDPM ancestral) — sampler ddim only; "
                        "0 = the reference's deterministic update")
    p.add_argument("--no-strict-resolution", action="store_true",
                   help="Accept inpainting references at any "
                        "multiple-of-8 size with a quality warning "
                        "instead of the reference's hard "
                        "trained-bucket check (diffusers/A1111 "
                        "semantics; useful for finetuned checkpoints)")
    p.add_argument("--unconditional-guidance-scale", "-gs", type=float,
                   default=7.5,
                   help="Controls the strength of the adherence to the prompt")
    p.add_argument("--n-diffusion-steps", "-steps", type=int, default=30,
                   help="Number of diffusion iterations")
    p.add_argument("--prompt", "-pr", type=str, required=True,
                   action="append",
                   help="Prompt; repeatable for distinct prompts in one "
                        "batched run (with --batch N, a single prompt is "
                        "replicated N times)")
    p.add_argument("--output-dir", "-od", type=str, required=True,
                   help="Prefix for the image outputs ({output_dir}{i}.png)")
    # --- additions over the reference ---
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--negative-prompt", type=str, default="")
    p.add_argument("--batch", type=int, default=1,
                   help="Number of images to sample in one batch")
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--tokenizer-dir", type=str, default=None)
    p.add_argument("--random-weights", action="store_true",
                   help="Run with random weights (pipeline bring-up)")
    p.add_argument("--family", type=str, default="sdxl",
                   choices=["sdxl", "sd1", "sd2", "sd3", "flux"],
                   help="Model family: SDXL (reference parity), the "
                        "SD 1.x / 2.x UNet architecture, SD3 (MMDiT + "
                        "flow matching), or FLUX.1 (guidance-distilled "
                        "rectified-flow DiT); sd3/flux load diffusers "
                        "checkpoints, txt2img/img2img/inpaint surface")
    p.add_argument("--no-t5", action="store_true",
                   help="SD3: drop the T5-XXL tower (its token block "
                        "becomes zeros — the public pipeline's "
                        "memory-saving mode)")
    p.add_argument("--f32", action="store_true",
                   help="Run the UNet in float32 instead of bfloat16")
    p.add_argument("--vae-bf16", action="store_true",
                   help="Decode in bfloat16: 1.16x faster VAE at ~1 u8 level "
                        "mean pixel cost (reference decodes f32)")
    p.add_argument("--sampler", type=str, default="ddim",
                   choices=["ddim", "euler", "dpmpp", "euler_a", "dpmpp_sde",
                            "dpmpp_3m_sde", "unipc", "heun", "euler_cfgpp",
                            "dpm2", "dpm2_a", "dpmpp_2s_a", "lms", "lcm"],
                   help="Sampler: deterministic DDIM (reference), Euler, "
                        "DPM-Solver++ 2M (best quality at low step counts), "
                        "UniPC, Heun (2nd-order, two UNet evals/step), "
                        "euler_cfgpp (CFG++, arXiv:2406.08070 — re-noises "
                        "along the uncond direction; use small scales ~1-2), "
                        "or the stochastic ancestral Euler / DPM++ 2M SDE / "
                        "DPM++ 3M SDE (third-order multistep; pair with "
                        "--schedule karras), DPM2/DPM2-a/DPM++ 2S-a "
                        "(2nd-order, two UNet evals/step at the log-mid "
                        "sigma), lms (order-4 linear multistep); "
                        "valid on every path (txt2img/inpaint/img2img/refiner). "
                        "lcm (4-8 steps) is for LCM-distilled checkpoints / "
                        "LCM-LoRA (use gs 1-2, or the baked-in guidance "
                        "embedding for distilled models)")
    p.add_argument("--schedule", type=str, default="linear",
                   choices=["linear", "karras", "ays", "trailing", "leading"],
                   help="Sigma spacing for the euler/dpmpp samplers: karras "
                        "(rho=7) improves low-step-count quality; ays uses "
                        "the published Align-Your-Steps optimized schedule "
                        "(arXiv:2404.14507; 10 steps native, other counts "
                        "log-linearly retargeted, family table auto-picked); "
                        "trailing/leading are diffusers' other "
                        "timestep_spacing grids — trailing anchors the "
                        "first step at the terminal t=999 (leading never "
                        "samples it) and is required by SDXL-Lightning / "
                        "zero-terminal-SNR checkpoints")
    p.add_argument("--zsnr", action="store_true",
                   help="Rescale the alpha-bar table to zero terminal SNR "
                        "(arXiv:2305.08891) — for v-prediction ZSNR "
                        "finetunes; pair with --schedule trailing and "
                        "--guidance-rescale as their model cards prescribe")
    p.add_argument("--pag-scale", type=float, default=0.0,
                   help="Perturbed-Attention Guidance scale "
                        "(arXiv:2403.17377, 'mid' layers; try 3.0): one "
                        "extra conditional UNet eval per step; composes "
                        "with CFG or --no-cfg; not with --controlnet/"
                        "--deepcache/--preview-every/--hires-scale/lcm")
    p.add_argument("--slg-scale", type=float, default=0.0,
                   help="SD3.5 skip-layer guidance scale (--family sd3; "
                        "try 2.8): one extra cond-only MMDiT eval with "
                        "--slg-layers omitted, inside the first ~fifth of "
                        "the run (diffusers skip_guidance_layers)")
    p.add_argument("--slg-layers", type=str, default=None,
                   metavar="I,J,...",
                   help="Transformer blocks the SLG perturbed branch "
                        "skips (default 7,8,9 — the SD3.5-medium "
                        "recommendation)")
    p.add_argument("--true-cfg-scale", type=float, default=1.0,
                   help="Flux: real pair-batched CFG over "
                        "--negative-prompt on top of the embedded "
                        "guidance (diffusers true_cfg_scale; try 4.0)")
    p.add_argument("--freeu", type=str, nargs="?", const="auto",
                   default=None, metavar="B1,B2,S1,S2",
                   help="FreeU decoder rebalancing (arXiv:2309.11497): "
                        "boosts backbone features, attenuates low-frequency "
                        "skips at the two deepest decoder levels. Bare "
                        "--freeu uses the official per-family settings "
                        "(sdxl 1.3,1.4,0.9,0.2); pass B1,B2,S1,S2 to "
                        "override")
    p.add_argument("--guidance-rescale", type=float, default=0.0,
                   help="CFG std-rescale factor (Lin et al. 2023); 0.7 is "
                        "typical for zero-terminal-SNR v-prediction models")
    p.add_argument("--no-cfg", action="store_true",
                   help="Drop the unconditional branch (half the UNet work) "
                        "— for guidance-distilled Turbo/Lightning-style "
                        "checkpoints; guidance_scale is ignored")
    p.add_argument("--clip-skip", type=int, default=0,
                   help="Extra CLIP blocks to skip beyond the family default "
                        "(the ecosystem clip-skip knob for fine-tuned models)")
    p.add_argument("--embedding", action="append", default=[],
                   metavar="PATH[:WORD]",
                   help="Textual-inversion embedding file (repeatable); the "
                        "trigger word defaults to the file stem. SDXL "
                        "clip_l/clip_g, SD emb_params, and A1111 .pt layouts")
    p.add_argument("--lora", action="append", default=[], metavar="PATH[:SCALE]",
                   help="Merge a LoRA safetensors file into the model at load "
                        "time (repeatable; kohya and diffusers/peft key "
                        "formats; default scale 1.0)")
    p.add_argument("--edit-image", type=str, default=None, metavar="PNG",
                   help="Instruction-based editing; the prompt is the edit "
                        "instruction. --family flux: FLUX.1 Kontext "
                        "in-context editing (the image rides the sequence "
                        "as clean reference tokens; use a Kontext-dev "
                        "checkpoint, -gs 2.5). UNet families: "
                        "InstructPix2Pix (needs an 8-channel ip2p "
                        "checkpoint, e.g. timbrooks/instruct-pix2pix; "
                        "see --image-guidance-scale)")
    p.add_argument("--outpaint", type=str, default=None, metavar="L,R,T,B",
                   help="Outpainting (with --reference-img): extend the "
                        "canvas by this many pixels per side "
                        "(left,right,top,bottom; padded dims must stay "
                        "multiples of 8) and generate the border — the "
                        "crop_out inpainting mode over an edge-padded "
                        "canvas. Use a high step count like inpainting")
    p.add_argument("--outpaint-fill", type=str, default="edge",
                   choices=["edge", "noise"],
                   help="Seed content for the new border before VAE "
                        "encoding (default edge-replicate)")
    p.add_argument("--invert-img", type=str, default=None, metavar="PNG",
                   help="DDIM inversion editing (UNet families, any "
                        "checkpoint): invert this image's DDIM chain under "
                        "--invert-prompt (gs 1), then denoise the inverted "
                        "latent under --prompt over the same grid — the "
                        "prompt-swap editing recipe (arXiv:2211.09794). "
                        "Same --prompt reconstructs the input")
    p.add_argument("--invert-prompt", type=str, default="",
                   help="Source prompt describing the --invert-img content "
                        "(default \"\": unconditional inversion)")
    p.add_argument("--image-guidance-scale", type=float, default=1.5,
                   help="InstructPix2Pix image guidance s_I "
                        "(arXiv:2211.09800; with --edit-image on the UNet "
                        "families): higher sticks closer to the input "
                        "image; text guidance stays -gs (typical 7.5/1.5)")
    p.add_argument("--quantize", choices=["int8", "int4"], default=None,
                   help="Weight-only quantized storage: block linears at "
                        "int8 (per-channel) or int4 (group-wise; modulation "
                        "linears stay int8), dequantized on the fly inside "
                        "the sampling scan. sd3/flux: transformer blocks + "
                        "T5 at int8 — the single-chip fit mode for FLUX.1's "
                        "12B transformer (23.8 GB bf16 -> 11.9 / ~6.4 GB). "
                        "sdxl/sd1/sd2: the UNet transformer linears (~2.0B "
                        "of SDXL's 2.6B UNet params) — frees HBM for "
                        "resident base+refiner and larger serving batches")
    p.add_argument("--controlnet", action="append", default=None,
                   metavar="DIR",
                   help="diffusers-layout ControlNetModel directory for this "
                        "model family (canny/depth/pose/...); use with "
                        "--control-image. Repeat for multi-ControlNet "
                        "(residuals summed, one --control-image each)")
    p.add_argument("--control-image", action="append", default=None,
                   metavar="PNG",
                   help="Conditioning image for --controlnet (same size as "
                        "--height/--width); repeat once per --controlnet")
    p.add_argument("--control-scale", action="append", type=float,
                   default=None,
                   help="ControlNet residual scale (default 1.0; repeatable "
                        "per net)")
    p.add_argument("--control-start", action="append", type=float,
                   default=None,
                   help="Step fraction where ControlNet guidance starts "
                        "(repeatable per net)")
    p.add_argument("--control-end", action="append", type=float,
                   default=None,
                   help="Step fraction where ControlNet guidance ends "
                        "(repeatable per net)")
    p.add_argument("--ip-adapter", type=str, default=None, metavar="FILE",
                   help="Official IP-Adapter safetensors file (image-prompt "
                        "conditioning via decoupled cross-attention); use "
                        "with --ip-image and --ip-image-encoder")
    p.add_argument("--ip-image-encoder", type=str, default=None,
                   metavar="DIR",
                   help="transformers CLIPVisionModelWithProjection "
                        "directory matching the adapter (ViT-H for "
                        "*_vit-h adapters, ViT-bigG for ip-adapter_sdxl)")
    p.add_argument("--ip-image", type=str, default=None, metavar="PNG",
                   help="Image prompt for --ip-adapter (any size; "
                        "CLIP-resized internally)")
    p.add_argument("--ip-scale", type=float, default=0.6,
                   help="IP-Adapter attention scale (default 0.6; 1.0 = "
                        "image dominates, ~0.3 = subtle)")
    p.add_argument("--deepcache", type=int, default=None, metavar="N",
                   help="DeepCache (arXiv:2312.00858): run the full UNet "
                        "every N steps and reuse the cached deep decoder "
                        "feature in between (~Nx less deep-transformer "
                        "work, small quality cost; try 2-3). Incompatible "
                        "with --controlnet and --preview-every")
    p.add_argument("--deepcache-branch", type=int, default=3, metavar="B",
                   help="How many shallow UNet blocks cached steps "
                        "recompute (default 3 = the full top level)")
    p.add_argument("--hires-scale", type=float, default=None,
                   help="Two-pass hires-fix: sample at --height/--width, "
                        "bicubic-upscale the latent by this factor, re-noise "
                        "at --hires-strength and denoise the tail")
    p.add_argument("--hires-strength", type=float, default=0.3,
                   help="Re-noise strength for the hires pass (0, 1]")
    p.add_argument("--img2img-strength", type=float, default=None,
                   help="With --reference-img: strength-based img2img "
                        "instead of crop-window inpainting")
    p.add_argument("--vae-tile", type=int, default=None, metavar="LATENT_PX",
                   help="Tiled VAE decode AND encode with this latent tile "
                        "size (e.g. 96): bounds VAE memory for >=4096^2 "
                        "outputs / img2img inputs at a small seam-blend "
                        "approximation")
    p.add_argument("--preview-every", type=int, default=None,
                   help="txt2img (any sampler): write a cheap latent preview "
                        "PNG ({output_dir}preview_{step}.png) every N steps")
    p.add_argument("--dp", type=int, default=None,
                   help="Data-parallel mesh axis size (multi-chip; default "
                        "all devices / --tp)")
    p.add_argument("--tp", type=int, default=None,
                   help="Tensor-parallel mesh axis size (multi-chip)")
    p.add_argument("--trace", type=str, default=None,
                   help="Write a jax.profiler trace to this directory")
    p.add_argument("--debug-nans", action="store_true",
                   help="Enable jax.config.debug_nans for bring-up")
    return p


def _unported(parser: argparse.ArgumentParser, args) -> str | None:
    """The error for the first flag main() does not run, or None."""
    if args.family in _FAMILY_MODULE:
        return (f"--family {args.family} is not ported yet (module "
                f"{_FAMILY_MODULE[args.family]})")
    for action in parser._actions:
        if action.dest in _PORTED:
            continue
        if getattr(args, action.dest) != action.default:
            return (f"{action.option_strings[0]} is not ported yet (module "
                    f"{_WAITS[action.dest]})")
    return None


def pipe_min_layers(pipe) -> int:
    """The shallowest text tower's depth (bounds --clip-skip)."""
    cfg = pipe.embedder_cfg
    if hasattr(cfg, "clip_config"):
        return min(cfg.clip_config.n_layer, cfg.open_clip_config.n_layer)
    return cfg.n_layer


def _load_sd1(args, dtype, loras, device):
    """--family sd1|sd2: (the pipeline, None) or (None, the error)."""
    from ..configs import (
        CLIP_VIT_L_CONFIG,
        OPEN_CLIP_VITH_CONFIG,
        SD2_DIFFUSER,
        SD15_DIFFUSER,
    )
    from ..pipeline.sd1 import load_sd1_pipeline, random_sd1_pipeline

    sd2 = args.family == "sd2"
    clip_cfg = OPEN_CLIP_VITH_CONFIG if sd2 else CLIP_VIT_L_CONFIG
    d_cfg = SD2_DIFFUSER if sd2 else SD15_DIFFUSER
    if args.use_refiner:
        return None, "--use-refiner is an SDXL feature"
    if args.random_weights or args.model_dir is None:
        if not args.random_weights:
            return None, "--model-dir is required (or --random-weights)"
        return random_sd1_pipeline(
            device=device, clip_cfg=clip_cfg, diffuser_cfg=d_cfg,
            unet_dtype=dtype, tokenizer_dir=args.tokenizer_dir,
            penultimate_hidden=sd2), None
    try:
        return load_sd1_pipeline(
            args.model_dir, clip_cfg, d_cfg, dtype, args.tokenizer_dir,
            penultimate_hidden=sd2, loras=loras, device=device), None
    except (KeyError, FileNotFoundError, ValueError) as e:
        return None, f"failed to load checkpoint from {args.model_dir}: {e}"


def _load_mask(args):
    """--mask-img PNG -> [H, W, 3] u8 array (None when not given)."""
    if args.mask_img is None:
        return None
    from ..io.images import load_images

    return load_images([args.mask_img])[0]


def _per_net(vals, default, n: int, name: str):
    """A repeatable ControlNet flag's value(s) for n nets: the default,
    one value for all, or one a net."""
    if vals is None:
        return default if n == 1 else [default] * n
    if len(vals) == 1:
        return vals[0] if n == 1 else vals * n
    if len(vals) != n:
        raise ValueError(f"{name}: {len(vals)} values for {n} ControlNets")
    return vals


def _check_module11(args):
    """The reference CLI's checks of the ControlNet, IP-Adapter,
    DeepCache, PAG, outpaint, mask, hires-fix, inversion and
    InstructPix2Pix flags, in its order: the error message of the first
    that fails, else the request's extra pipeline keywords (the control
    ones without the images, which main loads after the pipeline)."""
    control_kw = {}
    if (args.controlnet is None) != (args.control_image is None):
        return "--controlnet and --control-image go together"
    if args.controlnet is not None:
        if args.hires_scale is not None:
            return ("--controlnet applies to txt2img/img2img/inpaint (no "
                    "--hires-scale)")
        n = len(args.controlnet)
        if len(args.control_image) != n:
            return (f"{n} --controlnet but {len(args.control_image)} "
                    "--control-image (need one image per net)")
        try:
            control_kw = dict(
                control_scale=_per_net(args.control_scale, 1.0, n,
                                       "--control-scale"),
                control_start=_per_net(args.control_start, 0.0, n,
                                       "--control-start"),
                control_end=_per_net(args.control_end, 1.0, n,
                                     "--control-end"))
        except ValueError as e:
            return str(e)
    if args.ip_adapter is not None or args.ip_image is not None:
        if not (args.ip_adapter and args.ip_image and args.ip_image_encoder):
            return "--ip-adapter, --ip-image-encoder and --ip-image go together"
        if args.hires_scale is not None:
            return ("--ip-adapter applies to txt2img/img2img/inpaint (no "
                    "--hires-scale)")
        control_kw["ip_adapter_scale"] = args.ip_scale
    if args.deepcache is not None:
        if args.controlnet is not None or args.hires_scale is not None \
                or args.preview_every:
            return ("--deepcache is incompatible with --controlnet, "
                    "--hires-scale and --preview-every")
        if args.deepcache < 1 or args.deepcache_branch < 1:
            return "--deepcache and --deepcache-branch must be >= 1"
        control_kw["deepcache"] = (args.deepcache, args.deepcache_branch)
    if args.pag_scale:
        if args.hires_scale is not None:
            return "--pag-scale is not supported with --hires-scale"
        control_kw["pag_scale"] = args.pag_scale
    if args.outpaint is not None and (
            args.reference_img is None or args.img2img_strength is not None):
        return ("--outpaint extends --reference-img (and is not an "
                "--img2img-strength mode)")
    if (args.mask_img is not None or args.mask_blur > 0) and (
            args.reference_img is None or args.img2img_strength is not None):
        return ("--mask-img/--mask-blur are inpainting flags (need "
                "--reference-img, not an --img2img-strength mode)")
    if args.hires_scale is not None:
        if args.reference_img is not None or args.use_refiner:
            return ("--hires-scale is a txt2img feature (no --reference-img "
                    "/ --use-refiner)")
    elif args.invert_img is not None:
        if (args.reference_img is not None or args.edit_image is not None
                or args.use_refiner or control_kw or args.preview_every):
            return ("--invert-img is not combinable with --reference-img / "
                    "--edit-image / --use-refiner / --controlnet / "
                    "--ip-adapter / --deepcache / --pag-scale / "
                    "--preview-every")
        if args.sampler != "ddim":
            return "--invert-img is defined on the DDIM chain (--sampler ddim)"
    elif args.edit_image is not None:
        if args.reference_img is not None:
            return ("--edit-image (ip2p) and --reference-img "
                    "(img2img/inpaint) are different conditioning modes — "
                    "pass one")
        if args.use_refiner or control_kw or args.preview_every:
            return ("--edit-image (ip2p) is not combinable with "
                    "--use-refiner / --controlnet / --ip-adapter / "
                    "--deepcache / --pag-scale / --preview-every")
    return control_kw


def main(argv=None, device="cuda") -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    bad = _unported(parser, args)
    if bad:
        print(f"error: {bad}", file=sys.stderr)
        return 1

    from ..configs import SDXL_REFINER_DIFFUSER
    from ..io.burn_mpk import MpkParseError
    from ..io.images import load_images, save_images
    from ..io.lora import parse_lora_specs
    from ..pipeline.loader import load_pipeline
    from ..pipeline.pipeline import random_pipeline
    from ..utils import log

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device: the port runs on the GPU",
              file=sys.stderr)
        return 1
    dtype = torch.float32 if args.f32 else torch.bfloat16

    loras = parse_lora_specs(args.lora)
    if loras and args.random_weights:
        print("error: --lora requires a real checkpoint (--model-dir)",
              file=sys.stderr)
        return 1
    if args.denoising_end is not None and (
            args.family != "sdxl" or not args.use_refiner
            or args.reference_img is not None):
        print("error: --denoising-end is the SDXL ensemble-of-experts "
              "txt2img split; it requires --family sdxl with "
              "--use-refiner and no --reference-img",
              file=sys.stderr)
        return 1
    if len(args.prompt) > 1 and args.batch != 1:
        print("error: use either repeated --prompt or --batch, not both",
              file=sys.stderr)
        return 1
    control_kw = _check_module11(args)
    if isinstance(control_kw, str):
        print(f"error: {control_kw}", file=sys.stderr)
        return 1

    if args.family in ("sd1", "sd2"):
        pipe, err = _load_sd1(args, dtype, loras, device)
        if err:
            print(f"error: {err}", file=sys.stderr)
            return 1
    elif args.random_weights or args.model_dir is None:
        if not args.random_weights:
            print("error: --model-dir is required (or pass --random-weights)",
                  file=sys.stderr)
            return 1
        pipe = random_pipeline(
            device=device, unet_dtype=dtype, with_encoder=True,
            refiner_cfg=SDXL_REFINER_DIFFUSER if args.use_refiner else None,
            tokenizer_dir=args.tokenizer_dir)
    else:
        try:
            pipe = load_pipeline(args.model_dir, args.use_refiner,
                                 compute_dtype=dtype,
                                 tokenizer_dir=args.tokenizer_dir,
                                 loras=loras, device=device)
        except (MpkParseError, KeyError, FileNotFoundError, ValueError,
                NotImplementedError) as e:
            # checkpoint problems are user input problems: print the
            # (path-qualified) reason instead of a traceback
            print(f"error: failed to load checkpoint from {args.model_dir}: "
                  f"{e}", file=sys.stderr)
            return 1
    if args.vae_bf16:
        pipe.vae_dtype = torch.bfloat16
    if args.vae_tile:
        pipe.vae_tile = args.vae_tile
    if args.no_strict_resolution:
        pipe.strict_resolutions = False
    if args.zsnr:
        pipe.rescale_zsnr()
        log("zsnr: alpha-bar table rescaled to zero terminal SNR "
            "(arXiv:2305.08891)")
    if args.freeu is not None:
        import dataclasses

        from ..configs import parse_freeu_spec

        try:
            fu = parse_freeu_spec(args.freeu, args.family)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        pipe.diffuser_cfg = dataclasses.replace(pipe.diffuser_cfg, freeu=fu)
        log(f"freeu: (b1,b2,s1,s2) = {fu} (base UNet decoder)")
    if args.embedding:
        try:
            pipe.add_textual_inversions(args.embedding)
        except (ValueError, KeyError, FileNotFoundError) as e:
            print(f"error: failed to load textual-inversion embedding: {e}",
                  file=sys.stderr)
            return 1
    if args.clip_skip:
        if not 0 <= args.clip_skip < pipe_min_layers(pipe) - 1:
            print(f"error: --clip-skip {args.clip_skip} out of range for "
                  f"this model", file=sys.stderr)
            return 1
        pipe.clip_skip = args.clip_skip

    if args.controlnet is not None:
        pipe.load_controlnet(args.controlnet[0] if len(args.controlnet) == 1
                             else args.controlnet)
        images = [load_images([p])[0] for p in args.control_image]
        control_kw["control_image"] = (images[0] if len(images) == 1
                                       else images)
    if args.ip_adapter is not None:
        try:
            pipe.load_ip_adapter(args.ip_adapter, args.ip_image_encoder)
        except (KeyError, FileNotFoundError, ValueError) as e:
            print(f"error: failed to load IP-Adapter: {e}", file=sys.stderr)
            return 1
        control_kw["ip_adapter_image"] = load_images([args.ip_image])[0]

    prompts = (args.prompt if len(args.prompt) > 1
               else [args.prompt[0]] * args.batch)
    common = dict(n_steps=args.n_diffusion_steps,
                  guidance_scale=args.unconditional_guidance_scale,
                  seed=args.seed, negative_prompt=args.negative_prompt,
                  sampler=args.sampler, schedule=args.schedule,
                  guidance_rescale=args.guidance_rescale,
                  no_cfg=args.no_cfg)
    if args.hires_scale is not None:
        images = pipe.txt2img_hires(
            prompts, resolution=(args.height, args.width),
            hires_scale=args.hires_scale,
            hires_strength=args.hires_strength, **common)
    elif args.invert_img is not None:
        # DDIM inversion editing (arXiv:2211.09794): invert under the
        # source prompt, denoise under the edit prompt over the same grid
        src = load_images([args.invert_img])
        try:
            inv = pipe.ddim_invert(
                [args.invert_prompt] * len(prompts), src,
                n_steps=args.n_diffusion_steps, guidance_scale=1.0)
            images = pipe.txt2img(
                prompts, resolution=(src.shape[1], src.shape[2]),
                n_steps=args.n_diffusion_steps,
                guidance_scale=args.unconditional_guidance_scale,
                seed=args.seed, negative_prompt=args.negative_prompt,
                guidance_rescale=args.guidance_rescale, no_cfg=args.no_cfg,
                initial_latent=inv)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    elif args.edit_image is not None:
        # InstructPix2Pix (arXiv:2211.09800): an 8-channel UNet, 3-way CFG
        try:
            images = pipe.ip2p(
                prompts, load_images([args.edit_image]),
                n_steps=args.n_diffusion_steps,
                guidance_scale=args.unconditional_guidance_scale,
                image_guidance_scale=args.image_guidance_scale,
                seed=args.seed, negative_prompt=args.negative_prompt,
                sampler=args.sampler, schedule=args.schedule,
                no_cfg=args.no_cfg)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    elif args.reference_img is not None and args.img2img_strength is not None:
        ref = load_images([args.reference_img])
        if len(prompts) > 1:
            # one variation per prompt off the same reference
            ref = np.repeat(ref, len(prompts), axis=0)
        images = pipe.img2img(prompts, ref, strength=args.img2img_strength,
                              ddim_eta=args.ddim_eta, **common, **control_kw)
    elif args.reference_img is not None and args.outpaint is not None:
        try:
            pad = tuple(int(v) for v in args.outpaint.split(","))
            if len(pad) != 4:
                raise ValueError
        except ValueError:
            print("error: --outpaint takes L,R,T,B pixel counts",
                  file=sys.stderr)
            return 1
        ref = load_images([args.reference_img])
        try:
            images = pipe.outpaint(prompts, ref, pad=pad,
                                   fill=args.outpaint_fill,
                                   ddim_eta=args.ddim_eta, **common,
                                   **control_kw)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    elif args.reference_img is not None:
        ref = load_images([args.reference_img])
        images = pipe.inpaint(
            prompts, ref, crop_left=args.crop_left,
            crop_right=args.crop_right, crop_top=args.crop_top,
            crop_bottom=args.crop_bottom, crop_out=args.crop_out,
            mask_image=_load_mask(args), mask_blur=args.mask_blur,
            use_refiner=args.use_refiner, ddim_eta=args.ddim_eta, **common,
            **control_kw)
    else:
        preview_cb = None
        if args.preview_every:
            def preview_cb(done, total, rgb):
                save_images(rgb[:1], f"{args.output_dir}preview_{done:03d}_")
                log(f"preview at step {done}/{total}")
        images = pipe.txt2img(
            prompts, resolution=(args.height, args.width),
            use_refiner=args.use_refiner, denoising_end=args.denoising_end,
            preview_every=args.preview_every, preview_callback=preview_cb,
            ddim_eta=args.ddim_eta, **common, **control_kw)

    meta = {
        "parameters": (
            f"{' | '.join(dict.fromkeys(prompts))}\n"
            f"Negative prompt: {args.negative_prompt}\n"
            f"Steps: {args.n_diffusion_steps}, Sampler: {args.sampler}"
            f"{' Karras' if args.schedule == 'karras' else ''}, "
            f"CFG scale: {args.unconditional_guidance_scale}, "
            f"Seed: {args.seed}, Size: {args.width}x{args.height}, "
            f"Model: {args.model_dir or 'random'}, Backend: sdxl_tpu_torch"
        ),
    }
    paths = save_images(np.asarray(images), args.output_dir, metadata=meta)
    log(f"saved: {paths}")
    log(pipe.timer.summary())
    total = pipe.timer.total()
    if total > 0:
        log(f"throughput: {60.0 * len(prompts) / total:.2f} images/min "
            f"(p50-equivalent latency {total / len(prompts):.2f}s/image)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
