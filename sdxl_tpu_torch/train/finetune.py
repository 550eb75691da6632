"""LoRA fine-tuning of the SDXL UNet (counterpart of the LoRA path of
sdxl_tpu/train/finetune.py).

The dataset is encoded once through the pipeline's own frozen towers
(``_encode_items``: VAE latents and text conditioning, held on the host
as numpy); batches are numpy gathers drawn from
``np.random.default_rng(seed + 1)``, the reference's batch indices; each
step is one forward/backward of the frozen bf16 UNet with f32 LoRA factors
in its linears, rematerialised (``torch.utils.checkpoint`` around the
whole ``unet_forward``, the counterpart of the reference's
``jax.checkpoint(..., nothing_saveable)``), so the backward recomputes the
forward, and one AdamW update.

Training runs on the pipeline's device; build the pipeline on "cuda"
(``random_pipeline(device="cuda", with_encoder=True)``) unless the CPU is
wanted. Left for later slices: listing and loading an image folder (the
card's Python has no PIL), aspect buckets, prior preservation, ControlNet,
textual inversion, text-encoder LoRA, full fine-tuning, checkpoints and
resume, validation sampling, multires noise, the flow-matching loss,
adapter export and the CLI.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models.unet import unet_forward, unfuse_unet_qkv
from ..pipeline.latent import encode_images_to_latent
from ..utils import log
from .lora import clear_factors, init_lora, set_factors
from .losses import Draw, diffusion_loss
from .step import TrainState, adamw_cosine, make_train_step


@dataclass
class EncodedDataset:
    latents: np.ndarray            # [N, h, w, c] f32, already VAE-scaled
    ctx: np.ndarray                # [N, T, d] text context
    label: Optional[np.ndarray]    # [N, adm] channel context
    uncond_ctx: np.ndarray         # [T, d] empty-prompt context
    uncond_label: Optional[np.ndarray]
    captions: list

    @property
    def n(self) -> int:
        return self.latents.shape[0]


def _pad_t(c: np.ndarray, t_max: int) -> np.ndarray:
    """Tile a [B, 77k, d] context along tokens to t_max (long captions
    chunk to more tokens; the batch gather wants one shape)."""
    if c.shape[1] == t_max:
        return c
    reps = -(-t_max // c.shape[1])
    return np.tile(c, (1, reps, 1))[:, :t_max]


@torch.no_grad()
def _encode_items(pipe, images: np.ndarray, captions: Sequence[str],
                  chunk: int = 4) -> EncodedDataset:
    """Encode uint8 images [N, H, W, 3] and their captions: VAE latents and
    text conditioning through the pipeline's own frozen towers, with the
    SDXL size conditioning at the images' (H, W)."""
    if pipe.vae_encoder is None:
        raise ValueError("the pipeline has no VAE encoder (random_pipeline("
                         "..., with_encoder=True))")
    hw = tuple(images.shape[1:3])
    lat_chunks, ctx_chunks, label_chunks = [], [], []
    for i in range(0, len(images), chunk):
        imgs = torch.as_tensor(images[i:i + chunk], device=pipe.device)
        lat_chunks.append(encode_images_to_latent(
            pipe.vae_encoder, imgs, pipe.scale_factor).float().cpu().numpy())
        cond = pipe.conditioning(list(captions[i:i + chunk]), hw,
                                 profile_stages=False)
        ctx_chunks.append(cond.context_full.float().cpu().numpy())
        label_chunks.append(cond.channel_context.float().cpu().numpy())
    # empty-prompt conditioning for caption dropout
    uncond = pipe.conditioning([""], hw, profile_stages=False)
    t_max = max(c.shape[1] for c in ctx_chunks)
    return EncodedDataset(
        latents=np.concatenate(lat_chunks, 0),
        ctx=np.concatenate([_pad_t(c, t_max) for c in ctx_chunks], 0),
        label=np.concatenate(label_chunks, 0),
        uncond_ctx=_pad_t(uncond.context_full.float().cpu().numpy(),
                          t_max)[0],
        uncond_label=uncond.channel_context.float().cpu().numpy()[0],
        captions=list(captions),
    )


def sample_batch(data: EncodedDataset, batch_size: int,
                 rng: np.random.Generator,
                 caption_dropout: float = 0.0) -> dict:
    idx = rng.integers(0, data.n, (batch_size,))
    ctx = data.ctx[idx]
    label = data.label[idx] if data.label is not None else None
    if caption_dropout > 0.0:
        drop = rng.random(batch_size) < caption_dropout
        ctx = np.where(drop[:, None, None], data.uncond_ctx[None], ctx)
        if label is not None:
            label = np.where(drop[:, None], data.uncond_label[None], label)
    batch = {"latents": data.latents[idx], "ctx": ctx}
    if label is not None:
        batch["label"] = label
    return batch


@dataclass
class FinetuneConfig:
    rank: int = 16
    targets: str = "attn"          # train/lora.py preset
    steps: int = 1000
    batch_size: int = 1
    accum: int = 1
    lr: float = 1e-4
    warmup: int = 0
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    snr_gamma: Optional[float] = None
    noise_offset: float = 0.0
    prediction_type: str = "epsilon"       # "epsilon" | "v"
    caption_dropout: float = 0.0
    ema_decay: Optional[float] = None
    seed: int = 0
    log_every: int = 10


def _draw_batch(data: EncodedDataset, cfg: FinetuneConfig,
                rng: np.random.Generator) -> dict:
    """One (possibly accum-stacked) training batch."""
    batch = sample_batch(data, cfg.batch_size * cfg.accum, rng,
                         cfg.caption_dropout)
    if cfg.accum > 1:
        batch = {k: v.reshape((cfg.accum, cfg.batch_size) + v.shape[1:])
                 for k, v in batch.items()}
    return batch


def _unet_loss_fn(pipe, cfg: FinetuneConfig) -> Callable:
    """loss(trainable, batch, draw) for the SDXL UNet with the factors in
    its linears (the conditioning comes cached in the batch; no
    text-encoder training)."""
    unet = pipe.unet
    alphas = pipe.alphas_cumprod
    dtype = pipe.compute_dtype

    def apply_fn(trainable, x_t, t, batch):
        set_factors(unet, trainable)
        return checkpoint(unet_forward, unet, x_t.to(dtype), t,
                          batch["ctx"].to(dtype), batch.get("label"),
                          use_reentrant=False)

    def loss_fn(trainable, batch, draw: Draw):
        return diffusion_loss(apply_fn, trainable, alphas, batch, draw,
                              prediction_type=cfg.prediction_type,
                              snr_gamma=cfg.snr_gamma,
                              noise_offset=cfg.noise_offset)

    return loss_fn


def _run_loop(step, state: TrainState, data: EncodedDataset,
              cfg: FinetuneConfig, device, draws=None,
              on_step=None) -> TrainState:
    """The host-side loop: numpy batch gathers -> the step; loss logging.
    draws(i) gives step i's draw(s); by default a torch.Generator seeded
    with seed + 2 on the device."""
    rng = np.random.default_rng(cfg.seed + 1)
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 2)
    t0, ema_loss = time.perf_counter(), None
    for i in range(cfg.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in _draw_batch(data, cfg, rng).items()}
        state, loss = step(state, batch, gen if draws is None else draws(i))
        loss = float(loss)
        if on_step is not None:
            on_step(i, state, loss)
        ema_loss = loss if ema_loss is None else 0.98 * ema_loss + 0.02 * loss
        if cfg.log_every and (i + 1) % cfg.log_every == 0:
            rate = (i + 1) / max(time.perf_counter() - t0, 1e-9)
            log(f"step {i + 1}/{cfg.steps}: loss {loss:.4f} "
                f"(ema {ema_loss:.4f}), {rate:.2f} it/s")
    return state


def finetune_lora(pipe, data: EncodedDataset, cfg: FinetuneConfig,
                  factors: Optional[Dict[str, torch.Tensor]] = None,
                  draws: Optional[Callable[[int], Draw]] = None,
                  on_step: Optional[Callable] = None
                  ) -> Tuple[Dict[str, torch.Tensor],
                             Optional[Dict[str, torch.Tensor]]]:
    """Run the LoRA fine-tune on the pipeline's device; returns (factors,
    ema factors or None).

    The UNet is switched to the unfused training layout (in place; its
    function is unchanged) and stays frozen; the f32 factors are the only
    trainable tensors and are taken out of it again at the end. factors:
    initial factors (default: init_lora from a generator seeded with
    cfg.seed). draws(i): step i's draw (default: one generator seeded with
    cfg.seed + 2). on_step(i, state, loss) is called after each step."""
    unet = unfuse_unet_qkv(pipe.unet)
    device = pipe.device
    if factors is None:
        factors = init_lora(unet, cfg.rank,
                            torch.Generator(device=device).manual_seed(
                                cfg.seed), targets=cfg.targets)
    factors = {k: v.to(device) for k, v in factors.items()}
    n_params = sum(v.numel() for v in factors.values())
    log(f"lora: rank {cfg.rank}, {len(factors) // 2} sites, "
        f"{n_params / 1e6:.2f}M trainable params (targets={cfg.targets})")
    tx = adamw_cosine(cfg.lr, cfg.steps, warmup=cfg.warmup, weight_decay=cfg.weight_decay,
                      grad_clip=cfg.grad_clip)
    state = TrainState.create(factors, tx, ema=cfg.ema_decay is not None)
    step = make_train_step(_unet_loss_fn(pipe, cfg), tx,
                           ema_decay=cfg.ema_decay, accum=cfg.accum)
    try:
        state = _run_loop(step, state, data, cfg, device, draws, on_step)
    finally:
        clear_factors(unet)
    return state.params, state.ema
