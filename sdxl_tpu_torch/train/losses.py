"""The diffusion training loss (counterpart of sdxl_tpu/train/losses.py).

DDPM epsilon / v-prediction MSE over the sampler's scaled-linear alpha-bar
table, with min-SNR-gamma weighting and noise offset. The random draws
(timesteps t, noise, the per-sample offset) come from an explicit
``torch.Generator``, or are passed in as tensors so a test can feed the
reference's own draws. Multi-resolution noise waits: it needs a port of
``jax.image.resize``'s bilinear resampling.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

# A draw: a generator to draw (t, noise, offset) from, or the three tensors
# {"t": [B] int, "noise": like the latents, "offset": [B, 1, 1, 1]}.
Draw = Union[torch.Generator, Dict[str, torch.Tensor]]


def _reduce(per_sample: torch.Tensor, batch: dict) -> torch.Tensor:
    """Plain mean, or sum(per_sample * batch["loss_weight"]) when the batch
    carries per-example weights (the caller owns the normalisation)."""
    lw = batch.get("loss_weight")
    if lw is not None:
        return torch.sum(per_sample * lw.float())
    return torch.mean(per_sample)


def snr_from_alphas(alphas_cumprod: torch.Tensor) -> torch.Tensor:
    """Signal-to-noise ratio per train timestep: ab / (1 - ab)."""
    ab = alphas_cumprod.float()
    return ab / (1.0 - ab)


def min_snr_weight(snr_t: torch.Tensor, gamma: float,
                   prediction_type: str) -> torch.Tensor:
    """Min-SNR-gamma per-sample loss weight (arXiv:2303.09556)."""
    clipped = torch.clamp(snr_t, max=gamma)
    if prediction_type == "epsilon":
        return clipped / snr_t
    if prediction_type == "v":
        return clipped / (snr_t + 1.0)
    raise ValueError(prediction_type)


def draw_noise(draw: Draw, x0: torch.Tensor, n_train: int,
               with_offset: bool) -> Dict[str, torch.Tensor]:
    """(t, noise, offset) for latents x0: drawn from a generator (t, then
    noise, then the offset when it is used) or taken as given."""
    b = x0.shape[0]
    if isinstance(draw, torch.Generator):
        out = {"t": torch.randint(0, n_train, (b,), generator=draw,
                                  device=x0.device),
               "noise": torch.randn(x0.shape, generator=draw,
                                    device=x0.device)}
        if with_offset:
            out["offset"] = torch.randn((b,) + (1,) * (x0.dim() - 1),
                                        generator=draw, device=x0.device)
        return out
    return {k: torch.as_tensor(v, device=x0.device) for k, v in draw.items()}


def diffusion_loss(apply_fn: Callable, params, alphas_cumprod: torch.Tensor,
                   batch: dict, draw: Draw, prediction_type: str = "epsilon",
                   snr_gamma: Optional[float] = None,
                   noise_offset: float = 0.0) -> torch.Tensor:
    """Noise-prediction MSE on a batch of clean latents.

    batch["latents"]: [B, h, w, c] VAE latents, already scaled. t ~ U{0..N-1};
    x_t = sqrt(ab_t) x0 + sqrt(1 - ab_t) eps; the target is eps, or
    v = sqrt(ab_t) eps - sqrt(1 - ab_t) x0. apply_fn(params, x_t, t, batch)
    is the model."""
    x0 = batch["latents"].float()
    b = x0.shape[0]
    n_train = alphas_cumprod.shape[0]
    r = draw_noise(draw, x0, n_train, bool(noise_offset))
    t, noise = r["t"].long(), r["noise"].float()
    if noise_offset:
        noise = noise + noise_offset * r["offset"].float()
    ab_t = alphas_cumprod.float()[t].reshape((b,) + (1,) * (x0.dim() - 1))
    sq, sq1 = torch.sqrt(ab_t), torch.sqrt(1.0 - ab_t)
    x_t = sq * x0 + sq1 * noise
    pred = apply_fn(params, x_t, t, batch).float()
    if prediction_type == "epsilon":
        target = noise
    elif prediction_type == "v":
        target = sq * noise - sq1 * x0
    else:
        raise ValueError(prediction_type)
    per_sample = torch.mean(torch.square(pred - target),
                            dim=tuple(range(1, x0.dim())))
    if snr_gamma is not None:
        per_sample = per_sample * min_snr_weight(
            snr_from_alphas(alphas_cumprod)[t], snr_gamma, prediction_type)
    return _reduce(per_sample, batch)
