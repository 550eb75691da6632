"""Flow-matching Euler sampler, the SD3 and FLUX.1 families' scheduler
(counterpart of sdxl_tpu/pipeline/flow_match.py; diffusers'
FlowMatchEulerDiscreteScheduler semantics).

- training grid sigmas = t / 1000, t in [1000 .. 1], time-shifted
  sigma' = shift * sigma / (1 + (shift - 1) * sigma); ``fm_schedule``
  linspaces in t between the shifted endpoints and shifts again, the
  public code's composition, kept as it is so trajectories match;
- the model predicts a velocity: x_{i+1} = x_i + (sigma_{i+1} - sigma_i) v;
- pure noise at sigma = 1; the model input is not rescaled; the
  transformer sees sigma * 1000;
- CFG pair-batched, [uncond | cond] in one transformer call, v = u + (c -
  u) * scale;
- img2img: the last n * strength steps (``fm_window``), from the clean
  latent noised along the straight path (``fm_add_noise``);
- inpainting (``pin_*``): after every update the clean reference,
  re-noised to the next sigma with the same noise every step, keeps the
  unmasked region; the last step's sigma is 0, so it ends on the
  reference exactly.

The loop (``euler_loop``) is a Python loop over the device: each step
launches its transformer call and update without reading anything back.
It calls the transformer through this module's ``mmdit_forward`` (and
pipeline/flux.py's ``flux_forward``), so a caller can count the calls.

``FlowPipelineBase`` holds what SD3Pipeline and FluxPipeline share: the
16-channel VAE and its normalisation, tokenisation and the noising.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..configs import SD3_VAE_CONFIG_KW, AutoencoderConfig
from ..models.mmdit import MMDiT, mmdit_forward
from ..models.vae import VAEDecoder, VAEEncoder
from ..tokenizer.bpe import tokenize_text
from ..utils import fence
from .latent import decode_latent_to_images, encode_images_to_latent

N_TRAIN = 1000


def fm_shift(sigmas: np.ndarray, shift: float) -> np.ndarray:
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


def fm_schedule(n_steps: int, shift: float = 3.0,
                n_train: int = N_TRAIN) -> Tuple[np.ndarray, np.ndarray]:
    """(timesteps [n], sigmas [n + 1] ending in 0), both descending f32."""
    train_sigmas = np.arange(n_train, 0, -1, dtype=np.float64) / n_train
    train_sigmas = fm_shift(train_sigmas, shift)
    sigma_max, sigma_min = train_sigmas[0], train_sigmas[-1]
    ts = np.linspace(sigma_max * n_train, sigma_min * n_train, n_steps,
                     dtype=np.float64)
    sigmas = fm_shift(ts / n_train, shift)
    timesteps = (sigmas * n_train).astype(np.float32)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return timesteps, sigmas


def fm_window(n_steps: int, strength: float) -> int:
    """Index of the first schedule entry an img2img run executes."""
    init = min(int(n_steps * strength), n_steps)
    return max(n_steps - init, 0)


def fm_add_noise(x0: torch.Tensor, noise: torch.Tensor,
                 sigma: float) -> torch.Tensor:
    """x = (1 - sigma) * x0 + sigma * noise, in f32."""
    return (1.0 - sigma) * x0.float() + sigma * noise


def euler_loop(velocity: Callable, latent: torch.Tensor,
               timesteps: np.ndarray, sigmas: np.ndarray,
               pin_reference: Optional[torch.Tensor] = None,
               pin_mask: Optional[torch.Tensor] = None,
               pin_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Euler loop over ``timesteps`` (sigma * 1000, f32) and
    ``sigmas`` (one longer): ``velocity(lat, i, t)`` gives the f32
    velocity of step i at timestep t."""
    lat = latent.float()
    if pin_reference is not None:
        pin_ref, pin_m = pin_reference.float(), pin_mask.float()
        pin_n = pin_noise.float()
    for i, t in enumerate(timesteps):
        v = velocity(lat, i, float(t))
        s_next = sigmas[i + 1]
        lat = lat + float(s_next - sigmas[i]) * v
        if pin_reference is not None:
            proper = float(np.float32(1.0) - s_next) * pin_ref \
                + float(s_next) * pin_n
            lat = pin_m * lat + (1.0 - pin_m) * proper
    return lat


@torch.no_grad()
def fm_diffuse_latent(
    model: MMDiT,
    latent: torch.Tensor,    # [B, h, w, C], noise at sigmas[start_index]
    context: torch.Tensor,   # [B or 2B, T, joint_dim] (CFG: [uncond|cond])
    pooled: torch.Tensor,    # [B or 2B, pooled_dim]
    guidance_scale: float,
    n_steps: int = 28,
    shift: float = 3.0,
    use_cfg: bool = True,
    start_index: int = 0,
    pin_reference: Optional[torch.Tensor] = None,  # clean latent
    pin_mask: Optional[torch.Tensor] = None,       # [1|B,h,w,1], 1 = gen
    pin_noise: Optional[torch.Tensor] = None,
    slg_scale: float = 0.0,
    slg_layers: Tuple[int, ...] = (),
    slg_start: float = 0.01,
    slg_stop: float = 0.2,
) -> torch.Tensor:
    """The MMDiT's flow-matching Euler run, in the model's dtype.

    Skip-layer guidance: inside the (slg_start, slg_stop) fraction of the
    run, one extra cond-only call with ``slg_layers`` omitted adds (v_cond
    - v_skip) * slg_scale to the guided velocity. The window is the public
    gate: i > n * start and i < n * stop, i the 0-based index over the
    steps run, n their count."""
    timesteps, sigmas = fm_schedule(n_steps, shift)
    if slg_layers and not use_cfg:
        raise ValueError("skip-layer guidance needs the CFG pair "
                         "(use_cfg=True), like the public pipeline")
    dtype = model.dtype
    ctx, pld = context.to(dtype), pooled.to(dtype)
    n_run = n_steps - start_index
    b = latent.shape[0]

    def t_vec(t, n):
        return torch.full((n,), t, dtype=torch.float32, device=latent.device)

    def velocity(lat, i, t):
        if not use_cfg:
            v = mmdit_forward(model, lat.to(dtype), t_vec(t, b), ctx,
                              pld).float()
            vc = v
        else:
            v2 = mmdit_forward(model, torch.cat([lat, lat]).to(dtype),
                               t_vec(t, 2 * b), ctx, pld).float()
            vu, vc = v2.chunk(2)
            v = vu + (vc - vu) * guidance_scale
        if slg_layers and n_run * slg_start < i < n_run * slg_stop:
            v_skip = mmdit_forward(model, lat.to(dtype), t_vec(t, b),
                                   ctx[b:], pld[b:],
                                   skip_layers=tuple(slg_layers)).float()
            v = v + (vc - v_skip) * slg_scale
        return v

    return euler_loop(velocity, latent, timesteps[start_index:],
                      sigmas[start_index:], pin_reference, pin_mask,
                      pin_noise)


def draw_noise(shape, seed: int, device) -> torch.Tensor:
    """N(0, 1) f32 of ``shape`` from a torch.Generator seeded with
    ``seed`` on ``device``: a request's initial (or img2img / inpainting)
    noise. Per-image seed lists are module 16's."""
    if not isinstance(seed, (int, np.integer)):
        raise NotImplementedError("per-image seed lists are not ported yet "
                                  "(module 16)")
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32)


def stub_t5_tokenizer(n_tokens: int, vocab_size: int) -> Callable:
    """The random pipelines' T5 tokenizer stand-in: eight ids from a
    stable hash of each text (crc32, the same in every process), the rest
    0; list[str] -> [B, n_tokens] int32."""
    import zlib

    def tokenize(texts):
        out = np.zeros((len(texts), n_tokens), np.int32)
        for i, text in enumerate(texts):
            h = zlib.crc32(text.encode("utf-8"))
            out[i, :min(8, n_tokens)] = [(h >> (4 * j)) % vocab_size
                                         for j in range(8)][:n_tokens]
        return out

    return tokenize


def sd3_vae_config() -> AutoencoderConfig:
    return AutoencoderConfig(**SD3_VAE_CONFIG_KW)


def _prompts(prompts):
    return [prompts] if isinstance(prompts, str) else list(prompts)


@dataclass
class FlowPipelineBase:
    """What the SD3 and FLUX.1 pipelines share: the VAE and its
    normalisation, the timer, the device and the last final latent.
    Building one turns TF32 off for cuBLAS and cuDNN, as SDXLPipeline
    does, so the f32 stages (the towers, T5 in f32, the VAE) run in full
    f32 on the GPU whatever else the process built."""

    vae: VAEDecoder
    vae_encoder: Optional[VAEEncoder]
    scale_factor: float
    shift_factor: float

    def __post_init__(self):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    @property
    def device(self) -> torch.device:
        return self.vae.decoder.conv_in.weight.device

    def _ids(self, tokenizer, texts, n_ctx: int) -> torch.Tensor:
        rows = [tokenize_text(t, tokenizer, n_ctx) for t in texts]
        return torch.as_tensor(np.asarray(rows, np.int64),
                               device=self.device)

    def _t5_ids(self, texts) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.t5_tokenize(list(texts)),
                                          np.int64), device=self.device)

    def _encode(self, images) -> torch.Tensor:
        """[B, H, W, 3] uint8 -> the normalised latent (f32 VAE)."""
        if self.vae_encoder is None:
            raise ValueError("this pipeline has no VAE encoder")
        with self.timer.stage("vae_encode"):
            lat = encode_images_to_latent(
                self.vae_encoder, torch.as_tensor(np.asarray(images),
                                                  device=self.device),
                self.scale_factor, self.shift_factor)
            fence(lat)
        return lat

    def _decode(self, latent: torch.Tensor) -> np.ndarray:
        self.last_latent = latent
        with self.timer.stage("vae_decode"):
            images = decode_latent_to_images(
                self.vae, latent, self.scale_factor,
                shift_factor=self.shift_factor)
            fence(images)
        return images.cpu().numpy()

    def _noised(self, lat0: torch.Tensor, seed, sigma: float):
        """(the clean latent noised to sigma, the noise)."""
        noise = draw_noise(tuple(lat0.shape), seed, self.device)
        return fm_add_noise(lat0, noise, sigma), noise
