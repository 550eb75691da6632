"""Latent -> image around the VAE decoder (the decode half of sdxl_tpu/pipeline/latent.py).

decode = VAE(latent / scale_factor), then [-1, 1] -> [0, 255], round and
clip to uint8. Images are NHWC [B, H, W, 3].
"""

from __future__ import annotations

import torch

from ..models.vae import VAEDecoder, decode_latent


@torch.no_grad()
def decode_latent_to_images(vae: VAEDecoder, latent: torch.Tensor,
                            scale_factor: float = 0.13025) -> torch.Tensor:
    """[B, h, w, 4] latent -> [B, 8h, 8w, 3] uint8 RGB, decoded in the
    decoder's dtype (f32 in the pipeline)."""
    dtype = vae.post_quant_conv.weight.dtype
    img = decode_latent(vae, latent.to(dtype) / scale_factor).float()
    img = (img + 1.0) * (255.0 / 2.0)
    return torch.clamp(torch.round(img), 0.0, 255.0).to(torch.uint8)
