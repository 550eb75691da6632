"""Image <-> latent around the VAE (counterpart of sdxl_tpu/pipeline/latent.py).

decode = VAE(latent / scale_factor), then [-1, 1] -> [0, 255], round and
clip to uint8; encode = uint8 -> [-1, 1] -> posterior mean * scale_factor.
Images are NHWC [B, H, W, 3].
"""

from __future__ import annotations

import torch

from ..models.vae import VAEDecoder, VAEEncoder, decode_latent, encode_image


@torch.no_grad()
def decode_latent_to_images(vae: VAEDecoder, latent: torch.Tensor,
                            scale_factor: float = 0.13025) -> torch.Tensor:
    """[B, h, w, 4] latent -> [B, 8h, 8w, 3] uint8 RGB, decoded in the
    decoder's dtype (f32 in the pipeline)."""
    dtype = vae.post_quant_conv.weight.dtype
    img = decode_latent(vae, latent.to(dtype) / scale_factor).float()
    img = (img + 1.0) * (255.0 / 2.0)
    return torch.clamp(torch.round(img), 0.0, 255.0).to(torch.uint8)


@torch.no_grad()
def encode_images_to_latent(vae_encoder: VAEEncoder, images_u8: torch.Tensor,
                            scale_factor: float = 0.13025) -> torch.Tensor:
    """[B, H, W, 3] uint8 RGB -> [B, H/8, W/8, 4] latent, encoded in the
    encoder's dtype (f32 in the pipeline)."""
    dtype = vae_encoder.quant_conv.weight.dtype
    x = images_u8.to(dtype) / 255.0 * 2.0 - 1.0
    return encode_image(vae_encoder, x) * scale_factor
