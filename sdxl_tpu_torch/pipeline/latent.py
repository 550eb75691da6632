"""Image <-> latent around the VAE (counterpart of sdxl_tpu/pipeline/latent.py).

decode = VAE(latent / scale_factor), then [-1, 1] -> [0, 255], round and
clip to uint8; encode = uint8 -> [-1, 1] -> posterior mean * scale_factor.
Images are NHWC [B, H, W, 3].
"""

from __future__ import annotations

import copy
import weakref
from typing import Optional

import torch

from ..models.vae import VAEDecoder, VAEEncoder, decode_latent, encode_image

# decoder -> {dtype: its copy cast to dtype}, made at the first decode in
# that dtype and kept as long as the decoder lives
_CAST_DECODERS: "weakref.WeakKeyDictionary[VAEDecoder, dict]" = (
    weakref.WeakKeyDictionary())


def _decoder_in(vae: VAEDecoder, dtype: torch.dtype) -> VAEDecoder:
    if vae.post_quant_conv.weight.dtype == dtype:
        return vae
    copies = _CAST_DECODERS.setdefault(vae, {})
    if dtype not in copies:
        copies[dtype] = copy.deepcopy(vae).to(dtype)
    return copies[dtype]


@torch.no_grad()
def decode_latent_to_images(vae: VAEDecoder, latent: torch.Tensor,
                            scale_factor: float = 0.13025,
                            compute_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """[B, h, w, 4] latent -> [B, 8h, 8w, 3] uint8 RGB, decoded in
    compute_dtype (default: the decoder's dtype, f32 in the pipeline).

    compute_dtype=torch.bfloat16 on an f32 decoder is the reference's
    opt-in half-precision decode (``--vae-bf16``). The reference casts the
    f32 weights inside its jitted decode on every call; here they are cast
    once, at the first bf16 decode with this decoder, and the copy is kept
    beside it, so weights loaded into the decoder after that do not reach
    the bf16 decode."""
    vae = _decoder_in(vae, compute_dtype or vae.post_quant_conv.weight.dtype)
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
