"""Image <-> latent around the VAE (counterpart of sdxl_tpu/pipeline/latent.py).

decode = VAE(latent / scale_factor), then [-1, 1] -> [0, 255], round and
clip to uint8; encode = uint8 -> [-1, 1] -> posterior mean * scale_factor.
Images are NHWC [B, H, W, 3].

Tiled VAE (``decode_latent_tiled``, ``encode_images_tiled``; the
reference's): overlapping tiles of one shape, decoded or encoded alone
and blended with linear ramps over the overlap in f32, the last tile of
each axis aligned to the edge, the decode's blend rounded and clipped to
u8 once; per-tile GroupNorm statistics are the usual approximation. A
tile at 1024² (tile 96) is a 768² decode: its mid-block attention runs
over 9216 tokens instead of 16384.
"""

from __future__ import annotations

import copy
import weakref
from typing import List, Optional

import torch

from ..models.vae import VAEDecoder, VAEEncoder, decode_latent, encode_image

# decoder -> {dtype: its copy cast to dtype}, made at the first decode in
# that dtype and kept as long as the decoder lives
_CAST_DECODERS: "weakref.WeakKeyDictionary[VAEDecoder, dict]" = (
    weakref.WeakKeyDictionary())


def _decoder_in(vae: VAEDecoder, dtype: torch.dtype) -> VAEDecoder:
    if vae.dtype == dtype:
        return vae
    copies = _CAST_DECODERS.setdefault(vae, {})
    if dtype not in copies:
        copies[dtype] = copy.deepcopy(vae).to(dtype)
    return copies[dtype]


def _decode_f32(vae: VAEDecoder, latent: torch.Tensor, scale_factor: float,
                dtype: torch.dtype, shift_factor: float = 0.0
                ) -> torch.Tensor:
    """The decode's [0, 255] image in f32, before rounding."""
    z = latent.to(dtype) / scale_factor
    if shift_factor:
        z = z + shift_factor
    img = decode_latent(vae, z).float()
    return (img + 1.0) * (255.0 / 2.0)


@torch.no_grad()
def decode_latent_to_images(vae: VAEDecoder, latent: torch.Tensor,
                            scale_factor: float = 0.13025,
                            compute_dtype: Optional[torch.dtype] = None,
                            shift_factor: float = 0.0) -> torch.Tensor:
    """[B, h, w, C] latent -> [B, 8h, 8w, 3] uint8 RGB, decoded in
    compute_dtype (default: the decoder's dtype, f32 in the pipeline).
    The decoder sees latent / scale_factor + shift_factor (SD3's and
    FLUX.1's normalisation; the shift is 0 for the UNet families).

    compute_dtype=torch.bfloat16 on an f32 decoder is the reference's
    opt-in half-precision decode (``--vae-bf16``). The reference casts the
    f32 weights inside its jitted decode on every call; here they are cast
    once, at the first bf16 decode with this decoder, and the copy is kept
    beside it, so weights loaded into the decoder after that do not reach
    the bf16 decode."""
    vae = _decoder_in(vae, compute_dtype or vae.dtype)
    img = _decode_f32(vae, latent, scale_factor, vae.dtype, shift_factor)
    return torch.clamp(torch.round(img), 0.0, 255.0).to(torch.uint8)


@torch.no_grad()
def encode_images_to_latent(vae_encoder: VAEEncoder, images_u8: torch.Tensor,
                            scale_factor: float = 0.13025,
                            shift_factor: float = 0.0) -> torch.Tensor:
    """[B, H, W, 3] uint8 RGB -> [B, H/8, W/8, C] latent (the posterior
    mean, minus shift_factor, times scale_factor), encoded in the
    encoder's dtype (f32 in the pipeline)."""
    dtype = vae_encoder.dtype
    x = images_u8.to(dtype) / 255.0 * 2.0 - 1.0
    z = encode_image(vae_encoder, x)
    if shift_factor:
        z = z - shift_factor
    return z * scale_factor


def _tile_starts(dim: int, tile: int, stride: int) -> List[int]:
    """Tile starts along one axis: every stride, the last one aligned to
    the edge (so every tile has one shape)."""
    if dim <= tile:
        return [0]
    return list(range(0, dim - tile, stride)) + [dim - tile]


def _ramp(tile: int, overlap: int, device) -> torch.Tensor:
    """[tile, tile] blend weights: linear over the overlap, flat inside."""
    r = torch.minimum(torch.arange(1, tile + 1, dtype=torch.float32),
                      torch.arange(tile, 0, -1, dtype=torch.float32))
    r = torch.clamp(r / max(overlap, 1), max=1.0).to(device)
    return r[:, None] * r[None, :]


def _overlap(tile: int) -> int:
    """Latent pixels two neighbouring tiles share: 16, less for small
    tiles (always < tile)."""
    return min(16, max(tile // 4, 1))


@torch.no_grad()
def decode_latent_tiled(vae: VAEDecoder, latent: torch.Tensor,
                        scale_factor: float = 0.13025,
                        compute_dtype: Optional[torch.dtype] = None,
                        tile: int = 96) -> torch.Tensor:
    """Tiled decode: latent tiles of tile x tile (an overlap of
    ``_overlap(tile)`` latent pixels hides the seams), each decoded alone, blended in
    f32, then rounded and clipped to uint8. A latent within one tile takes
    decode_latent_to_images."""
    b, h, w, _ = latent.shape
    if h <= tile and w <= tile:
        return decode_latent_to_images(vae, latent, scale_factor,
                                       compute_dtype)
    overlap = _overlap(tile)
    vae = _decoder_in(vae, compute_dtype or vae.dtype)
    dtype = vae.dtype
    f = 2 ** (len(vae.cfg.decoder_channels) - 1)  # the VAE's upsampling
    out = torch.zeros((b, h * f, w * f, 3), dtype=torch.float32,
                      device=latent.device)
    wsum = torch.zeros((1, h * f, w * f, 1), dtype=torch.float32,
                       device=latent.device)
    weight = _ramp(tile * f, overlap * f, latent.device)
    stride = tile - overlap
    for y in _tile_starts(h, tile, stride):
        for x in _tile_starts(w, tile, stride):
            rgb = _decode_f32(vae, latent[:, y:y + tile, x:x + tile],
                              scale_factor, dtype)
            th, tw = rgb.shape[1:3]
            wt = weight[:th, :tw, None]
            out[:, y * f:y * f + th, x * f:x * f + tw] += rgb * wt
            wsum[:, y * f:y * f + th, x * f:x * f + tw] += wt
    img = out / torch.clamp(wsum, min=1e-8)
    return torch.clamp(torch.round(img), 0.0, 255.0).to(torch.uint8)


@torch.no_grad()
def encode_images_tiled(vae_encoder: VAEEncoder, images_u8: torch.Tensor,
                        scale_factor: float = 0.13025, tile: int = 96
                        ) -> torch.Tensor:
    """Tiled encode, the decode's twin: image tiles of 8 * tile pixels
    (``tile`` and the overlap in latent pixels, as the decode's), each
    encoded alone, their latents blended in f32. Images within one tile
    take encode_images_to_latent."""
    f = 2 ** (len(vae_encoder.cfg.encoder_channels) - 1)
    b, H, W, _ = images_u8.shape
    h, w = H // f, W // f
    if h <= tile and w <= tile:
        return encode_images_to_latent(vae_encoder, images_u8, scale_factor)
    overlap = _overlap(tile)
    out = torch.zeros((b, h, w, vae_encoder.cfg.latent_channels),
                      dtype=torch.float32,
                      device=images_u8.device)
    wsum = torch.zeros((1, h, w, 1), dtype=torch.float32,
                       device=images_u8.device)
    weight = _ramp(tile, overlap, images_u8.device)
    tpx, stride = tile * f, (tile - overlap) * f
    for y in _tile_starts(H, tpx, stride):
        for x in _tile_starts(W, tpx, stride):
            lat = encode_images_to_latent(
                vae_encoder, images_u8[:, y:y + tpx, x:x + tpx],
                scale_factor).float()
            th, tw = lat.shape[1:3]
            wt = weight[:th, :tw, None]
            ly, lx = y // f, x // f
            out[:, ly:ly + th, lx:lx + tw] += lat * wt
            wsum[:, ly:ly + th, lx:lx + tw] += wt
    return out / torch.clamp(wsum, min=1e-8)
