"""Latent-space inpainting masks (the port's copy of
sdxl_tpu/pipeline/masks.py, numpy in and out).

Two surfaces produce the same [1, H/8, W/8, 1] float32 mask (1 =
generate): a pixel-space crop WINDOW (the reference binary's crop-window
semantics) or a mask IMAGE where any >127 pixel inside an 8x8 cell marks
the cell generated."""

from __future__ import annotations

from typing import Optional

import numpy as np


def _gaussian_blur2d(a: np.ndarray, sigma: float) -> np.ndarray:
    """Separable gaussian blur (edge-padded), sigma in pixels — the same
    operation A1111's mask_blur applies (PIL GaussianBlur(radius) with
    radius as the standard deviation)."""
    r = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    k /= k.sum()
    out = np.pad(a.astype(np.float64), ((r, r), (0, 0)), mode="edge")
    out = np.apply_along_axis(
        lambda v: np.convolve(v, k, "valid"), 0, out)
    out = np.pad(out, ((0, 0), (r, r)), mode="edge")
    out = np.apply_along_axis(
        lambda v: np.convolve(v, k, "valid"), 1, out)
    return out


def build_latent_mask(
    height: int,
    width: int,
    mask_image: Optional[np.ndarray] = None,  # [H, W(,C)] u8, >127 = gen
    crop_left: Optional[int] = None,
    crop_right: Optional[int] = None,
    crop_top: Optional[int] = None,
    crop_bottom: Optional[int] = None,
    crop_out: bool = False,
    mask_blur: float = 0.0,
) -> np.ndarray:
    """mask_blur > 0 (pixels of gaussian sigma) returns a CONTINUOUS
    [0, 1] mask: the pixel-space 0/1 decision is blurred, then
    mean-pooled 8x8 into latent cells — the soft-inpainting boundary
    feather of A1111's mask_blur, which the per-step pin lerps
    (sampler.inpaint_pin). mask_blur == 0 keeps the hard mask (max-pooled
    cells / floored crop window)."""
    lh, lw = height // 8, width // 8
    if mask_image is not None:
        if any(v is not None
               for v in (crop_left, crop_right, crop_top, crop_bottom)):
            raise ValueError("pass either mask_image or a crop window, "
                             "not both")
        m = np.asarray(mask_image)
        if m.shape[:2] != (height, width):
            raise ValueError(f"mask {m.shape[:2]} does not match image "
                             f"{(height, width)}")
        if m.ndim == 3:
            m = m.max(axis=-1)
        if mask_blur > 0:
            px = (m[: lh * 8, : lw * 8] > 127).astype(np.float64)
        else:
            cells = (m[: lh * 8, : lw * 8].reshape(lh, 8, lw, 8)
                     .max(axis=(1, 3)) > 127)
            mask = cells[None, :, :, None]
    else:
        crop_left = 0 if crop_left is None else crop_left
        crop_right = width if crop_right is None else crop_right
        crop_top = 0 if crop_top is None else crop_top
        crop_bottom = height if crop_bottom is None else crop_bottom
        if not (crop_right <= width and crop_bottom <= height
                and (crop_left < crop_right or crop_top < crop_bottom)):
            raise ValueError("Invalid crop parameters.")
        if mask_blur > 0:
            px = np.zeros((lh * 8, lw * 8), dtype=np.float64)
            px[crop_top:crop_bottom, crop_left:crop_right] = 1.0
        else:
            l, r = crop_left // 8, crop_right // 8
            t, b = crop_top // 8, crop_bottom // 8
            mask = np.zeros((1, lh, lw, 1), dtype=bool)
            mask[:, t:b, l:r, :] = True
    if mask_blur > 0:
        if crop_out:
            px = 1.0 - px
        px = _gaussian_blur2d(px, float(mask_blur))
        mask = px.reshape(lh, 8, lw, 8).mean(axis=(1, 3))[None, :, :, None]
        return np.clip(mask, 0.0, 1.0).astype(np.float32)
    if crop_out:
        mask = ~mask
    return mask.astype(np.float32)
