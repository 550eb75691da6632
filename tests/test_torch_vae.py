"""Port VAE decoder against sdxl_tpu/models/vae.py, f32 on CPU.

Weights drawn in the reference's tree layout cross over through
io/bridge.py. Decode within 4e-3 (the reference's full-scale VAE decode
bound); uint8 images within one level (the bf16 decode's bounds are in
its test). The second config's mid-block
attention (1024 tokens, one 128-wide head) routes through flash: the JAX
kernel in interpret mode, the port's plain version on CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdxl_tpu.configs import AutoencoderConfig
from sdxl_tpu.models.vae import decode_latent as j_decode_latent
from sdxl_tpu.models.vae import init_autoencoder
from sdxl_tpu.pipeline.latent import decode_latent_to_images as j_decode_images
from sdxl_tpu_torch.io.bridge import vae_decoder_state_dict
from sdxl_tpu_torch.models.vae import VAEDecoder, decode_latent
from sdxl_tpu_torch.ops.flash_attention import use_flash
from sdxl_tpu_torch.pipeline import latent as latent_mod
from sdxl_tpu_torch.pipeline.latent import decode_latent_to_images
from tests.test_torch_unet import random_tree

# One intra-op thread: the suite runs six workers on shared cores,
# where torch's default of a thread per core makes small ops spin.
torch.set_num_threads(1)

TINY = AutoencoderConfig(encoder_channels=((8, 8), (8, 16)),
                         decoder_channels=((16, 16), (16, 8)), n_group=4,
                         n_channels_out=8, latent_channels=4)
FLASH_TINY = AutoencoderConfig(encoder_channels=((8, 8), (8, 16)),
                               decoder_channels=((128, 128), (128, 32)),
                               n_group=32, n_channels_out=8,
                               latent_channels=4)


def models(cfg, seed):
    params = random_tree(init_autoencoder, cfg, seed=seed, scale=0.05)
    model = VAEDecoder(cfg)
    model.load_state_dict(vae_decoder_state_dict(params))
    return params, model


@pytest.mark.parametrize("cfg,hw", [(TINY, 12), (FLASH_TINY, 32)])
def test_decode_matches_reference(cfg, hw):
    params, model = models(cfg, seed=hw)
    latent = np.random.default_rng(hw).standard_normal(
        (2, hw, hw, 4)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, z: j_decode_latent(p, cfg, z))(
        params, latent))
    with torch.no_grad():
        got = decode_latent(model, torch.from_numpy(latent)).numpy()
    assert got.shape == want.shape == (2, 2 * hw, 2 * hw, 3)
    assert np.abs(want).max() > 0.05  # a real signal, not all zeros
    np.testing.assert_allclose(got, want, atol=4e-3, rtol=0)


def test_flash_config_routes_mid_attention_to_flash():
    assert use_flash(32 * 32, 32 * 32, 128, False)


def test_decode_latent_to_images_matches_reference():
    params, model = models(TINY, seed=3)
    latent = (np.random.default_rng(3).standard_normal((1, 12, 12, 4))
              .astype(np.float32) * 0.13025)
    want = np.asarray(j_decode_images(params, TINY, jnp.asarray(latent)))
    got = decode_latent_to_images(model, torch.from_numpy(latent)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_decode_latent_to_images_bf16_matches_reference():
    """compute_dtype=bfloat16 (the reference's --vae-bf16 decode). bf16
    rounds at other places in the two frameworks (the reference rounds the
    conv output before its bias and sigmoid(x) before x * sigmoid(x); torch
    fuses both), so the two bf16 decodes differ by two independent bf16
    noises: up to 6 u8 levels here, 0.8 on average. Bounds: the mean
    |port - reference| over the image within 2 levels, and the port no
    farther from the f32 decode, at any pixel, than the reference's own
    bf16 decode is, plus one level. The f32 decoder is cast once and the
    bf16 copy kept for later calls; the f32 weights stay as they were."""
    params, model = models(TINY, seed=5)
    latent = (np.random.default_rng(5).standard_normal((1, 12, 12, 4))
              .astype(np.float32) * 0.13025)
    want, f32 = (np.asarray(j_decode_images(params, TINY, jnp.asarray(latent),
                                            0.13025, dt)).astype(int)
                 for dt in (jnp.bfloat16, jnp.float32))
    got = decode_latent_to_images(model, torch.from_numpy(latent),
                                  compute_dtype=torch.bfloat16).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got - want).mean() <= 2
    assert np.abs(got - f32).max() <= np.abs(want - f32).max() + 1
    copy = latent_mod._CAST_DECODERS[model][torch.bfloat16]
    assert copy.post_quant_conv.weight.dtype == torch.bfloat16
    assert model.post_quant_conv.weight.dtype == torch.float32
    again = decode_latent_to_images(model, torch.from_numpy(latent),
                                    compute_dtype=torch.bfloat16).numpy()
    assert latent_mod._CAST_DECODERS[model][torch.bfloat16] is copy
    np.testing.assert_array_equal(again, got)
