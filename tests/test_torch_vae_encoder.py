"""Port VAE encoder against sdxl_tpu/models/vae.py, f32 on CPU.

Weights drawn in the reference's tree layout cross over through
io/bridge.py. Latents within 2e-3, the reference's full-scale VAE-encode
bound (goldens/full_scale/report.json). The encoder's stride-2
downsamplers pad one row below and one column right only; the conv op is
also held against the reference's ((0, 1), (0, 1)) padding at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdxl_tpu.ops.conv as jconv
from sdxl_tpu.models.vae import ASYM, init_autoencoder
from sdxl_tpu.models.vae import encode_image as j_encode_image
from sdxl_tpu.pipeline.latent import encode_images_to_latent as j_encode_u8
from sdxl_tpu_torch.io.bridge import vae_encoder_state_dict
from sdxl_tpu_torch.models.vae import VAEEncoder, encode_image
from sdxl_tpu_torch.ops.conv import conv2d_pad_br
from sdxl_tpu_torch.pipeline.latent import encode_images_to_latent
from tests.test_torch_vae import TINY, random_tree

# One intra-op thread: the suite runs six workers on shared cores,
# where torch's default of a thread per core makes small ops spin.
torch.set_num_threads(1)


@pytest.mark.parametrize("hw", [(9, 8), (8, 8)])
def test_conv_pad_bottom_right(hw):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, *hw, 6)).astype(np.float32)
    w = rng.standard_normal((3, 3, 6, 10)).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    want = jconv.conv2d({"w": w, "b": b}, jnp.asarray(x), stride=2,
                        padding=ASYM)
    got = conv2d_pad_br(torch.from_numpy(x).permute(0, 3, 1, 2),
                        torch.from_numpy(w).permute(3, 2, 0, 1),
                        torch.from_numpy(b))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def models():
    params = random_tree(init_autoencoder, TINY, seed=11, scale=0.05)
    model = VAEEncoder(TINY)
    model.load_state_dict(vae_encoder_state_dict(params))
    return params, model


def test_encode_image_matches_reference(models):
    params, model = models
    x = np.random.default_rng(12).uniform(-1, 1, (2, 24, 20, 3)) \
        .astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: j_encode_image(p, TINY, x))(
        params, x))
    with torch.no_grad():
        got = encode_image(model, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 12, 10, 4)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_encode_images_to_latent_matches_reference(models):
    params, model = models
    imgs = np.random.default_rng(13).integers(0, 256, (1, 16, 16, 3),
                                              dtype=np.uint8)
    want = np.asarray(j_encode_u8(params, TINY, jnp.asarray(imgs)))
    got = encode_images_to_latent(model, torch.from_numpy(imgs)).numpy()
    assert got.shape == want.shape == (1, 8, 8, 4)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
