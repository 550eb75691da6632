"""The whole slice: the port's txt2img against the JAX pipeline, f32 on CPU.

A tiny pipeline (CLIP towers of width 32, UNet model_channels 32, a small
VAE) with the same weights on both sides (drawn in the reference's tree
layout, carried across by io/bridge.py) runs 2 DDIM steps from the same
injected starting latent: the port's txt2img against the reference's
conditioning, sample_latent and decode_latent_to_images, the stages of its
txt2img. Final latent within 1e-3, uint8 images within one level. A
subprocess proves the port imports neither JAX nor the JAX package.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdxl_tpu.configs import CLIPConfig, EmbedderConfig
from sdxl_tpu.models.clip import init_clip
from sdxl_tpu.models.unet import fuse_unet_qkv, init_unet
from sdxl_tpu.models.vae import init_autoencoder
from sdxl_tpu.pipeline.latent import decode_latent_to_images as j_decode_images
from sdxl_tpu.pipeline.pipeline import SDXLPipeline as JPipeline
from sdxl_tpu.pipeline.sampler import sample_latent as j_sample_latent
from sdxl_tpu.pipeline.sampler import scaled_linear_alphas_cumprod
from sdxl_tpu.tokenizer import ClipTokenizer, OpenClipTokenizer
from sdxl_tpu_torch.io.bridge import (
    clip_state_dict,
    unet_state_dict,
    vae_decoder_state_dict,
)
from sdxl_tpu_torch.pipeline.latent import decode_latent_to_images
from sdxl_tpu_torch.pipeline.pipeline import random_pipeline
from tests.test_pipeline_e2e import TINY_DIFFUSER, TINY_VAE
from tests.test_torch_unet import random_tree
from tests.torch_parity import fast_reference_compiles  # noqa: F401

# One intra-op thread: the suite runs six workers on shared cores,
# where torch's default of a thread per core makes small ops spin.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_EMBEDDER = EmbedderConfig(
    clip_config=CLIPConfig(n_vocab=49408, n_state=32, embed_dim=32, n_head=4,
                           n_ctx=77, n_layer=2, quick_gelu=True),
    open_clip_config=CLIPConfig(n_vocab=49408, n_state=32, embed_dim=32,
                                n_head=4, n_ctx=77, n_layer=2,
                                quick_gelu=False),
)
PROMPTS = ["a (red:1.3) cat on a [wooden] table", "a photo of a dog"]
NEGATIVE = "blurry"
RES = (64, 64)


@pytest.fixture(scope="module")
def pipes():
    emb = {"clip": random_tree(init_clip, TINY_EMBEDDER.clip_config, seed=1),
           "open_clip": random_tree(init_clip, TINY_EMBEDDER.open_clip_config,
                                    seed=2)}
    unet = jax.tree.map(np.asarray, fuse_unet_qkv(random_tree(
        init_unet, TINY_DIFFUSER.unet_config(), jnp.float32, seed=3)))
    vae = random_tree(init_autoencoder, TINY_VAE, seed=4, scale=0.05)
    alphas = scaled_linear_alphas_cumprod()
    jpipe = JPipeline(
        embedder_cfg=TINY_EMBEDDER, embedder_params=emb,
        diffuser_cfg=TINY_DIFFUSER, unet_params=unet,
        alphas_cumprod=jnp.asarray(alphas), vae_cfg=TINY_VAE,
        vae_params=vae, clip_tokenizer=ClipTokenizer(None),
        open_clip_tokenizer=OpenClipTokenizer(None),
        compute_dtype=jnp.float32)
    tpipe = random_pipeline(device="cpu", embedder_cfg=TINY_EMBEDDER,
                            diffuser_cfg=TINY_DIFFUSER, vae_cfg=TINY_VAE,
                            unet_dtype=torch.float32)
    for k in ("clip", "open_clip"):
        tpipe.embedder[k].load_state_dict(clip_state_dict(emb[k]))
    tpipe.unet.load_state_dict(unet_state_dict(unet))
    tpipe.vae.load_state_dict(vae_decoder_state_dict(vae))
    return jpipe, tpipe


def test_txt2img_matches_reference(pipes):
    jpipe, tpipe = pipes
    noise = np.random.default_rng(5).standard_normal(
        (len(PROMPTS), RES[0] // 8, RES[1] // 8, 4)).astype(np.float32)

    cond = jpipe.conditioning(PROMPTS, RES, negative_prompt=NEGATIVE)
    want_latent = np.asarray(j_sample_latent(
        jpipe.unet_params, TINY_DIFFUSER, jpipe.alphas_cumprod, cond,
        jax.random.PRNGKey(0), 7.5, 2, jnp.float32,
        initial_noise=jnp.asarray(noise)))
    # what the reference's txt2img does with this latent: one compile of
    # the sampling loop, not a second one inside jpipe.txt2img
    want_images = j_decode_images(jpipe.vae_params, TINY_VAE,
                                  jnp.asarray(want_latent),
                                  jpipe.scale_factor)

    got_images = tpipe.txt2img(PROMPTS, RES, n_steps=2,
                               negative_prompt=NEGATIVE,
                               initial_latent=torch.from_numpy(noise))
    got_latent = tpipe.last_latent.numpy()
    assert got_latent.shape == want_latent.shape == noise.shape
    assert np.abs(want_latent - noise).max() > 0.1  # the steps did move it
    np.testing.assert_allclose(got_latent, want_latent, atol=1e-3, rtol=0)
    assert got_images.shape == (2, 64, 64, 3) and got_images.dtype == np.uint8
    assert got_images.std() > 0
    diff = np.abs(got_images.astype(int) - np.asarray(want_images).astype(int))
    assert diff.max() <= 1


def test_vae_dtype_bf16_decodes_through_the_bf16_copy(pipes):
    """SDXLPipeline.vae_dtype (f32 by default, as the reference's) sets
    the decode's dtype: with bf16 the images are decode_latent_to_images
    of the final latent with compute_dtype=bfloat16."""
    _, tpipe = pipes
    assert tpipe.vae_dtype == torch.float32
    noise = np.random.default_rng(6).standard_normal(
        (1, RES[0] // 8, RES[1] // 8, 4)).astype(np.float32)
    tpipe.vae_dtype = torch.bfloat16
    try:
        images = tpipe.txt2img(PROMPTS[1], RES, n_steps=1,
                               initial_latent=torch.from_numpy(noise))
    finally:
        tpipe.vae_dtype = torch.float32
    want = decode_latent_to_images(tpipe.vae, tpipe.last_latent,
                                   tpipe.scale_factor, torch.bfloat16)
    np.testing.assert_array_equal(images, want.numpy())


def test_unported_options_raise(pipes):
    """The options that still wait for module 16: device_output and
    per-image seed lists."""
    _, tpipe = pipes
    with pytest.raises(NotImplementedError, match="device_output"):
        tpipe.txt2img("a cat", RES, n_steps=2, device_output=True)
    with pytest.raises(NotImplementedError, match="seed lists"):
        tpipe.txt2img(["a cat", "a dog"], RES, n_steps=2, seed=[1, 2])


def test_port_never_imports_jax(tmp_path):
    """Every module of the port imports (pipeline/sd1.py too), and a tiny
    pipeline runs txt2img,
    txt2img with the refiner (DDIM, and a k-sampler on the karras
    schedule), a mask-image inpaint request (the VAE encoder, masks.py,
    the pin), a ControlNet request and an IP-Adapter request (the adapter
    and its vision tower written by the port's writers and read back),
    and a tiny SD 2.x v-prediction pipeline (pipeline/sd1.py) runs euler
    txt2img and DDIM img2img,
    with `import jax` and `import sdxl_tpu`
    made to fail: the port keeps its own configs and tokenizer. Nor does
    it import the packages the card lacks (safetensors, msgpack, PIL,
    ml_dtypes): it has its own readers."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import numpy as np
        BLOCKED = ("jax", "sdxl_tpu", "safetensors", "msgpack", "PIL",
                   "ml_dtypes")
        for name in BLOCKED:
            sys.modules[name] = None
        import torch
        import sdxl_tpu_torch
        for m in pkgutil.walk_packages(sdxl_tpu_torch.__path__,
                                       "sdxl_tpu_torch."):
            importlib.import_module(m.name)
        from sdxl_tpu_torch.configs import AutoencoderConfig, CLIPConfig, \\
            DiffuserConfig, EmbedderConfig
        from sdxl_tpu_torch.pipeline.pipeline import random_pipeline
        clip = CLIPConfig(n_vocab=49408, n_state=32, embed_dim=32, n_head=4,
                          n_ctx=77, n_layer=2)
        pipe = random_pipeline(
            device="cpu", embedder_cfg=EmbedderConfig(clip, clip),
            diffuser_cfg=DiffuserConfig(
                adm_in_channels=32 + 6 * 256, model_channels=32,
                num_head_channels=8, transformer_depths=(1, 1, 1),
                context_dim=64),
            vae_cfg=AutoencoderConfig(
                encoder_channels=((8, 8), (8, 8), (8, 8), (8, 8)),
                decoder_channels=((16, 16), (16, 16), (16, 8), (8, 8)),
                n_group=4),
            unet_dtype=torch.float32, with_encoder=True,
            refiner_cfg=DiffuserConfig(
                adm_in_channels=32 + 5 * 256, model_channels=32,
                channel_mults=(1, 2, 4, 4), num_head_channels=8,
                transformer_depths=(1, 1, 1, 1), context_dim=32,
                is_refiner=True))
        img = pipe.txt2img("a cat", (64, 64), n_steps=1)
        assert img.shape == (1, 64, 64, 3), img.shape
        img = pipe.txt2img("a cat", (64, 64), n_steps=2, use_refiner=True)
        assert img.shape == (1, 64, 64, 3), img.shape
        img = pipe.txt2img("a cat", (64, 64), n_steps=2, sampler="dpm2_a",
                           schedule="karras", use_refiner=True)
        assert img.shape == (1, 64, 64, 3), img.shape
        pipe.strict_resolutions = False
        mask = np.zeros((64, 64, 3), np.uint8)
        mask[8:40, 16:48] = 255
        img = pipe.inpaint("a cat", img, mask_image=mask, n_steps=2)
        assert img.shape == (1, 64, 64, 3), img.shape
        import os
        from sdxl_tpu_torch.io.ip_adapter import (
            save_clip_vision_dir, save_ip_adapter_file)
        from sdxl_tpu_torch.models.clip_vision import (
            CLIPVisionConfig, CLIPVisionModel)
        from sdxl_tpu_torch.models.controlnet import ControlNet
        from sdxl_tpu_torch.models.ip_adapter import (
            IPAdapter, IPAdapterConfig)
        from sdxl_tpu_torch.models.layers import init_reference_
        g = torch.Generator().manual_seed(0)
        ucfg = pipe.diffuser_cfg.unet_config()
        pipe.controlnet = init_reference_(
            ControlNet(ucfg, dtype=torch.float32), g).eval()
        img = pipe.txt2img("a cat", (64, 64), n_steps=2, control_image=img)
        assert img.shape == (1, 64, 64, 3), img.shape
        vcfg = CLIPVisionConfig(image_size=28, patch_size=14, n_state=32,
                                n_head=4, n_layer=2, embed_dim=16)
        tmp = sys.argv[1]  # the test's tmp_path
        save_clip_vision_dir(os.path.join(tmp, "enc"), init_reference_(
            CLIPVisionModel(vcfg), g))
        save_ip_adapter_file(os.path.join(tmp, "ip.safetensors"),
                             init_reference_(IPAdapter(IPAdapterConfig(
                                 clip_embed_dim=16, context_dim=64), ucfg),
                                 g))
        pipe.load_ip_adapter(os.path.join(tmp, "ip.safetensors"),
                             os.path.join(tmp, "enc"))
        img = pipe.txt2img("a cat", (64, 64), n_steps=2,
                           ip_adapter_image=img)
        assert img.shape == (1, 64, 64, 3), img.shape
        from sdxl_tpu_torch.pipeline.sd1 import random_sd1_pipeline
        sd2 = random_sd1_pipeline(
            device="cpu", clip_cfg=clip, diffuser_cfg=DiffuserConfig(
                adm_in_channels=0, model_channels=32,
                channel_mults=(1, 2, 4, 4), num_head_channels=8,
                transformer_depths=(1, 1, 1, 1), context_dim=32,
                transformer_levels=(0, 1, 2), prediction_type="v"),
            vae_cfg=AutoencoderConfig(
                encoder_channels=((8, 8), (8, 8), (8, 8), (8, 8)),
                decoder_channels=((16, 16), (16, 16), (16, 8), (8, 8)),
                n_group=4),
            unet_dtype=torch.float32, penultimate_hidden=True)
        img = sd2.txt2img("a cat", (64, 64), n_steps=2, sampler="euler")
        assert img.shape == (1, 64, 64, 3), img.shape
        img = sd2.img2img("a cat", img, strength=0.5, n_steps=2)
        assert img.shape == (1, 64, 64, 3), img.shape
        assert not any(k.split(".")[0] in BLOCKED
                       for k, v in sys.modules.items() if v is not None)
        print("NO_JAX_OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
