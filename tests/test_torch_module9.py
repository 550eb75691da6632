"""Module 9: the refiner, inpainting (4- and 9-channel UNets), img2img and
outpaint, their loading and their `sample` CLI flags, against sdxl_tpu at
tiny configs, f32 on the CPU.

One fixture holds a reference pipeline and a port pipeline with the same
weights, drawn in the reference's tree layout and carried across by
io/bridge.py: the CLIP towers of test_torch_pipeline.py, a two-level base
UNet (and a 9-channel copy of its plan), the reference tests' four-level
refiner (transformers at levels 1 and 2, bigG context) and a four-level
VAE with its encoder. Each request runs the reference pipeline's own
entry point (inpaint, txt2img, img2img, outpaint) and the port's with the
reference's draws injected: the initial noise, the per-step pin noise
(jax.random.split of the inpaint key, one _scan_normal each) and the
refiner's or img2img's re-noise, computed here from the seed as the
reference derives them. Final latents within 1e-3 and images within one
u8 level, as tests/test_torch_pipeline.py holds txt2img. Masks and PNG
decoding are held exactly; loading bitwise against the reference's
readers on files its writers made; the CLI against the in-memory port
pipeline, and its bad flag combinations against the reference CLI's
messages.
"""

import dataclasses
import functools
import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load
from safetensors.numpy import save_file as st_save

import sdxl_tpu.io.checkpoint as rck
import sdxl_tpu.io.diffusers_sdxl as j_dif
import sdxl_tpu.io.hf_sdxl as j_hf
import sdxl_tpu.io.params_builder as j_pb
import sdxl_tpu_torch.pipeline.pipeline as tpipeline
from sdxl_tpu.configs import (
    DiffuserConfig,
    EmbedderConfig,
    LatentDecoderConfig,
)
from sdxl_tpu.configs import load_cfg as j_load_cfg
from sdxl_tpu.configs import save_cfg as j_save_cfg
from sdxl_tpu.io.burn_mpk_write import (
    write_diffuser_mpk,
    write_embedder_mpk,
    write_latent_decoder_mpk,
)
from sdxl_tpu.io.hf_sdxl import load_sdxl_safetensors as j_load_sgm
from sdxl_tpu.io.npy_tree import write_scalar, write_shape_prefixed
from sdxl_tpu.models.unet import fuse_unet_qkv
from sdxl_tpu.pipeline.masks import build_latent_mask as j_build_latent_mask
from sdxl_tpu.pipeline.pipeline import SDXLPipeline as JPipeline
from sdxl_tpu.pipeline.sampler import _scan_normal, ddim_timesteps
from sdxl_tpu.pipeline.sampler import inpaint_pin as j_inpaint_pin
from sdxl_tpu.pipeline.sampler import scaled_linear_alphas_cumprod
from sdxl_tpu.tokenizer import ClipTokenizer, OpenClipTokenizer
from sdxl_tpu_torch.io.bridge import state_dict_to_flat, unet_state_dict
from sdxl_tpu_torch.io.checkpoint import save_native_pipeline
from sdxl_tpu_torch.io.images import load_images, read_png, save_images
from sdxl_tpu_torch.models.layers import init_reference_
from sdxl_tpu_torch.models.unet import UNet
from sdxl_tpu_torch.pipeline import loader
from sdxl_tpu_torch.pipeline.loader import load_pipeline
from sdxl_tpu_torch.pipeline.masks import build_latent_mask
from sdxl_tpu_torch.pipeline.pipeline import random_pipeline
from sdxl_tpu_torch.pipeline.sampler import inpaint_pin
from tests.test_io import write_clip_npy, write_unet_npy, write_vae_npy
from tests.test_pipeline_e2e import TINY_REFINER, TINY_VAE
import tests.test_torch_loader as loader_tests
from tests.test_torch_loader import _sgm_dict, assert_state_equal
from tests.test_torch_pipeline import TINY_EMBEDDER
from tests.test_hf_sdxl import make_ldm_unet_dict, make_ldm_vae_dict

# One intra-op thread: the suite runs six workers on shared cores.
torch.set_num_threads(1)

# a one-level base (transformers at level 0): the reference's sampling
# loops compile in about a third of the three-level TINY_DIFFUSER's time
TINY_BASE = DiffuserConfig(
    adm_in_channels=32 + 6 * 256, model_channels=32, channel_mults=(1,),
    num_head_channels=8, transformer_depths=(1,), context_dim=64,
    transformer_levels=(0,))
TINY_BASE9 = dataclasses.replace(TINY_BASE, in_channels=9)
RES = (64, 64)
PROMPT = "a (red:1.3) cat on a [wooden] table"
NEGATIVE = "blurry"
STEPS = 2
CROP = dict(crop_left=8, crop_right=40, crop_top=16, crop_bottom=48)


def fused(tree):
    return jax.tree.map(np.asarray, fuse_unet_qkv(tree))


def image(seed, shape=(1, *RES, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def mask_image(seed=9):
    """[64, 64, 3] u8 of 4x4-pixel blocks, a quarter of them above 127 in
    one channel: about two thirds of the 8x8 latent cells generated."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 128, (16, 16, 3))
    cells[rng.random((16, 16)) < 0.25, 1] += 128
    return np.kron(cells, np.ones((4, 4, 1))).astype(np.uint8)


def reference_tree(*modules):
    """The reference's parameter tree (numpy leaves, self-attention q/k/v
    apart) of port modules: io/bridge.py's state_dict_to_flat, unflattened
    as the reference's native reader does."""
    sd = {}
    for m in modules:
        sd.update(m.state_dict())
    return rck.unflatten_pytree(
        {k: v.numpy() for k, v in state_dict_to_flat(sd).items()})


@pytest.fixture(scope="module")
def trees():
    """The port pipeline (random_pipeline's draw, every bias and norm
    parameter then moved off 0 and 1) with its 9-channel UNet, and their
    weights as reference trees. Drawing in the port spares the reference
    inits' traces (about half a second each)."""
    tpipe = random_pipeline(device="cpu", embedder_cfg=TINY_EMBEDDER,
                            diffuser_cfg=TINY_BASE, vae_cfg=TINY_VAE,
                            unet_dtype=torch.float32, with_encoder=True,
                            refiner_cfg=TINY_REFINER)
    g = torch.Generator().manual_seed(10)
    unet9 = init_reference_(UNet(TINY_BASE9.unet_config(), "cpu",
                                 torch.float32), g)
    unet9.eval().requires_grad_(False)
    modules = [tpipe.embedder, tpipe.unet, tpipe.refiner, tpipe.vae,
               tpipe.vae_encoder, unet9]
    with torch.no_grad():
        for m in modules:
            for p in m.parameters():
                if p.dim() == 1:
                    p.add_(0.05 * torch.randn(p.shape, generator=g))
    base, refiner = reference_tree(tpipe.unet), reference_tree(tpipe.refiner)
    return dict(
        port=(tpipe, unet9),
        emb={k: reference_tree(tpipe.embedder[k])
             for k in ("clip", "open_clip")},
        base=fused(base), base_unfused=base,
        base9=fused(reference_tree(unet9)),
        refiner=fused(refiner), refiner_unfused=refiner,
        vae=reference_tree(tpipe.vae, tpipe.vae_encoder),
        alphas=scaled_linear_alphas_cumprod())


@pytest.fixture(scope="module")
def pipes(trees):
    """(reference, port) pipelines with the 4-channel base, and the same
    pair on the 9-channel base that shares the towers and the VAE."""
    alphas = jnp.asarray(trees["alphas"])
    jpipe = JPipeline(
        embedder_cfg=TINY_EMBEDDER, embedder_params=trees["emb"],
        diffuser_cfg=TINY_BASE, unet_params=trees["base"],
        alphas_cumprod=alphas, vae_cfg=TINY_VAE, vae_params=trees["vae"],
        refiner_cfg=TINY_REFINER, refiner_params=trees["refiner"],
        refiner_alphas=alphas, clip_tokenizer=ClipTokenizer(None),
        open_clip_tokenizer=OpenClipTokenizer(None),
        compute_dtype=jnp.float32, strict_resolutions=False)
    tpipe, unet9 = trees["port"]
    tpipe.strict_resolutions = False
    jpipe9 = dataclasses.replace(jpipe, diffuser_cfg=TINY_BASE9,
                                 unet_params=trees["base9"])
    tpipe9 = dataclasses.replace(tpipe, diffuser_cfg=TINY_BASE9, unet=unet9)
    return {4: (jpipe, tpipe), 9: (jpipe9, tpipe9)}


def reference_draws(seed, batch=1, steps=STEPS):
    """The reference txt2img's draws for an int seed: (initial noise, pin
    noise [T, B, h, w, 4] over the full grid, refiner re-noise)."""
    shape = (batch, RES[0] // 8, RES[1] // 8, 4)
    base_key, refiner_key = jax.random.split(jax.random.PRNGKey(seed))
    noise_key, inpaint_key = jax.random.split(base_key)
    keys = jax.random.split(inpaint_key, len(ddim_timesteps(0, steps)))
    return (np.asarray(jax.random.normal(noise_key, shape, jnp.float32)),
            np.stack([np.asarray(_scan_normal(k, shape)) for k in keys]),
            np.asarray(jax.random.normal(refiner_key, shape, jnp.float32)))


def inject(monkeypatch, initial=None, pin=None, renoise=None):
    """Make the port pipeline's samplers take the given draws in place of
    its generator's."""
    real_sample, real_refine = tpipeline.sample_latent, tpipeline.refine_latent

    def tensor(a):
        return None if a is None else torch.tensor(a)

    def sample(*args, **kw):
        kw["initial_noise"] = tensor(initial)
        kw["pin_noise"] = tensor(pin)
        return real_sample(*args, **kw)

    def refine(*args, **kw):
        return real_refine(*args, noise=tensor(renoise), **kw)

    monkeypatch.setattr(tpipeline, "sample_latent", sample)
    monkeypatch.setattr(tpipeline, "refine_latent", refine)


def run_reference(monkeypatch, jpipe, fn):
    """(images, final latent) of fn() on the reference pipeline."""
    seen = []
    real = jpipe._decode

    def decode(latent):
        seen.append(np.asarray(latent))
        return real(latent)

    monkeypatch.setattr(jpipe, "_decode", decode)
    images = np.asarray(fn())
    return images, seen[-1]


def assert_matches(got_images, got_latent, want_images, want_latent, start):
    assert got_latent.shape == want_latent.shape
    assert np.abs(want_latent - start).max() > 0.1  # the steps moved it
    np.testing.assert_allclose(got_latent, want_latent, atol=1e-3, rtol=0)
    assert got_images.shape == want_images.shape
    assert got_images.dtype == np.uint8 and got_images.std() > 0
    diff = np.abs(got_images.astype(int) - want_images.astype(int))
    assert diff.max() <= 1


# ---------------------------------------------------------------------------
# conditioning, masks, the pin
# ---------------------------------------------------------------------------

def test_refiner_channel_contexts_match_reference(pipes):
    """The refiner channel (pooled bigG ++ sinusoids of size, crop and
    aesthetic score 6) and its unconditional half within the CLIP bound,
    also when the unconditional half comes from uncond_cache."""
    jpipe, tpipe = pipes[4]
    prompts = [PROMPT]
    want = jpipe.conditioning(prompts, RES, negative_prompt=NEGATIVE)
    tpipe._uncond_cache.clear()
    first = tpipe.conditioning(prompts, RES, NEGATIVE)
    hit = tpipe.conditioning(prompts, RES, NEGATIVE)
    assert len(tpipe._uncond_cache) == 1
    assert (hit.unconditional_channel_context_refiner
            is first.unconditional_channel_context_refiner)
    for got in (first, hit):
        for name, shape in (("channel_context_refiner", (1, 32 + 5 * 256)),
                            ("unconditional_channel_context_refiner",
                             (1, 32 + 5 * 256))):
            g = getattr(got, name).numpy()
            assert g.shape == shape
            np.testing.assert_allclose(g, np.asarray(getattr(want, name)),
                                       atol=2e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(CROP),
    dict(CROP, crop_out=True),
    dict(mask_image=mask_image()),
    dict(mask_image=mask_image()[..., 1], mask_blur=3.0),
    dict(CROP, crop_out=True, mask_blur=2.0),
], ids=["crop_in", "crop_out", "mask_image", "mask_image_blur",
        "crop_out_blur"])
def test_build_latent_mask_matches_reference(kw):
    want = np.asarray(j_build_latent_mask(*RES, **kw))
    got = build_latent_mask(*RES, **kw)
    assert got.dtype == np.float32 and got.shape == (1, 8, 8, 1)
    assert 0 < got.mean() < 1
    np.testing.assert_array_equal(got, want)


def test_inpaint_pin_bool_equals_float():
    """A {0, 1} float mask pins bitwise as the bool mask does; a soft mask
    blends as the reference's."""
    rng = np.random.default_rng(3)
    lat, ref = (torch.from_numpy(rng.standard_normal((2, 8, 8, 4))
                                 .astype(np.float32)) for _ in range(2))
    hard = torch.from_numpy(rng.random((1, 8, 8, 4)) > 0.5)
    assert torch.equal(inpaint_pin(hard, lat, ref),
                       inpaint_pin(hard.float(), lat, ref))
    assert torch.equal(inpaint_pin(hard, lat, ref), torch.where(hard, lat, ref))
    soft = rng.random((1, 8, 8, 4)).astype(np.float32)
    want = j_inpaint_pin(jnp.asarray(soft), jnp.asarray(lat.numpy()),
                         jnp.asarray(ref.numpy()))
    np.testing.assert_allclose(
        inpaint_pin(torch.from_numpy(soft), lat, ref).numpy(),
        np.asarray(want), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the requests, against the reference pipeline's own entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [4, 9])
def test_inpaint_matches_reference(channels, pipes, monkeypatch):
    """Crop-window inpainting: on the 4-channel base the per-step pin with
    the reference's pin noise, on the 9-channel base the [mask, masked
    latent] input channels."""
    jpipe, tpipe = pipes[channels]
    ref = image(11)
    initial, pin, _ = reference_draws(4)
    kw = dict(n_steps=STEPS, seed=4, negative_prompt=NEGATIVE, **CROP)
    want_images, want_latent = run_reference(
        monkeypatch, jpipe, lambda: jpipe.inpaint(PROMPT, ref, **kw))
    inject(monkeypatch, initial, pin if channels == 4 else None)
    got = tpipe.inpaint(PROMPT, ref, **kw)
    assert_matches(got, tpipe.last_latent.numpy(), want_images, want_latent,
                   initial)
    tpipe.strict_resolutions = True
    try:
        with pytest.raises(ValueError, match="incompatible"):
            tpipe.inpaint(PROMPT, ref, **kw)
    finally:
        tpipe.strict_resolutions = False


def test_inpaint_then_refiner_matches_reference(pipes, monkeypatch):
    """A mask image, then the refiner stage: re-noise at t=200 with the
    reference's refiner draw, the 1-entry tail from t=199."""
    jpipe, tpipe = pipes[4]
    ref = image(12)
    initial, pin, renoise = reference_draws(5)
    kw = dict(n_steps=STEPS, seed=5, negative_prompt=NEGATIVE,
              mask_image=mask_image(), use_refiner=True)
    want_images, want_latent = run_reference(
        monkeypatch, jpipe, lambda: jpipe.inpaint(PROMPT, ref, **kw))
    inject(monkeypatch, initial, pin, renoise)
    got = tpipe.inpaint(PROMPT, ref, **kw)
    assert_matches(got, tpipe.last_latent.numpy(), want_images, want_latent,
                   initial)


def test_expert_split_matches_reference(pipes, monkeypatch, trees):
    """denoising_end=0.5 on a 4-step grid: the base runs t=999 and 749, the
    second stage continues 499 and 249 from the still-noisy handoff with
    no re-noise. The base UNet stands in for the refiner in that stage:
    the split is the same, and a second compile of the reference's
    refiner loop would double the test's time (the refiner's own call is
    held by test_inpaint_then_refiner_matches_reference)."""
    jpipe, tpipe = pipes[4]
    jpipe = dataclasses.replace(jpipe, refiner_cfg=TINY_BASE,
                                refiner_params=trees["base"])
    tpipe = dataclasses.replace(tpipe, refiner_cfg=TINY_BASE,
                                refiner=tpipe.unet)
    initial, _, _ = reference_draws(6, steps=4)
    kw = dict(resolution=RES, n_steps=4, seed=6, negative_prompt=NEGATIVE,
              use_refiner=True, denoising_end=0.5)
    want_images, want_latent = run_reference(
        monkeypatch, jpipe, lambda: jpipe.txt2img(PROMPT, **kw))
    inject(monkeypatch, initial)
    got = tpipe.txt2img(PROMPT, **kw)
    assert_matches(got, tpipe.last_latent.numpy(), want_images, want_latent,
                   initial)
    with pytest.raises(ValueError, match="requires use_refiner"):
        tpipe.txt2img(PROMPT, RES, n_steps=4, denoising_end=0.5)


def test_img2img_matches_reference(pipes, monkeypatch):
    """Strength 0.3: re-noise at t=300, the 10-entry tail from t=299 on a
    30-step grid, with the reference's re-noise draw."""
    jpipe, tpipe = pipes[4]
    ref = image(13)
    renoise = np.asarray(jax.random.normal(
        jax.random.PRNGKey(7), (1, 8, 8, 4), jnp.float32))
    kw = dict(strength=0.3, n_steps=30, seed=7, negative_prompt=NEGATIVE)
    want_images, want_latent = run_reference(
        monkeypatch, jpipe, lambda: jpipe.img2img(PROMPT, ref, **kw))
    inject(monkeypatch, renoise=renoise)
    got = tpipe.img2img(PROMPT, ref, **kw)
    start = tpipe._encode(ref).numpy()
    assert_matches(got, tpipe.last_latent.numpy(), want_images, want_latent,
                   start)


@pytest.mark.parametrize("fill", ["edge", "noise"])
def test_outpaint_matches_reference(fill, pipes, monkeypatch):
    """A 64x48 image padded 8 left and 8 right: the canvas the reference
    builds (edge replication, or default_rng(seed) noise) bitwise, then
    its latents and images."""
    jpipe, tpipe = pipes[4]
    ref = image(14, (1, 64, 48, 3))
    initial, pin, _ = reference_draws(8)
    kw = dict(pad=(8, 8, 0, 0), fill=fill, n_steps=STEPS, seed=8,
              negative_prompt=NEGATIVE)
    canvases = []

    def canvas_of(pipe):
        real = pipe.inpaint

        def inpaint(prompts, canvas, **k):
            canvases.append(np.array(canvas))
            return real(prompts, canvas, **k)
        monkeypatch.setattr(pipe, "inpaint", inpaint)

    canvas_of(jpipe)
    canvas_of(tpipe)
    want_images, want_latent = run_reference(
        monkeypatch, jpipe, lambda: jpipe.outpaint(PROMPT, ref, **kw))
    inject(monkeypatch, initial, pin)
    got = tpipe.outpaint(PROMPT, ref, **kw)
    assert canvases[0].shape == (1, 64, 64, 3)
    np.testing.assert_array_equal(canvases[1], canvases[0])
    np.testing.assert_array_equal(canvases[1][:, :, 8:56], ref)
    assert_matches(got, tpipe.last_latent.numpy(), want_images, want_latent,
                   initial)


# ---------------------------------------------------------------------------
# PNG decoding
# ---------------------------------------------------------------------------

def _png(path, rows: np.ndarray, color: int, filters, bpp: int):
    """A PNG of 8-bit samples [H, W*bpp] with the given row filters,
    encoded here (the encoder side of each filter)."""
    h, stride = rows.shape
    r = rows.astype(np.int64)
    out = bytearray()
    for y in range(h):
        f = filters[y % len(filters)]
        up = r[y - 1] if y else np.zeros(stride, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), r[y, :-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if f == 0:
            pred = np.zeros(stride, np.int64)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out += bytes([f]) + ((r[y] - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    w = stride // bpp
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(out)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "P4", "LA", "RGBA", "1",
                                  "filters_rgb", "filters_la"])
def test_load_images_matches_pil(mode, tmp_path):
    """load_images against PIL's convert("RGB"): PIL-written files of each
    colour type (a 16-colour palette at 4 bits), and hand-built files
    whose rows cycle through the filters 0-4 (Paeth included)."""
    from PIL import Image

    rng = np.random.default_rng(21)
    path = str(tmp_path / "img.png")
    if mode.startswith("filters"):
        bpp = 3 if mode == "filters_rgb" else 2
        rows = rng.integers(0, 256, (13, 11 * bpp), np.uint8)
        rows[:, :bpp] = rows[:, bpp:2 * bpp] // 2  # smooth runs too
        _png(path, rows, 2 if bpp == 3 else 4, [0, 1, 2, 3, 4, 4, 3], bpp)
    elif mode in ("P", "P4"):
        n = 256 if mode == "P" else 16
        im = Image.fromarray(rng.integers(0, n, (17, 23), np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 3 * n).tolist())
        im.save(path)
    elif mode == "1":
        Image.fromarray(rng.random((17, 23)) > 0.5).save(path)
    else:
        c = {"L": 1, "RGB": 3, "LA": 2, "RGBA": 4}[mode]
        a = rng.integers(0, 256, (17, 23, c), np.uint8)
        Image.fromarray(a[..., 0] if c == 1 else a, mode).save(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    got = load_images([path, path])
    assert got.dtype == np.uint8 and got.shape == (2, *want.shape)
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], want)


def test_read_png_refuses_16_bit_and_interlaced(tmp_path):
    from PIL import Image

    deep = str(tmp_path / "deep.png")
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(deep)
    with pytest.raises(ValueError, match="deep.png: bit depth 16"):
        read_png(deep)
    laced = tmp_path / "laced.png"
    data = bytearray(open(save_images(image(1, (1, 8, 8, 3)),
                                      str(tmp_path / "x"))[0], "rb").read())
    data[28] = 1  # IHDR's interlace byte (the CRC is not checked)
    laced.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="laced.png: an interlaced PNG"):
        read_png(str(laced))
    pixels, text = read_png(save_images(image(2, (1, 8, 8, 3)),
                                        str(tmp_path / "t"),
                                        {"parameters": "a crab é",
                                         "note": "a crab — é"})[0])
    np.testing.assert_array_equal(pixels, image(2, (1, 8, 8, 3))[0])
    assert text == {"parameters": "a crab é", "note": "a crab — é"}


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

REFINER_LAYOUTS = ["native", "mpk", "npy", "sgm"]
# the layouts' towers: the fixture's cut to one block and a 64-token
# vocabulary, which keeps the files small (full towers load in
# tests/test_torch_loader.py)
LAYOUT_EMBEDDER = EmbedderConfig(
    clip_config=dataclasses.replace(TINY_EMBEDDER.clip_config, n_vocab=64,
                                    n_layer=1),
    open_clip_config=dataclasses.replace(TINY_EMBEDDER.open_clip_config,
                                         n_vocab=64, n_layer=1))


@pytest.fixture(scope="module")
def refiner_layouts(trees, tmp_path_factory):
    """{layout: dir} of the tiny base with the tiny refiner, each written
    by the reference's own writers."""
    vae, alphas = trees["vae"], trees["alphas"]
    # the towers cut to one block and 64 tokens
    emb = {k: dict(t, token_embedding=t["token_embedding"][:64],
                   blocks=t["blocks"][:1])
           for k, t in trees["emb"].items()}
    base, refiner = trees["base_unfused"], trees["refiner_unfused"]
    # no "refiner" in the directory's name: the sgm loader tells the base
    # file from the refiner's by that word in the path
    root = tmp_path_factory.mktemp("layouts")
    out = {name: str(root / name) for name in REFINER_LAYOUTS}
    for d in out.values():
        os.makedirs(d)
    ralphas = jnp.asarray(alphas)
    rck.save_native_pipeline(out["native"], JPipeline(
        embedder_cfg=LAYOUT_EMBEDDER, embedder_params=emb,
        diffuser_cfg=TINY_BASE, unet_params=base, alphas_cumprod=ralphas,
        vae_cfg=TINY_VAE, vae_params=vae, refiner_cfg=TINY_REFINER,
        refiner_params=refiner, refiner_alphas=ralphas,
        clip_tokenizer=ClipTokenizer(None),
        open_clip_tokenizer=OpenClipTokenizer(None)))

    d = out["mpk"]
    write_embedder_mpk(os.path.join(d, "embedder.mpk"), emb)
    write_diffuser_mpk(os.path.join(d, "diffuser.mpk"),
                       TINY_BASE.unet_config(), base, alphas)
    # the refiner's own table differs from the base's: its file's must load
    write_diffuser_mpk(os.path.join(d, "refiner.mpk"),
                       TINY_REFINER.unet_config(), refiner,
                       (alphas ** 1.01).astype(np.float32))
    write_latent_decoder_mpk(os.path.join(d, "latent_decoder.mpk"), vae)
    for name, cfg in (("embedder", LAYOUT_EMBEDDER),
                      ("diffuser", TINY_BASE),
                      ("refiner", TINY_REFINER),
                      ("latent_decoder", LatentDecoderConfig())):
        j_save_cfg(os.path.join(d, f"{name}.cfg"), cfg)

    d = out["npy"]
    for k in ("clip", "open_clip"):
        write_clip_npy(os.path.join(d, "embedder", k), emb[k])
    write_unet_npy(os.path.join(d, "diffuser", "diffuser_base"),
                   TINY_BASE.unet_config(), base)
    write_unet_npy(os.path.join(d, "diffuser", "diffuser_refiner"),
                   TINY_REFINER.unet_config(), refiner)
    write_shape_prefixed(os.path.join(d, "diffuser", "alphas_cumprod.npy"),
                         alphas)
    write_vae_npy(os.path.join(d, "latent_decoder", "autoencoder"), vae)
    write_scalar(os.path.join(d, "latent_decoder", "scale_factor.npy"),
                 0.13025)

    d = out["sgm"]
    saved = loader_tests.TINY_DIFFUSER
    loader_tests.TINY_DIFFUSER = TINY_BASE  # the UNet plan _sgm_dict writes
    try:
        flat = _sgm_dict(emb, base, vae)
    finally:
        loader_tests.TINY_DIFFUSER = saved
    st_save({k: v.astype(np.float16) for k, v in flat.items()},
            os.path.join(d, "sd_xl_base_1.0.safetensors"))
    # the refiner file carries its UNet and the VAE (and no ViT-L tower)
    flat = make_ldm_unet_dict(TINY_REFINER.unet_config(), refiner)
    flat.update(make_ldm_vae_dict(vae))
    st_save({k: np.asarray(v, np.float16) for k, v in flat.items()},
            os.path.join(d, "sd_xl_refiner_1.0.safetensors"))
    return out


def reference_refiner(layout, path):
    """(refiner cfg, refiner tree cast to bf16, refiner alphas) through
    the reference's own readers."""
    f32, alphas = jnp.float32, scaled_linear_alphas_cumprod()
    if layout == "native":
        cfg = j_load_cfg(os.path.join(path, "refiner.cfg"), DiffuserConfig)
        tree = rck.load_native(os.path.join(path, "refiner.safetensors"))
    elif layout == "mpk":
        cfg, tree, alphas = rck.load_diffuser_mpk(path, "refiner", f32)
    elif layout == "npy":
        cfg = TINY_REFINER
        tree, alphas = rck.load_diffuser_npy(path, cfg, True, f32)
    else:
        cfg = TINY_REFINER
        _, tree, _ = j_load_sgm(
            os.path.join(path, "sd_xl_refiner_1.0.safetensors"), cfg, None,
            f32)
    tree = jax.tree.map(lambda a: np.asarray(a).astype(ml_dtypes.bfloat16),
                        tree)
    return cfg, tree, np.asarray(alphas)


@pytest.fixture
def tiny_presets(monkeypatch):
    """npy and sgm files carry no configs: the loaders assume SDXL 1.0's,
    here the tiny models'; the reference readers cast on the host."""
    monkeypatch.setattr(loader, "SDXL_EMBEDDER", LAYOUT_EMBEDDER)
    monkeypatch.setattr(loader, "SDXL_BASE_DIFFUSER", TINY_BASE)
    monkeypatch.setattr(loader, "SDXL_REFINER_DIFFUSER", TINY_REFINER)
    monkeypatch.setattr(loader, "SDXL_VAE", TINY_VAE)
    cast = functools.partial(j_hf._as, host=True)
    for mod in (j_hf, j_dif, j_pb):
        monkeypatch.setattr(mod, "_as", cast)


@pytest.mark.parametrize("layout", REFINER_LAYOUTS)
def test_refiner_loads_bitwise(layout, refiner_layouts, tiny_presets):
    path = refiner_layouts[layout]
    cfg, tree, alphas = reference_refiner(layout, path)
    pipe = load_pipeline(path, use_refiner=True, device="cpu")
    assert dataclasses.asdict(pipe.refiner_cfg) == dataclasses.asdict(cfg)
    assert pipe.refiner_cfg.is_refiner
    assert_state_equal(pipe.refiner, unet_state_dict(tree))
    np.testing.assert_array_equal(pipe.refiner_alphas.numpy(), alphas)
    assert pipe.refiner_alphas.dtype == torch.float32


def test_refiner_load_errors(refiner_layouts, tmp_path):
    """Without use_refiner no refiner loads; asked for with no refiner
    files: FileNotFoundError, as the reference; a diffusers dir: the
    reference's ValueError."""
    src = refiner_layouts["native"]
    assert load_pipeline(src, device="cpu").refiner is None
    for f in os.listdir(src):
        if not f.startswith("refiner"):
            os.symlink(os.path.join(src, f), tmp_path / f)
    with pytest.raises(FileNotFoundError):
        load_pipeline(str(tmp_path), use_refiner=True, device="cpu")
    dif = tmp_path / "dif"
    (dif / "unet").mkdir(parents=True)
    (dif / "model_index.json").write_text("{}")
    with pytest.raises(ValueError, match="separate diffusers repo"):
        load_pipeline(str(dif), use_refiner=True, device="cpu")


def test_native_writer_writes_the_refiner(refiner_layouts, tmp_path):
    """The port's save_native_pipeline of a pipeline loaded (f32) from the
    reference-written dir gives the reference's files, refiner.safetensors
    and refiner.cfg included: keys, dtypes, shapes and bytes."""
    ref = refiner_layouts["native"]
    pipe = load_pipeline(ref, use_refiner=True, compute_dtype=torch.float32,
                         device="cpu")
    out = str(tmp_path / "port")
    save_native_pipeline(out, pipe)
    assert sorted(os.listdir(out)) == sorted(os.listdir(ref))
    assert "refiner.safetensors" in os.listdir(out)
    for f in sorted(os.listdir(ref)):
        if f.endswith(".cfg"):
            assert json.load(open(os.path.join(out, f))) == json.load(
                open(os.path.join(ref, f))), f
            continue
        got, want = (st_load(os.path.join(d, f)) for d in (out, ref))
        assert sorted(got) == sorted(want), f
        for k, w in want.items():
            assert (got[k].dtype, got[k].shape) == (w.dtype, w.shape)
            np.testing.assert_array_equal(got[k].view(np.uint8),
                                          w.view(np.uint8), err_msg=k)


# ---------------------------------------------------------------------------
# the sample CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_files(pipes, tmp_path_factory):
    """The port pipeline (base, refiner, VAE with its encoder) as a native
    checkpoint, a reference PNG of 64x64 and one of 64x48, and a mask PNG,
    each written by the port."""
    _, tpipe = pipes[4]
    root = tmp_path_factory.mktemp("cli")
    ckpt = save_native_pipeline(str(root / "ckpt"), tpipe)
    ref = save_images(image(15), str(root / "ref"))[0]
    narrow = save_images(image(16, (1, 64, 48, 3)), str(root / "narrow"))[0]
    mask = save_images(mask_image()[None], str(root / "mask"))[0]
    return dict(ckpt=ckpt, ref=ref, narrow=narrow, mask=mask)


CLI_CASES = {
    "refiner": (["--use-refiner"],
                lambda p, f, kw: p.txt2img(resolution=RES, use_refiner=True,
                                           **kw)),
    "denoising_end": (
        ["--use-refiner", "--denoising-end", "0.5"],
        lambda p, f, kw: p.txt2img(resolution=RES, use_refiner=True,
                                   denoising_end=0.5, **kw)),
    "crop_out_refiner": (
        ["--reference-img", "{ref}", "--crop-left", "8", "--crop-right",
         "40", "--crop-top", "16", "--crop-bottom", "48", "--crop-out",
         "--use-refiner"],
        lambda p, f, kw: p.inpaint(reference_images=load_images([f["ref"]]),
                                   crop_out=True, use_refiner=True, **CROP,
                                   **kw)),
    "mask": (["--reference-img", "{ref}", "--mask-img", "{mask}",
              "--mask-blur", "2"],
             lambda p, f, kw: p.inpaint(reference_images=load_images(
                 [f["ref"]]), mask_image=mask_image(), mask_blur=2.0, **kw)),
    "img2img": (["--reference-img", "{ref}", "--img2img-strength", "0.5"],
                lambda p, f, kw: p.img2img(reference_images=np.repeat(
                    load_images([f["ref"]]), 2, axis=0), strength=0.5, **kw)),
    "outpaint": (["--reference-img", "{narrow}", "--outpaint", "8,8,0,0",
                  "--outpaint-fill", "noise"],
                 lambda p, f, kw: p.outpaint(
                     reference_images=load_images([f["narrow"]]),
                     pad=(8, 8, 0, 0), fill="noise", **kw)),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_module9_flags_match_the_in_memory_pipeline(case, pipes,
                                                         cli_files, tmp_path):
    """main(..., device="cpu") on the port-written checkpoint writes, pixel
    for pixel, what the in-memory port pipeline returns for the same
    request (the same weights and the same seeded draws)."""
    from sdxl_tpu_torch.cli.sample import main

    _, tpipe = pipes[4]
    flags, call = CLI_CASES[case]
    out = str(tmp_path / "img")
    prompts = [PROMPT, "a photo of a dog"]
    argv = ["--model-dir", cli_files["ckpt"], "--f32",
            "--no-strict-resolution", "--prompt", prompts[0], "--prompt",
            prompts[1], "--height", "64", "--width", "64", "-steps",
            str(STEPS), "--seed", "3", "--negative-prompt", NEGATIVE,
            "--output-dir", out, *(a.format(**cli_files) for a in flags)]
    assert main(argv, device="cpu") == 0
    got = load_images([f"{out}{i}.png" for i in range(2)])
    want = call(tpipe, cli_files, dict(prompts=prompts, n_steps=STEPS,
                                       seed=3, negative_prompt=NEGATIVE))
    np.testing.assert_array_equal(got, want)


CLI_ERRORS = [
    ["--denoising-end", "0.8"],
    ["--use-refiner", "--denoising-end", "0.8", "--reference-img", "{ref}"],
    ["--outpaint", "8,8,0,0"],
    ["--reference-img", "{ref}", "--outpaint", "8,8,0,0",
     "--img2img-strength", "0.5"],
    ["--mask-img", "{mask}"],
    ["--reference-img", "{ref}", "--mask-blur", "2", "--img2img-strength",
     "0.5"],
    ["--reference-img", "{ref}", "--outpaint", "8,8"],
]


@pytest.mark.parametrize("flags", CLI_ERRORS,
                         ids=["denoising_end_alone", "denoising_end_inpaint",
                              "outpaint_alone", "outpaint_img2img",
                              "mask_alone", "mask_blur_img2img",
                              "outpaint_spec"])
def test_cli_bad_combinations_exit_1_as_the_reference(flags, cli_files,
                                                      capsys, monkeypatch,
                                                      tmp_path):
    import sdxl_tpu.cli.sample as j_cli
    import sdxl_tpu.pipeline.loader as j_loader
    from sdxl_tpu_torch.cli.sample import main

    class Stub:  # the reference CLI's pipeline, never sampled from
        pass

    monkeypatch.setattr(j_loader, "load_pipeline", lambda *a, **k: Stub())
    argv = ["--model-dir", cli_files["ckpt"], "--f32", "--prompt", "a cat",
            "--output-dir", str(tmp_path / "x"),
            *(a.format(**cli_files) for a in flags)]

    def error_line(rc):
        assert rc == 1
        lines = [ln for ln in capsys.readouterr().err.splitlines()
                 if ln.startswith("error:")]
        assert len(lines) == 1
        return lines[0]

    want = error_line(j_cli.main(argv))
    assert error_line(main(argv, device="cpu")) == want
    assert not os.path.exists(tmp_path / "x0.png")
