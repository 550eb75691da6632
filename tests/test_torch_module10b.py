"""Module 10b (LCM, step previews, DDIM inversion) and module 11's
weight-free UNet extensions (FreeU, PAG, DeepCache), against sdxl_tpu on
the CPU.

- LCM's guidance embedding, timestep grid, boundary scalings and loop
  against goldens/k_samplers/lcm_goldens.npz (a literal torch
  transcription of diffusers' LCMScheduler) at tests/test_lcm.py's
  tolerances, the loop driven with that file's synthetic model.
- The UNet's new forward variants (the LCM ``t_add``, PAG's identity
  self-attention, FreeU, DeepCache's cached and shallow calls at every
  branch of a two-level UNet) against the reference's functions, run
  eagerly, on weights the bridge carries across: 1e-3 absolute in f32,
  the reference's UNet bound (goldens/full_scale) being 2e-3.
- Loading an LCM-distilled UNet written by the reference's native writer,
  bitwise; a config that disagrees with the file fails the strict load.
- Port-only identities: previews leave the final latent bit-equal, and
  DeepCache at interval 1 is the plain loop bit for bit; DDIM inversion
  is exact for a constant eps field (tests/test_inversion.py's identity).
- Five requests through the reference pipeline's entry points and the
  port's with the reference's draws injected: final latents within 1e-3
  of max(1, |latent|) and images within one u8 level
  (tests/test_torch_module9.py's bounds).
- The CLI's new flags against the in-memory pipeline, their bad
  combinations against the reference CLI's messages.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdxl_tpu.io.checkpoint as rck
import sdxl_tpu.models.unet as JU
import sdxl_tpu.pipeline.sampler as R
import sdxl_tpu_torch.pipeline.pipeline as tpipeline
import sdxl_tpu_torch.pipeline.sampler as S
from sdxl_tpu.configs import UNetConfig
from sdxl_tpu.ops.embeddings import guidance_scale_embedding as j_gse
from sdxl_tpu.ops.linear import linear_nobias as j_linear_nobias
from sdxl_tpu.pipeline.pipeline import SDXLPipeline as JPipeline
from sdxl_tpu.tokenizer import ClipTokenizer, OpenClipTokenizer
from sdxl_tpu_torch.io.bridge import unet_state_dict
from sdxl_tpu_torch.io.checkpoint import save_native_pipeline
from sdxl_tpu_torch.io.images import load_images, save_images
from sdxl_tpu_torch.models import unet as TU
from sdxl_tpu_torch.ops.embeddings import guidance_scale_embedding
from sdxl_tpu_torch.pipeline.k_samplers import scaled_linear_alphas_cumprod
from sdxl_tpu_torch.pipeline.loader import load_pipeline
from sdxl_tpu_torch.pipeline.pipeline import random_pipeline
from tests.test_pipeline_e2e import TINY_VAE
from tests.test_torch_module10 import (
    BASE,
    REFINER,
    SHAPE,
    assert_matches,
    normal,
)
from tests.test_torch_module9 import (
    CROP,
    NEGATIVE,
    PROMPT,
    RES,
    fused,
    image,
    reference_tree,
    run_reference,
)
from tests.test_torch_pipeline import TINY_EMBEDDER
from tests.test_torch_unet import random_tree
from tests.torch_parity import fast_reference_compiles  # noqa: F401

# One intra-op thread: the suite runs six workers on shared cores.
torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens", "k_samplers", "lcm_goldens.npz")
# the distilled base: BASE with a 16-wide guidance embedding
LCM_BASE = dataclasses.replace(BASE, time_cond_proj_dim=16)
# two levels (six output blocks: DeepCache branches 1-5; FreeU's two
# deepest levels are all of them), a transformer at level 1 and a
# cond_proj
TINY2 = UNetConfig(adm_in_channels=32 + 6 * 256, model_channels=32,
                   channel_mults=(1, 2), n_head_channels=8,
                   transformer_depths=(1, 1), context_dim=64,
                   transformer_levels=(1,), time_cond_proj_dim=16)
FREEU = (1.3, 1.4, 0.9, 0.2)


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDENS)


# ---------------------------------------------------------------------------
# LCM against the goldens
# ---------------------------------------------------------------------------

def test_guidance_scale_embedding_matches_golden(g):
    """atol 1e-3, tests/test_lcm.py's: the phase reaches w * 1000 ~ 6.5e3,
    where one f32 ulp is ~8e-4 rad, so two libms differ there."""
    got = guidance_scale_embedding(torch.tensor([6.5, 0.0, -1.0]), 256)
    np.testing.assert_allclose(got.numpy(), g["w_emb"], rtol=1e-5, atol=1e-3)
    odd = guidance_scale_embedding(4.0, 9)
    np.testing.assert_allclose(odd.numpy(), g["w_emb_odd"], rtol=1e-5,
                               atol=1e-3)
    assert odd.shape == (1, 9) and float(odd[0, -1]) == 0.0


def test_lcm_timesteps_match_golden(g):
    np.testing.assert_array_equal(S.lcm_timesteps(4), g["ts4"])
    np.testing.assert_array_equal(S.lcm_timesteps(8), g["ts8"])
    np.testing.assert_array_equal(S.lcm_timesteps(6, strength=0.5),
                                  g["ts6_s05"])
    np.testing.assert_array_equal(S.lcm_timesteps(4, original_steps=25),
                                  g["ts4_o25"])
    np.testing.assert_array_equal(S.lcm_timesteps(4), [999, 759, 499, 259])
    for n, kw in ((60, {}), (30, dict(strength=0.5))):
        with pytest.raises(ValueError, match="exceeds the trained grid"):
            S.lcm_timesteps(n, **kw)


def synth_model(x, t):
    """scripts/gen_lcm_goldens.py's synth_model, in torch."""
    return torch.sin(x * 1.7) * 0.8 + 0.1 * x * t / 1000.0


def test_lcm_loop_matches_transcription(g, monkeypatch):
    """lcm_step_update's scalings and the sequential trajectory (every
    denoised estimate too), then the port's lcm_diffuse_latent itself with
    the synthetic model in place of the guided UNet call, against the
    golden's final latent: rtol 2e-5, atol 1e-6 (tests/test_lcm.py)."""
    for t, cs, co in zip(g["t_grid"], g["c_skip"], g["c_out"]):
        _, den = S.lcm_step_update(torch.ones(()), torch.zeros(()),
                                   torch.tensor(0.7), torch.tensor(0.5),
                                   float(t), torch.zeros(()), False)
        np.testing.assert_allclose(float(den), co / np.sqrt(0.7) + cs,
                                   rtol=1e-6)
    alphas = torch.tensor(scaled_linear_alphas_cumprod())
    ts, noises = g["ts4"], torch.tensor(g["noises"])
    x = torch.tensor(g["x0"])
    traj, dens = [x.numpy()], []
    for i, t in enumerate(ts):
        prev = int(ts[i + 1]) if i + 1 < len(ts) else int(t)
        x, den = S.lcm_step_update(x, synth_model(x, float(t)),
                                   alphas[int(t)], alphas[prev], float(t),
                                   noises[i], i == len(ts) - 1)
        traj.append(x.numpy())
        dens.append(den.numpy())
    tol = dict(rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.stack(traj), g["traj"], **tol)
    np.testing.assert_allclose(np.stack(dens), g["denoised_traj"], **tol)

    monkeypatch.setattr(S, "_guided_setup", lambda *a: (None,) * 4)
    monkeypatch.setattr(S, "lcm_guidance_add", lambda *a: None)
    monkeypatch.setattr(S, "_cfg_eps", lambda unet, cfg, lat, t, *a, **k:
                        synth_model(lat, t.float()))
    out = S.lcm_diffuse_latent(None, BASE, alphas, torch.tensor(g["x0"]),
                               None, 8.0, n_steps=4, step_noise=noises)
    np.testing.assert_allclose(out.numpy(), g["final"], **tol)


# ---------------------------------------------------------------------------
# the UNet's forward variants against the reference's, eagerly
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unets():
    """(reference tree, port UNet, inputs) of TINY2, f32."""
    tree = random_tree(JU.init_unet, TINY2, jnp.float32, seed=5)
    assert "cond_proj" in tree["time_embed"]
    model = TU.UNet(TINY2, dtype=torch.float32)
    model.load_state_dict(unet_state_dict(jax.tree.map(np.asarray, tree)))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 64)).astype(np.float32)
    label = rng.standard_normal((2, TINY2.adm_in_channels)).astype(np.float32)
    ts = np.array([999, 500], np.int32)
    return tree, model, (x, ts, ctx, label)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol=1e-3):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got), want, atol=tol, rtol=0)


def test_lcm_t_add_and_unet_match_reference(unets):
    """The guidance embedding through cond_proj (once a request), then the
    distilled UNet's eps with it, f32; and _unet_embed in bf16, where the
    addend joins the sinusoid after its cast (2e-2 of max(1, |emb|), the
    bf16 bound of bench.py:53-66)."""
    tree, model, inputs = unets
    cfg = dataclasses.replace(LCM_BASE, **{
        k: getattr(TINY2, k) for k in ("adm_in_channels", "channel_mults",
                                       "transformer_depths",
                                       "transformer_levels")})
    t_add = S.lcm_guidance_add(model, cfg, 8.0, torch.float32)
    w = j_gse(jnp.asarray(8.0, jnp.float32) - 1.0, 16)
    j_add = j_linear_nobias(tree["time_embed"]["cond_proj"], w)
    _close(t_add.detach(), j_add, 1e-6)
    x, ts, ctx, label = inputs
    with torch.no_grad():
        got = TU.unet_forward(model, *_torch(x, ts, ctx, label),
                              t_add=t_add)
    _close(got, JU.unet_forward(tree, TINY2, x, ts, ctx, label,
                                t_add=j_add))
    bf = jnp.bfloat16
    # the embedding's weights alone, cast on the host (ml_dtypes)
    j_tree16 = jax.tree.map(lambda a: np.asarray(a).astype(bf), {
        k: tree[k] for k in ("time_embed", "label_embed")})
    want = np.asarray(JU._unet_embed(j_tree16, TINY2, ts, label, bf,
                                     j_add.astype(bf)).astype(jnp.float32))
    model16 = TU.UNet(TINY2, dtype=torch.bfloat16)
    model16.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = TU._unet_embed(model16, torch.from_numpy(ts),
                             torch.from_numpy(label), torch.bfloat16,
                             t_add).float()
    _close(got, want, 2e-2 * max(1.0, float(np.abs(want).max())))


def test_freeu_fourier_filter_matches_reference():
    """The port filters NCHW over its last two axes, the reference NHWC
    over (1, 2): 1e-5 absolute; scale 1 is the identity (to the FFT's
    rounding) and bf16 comes back in bf16."""
    x = np.random.default_rng(3).standard_normal((2, 8, 6, 5)).astype(
        np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for scale in (0.2, 0.9):
        got = TU.freeu_fourier_filter(xt, 1, scale).permute(0, 2, 3, 1)
        _close(got, JU.freeu_fourier_filter(jnp.asarray(x), 1, scale), 1e-5)
    _close(TU.freeu_fourier_filter(xt, 1, 1.0), xt, 1e-5)
    assert TU.freeu_fourier_filter(xt.bfloat16(), 1, 0.5).dtype == \
        torch.bfloat16


def test_mha_identity_matches_reference(unets, monkeypatch):
    """PAG's perturbed self-attention on the fused qkv (the v third of
    its product, then the out projection) and on the unfused q/k/v,
    against the reference's _mha_identity: 1e-6 absolute, with no
    attention call at all."""
    tree, model, _ = unets
    blk = tree["input_blocks"][4]["transformer"]["blocks"][0]["attn1"]
    attn = model.input_blocks[4].transformer.blocks[0].attn1
    x = np.random.default_rng(4).standard_normal((2, 16, 64)).astype(
        np.float32)

    def no_attention(*a, **k):
        raise AssertionError("the identity map ran an attention")

    monkeypatch.setattr(TU, "qkv_attention", no_attention)
    for p in (jax.tree.map(np.asarray, JU.fuse_unet_qkv(
            {"a": {"attn1": blk}})["a"]["attn1"]), blk):
        want = JU._mha_identity(p, jnp.asarray(x))
        with torch.no_grad():
            got = attn(torch.from_numpy(x), 8, identity=True)
        _close(got, want, 1e-6)
    assert hasattr(attn, "qkv")


def test_pag_and_freeu_forward_match_reference(unets):
    """unet_forward with the middle block's self-attentions as identities
    (PAG's perturbed call) and FreeU at both decoder levels, 1e-3."""
    tree, model, (x, ts, ctx, label) = unets
    cfg = dataclasses.replace(TINY2, freeu=FREEU)
    with torch.no_grad():
        got = TU.unet_forward(model, *_torch(x, ts, ctx, label),
                              pag_mid=True, freeu=FREEU)
    _close(got, JU.unet_forward(tree, cfg, x, ts, ctx, label, pag_mid=True))


@pytest.mark.parametrize("branch", [1, 2, 3, 4, 5])
def test_deepcache_forwards_match_reference(branch, unets):
    """unet_forward_cached's output and feature (NCHW here, NHWC there)
    and unet_forward_shallow on that feature, with FreeU inside both as
    the reference runs it, every branch of TINY2: 1e-3; the cached call
    is unet_forward bit for bit."""
    tree, model, (x, ts, ctx, label) = unets
    cfg = dataclasses.replace(TINY2, freeu=FREEU)
    args = _torch(x, ts, ctx, label)
    with torch.no_grad():
        out, cache = TU.unet_forward_cached(model, *args, branch=branch,
                                            freeu=FREEU)
        assert torch.equal(out, TU.unet_forward(model, *args, freeu=FREEU))
        shallow = TU.unet_forward_shallow(model, *args, cache,
                                          branch=branch, freeu=FREEU)
    j_out, j_cache = JU.unet_forward_cached(tree, cfg, x, ts, ctx, label,
                                            branch=branch)
    _close(out, j_out)
    _close(cache.permute(0, 2, 3, 1), j_cache)
    _close(shallow, JU.unet_forward_shallow(tree, cfg, x, ts, ctx, label,
                                            j_cache, branch=branch))


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipes():
    """(reference, port) pipelines on the same weights (the port draws
    them; bias and norm parameters moved off 0 and 1; the bridge carries
    them across), and the same pair with an LCM-distilled base UNet that
    shares the towers and the VAE."""
    tpipe = random_pipeline(device="cpu", embedder_cfg=TINY_EMBEDDER,
                            diffuser_cfg=BASE, vae_cfg=TINY_VAE,
                            unet_dtype=torch.float32, with_encoder=True)
    gen = torch.Generator().manual_seed(6)
    lcm_unet = TU.UNet(LCM_BASE.unet_config(), dtype=torch.float32)
    gen10 = torch.Generator().manual_seed(10)
    with torch.no_grad():
        for p in lcm_unet.parameters():
            p.copy_(0.02 * torch.randn(p.shape, generator=gen))
        for m in (tpipe.embedder, tpipe.unet, tpipe.vae, tpipe.vae_encoder,
                  lcm_unet):
            for p in m.parameters():
                if p.dim() == 1:
                    p.add_(0.05 * torch.randn(p.shape, generator=gen10))
    lcm_unet.eval().requires_grad_(False)
    tpipe.strict_resolutions = False
    t_lcm = dataclasses.replace(tpipe, diffuser_cfg=LCM_BASE, unet=lcm_unet)
    alphas = jnp.asarray(R.scaled_linear_alphas_cumprod())
    jpipe = JPipeline(
        embedder_cfg=TINY_EMBEDDER,
        embedder_params={k: reference_tree(tpipe.embedder[k])
                         for k in ("clip", "open_clip")},
        diffuser_cfg=BASE, unet_params=fused(reference_tree(tpipe.unet)),
        alphas_cumprod=alphas, vae_cfg=TINY_VAE,
        vae_params=reference_tree(tpipe.vae, tpipe.vae_encoder),
        clip_tokenizer=ClipTokenizer(None),
        open_clip_tokenizer=OpenClipTokenizer(None),
        compute_dtype=jnp.float32, strict_resolutions=False)
    j_lcm = dataclasses.replace(
        jpipe, diffuser_cfg=LCM_BASE,
        unet_params=fused(reference_tree(lcm_unet)))
    return jpipe, tpipe, j_lcm, t_lcm


@pytest.fixture(scope="module")
def refiner(pipes):
    """(reference, port) keywords that give a pipeline the same random
    refiner UNet (module 10's tiny one). Its weights are N(0, 0.3^2): at
    the init's 0.02 a DeepCache shallow step moves the refiner's latent
    by about 1e-4, under the requests' bound; at 0.3 by about 0.15."""
    unet = TU.UNet(REFINER.unet_config(), dtype=torch.float32)
    gen = torch.Generator().manual_seed(17)
    with torch.no_grad():
        for p in unet.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen)
                    + (0.05 if p.dim() == 1 else 0.0))
    unet.eval().requires_grad_(False)
    return (dict(refiner_cfg=REFINER,
                 refiner_params=fused(reference_tree(unet)),
                 refiner_alphas=pipes[0].alphas_cumprod),
            dict(refiner_cfg=REFINER, refiner=unet))


def lcm_draws(key, n):
    """LCM's per-step noise from its scan key: split(key, n), stream 0 of
    each step key (the pin noise would be stream 1)."""
    return np.stack([np.asarray(R._scan_normal(R._scan_fold(k, 0), SHAPE))
                     for k in jax.random.split(key, n)])


def inject(monkeypatch, name, **draws):
    real = getattr(tpipeline, name)
    kw = {k: torch.tensor(v) for k, v in draws.items()}
    monkeypatch.setattr(tpipeline, name,
                        lambda *a, **k: real(*a, **{**k, **kw}))


def test_lcm_distilled_txt2img_matches_reference(pipes, refiner,
                                                 monkeypatch):
    """The distilled UNet at 4 steps, guidance 8 through its embedding
    (batch-1 calls), then the refiner's DDIM stage (the reference runs it
    after LCM): the initial noise, each step's re-noise and the refiner's
    re-noise from the reference's keys."""
    _, _, j_lcm, t_lcm = pipes
    j_lcm = dataclasses.replace(j_lcm, **refiner[0])
    t_lcm = dataclasses.replace(t_lcm, **refiner[1])
    base_key, refiner_key = jax.random.split(jax.random.PRNGKey(11))
    noise_key, scan_key = jax.random.split(base_key)
    kw = dict(resolution=RES, n_steps=4, guidance_scale=8.0, seed=11,
              negative_prompt=NEGATIVE, sampler="lcm", use_refiner=True)
    want_images, want_latent = run_reference(
        monkeypatch, j_lcm, lambda: j_lcm.txt2img(PROMPT, **kw))
    initial = normal(noise_key)
    inject(monkeypatch, "lcm_sample_latent", initial_noise=initial,
           step_noise=lcm_draws(scan_key, 4))
    inject(monkeypatch, "refine_latent", noise=normal(refiner_key))
    got = t_lcm.txt2img(PROMPT, **kw)
    assert_matches(got, t_lcm, want_images, want_latent, initial)


def test_lcm_distilled_img2img_matches_reference(pipes, monkeypatch):
    """LCM img2img at strength 0.5: the grid windowed to its last 25
    points, the re-noise to its first, then 4 steps."""
    _, _, j_lcm, t_lcm = pipes
    ref = image(31)
    noise_key, scan_key = jax.random.split(jax.random.PRNGKey(12))
    kw = dict(strength=0.5, n_steps=4, guidance_scale=8.0, seed=12,
              negative_prompt=NEGATIVE, sampler="lcm")
    want_images, want_latent = run_reference(
        monkeypatch, j_lcm, lambda: j_lcm.img2img(PROMPT, ref, **kw))
    inject(monkeypatch, "lcm_refine_latent", noise=normal(noise_key),
           step_noise=lcm_draws(scan_key, 4))
    got = t_lcm.img2img(PROMPT, ref, **kw)
    assert_matches(got, t_lcm, want_images, want_latent,
                   t_lcm._encode(ref).numpy())


def test_ddim_invert_matches_reference(pipes):
    """ddim_invert (gs 1: no CFG pair) of an image under its prompt:
    within 1e-3 of max(1, |latent|)."""
    jpipe, tpipe, _, _ = pipes
    ref = image(32)
    want = np.asarray(jpipe.ddim_invert(PROMPT, ref, n_steps=4))
    got = tpipe.ddim_invert(PROMPT, ref, n_steps=4)
    assert got.shape == want.shape == SHAPE and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * max(
        1.0, float(np.abs(want).max())))


def test_pag_freeu_dpmpp_matches_reference(pipes, monkeypatch):
    """PAG at 3.0 with CFG and FreeU on the base (the CLI's --freeu auto
    settings) through DPM++ 2M on the karras schedule."""
    jpipe, tpipe, _, _ = pipes
    noise_key = jax.random.split(jax.random.split(
        jax.random.PRNGKey(13))[0])[0]
    kw = dict(resolution=RES, n_steps=4, seed=13, negative_prompt=NEGATIVE,
              sampler="dpmpp", schedule="karras", pag_scale=3.0)
    j_cfg, t_cfg = jpipe.diffuser_cfg, tpipe.diffuser_cfg
    try:
        jpipe.diffuser_cfg = dataclasses.replace(j_cfg, freeu=FREEU)
        tpipe.diffuser_cfg = dataclasses.replace(t_cfg, freeu=FREEU)
        want_images, want_latent = run_reference(
            monkeypatch, jpipe, lambda: jpipe.txt2img(PROMPT, **kw))
        initial = normal(noise_key)
        inject(monkeypatch, "euler_sample_latent", initial_noise=initial)
        got = tpipe.txt2img(PROMPT, **kw)
    finally:
        jpipe.diffuser_cfg, tpipe.diffuser_cfg = j_cfg, t_cfg
    assert_matches(got, tpipe, want_images, want_latent, initial)


def test_deepcache_ddim_inpaint_matches_reference(pipes, refiner,
                                                 monkeypatch):
    """DeepCache (2, 1) through DDIM on a crop-window inpaint: full calls
    at steps 0, 2, 4 and 6, shallow ones between, the pin noise each step;
    then the refiner's stage with DeepCache too (unguided, batch B: a full
    call at t = 199, a shallow one at 74) after its re-noise."""
    jpipe, tpipe, _, _ = pipes
    jpipe = dataclasses.replace(jpipe, **refiner[0])
    tpipe = dataclasses.replace(tpipe, **refiner[1])
    ref = image(33)
    base_key, refiner_key = jax.random.split(jax.random.PRNGKey(14))
    noise_key, scan_key = jax.random.split(base_key)
    pin = np.stack([np.asarray(R._scan_normal(k, SHAPE))
                    for k in jax.random.split(scan_key, len(
                        R.ddim_timesteps(0, 8)))])
    assert len(R.ddim_timesteps(800, 8)) == 2
    kw = dict(n_steps=8, seed=14, negative_prompt=NEGATIVE,
              deepcache=(2, 1), use_refiner=True, **CROP)
    want_images, want_latent = run_reference(
        monkeypatch, jpipe, lambda: jpipe.inpaint(PROMPT, ref, **kw))
    initial = normal(noise_key)
    inject(monkeypatch, "sample_latent", initial_noise=initial,
           pin_noise=pin)
    inject(monkeypatch, "refine_latent", noise=normal(refiner_key))
    got = tpipe.inpaint(PROMPT, ref, **kw)
    assert_matches(got, tpipe, want_images, want_latent, initial)


# ---------------------------------------------------------------------------
# port-only identities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler", ["ddim", "euler_a"])
def test_previews_leave_the_latent_bit_equal(sampler, pipes):
    """preview_every=2 over 5 steps: previews after steps 2 and 4 (none
    after the last), [1, 8, 8, 3] uint8, and the final latent equal to the
    request without previews bit for bit (the stochastic euler_a too)."""
    _, tpipe, _, _ = pipes
    seen = []
    kw = dict(resolution=RES, n_steps=5, seed=15, sampler=sampler)
    tpipe.txt2img(PROMPT, **kw, preview_every=2,
                  preview_callback=lambda *a: seen.append(a))
    with_previews = tpipe.last_latent
    tpipe.txt2img(PROMPT, **kw)
    assert torch.equal(with_previews, tpipe.last_latent)
    total = 5  # DDIM's grid at 5 steps: t = 999, 799, ..., 199
    assert [(d, t) for d, t, _ in seen] == [(2, total), (4, total)]
    assert all(p.shape == (1, 8, 8, 3) and p.dtype == np.uint8
               for *_, p in seen)
    with pytest.raises(ValueError, match="preview_every must be >= 1"):
        tpipe.txt2img(PROMPT, **kw, preview_every=0)


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
def test_deepcache_interval_1_is_the_plain_loop(sampler, pipes):
    _, tpipe, _, _ = pipes
    kw = dict(resolution=RES, n_steps=3, seed=16, sampler=sampler)
    tpipe.txt2img(PROMPT, **kw, deepcache=(1, 2))
    cached = tpipe.last_latent
    tpipe.txt2img(PROMPT, **kw)
    assert torch.equal(cached, tpipe.last_latent)


def test_invert_then_sample_is_identity_for_constant_eps(pipes,
                                                         monkeypatch):
    """tests/test_inversion.py's identity on the port: with eps constant
    in x and t the DDIM chain inverts exactly, so DDIM from the inverted
    latent returns x0 and the inverted latent is sqrt(a_999) x0 +
    sqrt(1 - a_999) c (2e-4, the reference test's tolerance)."""
    _, tpipe, _, _ = pipes
    gen = torch.Generator().manual_seed(3)
    const = 0.3 * torch.randn((1, 6, 10, 4), generator=gen)
    x0 = torch.randn((1, 6, 10, 4), generator=gen)
    monkeypatch.setattr(S, "unet_forward", lambda unet, x, *a, **k:
                        const.expand(x.shape[0], -1, -1, -1).to(x.dtype))
    cond = tpipe.conditioning([PROMPT], (48, 80), profile_stages=False)
    alphas = tpipe.alphas_cumprod
    inv = S.ddim_invert_latent(tpipe.unet, BASE, alphas, x0, cond, 1.0, 5,
                               torch.float32)
    recon = S.diffuse_latent(tpipe.unet, BASE, alphas, inv, cond, 1.0, 0, 5,
                             torch.float32, use_cfg=False)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(recon.numpy(), x0.numpy(), **tol)
    a = float(alphas[999])
    np.testing.assert_allclose(
        inv.numpy(), (np.sqrt(a) * x0 + np.sqrt(1 - a) * const).numpy(),
        **tol)


def test_lcm_and_extension_refusals_are_the_references(pipes):
    """The reference's refusals: CFG on a distilled UNet, the refiner,
    PAG with LCM, previews or DeepCache, DeepCache with previews, the
    two-evaluation k-samplers, lms and CFG++, and a 9-channel UNet."""
    _, tpipe, _, t_lcm = pipes
    kw = dict(resolution=RES, n_steps=2)
    cases = [
        (dict(sampler="lcm", pag_scale=2.0), "pag_scale does not apply"),
        (dict(preview_every=1, pag_scale=2.0), "not supported with step"),
        (dict(preview_every=1, sampler="lcm"), "not supported with the LCM"),
        (dict(preview_every=1, deepcache=(2, 1)), "incompatible with step"),
        (dict(deepcache=(2, 1), sampler="lcm"), "few-step by design"),
        (dict(deepcache=(2, 1), pag_scale=2.0), "not combinable with "
                                                "ControlNet or deepcache"),
        (dict(deepcache=(0, 1)), "interval must be >= 1"),
        (dict(deepcache=(2, 1), sampler="heun"), "two UNet evals"),
        (dict(deepcache=(2, 1), sampler="lms"), "4-deep derivative"),
        (dict(deepcache=(2, 1), sampler="euler_cfgpp"), "no uncond split"),
        (dict(deepcache=(2, 3)), "branch must be in"),
    ]
    for options, msg in cases:
        with pytest.raises(ValueError, match=msg):
            tpipe.txt2img(PROMPT, **kw, **options)
    with pytest.raises(ValueError, match="embed guidance"):
        S.lcm_diffuse_latent(t_lcm.unet, LCM_BASE, t_lcm.alphas_cumprod,
                             torch.zeros(SHAPE), None, 8.0, use_cfg=True)


# ---------------------------------------------------------------------------
# loading a distilled UNet, and the CLI
# ---------------------------------------------------------------------------

def test_distilled_unet_native_load_is_bitwise(pipes, tmp_path):
    """The reference's native writer on the distilled pipeline: the port
    loads cond_proj bitwise with time_cond_proj_dim from diffuser.cfg; the
    port's writer round-trips it; a cfg without time_cond_proj_dim fails
    the strict load naming the key."""
    from sdxl_tpu.configs import save_cfg as j_save_cfg

    _, _, j_lcm, t_lcm = pipes
    rck.save_native_pipeline(str(tmp_path / "ref"), j_lcm)
    for path in (str(tmp_path / "ref"),
                 save_native_pipeline(str(tmp_path / "port"), t_lcm)):
        pipe = load_pipeline(path, compute_dtype=torch.float32, device="cpu")
        assert pipe.diffuser_cfg.time_cond_proj_dim == 16
        got, want = pipe.unet.state_dict(), t_lcm.unet.state_dict()
        assert set(got) == set(want) and "time_embed.cond_proj.weight" in got
        for k in want:
            assert torch.equal(got[k], want[k]), k
    j_save_cfg(str(tmp_path / "ref" / "diffuser.cfg"), BASE)
    with pytest.raises(ValueError, match="time_embed.cond_proj.weight"):
        load_pipeline(str(tmp_path / "ref"), device="cpu")


@pytest.fixture(scope="module")
def cli_files(pipes, tmp_path_factory):
    _, tpipe, _, t_lcm = pipes
    root = tmp_path_factory.mktemp("cli10b")
    return dict(ckpt=save_native_pipeline(str(root / "ckpt"), tpipe),
                lcm=save_native_pipeline(str(root / "lcm"), t_lcm),
                ref=save_images(image(34), str(root / "ref"))[0])


CLI_CASES = {
    "lcm": (["--model-dir", "{lcm}", "--sampler", "lcm", "-gs", "8"],
            lambda p, f, kw: p.txt2img(resolution=RES, sampler="lcm",
                                       **dict(kw, guidance_scale=8.0))),
    "preview_every": (["--preview-every", "2"],
                      lambda p, f, kw: p.txt2img(resolution=RES, **kw)),
    "invert": (["--invert-img", "{ref}", "--invert-prompt", "a cat"],
               lambda p, f, kw: p.txt2img(
                   resolution=RES, initial_latent=p.ddim_invert(
                       ["a cat"] * 2, load_images([f["ref"]]), n_steps=3),
                   **kw)),
    "freeu": (["--freeu", "--sampler", "dpmpp"],
              lambda p, f, kw: dataclasses.replace(p, diffuser_cfg=(
                  dataclasses.replace(p.diffuser_cfg, freeu=FREEU))
              ).txt2img(resolution=RES, sampler="dpmpp", **kw)),
    "pag_no_cfg": (["--pag-scale", "3", "--sampler", "euler", "--no-cfg"],
                   lambda p, f, kw: p.txt2img(
                       resolution=RES, sampler="euler", no_cfg=True,
                       pag_scale=3.0, **kw)),
    "deepcache_img2img": (
        ["--deepcache", "2", "--deepcache-branch", "1", "--reference-img",
         "{ref}", "--img2img-strength", "0.5"],
        lambda p, f, kw: p.img2img(reference_images=np.repeat(
            load_images([f["ref"]]), 2, axis=0), strength=0.5,
            deepcache=(2, 1), **kw)),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_module10b_flags_match_the_in_memory_pipeline(case, pipes,
                                                           cli_files,
                                                           tmp_path):
    """main(..., device="cpu") on a port-written checkpoint (the distilled
    one for --sampler lcm) writes, pixel for pixel, what the in-memory
    pipeline returns for the same request and seed; --preview-every also
    writes its preview PNG."""
    from sdxl_tpu_torch.cli.sample import main

    _, tpipe, _, t_lcm = pipes
    flags, call = CLI_CASES[case]
    out = str(tmp_path / "img")
    prompts = [PROMPT, "a photo of a dog"]
    argv = ["--model-dir", cli_files["ckpt"], "--f32",
            "--no-strict-resolution", "--prompt", prompts[0], "--prompt",
            prompts[1], "--height", "64", "--width", "64", "-steps", "3",
            "--seed", "3", "--negative-prompt", NEGATIVE, "--output-dir", out,
            *(a.format(**cli_files) for a in flags)]
    assert main(argv, device="cpu") == 0
    got = load_images([f"{out}{i}.png" for i in range(2)])
    want = call(t_lcm if case == "lcm" else tpipe, cli_files,
                dict(prompts=prompts, n_steps=3, seed=3,
                     negative_prompt=NEGATIVE))
    np.testing.assert_array_equal(got, want)
    if case == "preview_every":
        assert load_images([f"{out}preview_002_0.png"]).shape == (1, 8, 8, 3)


CLI_ERRORS = [
    ["--deepcache", "2", "--preview-every", "2"],
    ["--deepcache", "0"],
    ["--invert-img", "{ref}", "--pag-scale", "3"],
    ["--invert-img", "{ref}", "--sampler", "euler"],
    ["--freeu", "1,2"],
]


@pytest.mark.parametrize("flags", CLI_ERRORS,
                         ids=["deepcache_preview", "deepcache_0",
                              "invert_pag", "invert_k_sampler", "freeu_spec"])
def test_cli_bad_combinations_exit_1_as_the_reference(flags, cli_files,
                                                      capsys, monkeypatch,
                                                      tmp_path):
    import sdxl_tpu.cli.sample as j_cli
    import sdxl_tpu.pipeline.loader as j_loader
    from sdxl_tpu_torch.cli.sample import main

    class Stub:  # the reference CLI's pipeline, never sampled from
        diffuser_cfg = BASE

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


@pytest.mark.parametrize("flags", [
    ["--sampler", "lcm", "--pag-scale", "2"],
    ["--sampler", "heun", "--deepcache", "2"],
], ids=["lcm_pag", "heun_deepcache"])
def test_cli_bad_extension_combinations_fail_as_the_reference(
        flags, pipes, cli_files, monkeypatch, tmp_path):
    """The reference's pipeline refuses these (its CLI lets the ValueError
    through): the port's CLI fails with the same message."""
    import sdxl_tpu.cli.sample as j_cli
    import sdxl_tpu.pipeline.loader as j_loader
    from sdxl_tpu_torch.cli.sample import main

    jpipe = pipes[0]
    monkeypatch.setattr(j_loader, "load_pipeline", lambda *a, **k: jpipe)
    argv = ["--model-dir", cli_files["ckpt"], "--f32", "--prompt", "a cat",
            "--height", "64", "--width", "64", "-steps", "2", "--output-dir",
            str(tmp_path / "x"), *flags]
    with pytest.raises(ValueError) as want:
        j_cli.main(argv)
    with pytest.raises(ValueError) as got:
        main(argv, device="cpu")
    assert str(got.value) == str(want.value)
    assert not os.path.exists(tmp_path / "x0.png")
