"""Module 10a: the twelve k-samplers, their six schedules, zsnr, DDIM eta,
guidance rescale and no-CFG, against sdxl_tpu on the CPU.

- The port's loop (k_samplers.k_sample, its model given as a function)
  with the synthetic model of scripts/gen_k_goldens.py, on the goldens'
  sigma grids and step noises, against goldens/k_samplers/k_goldens.npz
  at tests/test_k_goldens.py's tolerances. Each trajectory is read as the
  loop's head_steps prefixes, so the prefix semantics of the ensemble
  split are held too.
- The schedules and each method's per-step extras against the
  reference's functions at 10, 30 and 61 steps (61: the count that gives
  diffusers' trailing arange an extra entry), with and without
  step_start and zsnr: 1e-6 relative (timesteps: 1e-6 of the grid's
  999, for karras's and ays's fractional ones near t = 0).
- Requests through the reference pipeline's own entry points and the
  port's with the reference's draws injected (the initial noise, the pin
  noise and each step's noise from its key splits, the refiner's and
  img2img's re-noise), on tiny configs whose UNets keep their one
  transformer in the middle block (the reference's loops compile in
  about two seconds each): final latents within 1e-3 (of max(1,
  |latent|): zsnr's first sigma is 4096 and a random UNet leaves latents
  of that size) and images within one u8 level, PR 14's bounds.
- The CLI's new flags against the in-memory pipeline, their bad
  combinations against the reference CLI's messages, and the flags the
  rest of module 11 ports still refused.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdxl_tpu.pipeline.sampler as R
import sdxl_tpu_torch.pipeline.pipeline as tpipeline
from sdxl_tpu.configs import DiffuserConfig
from sdxl_tpu.pipeline.pipeline import SDXLPipeline as JPipeline
from sdxl_tpu.tokenizer import ClipTokenizer, OpenClipTokenizer
from sdxl_tpu_torch.io.checkpoint import save_native_pipeline
from sdxl_tpu_torch.io.images import load_images, save_images
from sdxl_tpu_torch.pipeline import k_samplers as K
from sdxl_tpu_torch.pipeline.pipeline import random_pipeline
from sdxl_tpu_torch.pipeline.sampler import (
    _cfg_contexts,
    _cfg_eps,
    expert_head_steps,
)
from tests.test_pipeline_e2e import TINY_VAE
from tests.test_torch_module9 import (
    CROP,
    NEGATIVE,
    PROMPT,
    RES,
    TINY_BASE,
    fused,
    image,
    mask_image,
    reference_tree,
    run_reference,
)
from tests.test_torch_pipeline import TINY_EMBEDDER
from tests.torch_parity import fast_reference_compiles  # noqa: F401

# One intra-op thread: the suite runs six workers on shared cores.
torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens", "k_samplers", "k_goldens.npz")
# tiny UNets with their one transformer in the middle block
BASE = dataclasses.replace(TINY_BASE, transformer_levels=())
REFINER = DiffuserConfig(
    adm_in_channels=32 + 5 * 256, model_channels=32, channel_mults=(1,),
    num_head_channels=8, transformer_depths=(1,), context_dim=32,
    transformer_levels=(), is_refiner=True)
SHAPE = (1, RES[0] // 8, RES[1] // 8, 4)


# ---------------------------------------------------------------------------
# the loop and the step math against the goldens
# ---------------------------------------------------------------------------

def synth_model(x, sigma):
    """scripts/gen_k_goldens.py's synth_model, in torch."""
    return torch.sin(x) * 0.9 + 0.05 * x / (1.0 + sigma)


# case -> (method, sigma grid, golden prefix, noises?, (traj tol, final tol))
TOL = ((1e-4, 1e-4), (1e-4, 1e-5))
UNIPC_TOL = ((2e-4, 2e-4), (2e-4, 2e-5))
GOLDEN_CASES = {
    "euler": ("euler", "sigmas_8", "euler", False, TOL),
    "dpmpp": ("dpmpp", "sigmas_8", "dpmpp", False, TOL),
    "euler_a": ("euler_a", "sigmas_8", "euler_a", True, TOL),
    "dpmpp_sde": ("dpmpp_sde", "sigmas_8", "dpmpp_sde", True, TOL),
    "dpmpp_3m_sde": ("dpmpp_3m_sde", "sigmas_8", "dpmpp_3m_sde", True, TOL),
    "unipc": ("unipc", "sigmas_8", "unipc", False, UNIPC_TOL),
    "unipc3": ("unipc", "sigmas_3", "unipc3", False, UNIPC_TOL),
    "unipc2": ("unipc", "sigmas_2", "unipc2", False, UNIPC_TOL),
    "heun": ("heun", "sigmas_8", "heun", False, TOL),
    # unguided CFG++ (eps_u == eps) is Euler: the loop's cfgpp wiring
    "euler_cfgpp": ("euler_cfgpp", "sigmas_8", "euler", False, TOL),
    "dpm2": ("dpm2", "sigmas_8", "dpm2", False, TOL),
    "dpm2_a": ("dpm2_a", "sigmas_8", "dpm2_a", True, TOL),
    "dpmpp_2s_a": ("dpmpp_2s_a", "sigmas_8", "dpmpp_2s_a", True, TOL),
    "lms": ("lms", "sigmas_8", "lms", False, TOL),
    "lms12": ("lms", "sigmas_12", "lms12", False, TOL),
}


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


@pytest.mark.parametrize("case", list(GOLDEN_CASES))
def test_k_loop_matches_goldens(case, goldens):
    """k_sample with the synthetic model (eps = (x - D(x, sigma)) / sigma,
    so denoised = D) against the literal k-diffusion / diffusers
    transcriptions' trajectories: the head_steps=k run is the golden's
    k-th point."""
    method, skey, gkey, noisy, ((tr, ta), (fr, fa)) = GOLDEN_CASES[case]
    g = goldens
    sigmas = g[skey]
    ts = np.arange(len(sigmas) - 1, 0, -1).astype(np.float32)
    noise = torch.tensor(g["step_noises"]) if noisy else None
    evals = []

    def eps_fn(x, sigma, t, i):
        evals.append(float(sigma))
        eps = (x - synth_model(x, sigma)) / sigma
        return (eps, eps) if method == "euler_cfgpp" else eps

    sigmas_full = K.sigma_table(K.scaled_linear_alphas_cumprod())
    n = len(sigmas) - 1
    traj = [g["x0"]]
    for k in range(1, n + 1):
        evals.clear()
        out = K.k_sample(eps_fn, torch.tensor(g["x0"]), method, ts, sigmas,
                         sigmas_full=sigmas_full, step_noise=noise,
                         head_steps=k if k < n else 0)
        assert len(evals) == K.model_evaluations(method, sigmas,
                                                 k if k < n else 0)
        traj.append(out.numpy())
    np.testing.assert_allclose(np.stack(traj), g[f"{gkey}_traj"], rtol=tr,
                               atol=ta)
    np.testing.assert_allclose(traj[-1], g[f"{gkey}_final"], rtol=fr,
                               atol=fa)
    if method == "lms":
        np.testing.assert_allclose(K.lms_scan_coeffs(sigmas),
                                   g[f"{gkey}_coeffs"], rtol=5e-5, atol=1e-7)


def test_karras_and_sigma_table_match_goldens(goldens):
    g = goldens
    for n, key in ((10, "karras_10"), (20, "karras_20")):
        np.testing.assert_allclose(
            K.karras_sigmas(float(g["sigma_min"]), float(g["sigma_max"]), n),
            g[key][:n], rtol=2e-5, atol=1e-6)
    sig = K.sigma_table(K.scaled_linear_alphas_cumprod())
    np.testing.assert_allclose(sig[[0, -1]], [g["sigma_min"], g["sigma_max"]],
                               rtol=1e-5)
    ts, sigmas = K.k_schedule(K.scaled_linear_alphas_cumprod(), 0, 10,
                              "karras")
    np.testing.assert_allclose(sigmas, g["karras_10"], rtol=2e-5, atol=1e-6)
    assert ts[0] == 999.0 and abs(ts[-1]) < 1e-5 and (np.diff(ts) < 0).all()


# ---------------------------------------------------------------------------
# schedules and extras against the reference's functions
# ---------------------------------------------------------------------------

def _rel(got, want, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    den = np.abs(want) if scale is None else scale
    return float(np.max(np.abs(got - want) / np.maximum(den, 1e-30)))


# (n_steps, step_start) of the schedule comparisons: 61 is the count that
# gives diffusers' trailing arange an extra entry
COMBOS = [(n, start) for n in (10, 30, 61) for start in (0, 700)]


@pytest.mark.parametrize("zsnr", [False, True], ids=["table", "zsnr"])
@pytest.mark.parametrize("schedule", K.SCHEDULES)
def test_k_schedule_matches_reference(schedule, zsnr):
    """k_schedule, k_sigma_max and expert_head_steps on the host against
    the reference's k_schedule: sigmas 1e-6 relative, timesteps 1e-6 of
    the grid's 999."""
    base = R.scaled_linear_alphas_cumprod()
    table = R.rescale_zero_terminal_snr(base) if zsnr else base
    np.testing.assert_array_equal(K.rescale_zero_terminal_snr(base),
                                  R.rescale_zero_terminal_snr(base))
    j_table = jnp.asarray(table)
    for t in (0, 500, 999):
        assert _rel(K.k_sigma_at(table, t), R.k_sigma_at(j_table, t)) < 1e-6
    for n, start in COMBOS:
        want_ts, want_sig = R.k_schedule(j_table, start, n, schedule)
        ts, sigmas = K.k_schedule(table, start, n, schedule)
        assert ts.dtype == sigmas.dtype == np.float32
        assert _rel(ts, want_ts, 999.0) < 1e-6, (n, start)
        assert _rel(sigmas, want_sig) < 1e-6, (n, start)
        if start:
            continue
        assert _rel(K.k_sigma_max(table, n, schedule), want_sig[0]) < 1e-6
        for end in (0.5, 0.8):
            # the reference's expert_head_steps: the entries at or above
            # its cutoff head the grid (DDIM's grid on the host there)
            cutoff = R.expert_cutoff(end, len(table))
            ddim = R.ddim_timesteps(0, n)
            for sampler, grid in (("ddim", ddim), ("dpmpp", want_ts)):
                head = int((np.asarray(grid) >= cutoff).sum())
                if sampler == "ddim" and 0 < head < len(grid):
                    assert R.expert_head_steps(table, n, end) == (
                        head, len(grid))
                if 0 < head < len(grid):
                    assert expert_head_steps(table, n, end, sampler,
                                             schedule) == (head, len(grid))
                else:
                    with pytest.raises(ValueError, match="leaves no"):
                        expert_head_steps(table, n, end, sampler, schedule)


def test_k_timesteps_match_reference():
    for spacing in ("linspace", "trailing", "leading"):
        for n in (1, 10, 30, 61, 103, 1000):
            for start in (0, 200, 800, 999):
                np.testing.assert_array_equal(
                    K.k_timesteps(start, n, 1000, spacing),
                    R.k_timesteps(start, n, 1000, spacing))
    assert len(K.k_timesteps(0, 61, 1000, "trailing")) == 61
    for spacing in ("trailing", "leading"):
        with pytest.raises(ValueError, match="n_steps .1001. > n_train"):
            K.k_timesteps(0, 1001, 1000, spacing)
    for n in (4, 10, 17):
        for family in ("sdxl", "sd15"):
            np.testing.assert_array_equal(K.ays_sigmas(n, family),
                                          R.ays_sigmas(n, family))


def reference_extras(sigmas, sigmas_full):
    """The reference's per-step extras over one grid (lms's coefficients
    are held to k-diffusion's own in test_k_loop_matches_goldens)."""
    sig = sigmas[:-1]
    return (R.m3_scan_extras(sig), R.unipc_scan_extras(sig),
            [R.mid_scan_extras(m, sigmas, sigmas_full) for m in K.K_MID])


@pytest.mark.parametrize("schedule", ["linear", "karras"])
def test_step_extras_match_reference(schedule):
    table = R.scaled_linear_alphas_cumprod()
    _, sigmas = K.k_schedule(table, 0, 10, schedule)
    sig_full = K.sigma_table(table)
    m3, unipc, mids = jax.device_get(reference_extras(
        jnp.asarray(sigmas), jnp.asarray(sig_full)))
    for got, want in zip(K.m3_scan_extras(sigmas[:-1]) +
                         K.unipc_scan_extras(sigmas[:-1]), m3 + unipc):
        np.testing.assert_array_equal(got, want)
    for method, want in zip(K.K_MID, mids):
        got = K.mid_scan_extras(method, sigmas, sig_full)
        for name, a, b in zip(("t_mid", "sig_mid", "sig_down", "sig_up"),
                              got, want):
            assert _rel(a, b, 999.0 if name == "t_mid" else
                        np.abs(b)) < 1e-6, (method, name)


# ---------------------------------------------------------------------------
# the requests, against the reference pipeline's own entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipes():
    """(reference, port) pipelines with the same weights: the port draws
    them (random_pipeline, every bias and norm parameter then moved off 0
    and 1) and io/bridge.py carries them to the reference's trees."""
    tpipe = random_pipeline(device="cpu", embedder_cfg=TINY_EMBEDDER,
                            diffuser_cfg=BASE, vae_cfg=TINY_VAE,
                            unet_dtype=torch.float32, with_encoder=True,
                            refiner_cfg=REFINER)
    modules = [tpipe.embedder, tpipe.unet, tpipe.refiner, tpipe.vae,
               tpipe.vae_encoder]
    g = torch.Generator().manual_seed(10)
    with torch.no_grad():
        for m in modules:
            for p in m.parameters():
                if p.dim() == 1:
                    p.add_(0.05 * torch.randn(p.shape, generator=g))
    tpipe.strict_resolutions = False
    alphas = jnp.asarray(R.scaled_linear_alphas_cumprod())
    jpipe = JPipeline(
        embedder_cfg=TINY_EMBEDDER,
        embedder_params={k: reference_tree(tpipe.embedder[k])
                         for k in ("clip", "open_clip")},
        diffuser_cfg=BASE, unet_params=fused(reference_tree(tpipe.unet)),
        alphas_cumprod=alphas, vae_cfg=TINY_VAE,
        vae_params=reference_tree(tpipe.vae, tpipe.vae_encoder),
        refiner_cfg=REFINER,
        refiner_params=fused(reference_tree(tpipe.refiner)),
        refiner_alphas=alphas, clip_tokenizer=ClipTokenizer(None),
        open_clip_tokenizer=OpenClipTokenizer(None),
        compute_dtype=jnp.float32, strict_resolutions=False)
    return jpipe, tpipe


def normal(key):
    return np.asarray(jax.random.normal(key, SHAPE, jnp.float32))


def scan_draws(key, n):
    """The reference scan's (pin, step) noise of n steps from its key:
    split(key, n); stream 0 of each step key pins, fold_in 1 steps."""
    keys = jax.random.split(key, n)
    return (np.stack([np.asarray(R._scan_normal(k, SHAPE)) for k in keys]),
            np.stack([np.asarray(R._scan_normal(R._scan_fold(k, 1), SHAPE))
                      for k in keys]))


def txt2img_draws(seed, n_base, n_refiner=0):
    """A reference txt2img's draws for an int seed: initial noise, the
    base scan's pin and step noise, the refiner's re-noise and step
    noise."""
    base_key, refiner_key = jax.random.split(jax.random.PRNGKey(seed))
    noise_key, scan_key = jax.random.split(base_key)
    pin, step = scan_draws(scan_key, n_base)
    r_step = (scan_draws(jax.random.fold_in(refiner_key, 1), n_refiner)[1]
              if n_refiner else None)
    return dict(initial=normal(noise_key), pin=pin, step=step,
                renoise=normal(refiner_key), refiner_step=r_step)


def inject(monkeypatch, base=None, refine=None):
    """The port's samplers take these draws in place of its generator's:
    base (euler_sample_latent / sample_latent keywords) and refine
    (k_refine_latent's noise and step_noise)."""
    def tensors(kw):
        return {k: None if v is None else torch.tensor(v)
                for k, v in (kw or {}).items()}

    for name, kw in (("euler_sample_latent", base), ("sample_latent", base),
                     ("k_refine_latent", refine)):
        if kw is None:
            continue
        real = getattr(tpipeline, name)

        def call(*args, _real=real, _kw=tensors(kw), **k):
            return _real(*args, **{**k, **_kw})
        monkeypatch.setattr(tpipeline, name, call)


def assert_matches(got_images, tpipe, want_images, want_latent, start):
    got = tpipe.last_latent.numpy()
    scale = max(1.0, float(np.abs(want_latent).max()))
    assert got.shape == want_latent.shape
    assert np.abs(want_latent - start).max() > 0.1  # the steps moved it
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want_latent, atol=1e-3 * scale, rtol=0)
    assert got_images.dtype == np.uint8 and got_images.std() > 0
    diff = np.abs(got_images.astype(int) - want_images.astype(int))
    assert diff.max() <= 1


def test_txt2img_dpmpp_karras_matches_reference(pipes, monkeypatch):
    """DPM++ 2M on the karras schedule: fractional timesteps, the
    multistep history, the sigma-space initial latent."""
    jpipe, tpipe = pipes
    d = txt2img_draws(3, 4)
    kw = dict(resolution=RES, n_steps=4, seed=3, negative_prompt=NEGATIVE,
              sampler="dpmpp", schedule="karras")
    want_images, want_latent = run_reference(
        monkeypatch, jpipe, lambda: jpipe.txt2img(PROMPT, **kw))
    inject(monkeypatch, base=dict(initial_noise=d["initial"]))
    got = tpipe.txt2img(PROMPT, **kw)
    assert_matches(got, tpipe, want_images, want_latent, d["initial"])


def test_inpaint_euler_a_with_refiner_matches_reference(pipes, monkeypatch):
    """Crop-window inpainting with euler_a (the pin on reference + sigma *
    pin noise, and each step's ancestral noise), then the refiner's
    euler_a stage: re-noise to the tail schedule's first sigma, its own
    step noise."""
    jpipe, tpipe = pipes
    ref = image(21)
    n_r = len(K.k_timesteps(800, 8, 1000))
    assert n_r == 2  # t = 143 and 0
    d = txt2img_draws(4, 8, n_r)
    kw = dict(n_steps=8, seed=4, negative_prompt=NEGATIVE, sampler="euler_a",
              use_refiner=True, **CROP)
    want_images, want_latent = run_reference(
        monkeypatch, jpipe, lambda: jpipe.inpaint(PROMPT, ref, **kw))
    inject(monkeypatch,
           base=dict(initial_noise=d["initial"], pin_noise=d["pin"],
                     step_noise=d["step"]),
           refine=dict(noise=d["renoise"], step_noise=d["refiner_step"]))
    got = tpipe.inpaint(PROMPT, ref, **kw)
    assert_matches(got, tpipe, want_images, want_latent, d["initial"])


def test_img2img_dpmpp_sde_no_cfg_matches_reference(pipes, monkeypatch):
    """img2img at strength 0.5 with DPM++ 2M SDE and no CFG (batch-1 UNet
    calls): the re-noise from the seed's key, the step noise from its
    fold_in(1)."""
    jpipe, tpipe = pipes
    ref = image(22)
    key = jax.random.PRNGKey(5)
    n = len(K.k_timesteps(500, 6, 1000))
    step = scan_draws(jax.random.fold_in(key, 1), n)[1]
    kw = dict(strength=0.5, n_steps=6, seed=5, negative_prompt=NEGATIVE,
              sampler="dpmpp_sde", no_cfg=True)
    want_images, want_latent = run_reference(
        monkeypatch, jpipe, lambda: jpipe.img2img(PROMPT, ref, **kw))
    inject(monkeypatch, refine=dict(noise=normal(key), step_noise=step))
    got = tpipe.img2img(PROMPT, ref, **kw)
    assert_matches(got, tpipe, want_images, want_latent,
                   tpipe._encode(ref).numpy())


def test_zsnr_trailing_guidance_rescale_matches_reference(pipes,
                                                          monkeypatch):
    """Guided CFG++ (euler_cfgpp at CFG 7.5: the Euler step toward the
    guided denoised along the unconditional eps, the second output of
    _cfg_eps's return_uncond) on the zero-terminal-SNR table (first sigma
    about 4096, the UNet's input scaled in f32 before its cast), the
    trailing grid and guidance_rescale 0.7; both tables restored after."""
    jpipe, tpipe = pipes
    j_alphas, t_alphas = jpipe.alphas_cumprod, tpipe.alphas_cumprod
    d = txt2img_draws(6, 4)
    kw = dict(resolution=RES, n_steps=4, seed=6, negative_prompt=NEGATIVE,
              sampler="euler_cfgpp", schedule="trailing",
              guidance_rescale=0.7)
    try:
        jpipe.rescale_zsnr()
        tpipe.rescale_zsnr()
        assert float(tpipe.alphas_cumprod[-1]) == 2.0 ** -24
        want_images, want_latent = run_reference(
            monkeypatch, jpipe, lambda: jpipe.txt2img(PROMPT, **kw))
        inject(monkeypatch, base=dict(initial_noise=d["initial"]))
        got = tpipe.txt2img(PROMPT, **kw)
    finally:
        jpipe.alphas_cumprod, tpipe.alphas_cumprod = j_alphas, t_alphas
    assert_matches(got, tpipe, want_images, want_latent,
                   d["initial"] * K.k_sigma_max(
                       K.rescale_zero_terminal_snr(t_alphas.numpy()), 4,
                       "trailing"))


def test_ddim_eta_matches_reference(pipes, monkeypatch):
    """Stochastic DDIM (eta 1) through diffuse_latent: its step noise from
    fold_in(1) of each scan key."""
    jpipe, tpipe = pipes
    d = txt2img_draws(7, len(R.ddim_timesteps(0, 3)))
    kw = dict(resolution=RES, n_steps=3, seed=7, negative_prompt=NEGATIVE,
              ddim_eta=1.0)
    want_images, want_latent = run_reference(
        monkeypatch, jpipe, lambda: jpipe.txt2img(PROMPT, **kw))
    inject(monkeypatch, base=dict(initial_noise=d["initial"],
                                  step_noise=d["step"]))
    got = tpipe.txt2img(PROMPT, **kw)
    assert_matches(got, tpipe, want_images, want_latent, d["initial"])


def test_cfg_eps_unconditional_and_no_cfg_rows(pipes):
    """return_uncond's second output is the UNet's eps on the
    unconditional rows alone and its first the guided eps; use_cfg=False
    runs the conditional rows alone, which guidance_scale 1 agrees
    with."""
    _, tpipe = pipes
    cond = tpipe.conditioning([PROMPT], RES, NEGATIVE)
    x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(0))
    t, dt = torch.tensor(512.5), torch.float32
    ctx2, ch2 = _cfg_contexts(BASE, cond, dt)
    ctx, ch = _cfg_contexts(BASE, cond, dt, use_cfg=False)
    assert ctx.shape[0] == ch.shape[0] == 1
    eps, eps_u = _cfg_eps(tpipe.unet, BASE, x, t, ctx2, ch2, 5.0, dt,
                          return_uncond=True)
    eps_c = _cfg_eps(tpipe.unet, BASE, x, t, ctx, ch, 5.0, dt, use_cfg=False)
    torch.testing.assert_close(eps_u, _cfg_eps(
        tpipe.unet, BASE, x, t, ctx2[:1], ch2[:1], 5.0, dt, use_cfg=False))
    torch.testing.assert_close(eps, eps_u + (eps_c - eps_u) * 5.0)
    torch.testing.assert_close(
        _cfg_eps(tpipe.unet, BASE, x, t, ctx2, ch2, 1.0, dt), eps_c,
        atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="CFG\\+\\+ needs"):
        _cfg_eps(tpipe.unet, BASE, x, t, ctx, ch, 5.0, dt, use_cfg=False,
                 return_uncond=True)


# ---------------------------------------------------------------------------
# the sample CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_files(pipes, tmp_path_factory):
    _, tpipe = pipes
    root = tmp_path_factory.mktemp("cli10")
    return dict(ckpt=save_native_pipeline(str(root / "ckpt"), tpipe),
                ref=save_images(image(23), str(root / "ref"))[0],
                narrow=save_images(image(24, (1, 64, 48, 3)),
                                   str(root / "narrow"))[0],
                mask=save_images(mask_image()[None], str(root / "mask"))[0])


CLI_CASES = {
    "dpmpp_karras": (["--sampler", "dpmpp", "--schedule", "karras"],
                     lambda p, f, kw: p.txt2img(resolution=RES, sampler="dpmpp",
                                                schedule="karras", **kw)),
    "euler_a_refiner": (
        ["--sampler", "euler_a", "--use-refiner"],
        lambda p, f, kw: p.txt2img(resolution=RES, sampler="euler_a",
                                   use_refiner=True, **kw)),
    "heun_no_cfg_img2img": (
        ["--sampler", "heun", "--no-cfg", "--reference-img", "{ref}",
         "--img2img-strength", "0.5"],
        lambda p, f, kw: p.img2img(reference_images=np.repeat(
            load_images([f["ref"]]), 2, axis=0), strength=0.5,
            sampler="heun", no_cfg=True, **kw)),
    "zsnr": (["--zsnr", "--sampler", "euler", "--schedule", "trailing",
              "--guidance-rescale", "0.7"],
             lambda p, f, kw: p.rescale_zsnr().txt2img(
                 resolution=RES, sampler="euler", schedule="trailing",
                 guidance_rescale=0.7, **kw)),
    "dpmpp_2s_a_mask": (
        ["--sampler", "dpmpp_2s_a", "--reference-img", "{ref}",
         "--mask-img", "{mask}"],
        lambda p, f, kw: p.inpaint(reference_images=load_images([f["ref"]]),
                                   mask_image=mask_image(),
                                   sampler="dpmpp_2s_a", **kw)),
    "ddim_eta_outpaint": (
        ["--ddim-eta", "1.0", "--reference-img", "{narrow}", "--outpaint",
         "8,8,0,0"],
        lambda p, f, kw: p.outpaint(
            reference_images=load_images([f["narrow"]]), pad=(8, 8, 0, 0),
            ddim_eta=1.0, **kw)),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_module10_flags_match_the_in_memory_pipeline(case, pipes,
                                                          cli_files, tmp_path):
    """main(..., device="cpu") on the port-written checkpoint writes, pixel
    for pixel, what the in-memory port pipeline returns for the same
    request and seed."""
    from sdxl_tpu_torch.cli.sample import main

    _, tpipe = pipes
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
    alphas = tpipe.alphas_cumprod
    try:
        want = call(tpipe, cli_files, dict(prompts=prompts, n_steps=3,
                                           seed=3, negative_prompt=NEGATIVE))
    finally:
        tpipe.alphas_cumprod = alphas
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flags", [
    ["--sampler", "euler", "--ddim-eta", "0.5"],
    ["--schedule", "karras"],
], ids=["ddim_eta_k_sampler", "schedule_ddim"])
def test_cli_bad_sampler_combinations_fail_as_the_reference(
        flags, pipes, cli_files, monkeypatch, tmp_path):
    """The reference's pipeline refuses these (its CLI lets the ValueError
    through): the port's CLI fails with the same message and writes
    nothing."""
    import sdxl_tpu.cli.sample as j_cli
    import sdxl_tpu.pipeline.loader as j_loader
    from sdxl_tpu_torch.cli.sample import main

    jpipe, _ = pipes
    monkeypatch.setattr(j_loader, "load_pipeline", lambda *a, **k: jpipe)
    argv = ["--model-dir", cli_files["ckpt"], "--f32", "--prompt", "a cat",
            "--height", "64", "--width", "64", "--output-dir",
            str(tmp_path / "x"), *flags]
    with pytest.raises(ValueError) as want:
        j_cli.main(argv)
    with pytest.raises(ValueError) as got:
        main(argv, device="cpu")
    assert str(got.value) == str(want.value)
    assert not os.path.exists(tmp_path / "x0.png")


@pytest.mark.parametrize("flags,error", [
    (["--ip-adapter", "x.safetensors"],
     "--ip-adapter, --ip-image-encoder and --ip-image go together"),
    (["--hires-scale", "2", "--reference-img", "x.png"],
     "--hires-scale is a txt2img feature (no --reference-img / "
     "--use-refiner)"),
    (["--vae-tile", "96", "--quantize", "int8"],
     "--quantize is not ported yet (module 14)"),
    (["--edit-image", "x.png", "--family", "flux"],
     "--family flux is not ported yet (module 13)"),
], ids=["ip_adapter", "hires_scale", "vae_tile", "edit_image"])
def test_cli_module10b_flags_still_exit_1(flags, error, capsys, tmp_path):
    """Module 11's flags run now (tests/test_torch_module11.py): an
    incomplete or misplaced one exits 1 with the reference CLI's message
    before any weights load, --vae-tile beside a flag that still waits
    names that flag's module, and --edit-image with --family flux
    (Kontext) names module 13."""
    from sdxl_tpu_torch.cli.sample import main

    argv = ["--random-weights", "--prompt", "a cat", "--output-dir",
            str(tmp_path / "x"), *flags]
    assert main(argv, device="cpu") == 1
    assert capsys.readouterr().err.strip() == f"error: {error}"
