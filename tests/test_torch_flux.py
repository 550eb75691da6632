"""Module 13, FLUX.1: the transformer (RoPE, double and single blocks,
the guidance embedding, Kontext's reference stream), its schedule, the
FLUX.1 pipeline with true CFG and Kontext, its loader and kohya BFL LoRA,
the LANCZOS resize and the sample CLI's --family flux, against sdxl_tpu
at tiny configs, f32 on the CPU.

- Configs: FLUX.1's presets and constants equal the reference's.
- rope_tables (with and without Kontext's second grid) and flux_schedule
  (dynamic and static shift): 1e-6 relative; apply_rope: 1e-6 of max.
- The forward (1 double and 2 single blocks), dev with a Kontext
  reference latent and schnell without guidance, from the reference's
  numpy tree carried across by io/bridge.py: 1e-3 of max|ref| with the
  plain attention.
- Requests through the reference's FluxPipeline entry points and the
  port's with the reference's draws injected (``draw_noise``): dev
  txt2img, schnell (static shift), true CFG with a negative prompt,
  img2img, a mask-image inpaint and a Kontext edit. Final latents within
  1e-3 of max(1, |latent|), images within one u8 level.
- A tiny diffusers directory (tests/test_flux_loader.py's writers, the
  VAE without quant convs) loaded bitwise as load_flux_diffusers_dir
  loads it, with the tokenizer_2 error; a kohya BFL-named LoRA (fused
  qkv and linear1 rows split onto the projections) merged as the
  reference merges it.
- resize_lanczos against PIL.Image.LANCZOS: within one u8 level.
- The CLI's --family flux --random-weights (the family presets patched
  to the tiny configs) with --true-cfg-scale and with --edit-image
  against the in-memory pipeline, pixel for pixel, and its refusals
  against the reference CLI's messages.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as st_save

import sdxl_tpu.configs as jcfg
import sdxl_tpu.pipeline.flux as j_flux
import sdxl_tpu_torch.configs as tcfg
import sdxl_tpu_torch.pipeline.flux as t_flux
from sdxl_tpu.io.flux import load_flux_diffusers_dir as j_load_dir
from sdxl_tpu.io.lora import apply_lora_files as j_apply_lora_files
from sdxl_tpu.models.flux import apply_rope as j_apply_rope
from sdxl_tpu.models.flux import flux_forward as j_flux_forward
from sdxl_tpu.models.flux import init_flux
from sdxl_tpu.models.flux import rope_tables as j_rope_tables
from sdxl_tpu.models.t5 import init_t5
from sdxl_tpu.tokenizer import ClipTokenizer
from sdxl_tpu_torch.io.bridge import flux_state_dict, t5_state_dict
from sdxl_tpu_torch.io.images import resize_lanczos
from sdxl_tpu_torch.io.lora import apply_lora_files
from sdxl_tpu_torch.models.clip import CLIPTextModel
from sdxl_tpu_torch.models.flux import Flux, apply_rope, flux_forward
from sdxl_tpu_torch.models.flux import rope_tables
from sdxl_tpu_torch.models.layers import init_reference_
from sdxl_tpu_torch.models.t5 import T5Encoder
from sdxl_tpu_torch.models.vae import VAEDecoder, VAEEncoder
from sdxl_tpu_torch.pipeline import flow_match as FM
from sdxl_tpu_torch.pipeline.flux import FluxPipeline
from sdxl_tpu_torch.tokenizer import ClipTokenizer as TClipTokenizer
from tests.test_diffusers_sdxl import make_diffusers_vae_dict
from tests.test_flux_loader import TINY_CLIP_L, make_diffusers_flux_dict
from tests.test_sd3_loader import (
    TINY_SD3_VAE,
    _make_hf_clip_dict,
    make_hf_t5_dict,
)
from tests.test_torch_module9 import NEGATIVE, PROMPT, RES, reference_tree
from tests.test_torch_sd3 import (
    _close,
    _jcfg,
    _moved,
    assert_request,
    numpy_tree,
)
from tests.torch_parity import fast_reference_compiles  # noqa: F401

torch.set_num_threads(1)

MODEL_TOL, SCHED_TOL = 1e-3, 1e-6
# 1 double and 2 single blocks over a 16-channel latent packed to 64;
# the pooled width is CLIP-L's unprojected hidden
FLUX = tcfg.FluxConfig(
    in_channels=64, num_layers=1, num_single_layers=2, n_heads=2,
    head_dim=16, joint_attention_dim=48, pooled_projection_dim=32,
    axes_dims=(4, 6, 6), time_sinusoid_dim=32)
SCHNELL = dataclasses.replace(FLUX, guidance_embeds=False)
T5 = tcfg.T5Config(vocab_size=128, d_model=48, d_kv=8, d_ff=64, n_heads=4,
                   n_layers=2, relative_buckets=8, relative_max_distance=16)
JT5 = _jcfg(T5, jcfg.T5Config)
T5_TOKENS = 16
STUB_T5 = FM.stub_t5_tokenizer(T5_TOKENS, T5.vocab_size)


def port_flux(tree, cfg):
    m = Flux(cfg, "cpu", torch.float32)
    m.load_state_dict(flux_state_dict(tree))
    return m.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def trees():
    g = torch.Generator().manual_seed(21)
    clip = init_reference_(CLIPTextModel(TINY_CLIP_L, "cpu"), g).eval()
    vae = init_reference_(VAEDecoder(TINY_SD3_VAE, "cpu"), g, 0.05).eval()
    enc = init_reference_(VAEEncoder(TINY_SD3_VAE, "cpu"), g, 0.05).eval()
    _moved(clip, vae, enc, seed=22)
    return dict(
        dev=numpy_tree(init_flux(jax.random.PRNGKey(0),
                                 _jcfg(FLUX, jcfg.FluxConfig)), 1),
        schnell=numpy_tree(init_flux(jax.random.PRNGKey(1),
                                     _jcfg(SCHNELL, jcfg.FluxConfig)), 2),
        t5=numpy_tree(init_t5(jax.random.PRNGKey(2), JT5), 3),
        clip=clip, vae=vae, enc=enc)


def _pair(t, variant):
    cfg = FLUX if variant == "dev" else SCHNELL
    t5 = T5Encoder(T5, "cpu")
    t5.load_state_dict(t5_state_dict(t["t5"]))
    shifts = dict(dynamic_shifting=variant == "dev")
    j = j_flux.FluxPipeline(
        flux_cfg=_jcfg(cfg, jcfg.FluxConfig), flux_params=t[variant],
        clip_cfg=TINY_CLIP_L, clip_params=reference_tree(t["clip"]),
        t5_cfg=JT5, t5_params=t["t5"], vae_cfg=TINY_SD3_VAE,
        vae_params=reference_tree(t["vae"], t["enc"]), t5_tokenize=STUB_T5,
        clip_tokenizer=ClipTokenizer(None), t5_tokens=T5_TOKENS,
        compute_dtype=jnp.float32, **shifts)
    p = FluxPipeline(
        vae=t["vae"], vae_encoder=t["enc"], scale_factor=tcfg.FLUX_VAE_SCALE,
        shift_factor=tcfg.FLUX_VAE_SHIFT, flux=port_flux(t[variant], cfg),
        clip=t["clip"], t5=t5.eval(), t5_tokenize=STUB_T5,
        clip_tokenizer=TClipTokenizer(), t5_tokens=T5_TOKENS, **shifts)
    return j, p


@pytest.fixture(scope="module")
def pipes(trees):
    return {v: _pair(trees, v) for v in ("dev", "schnell")}


def inject_noise(monkeypatch):
    def draw(shape, seed, device):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(seed), shape, jnp.float32)))
    monkeypatch.setattr(t_flux, "draw_noise", draw)
    monkeypatch.setattr(FM, "draw_noise", draw)


def run_pair(monkeypatch, pair, method, *args, **kw):
    jpipe, tpipe = pair
    seen = []
    real = jpipe._decode
    monkeypatch.setattr(jpipe, "_decode",
                        lambda lat: (seen.append(np.asarray(lat)),
                                     real(lat))[1])
    want = np.asarray(getattr(jpipe, method)(*args, **kw))
    inject_noise(monkeypatch)
    got = getattr(tpipe, method)(*args, **kw)
    return got, tpipe.last_latent.numpy(), want, seen[-1]


# ---------------------------------------------------------------------------
# configs, tables, schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "FLUX_DEV", "FLUX_SCHNELL", "FLUX_VAE_SCALE", "FLUX_VAE_SHIFT",
    "FLUX_BASE_SHIFT", "FLUX_MAX_SHIFT"])
def test_flux_configs_match_reference(name):
    got, want = getattr(tcfg, name), getattr(jcfg, name)
    if dataclasses.is_dataclass(want):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    else:
        assert got == want


def test_rope_tables_apply_rope_and_schedule_match_reference():
    """rope_tables at a text + image grid, with Kontext's second grid
    and at FLUX.1's published axes; flux_schedule dynamic (three sizes)
    and static: 1e-6 relative. apply_rope: 1e-6 of max|ref|."""
    jf = _jcfg(FLUX, jcfg.FluxConfig)
    for cfg, jc in ((FLUX, jf), (tcfg.FLUX_DEV, jcfg.FLUX_DEV)):
        for args in ((4, 6, 5), (4, 6, 5, 3, 2), (64, 64, 512)):
            for got, want in zip(rope_tables(cfg, *args),
                                 j_rope_tables(jc, *args)):
                np.testing.assert_allclose(got, want, rtol=SCHED_TOL,
                                           atol=0)
    for n, seq, dyn, shift in ((28, 4096, True, 1.0), (4, 256, True, 1.0),
                               (13, 1000, True, 1.0), (4, 4096, False, 1.0),
                               (6, 4096, False, 3.0)):
        for got, want in zip(t_flux.flux_schedule(n, seq, dynamic=dyn,
                                                  shift=shift),
                             j_flux.flux_schedule(n, seq, dynamic=dyn,
                                                  shift=shift)):
            np.testing.assert_allclose(got, want, rtol=SCHED_TOL, atol=0)
    cos, sin = rope_tables(FLUX, 2, 3, 4)
    x = np.random.default_rng(0).standard_normal((2, 10, 2, 16)).astype(
        np.float32)
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(cos),
                     torch.from_numpy(sin))
    _close(got, want, SCHED_TOL)


@pytest.mark.parametrize("variant", ["dev_kontext", "schnell"])
def test_flux_forward_matches_reference(variant, trees):
    """One call at fractional timesteps on an 8x6 latent (a 4x3 packed
    grid) with 7 text tokens; dev with guidance and a 4x8 Kontext
    reference latent, schnell without either: 1e-3 of max|ref|."""
    dev = variant != "schnell"
    cfg = FLUX if dev else SCHNELL
    tree = trees["dev" if dev else "schnell"]
    rng = np.random.default_rng(8)
    lat = rng.standard_normal((2, 8, 6, 16)).astype(np.float32)
    t = np.array([937.5, 212.25], np.float32)
    ctx = rng.standard_normal((2, 7, 48)).astype(np.float32)
    pooled = rng.standard_normal((2, 32)).astype(np.float32)
    g = np.array([3500.0, 2500.0], np.float32) if dev else None
    cond = rng.standard_normal((2, 4, 8, 16)).astype(np.float32) \
        if dev else None
    want = jax.jit(j_flux_forward, static_argnums=1)(
        tree, _jcfg(cfg, jcfg.FluxConfig), *map(jnp.asarray, (
            lat, t, ctx, pooled)),
        guidance=None if g is None else jnp.asarray(g),
        cond_latent=None if cond is None else jnp.asarray(cond))
    with torch.no_grad():
        got = flux_forward(
            port_flux(tree, cfg), *map(torch.from_numpy, (lat, t, ctx,
                                                          pooled)),
            guidance=None if g is None else torch.from_numpy(g),
            cond_latent=None if cond is None else torch.from_numpy(cond))
    _close(got, want, MODEL_TOL)


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

REQUESTS = {
    "dev": ("dev", {}),
    "schnell": ("schnell", {}),
    "true_cfg": ("dev", dict(negative_prompt=NEGATIVE, true_cfg_scale=4.0)),
}


@pytest.mark.parametrize("case", list(REQUESTS))
def test_flux_txt2img_matches_reference(case, pipes, monkeypatch):
    variant, kw = REQUESTS[case]
    out = run_pair(monkeypatch, pipes[variant], "txt2img", PROMPT,
                   resolution=RES, n_steps=3, guidance_scale=3.5, seed=3,
                   **kw)
    assert_request(*out)


@pytest.fixture(scope="module")
def reference_image(pipes):
    img = pipes["schnell"][1].txt2img(PROMPT, resolution=RES, n_steps=2,
                                      seed=9)
    return np.ascontiguousarray(img)


def test_flux_img2img_matches_reference(pipes, reference_image,
                                        monkeypatch):
    out = run_pair(monkeypatch, pipes["dev"], "img2img", PROMPT,
                   reference_image, strength=0.6, n_steps=5,
                   guidance_scale=3.5, seed=4)
    assert_request(*out)


def test_flux_mask_inpaint_matches_reference(pipes, reference_image,
                                             monkeypatch):
    mask = np.zeros((64, 64), np.uint8)
    mask[8:40, 20:56] = 255
    out = run_pair(monkeypatch, pipes["dev"], "inpaint", PROMPT,
                   reference_image, mask_image=mask, n_steps=3,
                   guidance_scale=3.5, seed=5)
    assert_request(*out)


def test_flux_kontext_matches_reference(pipes, reference_image,
                                        monkeypatch):
    """Kontext on a 48x64 edit image (its own size): the clean reference
    latent after the target tokens, id axis 0 = 1."""
    edit = np.ascontiguousarray(reference_image[:, :48])
    out = run_pair(monkeypatch, pipes["dev"], "kontext", PROMPT, edit,
                   n_steps=3, guidance_scale=2.5, seed=6)
    assert_request(*out)


# ---------------------------------------------------------------------------
# loading, LoRA, the resize
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flux_dir(tmp_path_factory, trees):
    """A diffusers-layout FLUX.1-dev directory of the tiny weights, its
    VAE without quant convs, no tokenizer_2/."""
    root = tmp_path_factory.mktemp("flux_dir")

    def write(sub, d, config):
        os.makedirs(root / sub)
        st_save({k: np.ascontiguousarray(v, np.float32)
                 for k, v in d.items()},
                str(root / sub / "diffusion_pytorch_model.safetensors"))
        with open(root / sub / "config.json", "w") as f:
            json.dump(config, f)

    write("transformer", make_diffusers_flux_dict(FLUX, trees["dev"]),
          {"attention_head_dim": 16, "num_attention_heads": 2,
           "axes_dims_rope": [4, 6, 6]})
    write("text_encoder", _make_hf_clip_dict(
        TINY_CLIP_L, reference_tree(trees["clip"])),
        {"hidden_size": 32, "num_attention_heads": 4,
         "num_hidden_layers": 2, "hidden_act": "quick_gelu"})
    write("text_encoder_2", make_hf_t5_dict(JT5, trees["t5"]),
          {"d_kv": 8, "num_heads": 4, "relative_attention_num_buckets": 8,
           "relative_attention_max_distance": 16})
    vd = make_diffusers_vae_dict(reference_tree(trees["vae"], trees["enc"]))
    write("vae", {k: v for k, v in vd.items() if "quant_conv" not in k},
          {"norm_num_groups": 4})
    os.makedirs(root / "scheduler")
    with open(root / "scheduler" / "scheduler_config.json", "w") as f:
        json.dump({"base_shift": 0.5, "max_shift": 1.15, "shift": 3.0,
                   "use_dynamic_shifting": True}, f)
    return str(root)


def test_flux_dir_loads_bitwise_as_reference(flux_dir):
    """load_flux_pipeline against load_flux_diffusers_dir: the
    transformer, T5, CLIP-L and the quant-conv-free VAE bitwise equal
    through the bridge, loaded strictly; the configs and scheduler keys;
    tokenizer_2/ missing refused as the reference refuses it."""
    from sdxl_tpu_torch.io.bridge import tree_to_state_dict

    with pytest.raises(ValueError, match="tokenizer_2"):
        t_flux.load_flux_pipeline(flux_dir, torch.float32, device="cpu")
    (jf_cfg, jf, _, jclip, jt5_cfg, jt5, _, jvae_cfg, jvae,
     sched) = j_load_dir(flux_dir, jnp.float32, t5_tokenize=STUB_T5)
    pipe = t_flux.load_flux_pipeline(flux_dir, torch.float32, device="cpu",
                                     t5_tokenize=STUB_T5)
    assert dataclasses.asdict(pipe.flux.cfg) == dataclasses.asdict(jf_cfg)
    assert dataclasses.asdict(pipe.t5.cfg) == dataclasses.asdict(jt5_cfg)
    assert dataclasses.asdict(pipe.vae.cfg) == dataclasses.asdict(jvae_cfg)
    assert pipe.vae.post_quant_conv is None
    assert pipe.vae_encoder.quant_conv is None
    assert (pipe.base_shift, pipe.max_shift, pipe.static_shift) == (
        sched["base_shift"], sched["max_shift"], sched["shift"])
    tree = jax.tree.map(np.asarray, {"f": jf, "t": jt5, "c": jclip,
                                     "v": jvae})
    vae = {**pipe.vae.state_dict(), **pipe.vae_encoder.state_dict()}
    for got, want in ((pipe.flux.state_dict(), flux_state_dict(tree["f"])),
                      (pipe.t5.state_dict(), t5_state_dict(tree["t"])),
                      (pipe.clip.state_dict(), tree_to_state_dict(tree["c"])),
                      (vae, tree_to_state_dict(tree["v"]))):
        assert sorted(got) == sorted(want)
        for k in got:
            assert torch.equal(got[k], want[k]), k


def test_flux_bfl_lora_merges_as_reference(flux_dir, tmp_path):
    """A kohya BFL-named LoRA: a double block's img qkv and txt qkv (each
    split in three), its mlp_0 and mod_lin, a single block's linear1 (q,
    k, v and proj_mlp rows) and linear2, alpha 2 at rank 4, merged at
    0.8: equal to the reference's merge, 1e-6 relative, 1e-7 absolute."""
    rng = np.random.default_rng(12)
    h, r = FLUX.hidden, 4
    mods = {"double_blocks_0_img_attn_qkv": (h, 3 * h),
            "double_blocks_0_txt_attn_qkv": (h, 3 * h),
            "double_blocks_0_txt_mlp_0": (h, 4 * h),
            "double_blocks_0_img_mod_lin": (h, 6 * h),
            "single_blocks_1_linear1": (h, 7 * h),
            "single_blocks_0_linear2": (5 * h, h)}
    t = {}
    for name, (d_in, d_out) in mods.items():
        t[f"lora_unet_{name}.lora_down.weight"] = rng.standard_normal(
            (r, d_in)).astype(np.float32)
        t[f"lora_unet_{name}.lora_up.weight"] = rng.standard_normal(
            (d_out, r)).astype(np.float32) * 0.1
        t[f"lora_unet_{name}.alpha"] = np.asarray(2.0, np.float32)
    path = str(tmp_path / "bfl.safetensors")
    st_save(t, path)
    _, jf, *_ = j_load_dir(flux_dir, jnp.float32, t5_tokenize=STUB_T5)
    jf = jax.tree.map(np.asarray, jf)
    j_apply_lora_files([(path, 0.8)], transformer=jf)
    pipe = t_flux.load_flux_pipeline(flux_dir, torch.float32, device="cpu",
                                     t5_tokenize=STUB_T5)
    before = {k: v.clone() for k, v in pipe.flux.state_dict().items()}
    apply_lora_files([(path, 0.8)], transformer=pipe.flux)
    got, want = pipe.flux.state_dict(), flux_state_dict(jf)
    changed = [k for k in got if not torch.equal(got[k], before[k])]
    assert len(changed) == 3 + 3 + 1 + 1 + 4 + 1
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("size", [(1000, 744, 1184, 880), (37, 50, 32, 16),
                                  (100, 33, 160, 48)],
                         ids=["kontext_1mp", "down", "up_and_down"])
def test_resize_lanczos_matches_pil(size):
    from PIL import Image

    w, h, nw, nh = size
    rng = np.random.default_rng(w)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img = np.cumsum(img, axis=1, dtype=np.int64) // np.arange(1, w + 1)[
        None, :, None]  # smooth ramps with noise: ringing and clipping
    img = img.astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((nw, nh), Image.LANCZOS))
    got = resize_lanczos(img, (nw, nh))
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def tiny_presets(monkeypatch):
    """The CLI's FLUX.1 presets as the tiny configs."""
    monkeypatch.setattr(t_flux, "FluxConfig", lambda: FLUX)
    monkeypatch.setattr(t_flux, "T5Config", lambda: T5)
    monkeypatch.setattr(t_flux, "CLIP_VIT_L_CONFIG", TINY_CLIP_L)
    monkeypatch.setattr(t_flux, "sd3_vae_config", lambda: TINY_SD3_VAE)


CLI_CASES = {
    "true_cfg": (["--negative-prompt", NEGATIVE, "--true-cfg-scale", "4"],
                 "txt2img"),
    "kontext": (["--edit-image", "{edit}"], "kontext"),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_family_flux_matches_the_in_memory_pipeline(
        case, tiny_presets, tmp_path):
    """main(..., device="cpu") with --family flux --random-weights writes,
    pixel for pixel, what random_flux_pipeline's pipeline returns for the
    same request: true CFG over a negative prompt, and a Kontext edit of
    a 64x48 PNG."""
    from sdxl_tpu_torch.cli.sample import main
    from sdxl_tpu_torch.io.images import load_images, save_images

    flags, method = CLI_CASES[case]
    edit = np.random.default_rng(3).integers(0, 256, (1, 64, 48, 3),
                                             dtype=np.uint8)
    edit_path = save_images(edit, str(tmp_path / "edit"))[0]
    out = str(tmp_path / "img")
    argv = ["--family", "flux", "--random-weights", "--f32", "--prompt",
            PROMPT, "--height", "64", "--width", "64", "-steps", "2",
            "--seed", "2", "--output-dir", out,
            *(f.format(edit=edit_path) for f in flags)]
    assert main(argv, device="cpu") == 0
    pipe = t_flux.random_flux_pipeline(device="cpu",
                                       flux_dtype=torch.float32)
    if method == "kontext":
        want = pipe.kontext([PROMPT], load_images([edit_path]), n_steps=2,
                            guidance_scale=7.5, seed=2)
    else:
        want = pipe.txt2img([PROMPT], resolution=RES, n_steps=2,
                            guidance_scale=7.5, seed=2,
                            negative_prompt=NEGATIVE, true_cfg_scale=4.0)
    np.testing.assert_array_equal(load_images([f"{out}0.png"]), want)


CLI_ERRORS = {
    "negative_without_true_cfg": ["--family", "flux", "--negative-prompt",
                                  "x"],
    "no_t5_and_slg": ["--family", "flux", "--no-t5", "--slg-scale", "2"],
    "no_cfg_vae_bf16": ["--family", "flux", "--no-cfg", "--vae-bf16"],
    "kontext_sampler": ["--family", "flux", "--edit-image", "e.png",
                        "--sampler", "dpmpp"],
    "true_cfg_on_sdxl": ["--random-weights", "--true-cfg-scale", "4"],
}


@pytest.mark.parametrize("case", list(CLI_ERRORS))
def test_cli_flux_refusals_are_the_references(case, capsys, tmp_path):
    """Each bad combination exits 1 with the reference CLI's own error
    line, before any weights load, and writes no image."""
    import sdxl_tpu.cli.sample as j_cli
    from sdxl_tpu_torch.cli.sample import main

    argv = ["--prompt", "a cat", "--output-dir", str(tmp_path / "x"),
            *CLI_ERRORS[case]]

    def error_line(rc):
        assert rc == 1
        lines = [ln for ln in capsys.readouterr().err.splitlines()
                 if ln.startswith("error:")]
        assert len(lines) == 1
        return lines[0]

    want = error_line(j_cli.main(argv))
    assert error_line(main(argv, device="cpu")) == want
    assert not os.path.exists(tmp_path / "x0.png")
