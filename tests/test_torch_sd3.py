"""Module 13, SD3 / SD3.5: the T5 encoder, the MMDiT, flow matching, the
SD3 pipeline, its loader and LoRA, and the sample CLI's --family sd3,
against sdxl_tpu at tiny configs, f32 on the CPU.

- Configs: SD3's presets and constants equal the reference's
  (dataclasses.asdict).
- T5 (2 layers) and the text conditioning (CLIP-L and CLIP-G penultimate
  hiddens zero-padded to the T5 width, then T5's 256 tokens or zeros;
  the pooled pair): 2e-4 of max|ref|.
- The MMDiT forward (3 blocks, SD3.5's RMS q/k norm, one dual-attention
  block, the pre-only last block), from the reference's numpy tree
  carried across by io/bridge.py, the fused-qkv tree too, with and
  without skip_layers: 1e-3 of max|ref| with the plain attention.
- The cropped sin/cos grid and fm_schedule: 1e-6 relative; fm_window
  exactly; the Euler loop with the synthetic model of tests/test_sd3.py
  against goldens/k_samplers/fm_goldens.npz: 1e-5.
- Requests through the reference's SD3Pipeline entry points and the
  port's with the reference's draws injected (``draw_noise``): txt2img
  with CFG, with no_cfg, without T5, img2img, a crop-window inpaint with
  mask_blur and SLG on the dual-attention MMDiT. Final latents within
  1e-3 of max(1, |latent|), images within one u8 level.
- A tiny diffusers directory (tests/test_sd3_loader.py's writers) loaded
  bitwise as load_sd3_diffusers_dir loads it; the tokenizer_3 error; a
  diffusers transformer LoRA merged as the reference merges it.
- The CLI's --family sd3 with --no-t5 and with --slg-* against the
  in-memory pipeline, pixel for pixel, and its refusals against the
  reference CLI's messages.
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
import sdxl_tpu.pipeline.sd3 as j_sd3
import sdxl_tpu_torch.configs as tcfg
import sdxl_tpu_torch.pipeline.sd3 as t_sd3
from sdxl_tpu.io.lora import apply_lora_files as j_apply_lora_files
from sdxl_tpu.io.sd3 import load_sd3_diffusers_dir as j_load_dir
from sdxl_tpu.models.mmdit import cropped_pos_embed as j_pos
from sdxl_tpu.models.mmdit import fuse_mmdit_qkv, init_mmdit
from sdxl_tpu.models.mmdit import mmdit_forward as j_mmdit_forward
from sdxl_tpu.models.t5 import init_t5
from sdxl_tpu.models.t5 import t5_encode as j_t5_encode
from sdxl_tpu.pipeline.flow_match import fm_schedule as j_fm_schedule
from sdxl_tpu.tokenizer import ClipTokenizer, OpenClipTokenizer
from sdxl_tpu_torch.io.bridge import mmdit_state_dict, t5_state_dict
from sdxl_tpu_torch.io.lora import apply_lora_files
from sdxl_tpu_torch.models.clip import CLIPTextModel
from sdxl_tpu_torch.models.layers import init_reference_
from sdxl_tpu_torch.models.mmdit import MMDiT, cropped_pos_embed, mmdit_forward
from sdxl_tpu_torch.models.t5 import T5Encoder, t5_encode
from sdxl_tpu_torch.models.vae import VAEDecoder, VAEEncoder
from sdxl_tpu_torch.pipeline import flow_match as FM
from sdxl_tpu_torch.pipeline.sd3 import SD3Pipeline
from sdxl_tpu_torch.tokenizer import ClipTokenizer as TClipTokenizer
from sdxl_tpu_torch.tokenizer import OpenClipTokenizer as TOpenClipTokenizer
from tests.test_diffusers_sdxl import make_diffusers_vae_dict
from tests.test_sd3 import GOLDENS, synth_model
from tests.test_sd3_loader import (
    TINY_CLIP_G,
    TINY_CLIP_L,
    TINY_SD3_VAE,
    TINY_T5,
    _make_hf_clip_dict,
    make_diffusers_mmdit_dict,
    make_hf_t5_dict,
)
from tests.test_torch_module9 import CROP, NEGATIVE, PROMPT, RES, reference_tree
from tests.torch_parity import fast_reference_compiles  # noqa: F401

# One intra-op thread: the suite runs six workers on shared cores.
torch.set_num_threads(1)

CLIP_TOL, MODEL_TOL, SCHED_TOL, LOOP_TOL = 2e-4, 1e-3, 1e-6, 1e-5
# 3 blocks: SD3.5's RMS q/k norm, a dual-attention block (attn2 and the
# 9-way modulation), the context_pre_only last block; the tiny T5 width
MMDIT = tcfg.MMDiTConfig(
    num_layers=3, n_heads=4, head_dim=8, joint_attention_dim=96,
    pooled_projection_dim=80, pos_embed_max_size=16, time_sinusoid_dim=32,
    qk_norm="rms", dual_attention_layers=(1,))
T5 = tcfg.T5Config(**dataclasses.asdict(TINY_T5))
SLG = dict(slg_scale=2.8, slg_layers=(1,), slg_start=0.0, slg_stop=0.7)


def _jcfg(cfg, cls):
    return cls(**dataclasses.asdict(cfg))


def numpy_tree(tree, seed):
    """A reference tree as numpy arrays, every 1-D leaf (biases and gains)
    moved off 0 and 1."""
    rng = np.random.default_rng(seed)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, list):
            return [go(v) for v in t]
        a = np.asarray(t, np.float32)
        if a.ndim == 1:
            a = a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return go(tree)


def _close(got, want, tol, rel=True):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max() if rel else 1.0
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _moved(*modules, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in modules:
            for p in m.parameters():
                if p.dim() == 1:
                    p.add_(0.05 * torch.randn(p.shape, generator=g))


@pytest.fixture(scope="module")
def trees():
    """The reference's MMDiT and T5 trees (numpy) and the port's towers and
    VAE with their reference trees."""
    jm = _jcfg(MMDIT, jcfg.MMDiTConfig)
    mmdit = numpy_tree(init_mmdit(jax.random.PRNGKey(0), jm), 1)
    t5 = numpy_tree(init_t5(jax.random.PRNGKey(2), TINY_T5), 3)
    g = torch.Generator().manual_seed(4)
    clip_l = init_reference_(CLIPTextModel(TINY_CLIP_L, "cpu"), g).eval()
    clip_g = init_reference_(CLIPTextModel(TINY_CLIP_G, "cpu"), g).eval()
    vae = init_reference_(VAEDecoder(TINY_SD3_VAE, "cpu"), g, 0.05).eval()
    enc = init_reference_(VAEEncoder(TINY_SD3_VAE, "cpu"), g, 0.05).eval()
    _moved(clip_l, clip_g, vae, enc, seed=5)
    return dict(mmdit=mmdit, t5=t5, clip_l=clip_l, clip_g=clip_g, vae=vae,
                enc=enc, jm=jm)


def port_mmdit(tree, cfg=MMDIT):
    m = MMDiT(cfg, "cpu", torch.float32)
    m.load_state_dict(mmdit_state_dict(tree))
    return m.eval().requires_grad_(False)


def port_t5(tree):
    m = T5Encoder(T5, "cpu")
    m.load_state_dict(t5_state_dict(tree))
    return m.eval().requires_grad_(False)


STUB_T5 = FM.stub_t5_tokenizer(t_sd3.SD3_T5_TOKENS, TINY_T5.vocab_size)


@pytest.fixture(scope="module")
def pipes(trees):
    """(reference SD3Pipeline, port SD3Pipeline) on the same weights, with
    T5 and one stub tokenizer; and the pair without T5."""
    t = trees
    jkw = dict(
        mmdit_cfg=t["jm"], mmdit_params=t["mmdit"], clip_l_cfg=TINY_CLIP_L,
        clip_l_params=reference_tree(t["clip_l"]), clip_g_cfg=TINY_CLIP_G,
        clip_g_params=reference_tree(t["clip_g"]), vae_cfg=TINY_SD3_VAE,
        vae_params=reference_tree(t["vae"], t["enc"]),
        clip_tokenizer=ClipTokenizer(None),
        open_clip_tokenizer=OpenClipTokenizer(None),
        compute_dtype=jnp.float32)
    tkw = dict(
        vae=t["vae"], vae_encoder=t["enc"], scale_factor=tcfg.SD3_VAE_SCALE,
        shift_factor=tcfg.SD3_VAE_SHIFT, mmdit=port_mmdit(t["mmdit"]),
        clip_l=t["clip_l"], clip_g=t["clip_g"],
        clip_tokenizer=TClipTokenizer(), open_clip_tokenizer=TOpenClipTokenizer())
    with_t5 = (j_sd3.SD3Pipeline(t5_cfg=TINY_T5, t5_params=t["t5"],
                                 t5_tokenize=STUB_T5, **jkw),
               SD3Pipeline(t5=port_t5(t["t5"]), t5_tokenize=STUB_T5, **tkw))
    return dict(t5=with_t5, no_t5=(j_sd3.SD3Pipeline(**jkw),
                                   SD3Pipeline(**tkw)))


def inject_noise(monkeypatch):
    """The port's draws become the reference's: normal(PRNGKey(seed))."""
    def draw(shape, seed, device):
        return torch.from_numpy(np.asarray(jax.random.normal(
            jax.random.PRNGKey(seed), shape, jnp.float32)))
    monkeypatch.setattr(t_sd3, "draw_noise", draw)
    monkeypatch.setattr(FM, "draw_noise", draw)


def run_pair(monkeypatch, pair, method, *args, **kw):
    """(port images, port final latent, reference images, reference
    final latent) of one request."""
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


def assert_request(got, got_lat, want, want_lat):
    scale = max(1.0, float(np.abs(want_lat).max()))
    assert np.isfinite(got_lat).all() and got_lat.shape == want_lat.shape
    np.testing.assert_allclose(got_lat, want_lat, atol=1e-3 * scale, rtol=0)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.std() > 0
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# configs, schedules, the position grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "SD3_MEDIUM_MMDIT", "T5_XXL_CONFIG", "SD3_VAE_CONFIG_KW", "SD3_VAE_SCALE",
    "SD3_VAE_SHIFT", "SD3_FLOW_SHIFT"])
def test_sd3_configs_match_reference(name):
    got, want = getattr(tcfg, name), getattr(jcfg, name)
    if dataclasses.is_dataclass(want):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.__class__.__name__ == want.__class__.__name__
    else:
        assert got == want


def test_cropped_pos_grid_and_fm_schedule_match_reference():
    """The cropped grid (odd crops, the full grid) and fm_schedule at
    three lengths and shifts: 1e-6 relative; fm_window exactly."""
    for gh, gw in ((4, 6), (16, 16), (3, 9)):
        want = j_pos(MMDIT, gh, gw)
        np.testing.assert_allclose(cropped_pos_embed(MMDIT, gh, gw), want,
                                   rtol=SCHED_TOL, atol=0)
    for n, shift in ((28, 3.0), (4, 5.0), (13, 1.0)):
        for got, want in zip(FM.fm_schedule(n, shift),
                             j_fm_schedule(n, shift)):
            np.testing.assert_allclose(got, want, rtol=SCHED_TOL, atol=0)
    from sdxl_tpu.pipeline.flow_match import fm_window as j_window
    for n, s in ((28, 1.0), (28, 0.6), (10, 0.34), (10, 0.0), (7, 0.5)):
        assert FM.fm_window(n, s) == j_window(n, s)


def test_fm_loop_matches_goldens(monkeypatch):
    """fm_diffuse_latent (no CFG) with the synthetic velocity model
    against the transcription's trajectory end, 8 steps at shift 3: 1e-5;
    fm_add_noise against its golden."""
    g = np.load(GOLDENS)
    monkeypatch.setattr(FM, "mmdit_forward",
                        lambda model, x, t, *a, **k: torch.from_numpy(
                            synth_model(x.numpy(), float(t[0]))))

    class Stub:
        dtype = torch.float32

    x0 = torch.from_numpy(g["x0"]).reshape(1, 1, 1, -1)
    out = FM.fm_diffuse_latent(Stub(), x0, torch.zeros(1, 1, 1),
                               torch.zeros(1, 1), 1.0, n_steps=8, shift=3.0,
                               use_cfg=False)
    np.testing.assert_allclose(out.reshape(-1).numpy(), g["final"],
                               rtol=0, atol=LOOP_TOL)
    noised = FM.fm_add_noise(torch.from_numpy(g["clean"]),
                             torch.from_numpy(g["nz"]),
                             float(g["noised_sigma"]))
    np.testing.assert_allclose(noised.numpy(), g["noised"], rtol=0,
                               atol=LOOP_TOL)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------

def test_t5_encode_matches_reference(trees):
    ids = np.random.default_rng(6).integers(0, TINY_T5.vocab_size,
                                            (2, 40)).astype(np.int32)
    want = j_t5_encode(trees["t5"], TINY_T5, jnp.asarray(ids))
    with torch.no_grad():
        got = t5_encode(port_t5(trees["t5"]), torch.from_numpy(ids).long())
    _close(got, want, CLIP_TOL)


@pytest.mark.parametrize("case", ["plain", "skip_layer_1", "fused_qkv"])
def test_mmdit_forward_matches_reference(case, trees):
    """One call at fractional timesteps on a 6x4 patch grid (an off-square
    crop): 1e-3 of max|ref|."""
    tree = trees["mmdit"]
    port_tree = (jax.tree.map(np.asarray, fuse_mmdit_qkv(tree))
                 if case == "fused_qkv" else tree)
    skip = (1,) if case == "skip_layer_1" else ()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, 8, 16)).astype(np.float32)
    t = np.array([937.5, 212.25], np.float32)
    ctx = rng.standard_normal((2, 9, 96)).astype(np.float32)
    pooled = rng.standard_normal((2, 80)).astype(np.float32)
    want = jax.jit(j_mmdit_forward, static_argnums=(1, 6))(
        tree, trees["jm"], *map(jnp.asarray, (x, t, ctx, pooled)), skip)
    with torch.no_grad():
        got = mmdit_forward(port_mmdit(port_tree), *map(torch.from_numpy, (
            x, t, ctx, pooled)), skip_layers=skip)
    _close(got, want, MODEL_TOL)


def test_sd3_conditioning_matches_reference(pipes):
    """[uncond | cond] token stream (the padded CLIP pair, then T5's 256
    tokens, or zeros) and the pooled pair: 2e-4."""
    for key in ("t5", "no_t5"):
        jpipe, tpipe = pipes[key]
        want = jpipe.conditioning([PROMPT, "a dog"], NEGATIVE)
        got = tpipe.conditioning([PROMPT, "a dog"], NEGATIVE)
        assert got[0].shape == (4, 77 + 256, 96)
        for g, w in zip(got, want):
            _close(g, w, CLIP_TOL)


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

REQUESTS = {
    "txt2img_cfg": ("t5", "txt2img", dict(resolution=RES)),
    "txt2img_no_cfg": ("t5", "txt2img", dict(resolution=RES, no_cfg=True)),
    "txt2img_no_t5": ("no_t5", "txt2img", dict(resolution=RES)),
    "txt2img_slg_dual": ("t5", "txt2img", dict(resolution=RES, **SLG)),
}


@pytest.mark.parametrize("case", list(REQUESTS))
def test_sd3_txt2img_matches_reference(case, pipes, monkeypatch):
    key, method, kw = REQUESTS[case]
    out = run_pair(monkeypatch, pipes[key], method, PROMPT, n_steps=3,
                   guidance_scale=5.0, seed=3, negative_prompt=NEGATIVE,
                   **kw)
    assert_request(*out)


@pytest.fixture(scope="module")
def reference_image(pipes):
    img = pipes["no_t5"][1].txt2img(PROMPT, resolution=RES, n_steps=2,
                                    seed=9)
    return np.ascontiguousarray(img)


def test_sd3_img2img_matches_reference(pipes, reference_image, monkeypatch):
    """img2img at 0.6 of 5 steps: the encode's (z - shift) * scale, the
    straight-path noising and the schedule's tail."""
    out = run_pair(monkeypatch, pipes["t5"], "img2img", PROMPT,
                   reference_image, strength=0.6, n_steps=5,
                   guidance_scale=4.0, seed=4, negative_prompt=NEGATIVE)
    assert_request(*out)


def test_sd3_crop_inpaint_mask_blur_matches_reference(pipes, reference_image,
                                                      monkeypatch):
    """A crop-window inpaint with mask_blur 3 (the soft pin) at strength
    0.8: the re-noised reference pinned every step."""
    out = run_pair(monkeypatch, pipes["t5"], "inpaint", PROMPT,
                   reference_image, mask_blur=3.0, strength=0.8, n_steps=4,
                   guidance_scale=4.0, seed=6, negative_prompt=NEGATIVE,
                   **CROP)
    assert_request(*out)


# ---------------------------------------------------------------------------
# loading and LoRA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sd3_dir(tmp_path_factory, trees):
    """A diffusers-layout SD3 directory of the tiny weights (no
    tokenizer_3/)."""
    root = tmp_path_factory.mktemp("sd3_dir")

    def write(sub, d, config):
        os.makedirs(root / sub)
        st_save({k: np.ascontiguousarray(v, np.float32)
                 for k, v in d.items()},
                str(root / sub / "diffusion_pytorch_model.safetensors"))
        with open(root / sub / "config.json", "w") as f:
            json.dump(config, f)

    write("transformer", make_diffusers_mmdit_dict(MMDIT, trees["mmdit"]),
          {"attention_head_dim": 8, "num_attention_heads": 4,
           "pos_embed_max_size": 16, "num_layers": 3,
           "dual_attention_layers": [1]})
    for sub, model, cfg in (("text_encoder", trees["clip_l"], TINY_CLIP_L),
                            ("text_encoder_2", trees["clip_g"], TINY_CLIP_G)):
        write(sub, _make_hf_clip_dict(cfg, reference_tree(model)),
              {"hidden_size": cfg.n_state, "projection_dim": cfg.embed_dim,
               "num_attention_heads": cfg.n_head,
               "num_hidden_layers": cfg.n_layer,
               "hidden_act": "quick_gelu" if cfg.quick_gelu else "gelu"})
    write("text_encoder_3", make_hf_t5_dict(TINY_T5, trees["t5"]),
          {"d_kv": 8, "num_heads": 4, "relative_attention_num_buckets": 8,
           "relative_attention_max_distance": 16})
    write("vae", make_diffusers_vae_dict(reference_tree(trees["vae"],
                                                        trees["enc"])),
          {"norm_num_groups": 4})
    os.makedirs(root / "scheduler")
    with open(root / "scheduler" / "scheduler_config.json", "w") as f:
        json.dump({"shift": 3.0}, f)
    return str(root)


def test_sd3_dir_loads_bitwise_as_reference(sd3_dir):
    """load_sd3_pipeline against load_sd3_diffusers_dir on one directory:
    the MMDiT, T5, both towers and the VAE bitwise equal through the
    bridge; configs and the flow shift equal; T5 without tokenizer_3/
    refused as the reference refuses it."""
    from sdxl_tpu_torch.io.bridge import tree_to_state_dict

    (jm_cfg, jm, _, jcl, _, jcg, jvae_cfg, jvae, jt5_cfg, jt5, _,
     jshift) = j_load_dir(sd3_dir, jnp.float32)
    with pytest.raises(ValueError, match="tokenizer_3"):
        t_sd3.load_sd3_pipeline(sd3_dir, torch.float32, device="cpu")
    pipe = t_sd3.load_sd3_pipeline(sd3_dir, torch.float32, device="cpu",
                                   t5_tokenize=STUB_T5)
    assert dataclasses.asdict(pipe.mmdit.cfg) == dataclasses.asdict(jm_cfg)
    assert dataclasses.asdict(pipe.t5.cfg) == dataclasses.asdict(jt5_cfg)
    assert dataclasses.asdict(pipe.vae.cfg) == dataclasses.asdict(jvae_cfg)
    assert pipe.flow_shift == jshift
    tree = jax.tree.map(np.asarray, {"m": jm, "t": jt5, "l": jcl, "g": jcg,
                                     "v": jvae})
    for model, want in ((pipe.mmdit, mmdit_state_dict(tree["m"])),
                        (pipe.t5, t5_state_dict(tree["t"])),
                        (pipe.clip_l, tree_to_state_dict(tree["l"])),
                        (pipe.clip_g, tree_to_state_dict(tree["g"]))):
        got = model.state_dict()
        assert sorted(got) == sorted(want)
        for k in got:
            assert torch.equal(got[k], want[k]), k
    vae = {**pipe.vae.state_dict(), **pipe.vae_encoder.state_dict()}
    want = tree_to_state_dict(tree["v"])
    assert sorted(vae) == sorted(want)
    assert all(torch.equal(vae[k], want[k]) for k in vae)
    no_t5 = t_sd3.load_sd3_pipeline(sd3_dir, torch.float32, load_t5=False,
                                    device="cpu")
    assert no_t5.t5 is None


def test_sd3_transformer_lora_merges_as_reference(sd3_dir, tmp_path):
    """A peft-keyed transformer LoRA (the joint attention, attn2, both
    MLPs, a modulation and proj_out) merged into the loaded MMDiT equals
    the reference's merge: 1e-6 relative, 1e-7 absolute."""
    rng = np.random.default_rng(11)
    h, r = MMDIT.hidden, 4
    mods = {"transformer_blocks.0.attn.to_q": (h, h),
            "transformer_blocks.1.attn.add_k_proj": (h, h),
            "transformer_blocks.1.attn2.to_out.0": (h, h),
            "transformer_blocks.0.ff.net.0.proj": (h, 4 * h),
            "transformer_blocks.1.ff_context.net.2": (4 * h, h),
            "transformer_blocks.2.norm1.linear": (h, 6 * h),
            "proj_out": (h, 64)}
    t = {}
    for name, (d_in, d_out) in mods.items():
        t[f"transformer.{name}.lora_A.weight"] = rng.standard_normal(
            (r, d_in)).astype(np.float32)
        t[f"transformer.{name}.lora_B.weight"] = rng.standard_normal(
            (d_out, r)).astype(np.float32) * 0.1
    path = str(tmp_path / "lora.safetensors")
    st_save(t, path)
    _, jm, *_ = j_load_dir(sd3_dir, jnp.float32, load_t5=False)
    jm = jax.tree.map(np.asarray, jm)
    j_apply_lora_files([(path, 0.7)], transformer=jm)
    pipe = t_sd3.load_sd3_pipeline(sd3_dir, torch.float32, load_t5=False,
                                   device="cpu")
    before = {k: v.clone() for k, v in pipe.mmdit.state_dict().items()}
    apply_lora_files([(path, 0.7)], transformer=pipe.mmdit)
    got, want = pipe.mmdit.state_dict(), mmdit_state_dict(jm)
    changed = [k for k in got if not torch.equal(got[k], before[k])]
    assert len(changed) == len(mods)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI_CASES = {
    "no_t5": ([], {}),
    "no_t5_slg": (["--slg-scale", "2.8", "--slg-layers", "1"],
                  dict(slg_scale=2.8, slg_layers=(1,))),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_family_sd3_matches_the_in_memory_pipeline(case, sd3_dir,
                                                       tmp_path):
    """main(..., device="cpu") with --family sd3 --no-t5 on the tiny
    directory writes, pixel for pixel, what the loaded pipeline returns
    for the same request (6 steps: SLG's default window holds step 1)."""
    from sdxl_tpu_torch.cli.sample import main
    from sdxl_tpu_torch.io.images import load_images

    flags, kw = CLI_CASES[case]
    out = str(tmp_path / "img")
    argv = ["--family", "sd3", "--no-t5", "--model-dir", sd3_dir, "--f32",
            "--prompt", PROMPT, "--height", "64", "--width", "64", "-steps",
            "6", "-gs", "4", "--seed", "2", "--negative-prompt", NEGATIVE,
            "--output-dir", out, *flags]
    assert main(argv, device="cpu") == 0
    pipe = t_sd3.load_sd3_pipeline(sd3_dir, torch.float32, load_t5=False,
                                   device="cpu")
    want = pipe.txt2img([PROMPT], resolution=RES, n_steps=6,
                        guidance_scale=4.0, seed=2,
                        negative_prompt=NEGATIVE, **kw)
    np.testing.assert_array_equal(load_images([f"{out}0.png"]), want)


CLI_ERRORS = {
    "sampler": ["--family", "sd3", "--sampler", "euler"],
    "edit_and_ddim_eta": ["--family", "sd3", "--edit-image", "x.png",
                          "--ddim-eta", "1"],
    "true_cfg": ["--family", "sd3", "--true-cfg-scale", "4"],
    "mask_with_img2img": ["--family", "sd3", "--reference-img", "r.png",
                          "--img2img-strength", "0.5", "--mask-blur", "2"],
    "no_model": ["--family", "sd3"],
    "slg_on_sdxl": ["--random-weights", "--slg-scale", "2.8"],
}


@pytest.mark.parametrize("case", list(CLI_ERRORS))
def test_cli_sd3_refusals_are_the_references(case, capsys, tmp_path):
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
