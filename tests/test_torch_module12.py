"""Module 12: SD 1.x / 2.x (single-tower conditioning, clip_skip,
v-prediction, the SD1 loaders and writer, LoRA and textual inversion on
one tower, the sample CLI's --family sd1|sd2 and --clip-skip) against
sdxl_tpu at tiny configs, f32 on the CPU.

- The towers: clip_final_hidden, and the three conditioning modes (SD
  1.x's final LayerNorm, SD 2.x's penultimate hidden, each with and
  without clip_skip, diffusers' semantics on the final-LN path) and
  SDXL's clip_skip in both towers, against the reference's functions:
  2e-4 (the reference's CLIP bound, goldens/full_scale).
- Requests through the reference's SD1Pipeline entry points and the
  port's with the reference's draws injected (as
  tests/test_torch_module11.py): SD 1.x txt2img (DDIM), dpmpp + karras
  with a ControlNet and an IP-Adapter, img2img and an off-bucket crop
  inpaint on a 9-channel UNet read from a single .ckpt file; SD 2.x
  v-prediction through DDIM and through euler on the karras schedule
  (fractional timesteps) with DeepCache; an SDXL v-prediction diffusers
  directory through load_pipeline. Final latents within 1e-3 of max(1,
  |latent|) and images within one u8 level, PR 14's bounds. The requests
  run tests/test_sd1.py's 4-level plan with its one transformer moved to
  the middle block: the reference's loops compile in about 3 s each
  instead of 8; the LoRA test keeps the literal plan (transformers at
  levels 0-2).
- ays resolves to the SD 1.x table (ays_sd15): the grid equals the
  reference's exactly.
- The loaders, bitwise against the reference's readers:
  load_sd1_single_file (SD 1.x's HF CLIP in a .ckpt, SD 2.x's OpenCLIP
  with its fused in_proj in a .safetensors) and load_sd1_diffusers_dir on
  the reference's writer's directory and on the port's writer's; the
  tokenizer given that directory pads as the reference's does.
- A kohya SD 1.x LoRA (the UNet resolver on the 4-level plan's
  down_blocks.3 and up_blocks.0, the one tower) merged as the
  reference's (1e-6 relative, 1e-7 absolute), and a single-tower textual
  inversion's conditioning (2e-4).
- The v->eps conversion against goldens/full_scale/sd1_unet.npz (no UNet
  run: the UNet call is replaced by the golden's raw output), 1e-6.
- The CLI's --family sd1|sd2 (the family presets patched to the tiny
  configs) and --clip-skip against the in-memory pipeline, pixel for
  pixel, and its refusals against the reference CLI's messages.
- The reference's full-width goldens (sd1_unet.npz, sd2_clip.npz) through
  the port, gated by SDXL_TPU_FULL_SCALE as tests/test_full_scale_golden.py
  gates them: 2e-3 (UNet) and 2e-4 (CLIP).
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

import sdxl_tpu.pipeline.sampler as R
import sdxl_tpu_torch.pipeline.pipeline as tpipeline
from sdxl_tpu.configs import AutoencoderConfig, CLIPConfig, EmbedderConfig
from sdxl_tpu.configs import DiffuserConfig as JDiffuserConfig
from sdxl_tpu.io.diffusers_sdxl import load_sd1_diffusers_dir as j_load_dir
from sdxl_tpu.io.diffusers_write import (
    write_diffusers_pipeline_dir as j_write_sdxl_dir,
)
from sdxl_tpu.io.diffusers_write import (
    write_sd1_diffusers_pipeline_dir as j_write_dir,
)
from sdxl_tpu.io.hf_sdxl import load_sd1_single_file as j_load_single
from sdxl_tpu.io.lora import apply_lora_files as j_apply_lora_files
from sdxl_tpu.models.clip import clip_final_hidden as j_final_hidden
from sdxl_tpu.io.diffusers_sdxl import (
    infer_sdxl_configs_from_diffusers_dir as j_infer,
)
from sdxl_tpu.io.diffusers_sdxl import (
    load_sdxl_diffusers_dir as j_load_sdxl_dir,
)
from sdxl_tpu.pipeline.pipeline import SDXLPipeline as JPipeline
from sdxl_tpu.pipeline.sd1 import SD1Pipeline as JSD1Pipeline
from sdxl_tpu.pipeline.sd1 import text_to_conditioning_sd1 as j_cond_sd1
from sdxl_tpu.tokenizer import ClipTokenizer, OpenClipTokenizer
from sdxl_tpu_torch.configs import SD21_768_DIFFUSER
from sdxl_tpu_torch.io.bridge import (
    clip_state_dict,
    tree_to_state_dict,
    unet_state_dict,
)
from sdxl_tpu_torch.io.checkpoint import save_native_pipeline
from sdxl_tpu_torch.io.diffusers_sdxl import load_sd1_diffusers_dir
from sdxl_tpu_torch.io.diffusers_write import write_sd1_diffusers_pipeline_dir
from sdxl_tpu_torch.io.hf_sdxl import load_sd1_single_file
from sdxl_tpu_torch.io.images import load_images
from sdxl_tpu_torch.io.lora import apply_lora_files
from sdxl_tpu_torch.io.ip_adapter import load_ip_adapter_file
from sdxl_tpu_torch.models import controlnet as TC
from sdxl_tpu_torch.models.clip import CLIPTextModel, clip_final_hidden
from sdxl_tpu_torch.models.layers import init_reference_
from sdxl_tpu_torch.models.unet import UNet
from sdxl_tpu_torch.pipeline import k_samplers as K
from sdxl_tpu_torch.pipeline.loader import load_pipeline
from sdxl_tpu_torch.pipeline.pipeline import random_pipeline
from sdxl_tpu_torch.pipeline.sampler import _cfg_eps
from sdxl_tpu_torch.pipeline.sd1 import random_sd1_pipeline
from sdxl_tpu_torch.tokenizer import ClipTokenizer as TClipTokenizer
from tests.test_hf_sdxl import (
    inv_linear,
    inv_norm,
    make_ldm_unet_dict_no_label,
    make_ldm_vae_dict,
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
    reference_tree,
    run_reference,
)
from tests.test_torch_module10 import assert_matches, normal
from tests.test_torch_module11 import TINY_VISION, write_ip_adapter
from tests.test_torch_pipeline import TINY_EMBEDDER
from tests.torch_parity import fast_reference_compiles  # noqa: F401

# One intra-op thread: the suite runs six workers on shared cores.
torch.set_num_threads(1)

# the reference's bounds (goldens/full_scale): UNet, CLIP
UNET_TOL, CLIP_TOL = 2e-3, 2e-4
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens", "full_scale")
FULL = os.environ.get("SDXL_TPU_FULL_SCALE") == "1"

# tests/test_sd1.py's tiny SD 1.x tower and UNet (4 levels, transformers
# at levels 0-2 of depth 1, a fixed head count)
CLIP_L = CLIPConfig(n_vocab=49408, n_state=32, embed_dim=32, n_head=4,
                    n_ctx=77, n_layer=2, quick_gelu=True)
CLIP_H = dataclasses.replace(CLIP_L, quick_gelu=False)  # OpenCLIP-style
SD1 = JDiffuserConfig(
    adm_in_channels=0, model_channels=32, channel_mults=(1, 2, 4, 4),
    num_head_channels=8, transformer_depths=(1, 1, 1, 1), context_dim=32,
    transformer_levels=(0, 1, 2), n_heads=4)
# the same plan with its one transformer in the middle block
MID = dataclasses.replace(SD1, transformer_levels=())
MID_V = dataclasses.replace(MID, prediction_type="v")
# the diffusers-canonical decoder plan (the diffusers writers need it)
CANON_VAE = AutoencoderConfig(
    encoder_channels=((16, 16), (16, 32), (32, 32), (32, 32)),
    decoder_channels=((32, 32), (32, 32), (32, 32), (32, 16)), n_group=4)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _moved(*modules, seed=30):
    """Every bias and norm parameter moved off 0 and 1."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in modules:
            for p in m.parameters():
                if p.dim() == 1:
                    p.add_(0.05 * torch.randn(p.shape, generator=g))


def _pair(d_cfg, clip_cfg=CLIP_L, penultimate=False, seed=0,
          vae_cfg=TINY_VAE):
    """(reference SD1Pipeline, port SD1Pipeline) on the same weights (the
    port draws them; the bridge carries them across)."""
    t = random_sd1_pipeline(seed, device="cpu", clip_cfg=clip_cfg,
                            diffuser_cfg=d_cfg, vae_cfg=vae_cfg,
                            unet_dtype=torch.float32,
                            penultimate_hidden=penultimate)
    _moved(t.embedder, t.unet, t.vae, t.vae_encoder, seed=seed + 30)
    j = JSD1Pipeline(
        embedder_cfg=clip_cfg, embedder_params=reference_tree(t.embedder),
        diffuser_cfg=d_cfg, unet_params=fused(reference_tree(t.unet)),
        alphas_cumprod=jnp.asarray(R.scaled_linear_alphas_cumprod()),
        vae_cfg=vae_cfg, vae_params=reference_tree(t.vae, t.vae_encoder),
        scale_factor=0.18215, clip_tokenizer=ClipTokenizer(None),
        open_clip_tokenizer=None, compute_dtype=jnp.float32,
        strict_resolutions=False, penultimate_hidden=penultimate,
        controlnet_cfg=d_cfg.unet_config())
    return j, t


@pytest.fixture(scope="module")
def sd1():
    return _pair(MID, seed=1)


@pytest.fixture(scope="module")
def sd2():
    return _pair(MID_V, CLIP_H, penultimate=True, seed=2)


def inject(monkeypatch, name, **draws):
    real = getattr(tpipeline, name)
    kw = {k: torch.tensor(v) for k, v in draws.items()}
    monkeypatch.setattr(tpipeline, name,
                        lambda *a, **k: real(*a, **{**k, **kw}))


def _txt2img_noise(seed):
    """A reference txt2img's initial noise for an int seed."""
    noise_key, _ = jax.random.split(jax.random.split(
        jax.random.PRNGKey(seed))[0])
    return normal(noise_key)


def _txt2img(monkeypatch, pair, name, seed=5, **kw):
    """One txt2img request on both pipelines, the reference's initial
    noise injected into the port's sampler ``name``."""
    jpipe, tpipe = pair
    kw = dict(resolution=RES, n_steps=3, seed=seed,
              negative_prompt=NEGATIVE, **kw)
    want_images, want_latent = run_reference(
        monkeypatch, jpipe, lambda: jpipe.txt2img(PROMPT, **kw))
    noise = _txt2img_noise(seed)
    inject(monkeypatch, name, initial_noise=noise)
    got = tpipe.txt2img(PROMPT, **kw)
    assert_matches(got, tpipe, want_images, want_latent, noise)


# ---------------------------------------------------------------------------
# the towers
# ---------------------------------------------------------------------------

# (penultimate, clip_skip): SD 1.x's final LN, diffusers' clip_skip on it,
# SD 2.x's penultimate hidden, one block earlier
MODES = {"final": (False, 0), "final_skip1": (False, 1),
         "penultimate": (True, 0), "penultimate_skip1": (True, 1)}
CLIP3 = dataclasses.replace(CLIP_H, n_layer=3)
# SDXL's two towers at 3 blocks: --clip-skip 1 is in range
EMBEDDER3 = EmbedderConfig(dataclasses.replace(CLIP_L, n_layer=3), CLIP3)


@pytest.fixture(scope="module")
def tower3():
    """A 3-block tower: clip_skip 1 still leaves a block to run."""
    model = CLIPTextModel(CLIP3, "cpu")
    init_reference_(model, torch.Generator().manual_seed(4))
    _moved(model, seed=34)
    return model.eval(), reference_tree(model)


def test_clip_final_hidden_matches_reference(tower3):
    """The whole tower and its final LayerNorm (diffusers'
    last_hidden_state): 2e-4."""
    model, tree = tower3
    tokens = np.asarray(ClipTokenizer(None).encode(PROMPT)
                        + [49407] * 60, np.int32)[None, :77]
    with torch.no_grad():
        got = clip_final_hidden(model, torch.from_numpy(tokens).long())
    want = jax.jit(j_final_hidden, static_argnums=1)(tree, CLIP3, tokens)
    assert np.abs(np.asarray(want)).max() > 0.1
    _close(got, want, CLIP_TOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_sd1_conditioning_modes_match_reference(mode, tower3):
    """text_to_conditioning_sd1 with prompt weights, a negative prompt and
    two prompts: both contexts within 2e-4; the OpenCLIP and channel
    fields None."""
    from sdxl_tpu_torch.pipeline.sd1 import text_to_conditioning_sd1

    penultimate, skip = MODES[mode]
    model, tree = tower3
    prompts = [PROMPT, "a photo of a dog"]
    want = j_cond_sd1(tree, CLIP3, ClipTokenizer(None), prompts, RES,
                      NEGATIVE, penultimate, clip_skip=skip)
    got = text_to_conditioning_sd1(model, CLIP3, TClipTokenizer(), prompts,
                                   RES, NEGATIVE, penultimate, clip_skip=skip)
    _close(got.context_full, want.context_full, CLIP_TOL)
    _close(got.unconditional_context_full, want.unconditional_context_full,
           CLIP_TOL)
    for name in ("context_open_clip", "unconditional_context_open_clip",
                 "channel_context", "unconditional_channel_context",
                 "channel_context_refiner",
                 "unconditional_channel_context_refiner"):
        assert getattr(got, name) is None and getattr(want, name) is None
    assert got.astype(torch.float64).context_open_clip is None


# ---------------------------------------------------------------------------
# SD 1.x requests
# ---------------------------------------------------------------------------

def test_sd1_txt2img_ddim_matches_reference(sd1, monkeypatch):
    """SD 1.x txt2img: the final-LN conditioning, no label, the 4-level
    plan's res blocks, DDIM with CFG."""
    _txt2img(monkeypatch, sd1, "sample_latent")


def test_sd1_ays_resolves_to_the_sd15_table(sd1):
    """schedule="ays" on an SD1Pipeline is the SD 1.x table: the port's
    (timesteps, sigmas) at 10 and 30 steps equal the reference's."""
    jpipe, tpipe = sd1
    assert tpipe._resolve_schedule("ays") == "ays_sd15" == \
        jpipe._resolve_schedule("ays")
    alphas = tpipe.alphas_cumprod.numpy()
    for n in (10, 30):
        got = K.k_schedule(alphas, 0, n, tpipe._resolve_schedule("ays"))
        want = R.k_schedule(alphas, 0, n, jpipe._resolve_schedule("ays"))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6)
        assert not np.allclose(got[1], K.k_schedule(alphas, 0, n, "ays")[1])


@pytest.fixture(scope="module")
def ip_file(tmp_path_factory):
    root = tmp_path_factory.mktemp("ip12")
    return write_ip_adapter(str(root / "proj.safetensors"), "proj",
                            MID.unet_config())


def test_sd1_controlnet_ip_adapter_dpmpp_karras_matches_reference(
        sd1, ip_file, monkeypatch):
    """dpmpp on the karras schedule with a ControlNet of the 4-level plan
    (every weight random: the zero convs too; the trunk without a label)
    and the proj IP-Adapter: the conditioning without channel contexts
    through the trunk, the merged image-token K/V and the k-sampler."""
    import sdxl_tpu.models.clip_vision as JV
    from sdxl_tpu.io.ip_adapter import load_ip_adapter_file as j_load_ip

    jpipe, tpipe = sd1
    g = torch.Generator().manual_seed(41)
    net = TC.ControlNet(MID.unet_config(), dtype=torch.float32)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=g))
    net.eval().requires_grad_(False)
    vtree, vmodel = _vision(seed=24)
    params, cfg = j_load_ip(ip_file, MID.unet_config())
    j = dataclasses.replace(
        jpipe, controlnet_params=reference_tree(net),
        ip_adapter_params=params, ip_adapter_cfg=cfg, ip_vision_params=vtree,
        ip_vision_cfg=JV.CLIPVisionConfig(**TINY_VISION))
    t = dataclasses.replace(
        tpipe, controlnet=net, ip_vision=vmodel,
        ip_adapter=load_ip_adapter_file(ip_file, MID.unet_config(),
                                        "cpu")[0])
    _txt2img(monkeypatch, (j, t), "euler_sample_latent", seed=6,
             sampler="dpmpp", schedule="karras",
             control_image=image(40, (*RES, 3)), control_end=0.7,
             ip_adapter_image=image(27, (40, 50, 3)), ip_adapter_scale=0.8)


def _vision(seed):
    """(reference tree, port tower) of module 11's tiny vision tower."""
    import sdxl_tpu.models.clip_vision as JV
    from sdxl_tpu_torch.models import clip_vision as TV
    from tests.test_torch_unet import random_tree

    cfg = JV.CLIPVisionConfig(**TINY_VISION)
    tree = jax.tree.map(np.asarray, random_tree(
        JV.init_clip_vision, cfg, jnp.float32, seed=seed, scale=0.1))
    model = TV.CLIPVisionModel(TV.CLIPVisionConfig(**TINY_VISION))
    model.load_state_dict(tree_to_state_dict(tree))
    return tree, model.eval()


def test_sd1_img2img_matches_reference(sd1, monkeypatch):
    """img2img at strength 0.6 through DDIM: the encoder at 0.18215 and
    the re-noise at the grid's first point."""
    jpipe, tpipe = sd1
    ref = image(45)
    kw = dict(strength=0.6, n_steps=4, seed=7, negative_prompt=NEGATIVE)
    want_images, want_latent = run_reference(
        monkeypatch, jpipe, lambda: jpipe.img2img(PROMPT, ref, **kw))
    inject(monkeypatch, "refine_latent",
           noise=normal(jax.random.PRNGKey(7)))
    got = tpipe.img2img(PROMPT, ref, **kw)
    assert_matches(got, tpipe, want_images, want_latent,
                   tpipe._encode(ref).numpy())


# ---------------------------------------------------------------------------
# single files
# ---------------------------------------------------------------------------

def _hf_clip_keys(d, prefix, tree):
    d[f"{prefix}.embeddings.token_embedding.weight"] = tree[
        "token_embedding"]
    d[f"{prefix}.embeddings.position_embedding.weight"] = tree[
        "position_embedding"]
    for i, b in enumerate(tree["blocks"]):
        s = f"{prefix}.encoder.layers.{i}"
        for n in ("q", "k", "v", "out"):
            inv_linear(d, f"{s}.self_attn.{n}_proj" if n != "out"
                       else f"{s}.self_attn.out_proj", b["attn"][n])
        inv_norm(d, f"{s}.layer_norm1", b["attn_ln"])
        inv_linear(d, f"{s}.mlp.fc1", b["mlp"]["fc1"])
        inv_linear(d, f"{s}.mlp.fc2", b["mlp"]["fc2"])
        inv_norm(d, f"{s}.layer_norm2", b["mlp_ln"])
    inv_norm(d, f"{prefix}.final_layer_norm", tree["layer_norm"])


def _open_clip_keys(d, prefix, tree):
    """open_clip's TextTransformer layout: fused in_proj [3d, d]."""
    d[f"{prefix}.token_embedding.weight"] = tree["token_embedding"]
    d[f"{prefix}.positional_embedding"] = tree["position_embedding"]
    d[f"{prefix}.text_projection"] = tree["text_projection"]
    for i, b in enumerate(tree["blocks"]):
        s = f"{prefix}.transformer.resblocks.{i}"
        a = b["attn"]
        d[f"{s}.attn.in_proj_weight"] = np.concatenate(
            [np.asarray(a[n]["w"]).T for n in "qkv"])
        d[f"{s}.attn.in_proj_bias"] = np.concatenate(
            [np.asarray(a[n]["b"]) for n in "qkv"])
        inv_linear(d, f"{s}.attn.out_proj", a["out"])
        inv_norm(d, f"{s}.ln_1", b["attn_ln"])
        inv_linear(d, f"{s}.mlp.c_fc", b["mlp"]["fc1"])
        inv_linear(d, f"{s}.mlp.c_proj", b["mlp"]["fc2"])
        inv_norm(d, f"{s}.ln_2", b["mlp_ln"])
    inv_norm(d, f"{prefix}.ln_final", tree["layer_norm"])


def _single_file(path, d_cfg, unet, clip, vae, open_clip: bool):
    """An ldm single file (.ckpt: a torch pickle of {"state_dict": ...})
    of port modules, from their reference trees."""
    d = make_ldm_unet_dict_no_label(d_cfg.unet_config(),
                                    reference_tree(unet))
    d.update(make_ldm_vae_dict(reference_tree(*vae)))
    tree = reference_tree(clip)
    if open_clip:
        _open_clip_keys(d, "cond_stage_model.model", tree)
    else:
        _hf_clip_keys(d, "cond_stage_model.transformer.text_model", tree)
    d = {k: np.ascontiguousarray(np.asarray(v, np.float32))
         for k, v in d.items()}
    if path.endswith(".ckpt"):
        torch.save({"state_dict": {k: torch.from_numpy(v)
                                   for k, v in d.items()},
                    "global_step": 3}, path)
    else:
        st_save(d, path)
    return path


@pytest.fixture
def reference_host_casts(monkeypatch):
    """The reference readers cast each leaf on the host path its own
    hf_sdxl._as offers: the values of its jnp casts into f32, without an
    XLA convert compiled per shape (tests/test_torch_loader.py's)."""
    import functools

    import sdxl_tpu.io.diffusers_sdxl as j_dif
    import sdxl_tpu.io.hf_sdxl as j_hf

    cast = functools.partial(j_hf._as, host=True)
    for mod in (j_hf, j_dif):
        monkeypatch.setattr(mod, "_as", cast)


def _assert_loads_bitwise(got, want):
    """Port state_dicts (tower, UNet, autoencoder) against the reference's
    trees through the bridge, bitwise."""
    for g, w in zip(got, (clip_state_dict(want[0]), unet_state_dict(want[1]),
                          tree_to_state_dict(want[2]))):
        assert sorted(g) == sorted(w)
        for k in w:
            assert torch.equal(g[k], w[k]), k


@pytest.fixture(scope="module")
def ckpt9(sd1, tmp_path_factory):
    """A 9-channel SD 1.x inpainting UNet with sd1's tower and VAE in an
    ldm .ckpt (SD 1.x's HF CLIP)."""
    _, tpipe = sd1
    cfg9 = dataclasses.replace(MID, in_channels=9)
    unet9 = UNet(cfg9.unet_config(), "cpu", torch.float32)
    init_reference_(unet9, torch.Generator().manual_seed(8))
    _moved(unet9, seed=9)
    path = str(tmp_path_factory.mktemp("ckpt") / "v1-5-inpainting.ckpt")
    return _single_file(path, cfg9, unet9.eval(), tpipe.embedder,
                        (tpipe.vae, tpipe.vae_encoder), open_clip=False)


@pytest.mark.parametrize("layout", ["sd1_ckpt", "sd2_safetensors"])
def test_sd1_single_file_loads_as_the_reference(layout, sd2, ckpt9,
                                                tmp_path,
                                                reference_host_casts):
    """load_sd1_single_file on an SD 1.x .ckpt (HF CLIP, a 9-channel
    UNet: in_channels corrected from conv_in) and an SD 2.x .safetensors
    (OpenCLIP, fused in_proj; found by its keys): the tower, the UNet
    and the autoencoder bitwise equal to the reference reader's."""
    if layout == "sd1_ckpt":
        path, cfg = ckpt9, MID
    else:
        _, t = sd2
        path = _single_file(str(tmp_path / "v2-1_768.safetensors"), MID_V,
                            t.unet, t.embedder, (t.vae, t.vae_encoder),
                            open_clip=True)
        cfg = MID_V
    clip_cfg = CLIP_H if layout == "sd2_safetensors" else CLIP_L
    got = load_sd1_single_file(path, cfg, clip_cfg, torch.float32,
                               vae_cfg=TINY_VAE)
    want = j_load_single(path, cfg, clip_cfg, jnp.float32, vae_cfg=TINY_VAE)
    assert got[3] == want[3]
    assert got[3].in_channels == (9 if layout == "sd1_ckpt" else 4)
    _assert_loads_bitwise(got[:3], want[:3])


def test_sd1_ckpt_inpaint_off_bucket_matches_reference(sd1, ckpt9,
                                                       monkeypatch,
                                                       reference_host_casts):
    """The 9-channel UNet read from the .ckpt, inpainting a crop window
    of a 64 x 64 reference (off SDXL's buckets: an SD 1.x pipeline does
    not hold it to them): the [mask | masked-image latent] channels."""
    jpipe, tpipe = sd1
    _, unet_sd, _, cfg9 = load_sd1_single_file(ckpt9, MID, CLIP_L,
                                               torch.float32,
                                               vae_cfg=TINY_VAE)
    unet9 = UNet(cfg9.unet_config(), "cpu", torch.float32)
    unet9.load_state_dict(unet_sd)
    _, j_unet, _, _ = j_load_single(ckpt9, MID, CLIP_L, jnp.float32,
                                    vae_cfg=TINY_VAE)
    from sdxl_tpu.models.unet import fuse_unet_qkv

    j = dataclasses.replace(jpipe, diffuser_cfg=cfg9,
                            unet_params=fuse_unet_qkv(j_unet))
    t = dataclasses.replace(tpipe, diffuser_cfg=cfg9, unet=unet9.eval())
    ref = image(46)
    kw = dict(n_steps=3, seed=8, negative_prompt=NEGATIVE, **CROP)
    want_images, want_latent = run_reference(
        monkeypatch, j, lambda: j.inpaint(PROMPT, ref, **kw))
    noise = _txt2img_noise(8)
    inject(monkeypatch, "sample_latent", initial_noise=noise)
    got = t.inpaint(PROMPT, ref, **kw)
    assert_matches(got, t, want_images, want_latent, noise)


# ---------------------------------------------------------------------------
# v-prediction
# ---------------------------------------------------------------------------

def test_sd2_v_prediction_ddim_matches_reference(sd2, monkeypatch):
    """SD 2.x: the penultimate hidden of an OpenCLIP-style tower,
    v-prediction turned into eps at each DDIM grid point's ᾱ."""
    _txt2img(monkeypatch, sd2, "sample_latent", seed=9)


def test_sd2_v_prediction_euler_karras_deepcache_matches_reference(
        sd2, monkeypatch):
    """euler on the karras schedule (fractional timesteps: ᾱ_t = 1 /
    (sigma^2 + 1)) with DeepCache (2, 1): the full steps and the shallow
    step's eps both converted from v."""
    _txt2img(monkeypatch, sd2, "euler_sample_latent", seed=11,
             sampler="euler", schedule="karras", deepcache=(2, 1))


def test_v_to_eps_matches_the_full_scale_golden():
    """goldens/full_scale/sd1_unet.npz: the port's conversion in _cfg_eps
    (the UNet call replaced by the golden's raw output, the conditional
    rows alone) gives v_eps from raw, x and alpha_t: 1e-6."""
    g = np.load(os.path.join(GOLDEN_DIR, "sd1_unet.npz"))
    raw = torch.from_numpy(g["raw"])
    got = _cfg_eps(None, SD21_768_DIFFUSER, torch.from_numpy(g["x"]),
                   torch.tensor(int(g["t"][0])), None, None, 7.5,
                   torch.float32, use_cfg=False,
                   forward=lambda *a, **k: raw,
                   alpha_t=torch.tensor(float(g["alpha_t"])))
    _close(got, g["v_eps"], 1e-6)


@pytest.fixture(scope="module")
def sdxl_v(tmp_path_factory):
    """(reference pipeline, port pipeline, directory): module 9's tiny
    SDXL base on the same weights, written by the reference's diffusers
    writer with a v_prediction scheduler."""
    cfg = dataclasses.replace(TINY_BASE, prediction_type="v")
    t = random_pipeline(device="cpu", embedder_cfg=TINY_EMBEDDER,
                        diffuser_cfg=cfg, vae_cfg=CANON_VAE,
                        unet_dtype=torch.float32, with_encoder=True)
    _moved(t.embedder, t.unet, t.vae, seed=12)
    emb = {k: reference_tree(t.embedder[k]) for k in ("clip", "open_clip")}
    emb["clip"]["text_projection"] = None  # as diffusers ships ViT-L
    j = JPipeline(
        embedder_cfg=TINY_EMBEDDER, embedder_params=emb, diffuser_cfg=cfg,
        unet_params=reference_tree(t.unet),
        alphas_cumprod=jnp.asarray(R.scaled_linear_alphas_cumprod()),
        vae_cfg=CANON_VAE, vae_params=reference_tree(t.vae, t.vae_encoder),
        clip_tokenizer=ClipTokenizer(None),
        open_clip_tokenizer=OpenClipTokenizer(None),
        compute_dtype=jnp.float32)
    d = str(tmp_path_factory.mktemp("sdxlv") / "dir")
    j_write_sdxl_dir(d, j)
    sched = os.path.join(d, "scheduler", "scheduler_config.json")
    with open(sched) as f:
        sc = json.load(f)
    sc["prediction_type"] = "v_prediction"  # diffusers' spelling
    with open(sched, "w") as f:
        json.dump(sc, f)
    return j, t, d


def test_sdxl_v_prediction_diffusers_dir_loads_and_samples(
        sdxl_v, reference_host_casts):
    """load_pipeline reads a v_prediction scheduler (no longer refused):
    its config is the reference reader's, its modules bitwise the
    reference reader's trees, and DDIM txt2img turns the UNet's v into
    eps (another image than the same weights read as eps)."""
    _, _, d = sdxl_v
    tpipe = load_pipeline(d, compute_dtype=torch.float32, device="cpu")
    e_cfg, d_cfg, v_cfg = j_infer(d)
    emb, unet, vae, alphas, scale, d_cfg = j_load_sdxl_dir(
        d, d_cfg, e_cfg, jnp.float32, vae_cfg=v_cfg)
    assert tpipe.diffuser_cfg.prediction_type == "v" == d_cfg.prediction_type
    assert dataclasses.asdict(tpipe.diffuser_cfg) == dataclasses.asdict(d_cfg)
    for module, want in ((tpipe.unet, unet_state_dict(unet)),
                         (tpipe.embedder["open_clip"],
                          clip_state_dict(emb["open_clip"]))):
        got = module.state_dict()
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    tpipe.strict_resolutions = False
    kw = dict(resolution=RES, n_steps=2, seed=13, negative_prompt=NEGATIVE)
    v_img = tpipe.txt2img(PROMPT, **kw)
    v_lat = tpipe.last_latent
    tpipe.diffuser_cfg = dataclasses.replace(tpipe.diffuser_cfg,
                                             prediction_type="eps")
    tpipe.txt2img(PROMPT, **kw)
    assert v_img.std() > 0 and torch.isfinite(v_lat).all()
    assert not torch.allclose(v_lat, tpipe.last_latent)


def test_sdxl_clip_skip_matches_reference(sdxl_v):
    """clip_skip 1 on SDXL taps both towers one block earlier: the eight
    tensors within 2e-4, the unconditional cache keyed by clip_skip."""
    jpipe, tpipe, _ = sdxl_v
    j = dataclasses.replace(jpipe, clip_skip=1)
    tpipe._uncond_cache.clear()
    base = tpipe.conditioning([PROMPT], RES, NEGATIVE)
    tpipe.clip_skip = 1
    try:
        got = tpipe.conditioning([PROMPT], RES, NEGATIVE)
    finally:
        tpipe.clip_skip = 0
    assert len(tpipe._uncond_cache) == 2
    want = j.conditioning([PROMPT], RES, negative_prompt=NEGATIVE)
    for f in dataclasses.fields(want):
        if f.name != "resolution":
            _close(getattr(got, f.name), getattr(want, f.name), CLIP_TOL)
    assert not torch.allclose(base.context_full, got.context_full)


# ---------------------------------------------------------------------------
# diffusers directories, LoRA, textual inversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_sd1_diffusers_dir_loads_as_the_reference(writer, tmp_path,
                                                  reference_host_casts):
    """An SD 2.x directory (sd2=True: "!" padding in the tokenizer
    directory, v_prediction in the scheduler) by the reference's writer
    or the port's: load_sd1_diffusers_dir's tower, UNet, autoencoder, ᾱ
    table, scale and config bitwise equal to the reference reader's (and,
    for the port's writer, to the modules written); the tokenizer given
    the directory pads as the reference's does."""
    jpipe, t = _pair(MID_V, CLIP_H, seed=14, vae_cfg=CANON_VAE)
    d = str(tmp_path / "sd2")
    if writer == "port":
        write_sd1_diffusers_pipeline_dir(d, t, sd2=True)
    else:
        # the writer takes the unfused tree with unfolded upsample convs
        j_write_dir(d, MID_V, reference_tree(t.unet), CLIP_H,
                    dict(jpipe.embedder_params, text_projection=None),
                    jpipe.vae_params, ClipTokenizer(None),
                    vae_cfg=CANON_VAE, sd2=True)
    with open(os.path.join(d, "scheduler", "scheduler_config.json")) as f:
        assert json.load(f)["prediction_type"] == "v_prediction"
    got = load_sd1_diffusers_dir(d, MID, CLIP_H, torch.float32)
    want = j_load_dir(d, MID, CLIP_H, jnp.float32)
    assert got[5] == want[5] and got[5].prediction_type == "eps"
    assert got[4] == want[4] == pytest.approx(0.18215)
    np.testing.assert_array_equal(got[3], want[3])
    want_vae = tree_to_state_dict(want[2])
    _assert_loads_bitwise(got[:3], want[:3])
    if writer == "port":
        sd = dict(t.embedder.state_dict())
        del sd["text_projection"]
        for g, w in zip(got[:3], (sd, t.unet.state_dict(),
                                  {**t.vae.state_dict(),
                                   **t.vae_encoder.state_dict()})):
            assert sorted(g) == sorted(w)
            assert all(torch.equal(g[k], w[k]) for k in w)
    assert sorted(want_vae) == sorted(got[2])
    tok_dir = os.path.join(d, "tokenizer")
    with open(os.path.join(tok_dir, "special_tokens_map.json")) as f:
        assert json.load(f)["pad_token"] == "!"
    port, ref = TClipTokenizer(tok_dir), ClipTokenizer(tok_dir)
    assert port.pad_token == ref.pad_token
    assert port.encode(PROMPT) == ref.encode(PROMPT)


def _sd1_lora(path):
    """A kohya SD 1.x LoRA: diffusers-named UNet modules on the 4-level
    plan (down_blocks.3 and up_blocks.0 hold resnets only) and the one
    tower's lora_te_ modules; alternate modules carry an alpha."""
    rng = np.random.default_rng(15)
    mods = [("unet_down_blocks_1_attentions_1_transformer_blocks_0_attn1"
             "_to_q", 64, 64),
            ("unet_up_blocks_1_attentions_2_transformer_blocks_0_attn2_to_k",
             32, 128),
            ("unet_down_blocks_3_resnets_1_time_emb_proj", 128, 128),
            ("unet_up_blocks_0_resnets_2_conv1", 256, 128),
            ("unet_mid_block_attentions_0_proj_in", 128, 128),
            ("te_text_model_encoder_layers_1_self_attn_v_proj", 32, 32),
            ("te_text_model_encoder_layers_0_mlp_fc2", 128, 32)]
    flat = {}
    for i, (name, d_in, d_out) in enumerate(mods):
        conv = name.endswith("conv1")
        flat[f"lora_{name}.lora_down.weight"] = (0.1 * rng.standard_normal(
            (4, d_in, 3, 3) if conv else (4, d_in))).astype(np.float32)
        flat[f"lora_{name}.lora_up.weight"] = (0.1 * rng.standard_normal(
            (d_out, 4, 1, 1) if conv else (d_out, 4))).astype(np.float32)
        if i % 2:
            flat[f"lora_{name}.alpha"] = np.asarray(2.0 * i, np.float32)
    st_save(flat, path)
    return len(mods)


def test_sd1_lora_merges_as_the_reference(tmp_path):
    """apply_lora_files(unet=..., te1=<the bare tower>) on the port's
    modules of tests/test_sd1.py's plan against the reference's on its
    trees: 1e-6 relative; every module moved."""
    import copy

    jpipe, tpipe = _pair(SD1, seed=19)
    path = str(tmp_path / "sd1_lora.safetensors")
    n = _sd1_lora(path)
    unet, clip = copy.deepcopy(tpipe.unet), copy.deepcopy(tpipe.embedder)
    apply_lora_files([(path, 0.7)], unet=unet, te1=clip)
    # the reference merges into the unfused tree (load_sd1_pipeline fuses
    # after its LoRAs)
    j_unet = reference_tree(tpipe.unet)
    j_clip = jax.tree.map(np.array, jpipe.embedder_params)
    j_apply_lora_files([(path, 0.7)], unet=j_unet, te1=j_clip)
    moved = 0
    for got, want, before in (
            (unet.state_dict(), unet_state_dict(j_unet),
             tpipe.unet.state_dict()),
            (clip.state_dict(), clip_state_dict(j_clip),
             tpipe.embedder.state_dict())):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            moved += not torch.equal(got[k], before[k])
    assert moved == n


def test_sd1_textual_inversion_matches_reference(sd1, tmp_path):
    """A single-tower embedding file (an SD 1.x "emb" tensor) merged by
    SD1Pipeline.add_textual_inversions on both sides: the token ids and
    the conditioning of a prompt with the trigger word (2e-4)."""
    jpipe, tpipe = sd1
    path = str(tmp_path / "concept.safetensors")
    rng = np.random.default_rng(16)
    st_save({"emb": rng.standard_normal((2, 32)).astype(np.float32)}, path)
    j = dataclasses.replace(jpipe, clip_tokenizer=ClipTokenizer(None))
    t = dataclasses.replace(tpipe, clip_tokenizer=TClipTokenizer(),
                            embedder=CLIPTextModel(CLIP_L, "cpu"))
    t.embedder.load_state_dict(tpipe.embedder.state_dict())
    j.add_textual_inversions([path])
    t.add_textual_inversions([path])
    text = "a photo of concept, in the style of concept"
    assert t.clip_tokenizer.encode(text) == j.clip_tokenizer.encode(text)
    assert max(t.clip_tokenizer.encode(text)) >= 49408
    want = j.conditioning([text], RES, negative_prompt=NEGATIVE)
    got = t.conditioning([text], RES, NEGATIVE)
    _close(got.context_full, want.context_full, CLIP_TOL)
    _close(got.unconditional_context_full, want.unconditional_context_full,
           CLIP_TOL)


# ---------------------------------------------------------------------------
# the sample CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory):
    """Port-written checkpoints: an SD 1.x and an SD 2.x diffusers
    directory (the port's writer) and an SDXL native one, with the
    pipelines they hold."""
    root = tmp_path_factory.mktemp("cli12")
    _, p1 = _pair(MID, CLIP_L, seed=17, vae_cfg=CANON_VAE)
    _, p2 = _pair(MID, CLIP3, penultimate=True, seed=18, vae_cfg=CANON_VAE)
    px = random_pipeline(device="cpu", embedder_cfg=EMBEDDER3,
                         diffuser_cfg=TINY_BASE, vae_cfg=TINY_VAE,
                         unet_dtype=torch.float32)
    return dict(
        sd1=(write_sd1_diffusers_pipeline_dir(str(root / "sd1"), p1), p1),
        sd2=(write_sd1_diffusers_pipeline_dir(str(root / "sd2"), p2,
                                              sd2=True), p2),
        sdxl=(save_native_pipeline(str(root / "sdxl"), px), px))


@pytest.fixture
def tiny_presets(monkeypatch):
    """The CLI's SD 1.x / 2.x presets and the published VAE as the tiny
    configs of cli_dirs' checkpoints."""
    import sdxl_tpu_torch.configs as tcfg
    import sdxl_tpu_torch.pipeline.sd1 as tsd1

    monkeypatch.setattr(tcfg, "SD15_DIFFUSER", MID)
    monkeypatch.setattr(tcfg, "SD2_DIFFUSER", MID)
    monkeypatch.setattr(tcfg, "CLIP_VIT_L_CONFIG", CLIP_L)
    monkeypatch.setattr(tcfg, "OPEN_CLIP_VITH_CONFIG", CLIP3)
    monkeypatch.setattr(tsd1, "AutoencoderConfig", lambda: CANON_VAE)


# case -> (checkpoint, extra flags, clip_skip of the in-memory request)
CLI_CASES = {
    "sd1": ("sd1", ["--family", "sd1"], 0),
    "sd2_clip_skip": ("sd2", ["--family", "sd2", "--clip-skip", "1"], 1),
    "sdxl_clip_skip": ("sdxl", ["--clip-skip", "1", "--sampler", "euler"],
                       1),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_family_and_clip_skip_match_the_in_memory_pipeline(
        case, cli_dirs, tiny_presets, tmp_path):
    """main(..., device="cpu") on the port-written directory writes, pixel
    for pixel, what the pipeline it holds returns for the same request,
    seed and clip_skip (SD 2.x: the penultimate hidden)."""
    from sdxl_tpu_torch.cli.sample import main

    name, flags, skip = CLI_CASES[case]
    d, pipe = cli_dirs[name]
    out = str(tmp_path / "img")
    argv = ["--model-dir", d, "--f32", "--prompt", PROMPT, "--height", "64",
            "--width", "64", "-steps", "3", "--seed", "3",
            "--negative-prompt", NEGATIVE, "--output-dir", out, *flags]
    assert main(argv, device="cpu") == 0
    got = load_images([f"{out}0.png"])
    sampler = "euler" if "--sampler" in flags else "ddim"
    pipe.clip_skip = skip
    try:
        want = pipe.txt2img([PROMPT], resolution=RES, n_steps=3, seed=3,
                            negative_prompt=NEGATIVE, sampler=sampler)
    finally:
        pipe.clip_skip = 0
    np.testing.assert_array_equal(got, want)


CLI_ERRORS = {
    "sd1_refiner": ["--family", "sd1", "--use-refiner"],
    "sd2_no_model": ["--family", "sd2"],
    "sd1_denoising_end": ["--family", "sd1", "--denoising-end", "0.8",
                          "--use-refiner"],
    "sd1_clip_skip_range": ["--family", "sd1", "--model-dir", "{sd1}",
                            "--clip-skip", "1"],
    "sdxl_clip_skip_range": ["--model-dir", "{sdxl}", "--clip-skip", "2"],
}


@pytest.mark.parametrize("case", list(CLI_ERRORS))
def test_cli_module12_refusals_are_the_references(case, cli_dirs,
                                                  tiny_presets, capsys,
                                                  monkeypatch, tmp_path):
    """Each bad combination exits 1 with the reference CLI's own error
    line and writes no image (the reference's loaders stubbed with a
    pipeline of the same towers' depths)."""
    import sdxl_tpu.cli.sample as j_cli
    import sdxl_tpu.pipeline.loader as j_loader
    import sdxl_tpu.pipeline.sd1 as j_sd1
    from sdxl_tpu_torch.cli.sample import main

    class Stub:  # the reference CLI's pipeline, never sampled from
        diffuser_cfg = MID
        clip_skip = 0

    sd1_stub, sdxl_stub = Stub(), Stub()
    sd1_stub.embedder_cfg = CLIP_L
    sdxl_stub.embedder_cfg = EMBEDDER3
    monkeypatch.setattr(j_sd1, "load_sd1_pipeline",
                        lambda *a, **k: sd1_stub)
    monkeypatch.setattr(j_loader, "load_pipeline", lambda *a, **k: sdxl_stub)
    paths = {k: v[0] for k, v in cli_dirs.items()}
    argv = ["--f32", "--prompt", "a cat", "--output-dir",
            str(tmp_path / "x"),
            *(a.format(**paths) for a in CLI_ERRORS[case])]

    def error_line(rc):
        assert rc == 1
        lines = [ln for ln in capsys.readouterr().err.splitlines()
                 if ln.startswith("error:")]
        assert len(lines) == 1
        return lines[0]

    want = error_line(j_cli.main(argv))
    assert error_line(main(argv, device="cpu")) == want
    assert not os.path.exists(tmp_path / "x0.png")


# ---------------------------------------------------------------------------
# the reference's full-width goldens (opt-in: minutes of CPU each)
# ---------------------------------------------------------------------------

@pytest.mark.skipif(not FULL, reason="set SDXL_TPU_FULL_SCALE=1 (slow)")
def test_sd2_clip_golden_reproduces_through_the_port():
    """OpenCLIP ViT-H (the reference's init at key 4, carried across by
    the bridge): its penultimate hidden against sd2_clip.npz, 2e-4."""
    from sdxl_tpu.configs import OPEN_CLIP_VITH_CONFIG
    from sdxl_tpu.models.clip import init_clip
    from sdxl_tpu_torch.models.clip import clip_hidden

    g = np.load(os.path.join(GOLDEN_DIR, "sd2_clip.npz"))
    cfg = OPEN_CLIP_VITH_CONFIG
    tree = jax.tree.map(np.asarray, init_clip(jax.random.PRNGKey(4), cfg))
    model = CLIPTextModel(cfg, "cpu")
    model.load_state_dict(clip_state_dict(tree))
    with torch.no_grad():
        got = clip_hidden(model, torch.from_numpy(g["tokens"]).long(),
                          cfg.n_layer - 1)
    _close(got, g["hidden"], CLIP_TOL)


@pytest.mark.skipif(not FULL, reason="set SDXL_TPU_FULL_SCALE=1 (slow)")
def test_sd1_unet_golden_reproduces_through_the_port():
    """SD 1.5's UNet (the reference's init at key 5) on the golden's x and
    t with its context (key 19): raw against sd1_unet.npz, 2e-3."""
    from sdxl_tpu.configs import SD15_DIFFUSER
    from sdxl_tpu.models.unet import init_unet
    from sdxl_tpu_torch.models.unet import unet_forward

    g = np.load(os.path.join(GOLDEN_DIR, "sd1_unet.npz"))
    cfg = SD15_DIFFUSER.unet_config()
    tree = jax.tree.map(np.asarray, init_unet(jax.random.PRNGKey(5), cfg,
                                              jnp.float32))
    ks = jax.random.split(jax.random.PRNGKey(19), 2)
    ctx = np.asarray(jax.random.normal(ks[1], (1, 77, 768), jnp.float32)
                     * 0.5)
    np.testing.assert_array_equal(ctx[:, :, :8], g["ctx_fingerprint"])
    unet = UNet(cfg, "cpu", torch.float32)
    unet.load_state_dict(unet_state_dict(tree))
    with torch.no_grad():
        raw = unet_forward(unet.eval(), torch.from_numpy(g["x"]),
                           torch.from_numpy(g["t"]), torch.from_numpy(ctx),
                           None)
    _close(raw, g["raw"], UNET_TOL)
