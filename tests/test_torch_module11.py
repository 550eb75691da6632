"""Module 11's rest: ControlNet (one and two nets), IP-Adapter (proj and
plus) with the CLIP vision tower, InstructPix2Pix, hires-fix and the tiled
VAE, against sdxl_tpu at tiny configs, f32 on the CPU.

- The ControlNet trunk (two levels, every weight random: its zero convs
  nonzero, which a zero init would leave untested), its conditioning-image
  embedding and the UNet with its residuals against the reference's
  functions run eagerly, 2e-3 absolute (the reference's UNet bound,
  goldens/full_scale); the window scales exactly; the port's diffusers
  writer read back by the reference's loader and the port's, exactly.
- The CLIP vision tower's resize (the antialiased a = -0.5 bicubic, down
  and up), its projected embedding and penultimate hidden state, and its
  transformers directory both ways: 2e-4 (the CLIP bound).
- Requests through the reference pipeline's entry points and the port's
  with the reference's draws injected (as tests/test_torch_module10b.py):
  txt2img and img2img with one and with two ControlNets, the proj and
  plus IP-Adapters from official-layout files both load (each in one of
  the txt2img ControlNet requests, so their loops compile once), ip2p
  through DDIM and euler_a (its 3-way eps alone too, and the unscaled
  edit latents), hires-fix through DDIM and dpmpp: final latents within 1e-3
  of max(1, |latent|), images within one u8 level.
- The tiled decode (u8 within one level) and encode (2e-3) over 3 x 3
  tiles.
- The CLI's new flags against the in-memory pipeline, pixel for pixel,
  and their bad combinations against the reference CLI's messages.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as st_save

import sdxl_tpu.models.clip_vision as JV
import sdxl_tpu.models.controlnet as JC
import sdxl_tpu.models.unet as JU
import sdxl_tpu.pipeline.sampler as R
import sdxl_tpu_torch.pipeline.pipeline as tpipeline
import sdxl_tpu_torch.pipeline.sampler as S
from sdxl_tpu.configs import DiffuserConfig as JDiffuserConfig
from sdxl_tpu.configs import UNetConfig as JUNetConfig
from sdxl_tpu.io.diffusers_sdxl import load_controlnet_dir as j_load_cn
from sdxl_tpu.io.ip_adapter import load_clip_vision_dir as j_load_vision
from sdxl_tpu.io.ip_adapter import load_ip_adapter_file as j_load_ip
from sdxl_tpu.pipeline.latent import decode_latent_tiled as j_decode_tiled
from sdxl_tpu.pipeline.latent import encode_images_tiled as j_encode_tiled
from sdxl_tpu.pipeline.pipeline import SDXLPipeline as JPipeline
from sdxl_tpu.tokenizer import ClipTokenizer, OpenClipTokenizer
from sdxl_tpu_torch.configs import DiffuserConfig, UNetConfig
from sdxl_tpu_torch.io.bridge import tree_to_state_dict, unet_state_dict
from sdxl_tpu_torch.io.checkpoint import save_native_pipeline
from sdxl_tpu_torch.io.diffusers_sdxl import load_controlnet_dir
from sdxl_tpu_torch.io.diffusers_write import write_diffusers_controlnet_dir
from sdxl_tpu_torch.io.images import load_images, save_images
from sdxl_tpu_torch.io.ip_adapter import (
    load_clip_vision_dir,
    load_ip_adapter_file,
    save_clip_vision_dir,
    save_ip_adapter_file,
)
from sdxl_tpu_torch.models import clip_vision as TV
from sdxl_tpu_torch.models import controlnet as TC
from sdxl_tpu_torch.models import unet as TU
from sdxl_tpu_torch.models.layers import init_reference_
from sdxl_tpu_torch.models.unet import UNet
from sdxl_tpu_torch.pipeline.latent import (
    decode_latent_tiled,
    encode_images_tiled,
)
from sdxl_tpu_torch.pipeline.pipeline import random_pipeline
from tests.test_pipeline_e2e import TINY_VAE
from tests.test_torch_module10 import assert_matches, normal, scan_draws
from tests.test_torch_module9 import (
    NEGATIVE,
    PROMPT,
    RES,
    TINY_BASE,
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

# the reference's bounds: UNet (goldens/full_scale), CLIP, VAE encode
UNET_TOL, CLIP_TOL, ENCODE_TOL = 2e-3, 2e-4, 2e-3
# two levels with a transformer at level 1: the trunk's down block and a
# second level in the writer's block mapping
TINY2 = dict(adm_in_channels=32 + 6 * 256, model_channels=32,
             channel_mults=(1, 2), transformer_depths=(1, 1),
             context_dim=64, transformer_levels=(1,))
TINY2_J = JUNetConfig(n_head_channels=8, **TINY2)
TINY2_T = UNetConfig(n_head_channels=8, **TINY2)
TINY_EDIT = dataclasses.replace(TINY_BASE, in_channels=8)
TINY_VISION = dict(image_size=28, patch_size=14, n_state=32, n_head=4,
                   n_layer=2, embed_dim=16)
SHAPE = (1, RES[0] // 8, RES[1] // 8, 4)


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()


# ---------------------------------------------------------------------------
# the ControlNet trunk and its file
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trunk():
    """(reference tree, port ControlNet) of TINY2, every weight random
    (N(0, 0.05^2)): the zero convs too."""
    tree = random_tree(JC.init_controlnet, TINY2_J, jnp.float32, seed=21,
                       scale=0.05)
    net = TC.ControlNet(TINY2_T, dtype=torch.float32)
    net.load_state_dict(unet_state_dict(jax.tree.map(np.asarray, tree)))
    return tree, net.eval()


def test_controlnet_forward_matches_reference(trunk):
    """The conditioning-image embedding (a [0, 1] image), the trunk's
    down and mid residuals, the same through precomputed cross K/V, and
    the UNet with them added, at a pair batch: 2e-3."""
    tree, net = trunk
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 64)).astype(np.float32)
    label = rng.standard_normal((2, TINY2["adm_in_channels"])).astype(
        np.float32)
    ts = np.array([999, 500], np.int32)
    img = rng.random((2, 64, 64, 3)).astype(np.float32)

    @jax.jit  # one compile instead of each op's eagerly
    def reference(tree, utree):
        ce = JC.control_cond_embed(tree["cond_embed"], img)
        res = JC.controlnet_forward(tree, TINY2_J, x, ts, ctx, label, ce)
        return ce, res, JU.unet_forward(utree, TINY2_J, x, ts, ctx, label,
                                        control_residuals=res)

    utree = random_tree(JU.init_unet, TINY2_J, jnp.float32, seed=23)
    ce_j, (down_j, mid_j), want_unet = reference(tree, utree)
    args = [torch.from_numpy(a) for a in (x, ts, ctx, label)]
    with torch.no_grad():
        ce = TC.control_cond_embed(net, torch.from_numpy(img))
        down, mid = TC.controlnet_forward(net, *args, ce)
        kv = TU.precompute_cross_kv(net, args[2])
        down_kv, mid_kv = TC.controlnet_forward(net, *args, ce, kv)
    _close(_nhwc(ce), ce_j, UNET_TOL)
    assert len(down) == len(down_j) == len(net.input_blocks)
    for got, want in zip(down + [mid], list(down_j) + [mid_j]):
        assert np.abs(np.asarray(want)).max() > 1e-2  # nonzero residuals
        _close(_nhwc(got), want, UNET_TOL)
    for a, b in zip(down + [mid], down_kv + [mid_kv]):
        _close(b, a.numpy(), 1e-5)

    unet = TU.UNet(TINY2_T, dtype=torch.float32)
    unet.load_state_dict(unet_state_dict(jax.tree.map(np.asarray, utree)))
    with torch.no_grad():
        got = TU.unet_forward(unet, *args, control_residuals=(down, mid))
        plain = TU.unet_forward(unet, *args)
    assert np.abs(np.asarray(want_unet) - plain.numpy()).max() > 1e-2
    _close(got, want_unet, UNET_TOL)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_control_window_scales_match_reference(multi):
    """diffusers' controlnet_keep rule, one net and two (a column each),
    on the host: exactly the reference's."""
    for n in (4, 31):
        for window in ((0.0, 1.0), (0.0, 0.5), (0.25, 0.75), (0.9, 1.0)):
            scale, win = ((2.5, 0.7), (window, (0.1, 0.6))) if multi else (
                2.5, window)
            got = S._control_window_scales(n, scale, win)
            want = np.asarray(R._control_window_scales(n, scale, win))
            assert got.shape == want.shape == ((n, 2) if multi else (n,))
            np.testing.assert_array_equal(got, want)


def test_controlnet_diffusers_dir_reads_back(trunk, tmp_path):
    """The port's writer: the reference's load_controlnet_dir reads the
    reference's tree back exactly, and the port's loader the port's
    state_dict bitwise."""
    tree, net = trunk
    d = write_diffusers_controlnet_dir(str(tmp_path / "cn"), net)
    dcfg = JDiffuserConfig(num_head_channels=8, **TINY2)
    j_params, j_cfg = j_load_cn(d, dcfg, jnp.float32)
    assert j_cfg == TINY2_J
    flat_want = dict(jax.tree_util.tree_leaves_with_path(tree))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(j_params))
    assert set(flat_got) == set(flat_want)
    for k, v in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_got[k]), v)
    t_net, t_cfg = load_controlnet_dir(
        d, DiffuserConfig(num_head_channels=8, **TINY2), torch.float32, "cpu")
    assert t_cfg == TINY2_T
    want = net.state_dict()
    got = t_net.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# the CLIP vision tower
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [100, 19], ids=["down", "up"])
def test_preprocess_image_matches_reference(size):
    """jax.image.resize's bicubic (Keys a = -0.5, antialiased when it
    shrinks) is torch's antialiased bicubic: 100 -> 28 and 19 -> 28
    (about 1.5x up) within 2e-4 after CLIP's normalisation; torch's
    default bicubic is far off going down."""
    cfg_j = JV.CLIPVisionConfig(**TINY_VISION)
    cfg_t = TV.CLIPVisionConfig(**TINY_VISION)
    img = np.random.default_rng(size).integers(0, 256, (2, size, size, 3),
                                               np.uint8)
    want = np.asarray(JV.preprocess_image(img, cfg_j))
    got = TV.preprocess_image(img, cfg_t)
    _close(got, want, CLIP_TOL)
    if size > 28:
        x = torch.from_numpy(img).float().permute(0, 3, 1, 2) / 255.0
        plain = torch.nn.functional.interpolate(x, (28, 28), mode="bicubic")
        assert np.abs(plain.permute(0, 2, 3, 1).numpy()
                      - (want * JV.CLIP_IMAGE_STD + JV.CLIP_IMAGE_MEAN)
                      ).max() > 0.1


@pytest.fixture(scope="module")
def vision():
    """(reference tree, port tower) of TINY_VISION, f32."""
    cfg = JV.CLIPVisionConfig(**TINY_VISION)
    tree = jax.tree.map(np.asarray,
                        random_tree(JV.init_clip_vision, cfg, jnp.float32,
                                    seed=24, scale=0.1))
    model = TV.CLIPVisionModel(TV.CLIPVisionConfig(**TINY_VISION))
    model.load_state_dict(tree_to_state_dict(tree))
    return tree, model.eval()


def test_clip_vision_tower_matches_reference(vision, tmp_path):
    """image_embeds and the penultimate hidden state (2e-4), then the
    tower written as a transformers directory by the port: the
    reference's reader gets its tree back and the port's its state."""
    tree, model = vision
    cfg_j = JV.CLIPVisionConfig(**TINY_VISION)
    px = np.array(JV.preprocess_image(image(25, (2, 40, 40, 3)), cfg_j))
    with torch.no_grad():
        emb = TV.clip_vision_embed(model, torch.from_numpy(px))
        pen = TV.clip_vision_penultimate(model, torch.from_numpy(px))
    _close(emb, JV.clip_vision_embed(tree, cfg_j, px), CLIP_TOL)
    _close(pen, JV.clip_vision_hidden(tree, cfg_j, px, n_blocks=1), CLIP_TOL)
    d = save_clip_vision_dir(str(tmp_path / "enc"), model)
    j_tree, j_cfg = j_load_vision(d)
    assert j_cfg == cfg_j
    for (path, want), (_, got) in zip(
            jax.tree_util.tree_leaves_with_path(tree),
            jax.tree_util.tree_leaves_with_path(j_tree)):
        np.testing.assert_array_equal(np.asarray(got), want, str(path))
    t_model, _ = load_clip_vision_dir(d, "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(t_model.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------

def _moved(*modules, seed=30):
    """Every bias and norm parameter moved off 0 and 1."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in modules:
            for p in m.parameters():
                if p.dim() == 1:
                    p.add_(0.05 * torch.randn(p.shape, generator=g))


@pytest.fixture(scope="module")
def pipes(vision):
    """(reference, port) pipelines on the same weights (the port draws
    them; the bridge carries them across): TINY_BASE with the VAE encoder,
    two ControlNets of its plan (weights N(0, 0.05^2)), an 8-channel edit
    UNet, and the vision tower."""
    tpipe = random_pipeline(device="cpu", embedder_cfg=TINY_EMBEDDER,
                            diffuser_cfg=TINY_BASE, vae_cfg=TINY_VAE,
                            unet_dtype=torch.float32, with_encoder=True)
    g = torch.Generator().manual_seed(31)
    nets = []
    for _ in range(2):
        net = TC.ControlNet(TINY_BASE.unet_config(), dtype=torch.float32)
        with torch.no_grad():
            for p in net.parameters():
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
        nets.append(net.eval().requires_grad_(False))
    unet8 = init_reference_(UNet(TINY_EDIT.unet_config(), "cpu",
                                 torch.float32), g).eval()
    _moved(tpipe.embedder, tpipe.unet, tpipe.vae, tpipe.vae_encoder, unet8)
    tpipe.strict_resolutions = False
    tpipe.ip_vision = vision[1]
    jpipe = JPipeline(
        embedder_cfg=TINY_EMBEDDER,
        embedder_params={k: reference_tree(tpipe.embedder[k])
                         for k in ("clip", "open_clip")},
        diffuser_cfg=TINY_BASE, unet_params=fused(reference_tree(tpipe.unet)),
        alphas_cumprod=jnp.asarray(R.scaled_linear_alphas_cumprod()),
        vae_cfg=TINY_VAE,
        vae_params=reference_tree(tpipe.vae, tpipe.vae_encoder),
        clip_tokenizer=ClipTokenizer(None),
        open_clip_tokenizer=OpenClipTokenizer(None),
        compute_dtype=jnp.float32, strict_resolutions=False,
        controlnet_cfg=TINY_BASE.unet_config(),
        ip_vision_params=vision[0],
        ip_vision_cfg=JV.CLIPVisionConfig(**TINY_VISION))
    edit = (dataclasses.replace(jpipe, diffuser_cfg=TINY_EDIT,
                                unet_params=fused(reference_tree(unet8))),
            dataclasses.replace(tpipe, diffuser_cfg=TINY_EDIT, unet=unet8))
    return dict(j=jpipe, t=tpipe, nets=nets,
                j_nets=[reference_tree(n) for n in nets], edit=edit)


def inject(monkeypatch, name, **draws):
    real = getattr(tpipeline, name)
    kw = {k: torch.tensor(v) for k, v in draws.items()}
    monkeypatch.setattr(tpipeline, name,
                        lambda *a, **k: real(*a, **{**k, **kw}))


def _draws(seed):
    """A txt2img's initial noise and its base scan key."""
    noise_key, scan_key = jax.random.split(jax.random.split(
        jax.random.PRNGKey(seed))[0])
    return normal(noise_key), scan_key


CONTROL_CASES = {
    # (entry point, nets, sampler, the request's control keywords, the
    # IP-Adapter variant in the same request)
    "txt2img_one": ("txt2img", 1, "heun", dict(control_end=0.5), "proj"),
    "txt2img_two": ("txt2img", 2, "dpmpp", dict(
        control_scale=[1.0, 0.6], control_start=[0.0, 0.25]), "plus"),
    "img2img_one": ("img2img", 1, "euler", dict(control_scale=0.8), None),
    "img2img_two": ("img2img", 2, "ddim", dict(control_end=[1.0, 0.5]),
                    None),
}
IP_CASES = {"proj": "txt2img_one", "plus": "txt2img_two"}


@pytest.fixture(scope="module")
def ip_files(tmp_path_factory):
    """variant -> an official-layout IP-Adapter file of TINY_BASE."""
    root = tmp_path_factory.mktemp("ip")
    return {v: write_ip_adapter(str(root / f"{v}.safetensors"), v,
                                TINY_BASE.unet_config())
            for v in ("proj", "plus")}


def _control_request(case, pipes, ip_files, monkeypatch):
    """One CONTROL_CASES request on both pipelines (the reference's draws
    injected into the port), then the port's again without the control
    keywords."""
    entry, n, sampler, ctl, ip = CONTROL_CASES[case]
    jpipe = dataclasses.replace(pipes["j"], controlnet_params=(
        pipes["j_nets"][0] if n == 1 else tuple(pipes["j_nets"])))
    tpipe = dataclasses.replace(pipes["t"], controlnet=(
        pipes["nets"][0] if n == 1 else tuple(pipes["nets"])))
    imgs = [image(40 + i, (*RES, 3)) for i in range(n)]
    kw = dict(n_steps=4, seed=17, negative_prompt=NEGATIVE, sampler=sampler,
              control_image=imgs[0] if n == 1 else imgs, **ctl)
    if ip is not None:
        params, cfg = j_load_ip(ip_files[ip], TINY_BASE.unet_config())
        jpipe = dataclasses.replace(jpipe, ip_adapter_params=params,
                                    ip_adapter_cfg=cfg)
        tpipe = dataclasses.replace(tpipe, ip_adapter=load_ip_adapter_file(
            ip_files[ip], TINY_BASE.unet_config(), "cpu")[0])
        kw.update(ip_adapter_image=image(27, (40, 50, 3)),
                  ip_adapter_scale=0.8)
    if entry == "txt2img":
        def request(p, **k):
            return p.txt2img(PROMPT, resolution=RES, **k)
        initial, _ = _draws(17)
        draws = dict(initial_noise=initial)
        name = "euler_sample_latent" if sampler != "ddim" else "sample_latent"
    else:
        ref = image(45)

        def request(p, **k):
            return p.img2img(PROMPT, ref, strength=0.6, **k)
        draws = dict(noise=normal(jax.random.PRNGKey(17)))
        name = "k_refine_latent" if sampler != "ddim" else "refine_latent"
    want_images, want_latent = run_reference(
        monkeypatch, jpipe, lambda: request(jpipe, **kw))
    inject(monkeypatch, name, **draws)
    got = request(tpipe, **kw)
    latent = tpipe.last_latent
    start = (initial if entry == "txt2img" else tpipe._encode(ref).numpy())
    plain = request(tpipe, **{k: v for k, v in kw.items()
                              if not k.startswith("control")})
    return dict(got=got, port=types.SimpleNamespace(last_latent=latent),
                want_images=want_images, want_latent=want_latent,
                start=start, plain=plain)


@pytest.fixture(scope="module")
def control_runs(pipes, ip_files):
    """case -> _control_request's result, each request run once for the
    ControlNet test and the IP-Adapter test that share it."""
    done = {}

    def run(case):
        if case not in done:
            with pytest.MonkeyPatch.context() as mp:
                done[case] = _control_request(case, pipes, ip_files, mp)
        return done[case]
    return run


@pytest.mark.parametrize("case", list(CONTROL_CASES))
def test_controlnet_requests_match_reference(case, control_runs):
    """txt2img and img2img (strength 0.6) with one ControlNet and with
    two (their residuals summed, each with its scale and window): 4 steps,
    [0, 1] control images at the request's size; heun's second evaluation
    of a step takes that step's window scale. The txt2img cases carry an
    IP-Adapter too (test_ip_adapter_txt2img_matches_reference), so each
    reference loop compiles once for both features. Without the control
    keywords the image moves by more than one level."""
    r = control_runs(case)
    assert_matches(r["got"], r["port"], r["want_images"], r["want_latent"],
                   r["start"])
    assert np.abs(r["plain"].astype(int) - r["got"].astype(int)).max() > 1


def _plus_tensors(rng, embedding_dim, out_ctx, dim=32, n_q=4, depth=2,
                  inner=128):
    """Official-layout 'plus' Resampler tensors (heads = inner / 64)."""
    def w(*shape):
        return (rng.standard_normal(shape) * 0.08).astype(np.float32)

    t = {"image_proj.latents": w(1, n_q, dim),
         "image_proj.proj_in.weight": w(dim, embedding_dim),
         "image_proj.proj_in.bias": w(dim),
         "image_proj.proj_out.weight": w(out_ctx, dim),
         "image_proj.proj_out.bias": w(out_ctx),
         "image_proj.norm_out.weight": 1.0 + w(out_ctx),
         "image_proj.norm_out.bias": w(out_ctx)}
    for i in range(depth):
        a, f = f"image_proj.layers.{i}.0", f"image_proj.layers.{i}.1"
        for n in ("norm1", "norm2"):
            t[f"{a}.{n}.weight"], t[f"{a}.{n}.bias"] = 1.0 + w(dim), w(dim)
        t[f"{a}.to_q.weight"] = w(inner, dim)
        t[f"{a}.to_kv.weight"] = w(2 * inner, dim)
        t[f"{a}.to_out.weight"] = w(dim, inner)
        t[f"{f}.0.weight"], t[f"{f}.0.bias"] = 1.0 + w(dim), w(dim)
        t[f"{f}.1.weight"] = w(4 * dim, dim)
        t[f"{f}.3.weight"] = w(dim, 4 * dim)
    return t


def write_ip_adapter(path, variant, ucfg, seed=26):
    """An official-layout adapter file (tests/test_ip_adapter.py's): the
    image projection, then ip_adapter.{1, 3, ...}.to_{k,v}_ip over the
    cross-attentions in checkpoint order with random widths' weights."""
    rng = np.random.default_rng(seed)
    ctx = ucfg.context_dim
    if variant == "plus":
        t = _plus_tensors(rng, TINY_VISION["n_state"], ctx)
    else:
        t = {"image_proj.proj.weight": (0.1 * rng.standard_normal(
                (4 * ctx, TINY_VISION["embed_dim"]))).astype(np.float32),
             "image_proj.proj.bias": (0.1 * rng.standard_normal(4 * ctx)
                                      ).astype(np.float32),
             "image_proj.norm.weight": (1 + 0.1 * rng.standard_normal(ctx)
                                        ).astype(np.float32),
             "image_proj.norm.bias": (0.1 * rng.standard_normal(ctx)
                                      ).astype(np.float32)}
    in_plan, mid, out_plan = JU.unet_block_plan(ucfg)
    j = 0
    for spec in ([s for s in in_plan if s.kind.startswith("res_t")]
                 + [s for s in out_plan if s.kind.startswith("res_t")]
                 + [mid]):
        for _ in range(spec.depth):
            for kk in ("to_k_ip", "to_v_ip"):
                t[f"ip_adapter.{2 * j + 1}.{kk}.weight"] = (
                    0.1 * rng.standard_normal((spec.ch_out, ctx))
                ).astype(np.float32)
            j += 1
    st_save(t, path)
    return path


@pytest.mark.parametrize("variant", ["proj", "plus"])
def test_ip_adapter_txt2img_matches_reference(variant, ip_files,
                                              control_runs, tmp_path):
    """An official-layout file loaded by both packages (the plus geometry
    read off the tensors), then txt2img with a 40 x 50 image prompt at
    scale 0.8 beside the ControlNet(s) of IP_CASES' request (heun for
    proj, dpmpp for plus): the tokens, the zero-embedding (proj) or
    zero-pixel (plus) unconditional rows and the six sites' numbering;
    the port's writer gives the file's tensors back."""
    path = ip_files[variant]
    adapter, t_cfg = load_ip_adapter_file(path, TINY_BASE.unet_config(),
                                          "cpu")
    assert (t_cfg.variant, t_cfg.n_tokens) == (
        "resampler" if variant == "plus" else "proj", 4)
    _, cfg = j_load_ip(path, TINY_BASE.unet_config())
    assert cfg.n_tokens == t_cfg.n_tokens
    r = control_runs(IP_CASES[variant])
    assert_matches(r["got"], r["port"], r["want_images"], r["want_latent"],
                   r["start"])
    again = load_ip_adapter_file(
        save_ip_adapter_file(str(tmp_path / "again.safetensors"), adapter),
        TINY_BASE.unet_config(), "cpu")[0]
    for k, v in adapter.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_ip2p_three_way_eps_matches_reference(pipes):
    """_cfg_eps's batch-3 InstructPix2Pix call over the rows3 contexts
    and the [zeros | image | image] concat: 2e-3."""
    jpipe, tpipe = pipes["edit"]
    cond = tpipe.conditioning([PROMPT], RES, NEGATIVE, profile_stages=False)
    rng = np.random.default_rng(28)
    lat = rng.standard_normal(SHAPE).astype(np.float32)
    cc = rng.standard_normal(SHAPE).astype(np.float32)
    ctx3, ch3 = S._cfg_contexts(TINY_EDIT, cond, torch.float32, rows3=True)
    cc3 = torch.cat([torch.zeros(SHAPE), torch.tensor(cc),
                     torch.tensor(cc)])
    t = torch.tensor(600)
    got = S._cfg_eps(tpipe.unet, TINY_EDIT, torch.tensor(lat), t, ctx3,
                     ch3, 7.5, torch.float32, concat=cc3, image_scale=1.8)
    want = jax.jit(lambda p, *a: R._cfg_eps(
        p, TINY_EDIT, *a[:4], 7.5, jnp.float32, concat=a[4],
        image_scale=1.8))(jpipe.unet_params, lat, jnp.asarray(600),
                          ctx3.numpy(), ch3.numpy(), cc3.numpy())
    _close(got, want, UNET_TOL)


@pytest.mark.parametrize("sampler", ["ddim", "euler_a"])
def test_ip2p_matches_reference(sampler, pipes, monkeypatch):
    """ip2p at guidance 7.5 / image guidance 1.8, 4 steps (euler_a with
    its step noise from the reference's scan key); the edit image is
    encoded to its unscaled posterior mean (scale factor 1.0)."""
    jpipe, tpipe = pipes["edit"]
    ref = image(29)
    kw = dict(n_steps=4, seed=19, negative_prompt=NEGATIVE, sampler=sampler,
              image_guidance_scale=1.8)
    want_images, want_latent = run_reference(
        monkeypatch, jpipe, lambda: jpipe.ip2p(PROMPT, ref, **kw))
    noise_key, scan_key = jax.random.split(jax.random.PRNGKey(19))
    draws = dict(initial_noise=normal(noise_key))
    if sampler == "euler_a":
        draws["step_noise"] = scan_draws(scan_key, 4)[1]
    inject(monkeypatch, "euler_sample_latent" if sampler == "euler_a"
           else "sample_latent", **draws)
    scales = []
    real_encode = tpipeline.encode_images_to_latent
    monkeypatch.setattr(tpipeline, "encode_images_to_latent",
                        lambda vae, im, sf: scales.append(sf)
                        or real_encode(vae, im, sf))
    got = tpipe.ip2p(PROMPT, ref, **kw)
    assert scales == [1.0]
    assert_matches(got, tpipe, want_images, want_latent,
                   draws["initial_noise"])


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
def test_txt2img_hires_matches_reference(sampler, pipes, monkeypatch):
    """Hires-fix 1.5x (64 -> 96 pixels) at strength 0.5, 4 steps: the base
    pass, the bicubic latent upscale, the second conditioning and the
    tail at the target size; the base's and the hires re-noise's draws
    from the reference's keys."""
    jpipe, tpipe = pipes["j"], pipes["t"]
    kw = dict(resolution=RES, hires_scale=1.5, hires_strength=0.5,
              n_steps=4, seed=20, negative_prompt=NEGATIVE, sampler=sampler)
    want_images, want_latent = run_reference(
        monkeypatch, jpipe, lambda: jpipe.txt2img_hires(PROMPT, **kw))
    base_key, hires_key = jax.random.split(jax.random.PRNGKey(20))
    initial = normal(jax.random.split(base_key)[0])
    renoise = np.asarray(jax.random.normal(hires_key, (1, 12, 12, 4)))
    k = sampler != "ddim"
    inject(monkeypatch, "euler_sample_latent" if k else "sample_latent",
           initial_noise=initial)
    inject(monkeypatch, "k_refine_latent" if k else "refine_latent",
           noise=renoise)
    got = tpipe.txt2img_hires(PROMPT, **kw)
    assert got.shape == (1, 96, 96, 3)
    assert_matches(got, tpipe, want_images, want_latent, 0.0)


@pytest.mark.parametrize("direction", ["decode", "encode"])
def test_tiled_vae_matches_reference(direction, pipes):
    """Tile 4 (overlap 1, stride 3) over an 8 x 8 latent: 3 x 3 tiles,
    edge-aligned, ramp-blended in f32; the decode within one u8 level,
    the encode 2e-3; a latent within one tile takes the untiled path."""
    jpipe, tpipe = pipes["j"], pipes["t"]
    if direction == "decode":
        lat = np.random.default_rng(32).standard_normal(
            (2, 8, 8, 4)).astype(np.float32) * 0.5
        want = np.asarray(j_decode_tiled(jpipe.vae_params, TINY_VAE, lat,
                                         tile=4))
        got = decode_latent_tiled(tpipe.vae, torch.from_numpy(lat),
                                  tile=4).numpy()
        assert got.dtype == np.uint8 and got.std() > 0
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        whole = decode_latent_tiled(tpipe.vae, torch.from_numpy(lat), tile=8)
        assert np.abs(whole.numpy().astype(int) - got.astype(int)).max() > 1
    else:
        imgs = image(33, (2, *RES, 3))
        want = np.asarray(j_encode_tiled(jpipe.vae_params, TINY_VAE, imgs,
                                         tile=4))
        got = encode_images_tiled(tpipe.vae_encoder, torch.from_numpy(imgs),
                                  tile=4)
        _close(got, want, ENCODE_TOL)


def test_module11_refusals_are_the_references(pipes):
    """The reference's messages: DeepCache and PAG with a ControlNet, a
    control image without one, or of another size, ip2p on a 4-channel
    UNet, and the 3-way CFG with guidance_rescale."""
    tpipe = dataclasses.replace(pipes["t"], controlnet=pipes["nets"][0])
    ci = image(41, (*RES, 3))
    kw = dict(resolution=RES, n_steps=2)
    cases = [
        (dict(control_image=ci, deepcache=(2, 1)), "incompatible with "
                                                   "ControlNet"),
        (dict(control_image=ci, pag_scale=2.0), "not combinable with "
                                                "ControlNet"),
        (dict(control_image=ci[:32]), "they must match"),
    ]
    for options, msg in cases:
        with pytest.raises(ValueError, match=msg):
            tpipe.txt2img(PROMPT, **kw, **options)
    with pytest.raises(ValueError, match="no ControlNet is loaded"):
        pipes["t"].txt2img(PROMPT, control_image=ci, **kw)
    with pytest.raises(ValueError, match="no IP-Adapter is loaded"):
        pipes["t"].txt2img(PROMPT, ip_adapter_image=ci, **kw)
    with pytest.raises(ValueError, match="needs an 8-channel edit UNet"):
        pipes["t"].ip2p(PROMPT, image(42), n_steps=2)
    _, tedit = pipes["edit"]
    with pytest.raises(ValueError, match="does not apply to the ip2p"):
        S.sample_latent(tedit.unet, TINY_EDIT, tedit.alphas_cumprod,
                        tedit.conditioning([PROMPT], RES), None,
                        n_steps=2, compute_dtype=torch.float32,
                        initial_noise=torch.zeros(SHAPE),
                        concat_channels=torch.zeros(SHAPE), edit=True,
                        guidance_rescale=0.7)


def test_edit_unet_mpk_carries_its_eight_channels(pipes, tmp_path):
    """An 8-channel UNet written as diffuser.mpk + diffuser.cfg by the
    reference's writers: the port's .mpk reader gives in_channels 8 and
    the tree the reference's reader gives (the native layout goes through
    the CLI's --edit-image case below)."""
    import sdxl_tpu.io.checkpoint as rck
    from sdxl_tpu.configs import save_cfg as j_save_cfg
    from sdxl_tpu.io.burn_mpk_write import write_diffuser_mpk
    from sdxl_tpu_torch.io.checkpoint import flatten_pytree, load_diffuser_mpk

    tree = reference_tree(pipes["edit"][1].unet)
    alphas = np.asarray(pipes["j"].alphas_cumprod)
    write_diffuser_mpk(str(tmp_path / "diffuser.mpk"),
                       TINY_EDIT.unet_config(), tree, alphas)
    j_save_cfg(str(tmp_path / "diffuser.cfg"), TINY_EDIT)
    cfg, got, got_alphas = load_diffuser_mpk(str(tmp_path))
    j_cfg, want, _ = rck.load_diffuser_mpk(str(tmp_path),
                                           dtype=jnp.float32)
    assert cfg.in_channels == j_cfg.in_channels == 8
    got, want = flatten_pytree(got), rck.flatten_pytree(want)
    assert set(got) == set(want) and got["input_blocks.0.conv.w"].shape[2] == 8
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    np.testing.assert_array_equal(got_alphas, alphas)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_files(pipes, vision, tmp_path_factory):
    root = tmp_path_factory.mktemp("cli11")
    tpipe = pipes["t"]
    ip = write_ip_adapter(str(root / "ip.safetensors"), "proj",
                          TINY_BASE.unet_config())
    return dict(
        ckpt=save_native_pipeline(str(root / "ckpt"), tpipe),
        edit=save_native_pipeline(str(root / "edit"), pipes["edit"][1]),
        cn=write_diffusers_controlnet_dir(str(root / "cn"), pipes["nets"][0]),
        ip=ip, enc=save_clip_vision_dir(str(root / "enc"), vision[1]),
        ctl=save_images(image(43, (1, *RES, 3)), str(root / "ctl"))[0],
        ipimg=save_images(image(44, (1, 40, 40, 3)), str(root / "ipimg"))[0],
        ref=save_images(image(46), str(root / "ref"))[0])


def _with_ip(p, f):
    adapter, _ = load_ip_adapter_file(f["ip"], TINY_BASE.unet_config(),
                                      "cpu")
    return dataclasses.replace(p, ip_adapter=adapter)


CLI_CASES = {
    "controlnet": (["--controlnet", "{cn}", "--control-image", "{ctl}",
                    "--control-end", "0.5"],
                   lambda p, f, kw, pipes: dataclasses.replace(
                       p, controlnet=pipes["nets"][0]).txt2img(
                       resolution=RES, control_image=load_images(
                           [f["ctl"]])[0], control_end=0.5, **kw)),
    "ip_adapter": (["--ip-adapter", "{ip}", "--ip-image-encoder", "{enc}",
                    "--ip-image", "{ipimg}", "--ip-scale", "0.8"],
                   lambda p, f, kw, pipes: _with_ip(p, f).txt2img(
                       resolution=RES, ip_adapter_image=load_images(
                           [f["ipimg"]])[0], ip_adapter_scale=0.8, **kw)),
    "edit_image": (["--model-dir", "{edit}", "--edit-image", "{ref}",
                    "--image-guidance-scale", "1.8"],
                   lambda p, f, kw, pipes: pipes["edit"][1].ip2p(
                       image_guidance_scale=1.8,
                       edit_images=load_images([f["ref"]]), **kw)),
    "hires_scale": (["--hires-scale", "1.5", "--hires-strength", "0.5",
                     "--sampler", "dpmpp"],
                    lambda p, f, kw, pipes: p.txt2img_hires(
                        resolution=RES, hires_scale=1.5, hires_strength=0.5,
                        sampler="dpmpp", **kw)),
    "vae_tile": (["--vae-tile", "4", "--reference-img", "{ref}",
                  "--img2img-strength", "0.6"],
                 lambda p, f, kw, pipes: dataclasses.replace(
                     p, vae_tile=4).img2img(
                     reference_images=np.repeat(load_images([f["ref"]]), 2,
                                                axis=0),
                     strength=0.6, **kw)),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_module11_flags_match_the_in_memory_pipeline(case, pipes,
                                                         cli_files,
                                                         tmp_path):
    """main(..., device="cpu") on port-written files (a native checkpoint,
    the 8-channel one for --edit-image, a ControlNet directory, an adapter
    file and its encoder directory) writes, pixel for pixel, what the
    in-memory pipeline returns for the same request and seed."""
    from sdxl_tpu_torch.cli.sample import main

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
    want = call(pipes["t"], cli_files,
                dict(prompts=prompts, n_steps=3, seed=3,
                     negative_prompt=NEGATIVE), pipes)
    np.testing.assert_array_equal(got, want)


CLI_ERRORS = {
    "controlnet_alone": ["--controlnet", "{cn}"],
    "control_count": ["--controlnet", "{cn}", "--control-image", "{ctl}",
                      "--controlnet", "{cn}"],
    "control_scales": ["--controlnet", "{cn}", "--control-image", "{ctl}",
                       "--controlnet", "{cn}", "--control-image", "{ctl}",
                       "--control-scale", "1", "--control-scale", "2",
                       "--control-scale", "3"],
    "ip_alone": ["--ip-image", "{ipimg}"],
    "hires_refiner": ["--hires-scale", "1.5", "--use-refiner"],
    "hires_controlnet": ["--hires-scale", "1.5", "--controlnet", "{cn}",
                         "--control-image", "{ctl}"],
    "edit_reference": ["--edit-image", "{ref}", "--reference-img", "{ref}"],
    "edit_pag": ["--edit-image", "{ref}", "--pag-scale", "3"],
    "edit_deepcache": ["--edit-image", "{ref}", "--deepcache", "2"],
}


@pytest.mark.parametrize("case", list(CLI_ERRORS))
def test_cli_bad_combinations_exit_1_as_the_reference(case, cli_files,
                                                      capsys, monkeypatch,
                                                      tmp_path):
    import sdxl_tpu.cli.sample as j_cli
    import sdxl_tpu.pipeline.loader as j_loader
    from sdxl_tpu_torch.cli.sample import main

    class Stub:  # the reference CLI's pipeline, never sampled from
        diffuser_cfg = TINY_BASE

    monkeypatch.setattr(j_loader, "load_pipeline", lambda *a, **k: Stub())
    argv = ["--model-dir", cli_files["ckpt"], "--f32", "--prompt", "a cat",
            "--output-dir", str(tmp_path / "x"),
            *(a.format(**cli_files) for a in CLI_ERRORS[case])]

    def error_line(rc):
        assert rc == 1
        lines = [ln for ln in capsys.readouterr().err.splitlines()
                 if ln.startswith("error:")]
        assert len(lines) == 1
        return lines[0]

    want = error_line(j_cli.main(argv))
    assert error_line(main(argv, device="cpu")) == want
    assert not os.path.exists(tmp_path / "x0.png")
