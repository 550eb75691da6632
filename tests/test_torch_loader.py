"""Module 8, loading: the port's readers and load_pipeline against the
reference's, on checkpoints the reference's own writers produce here.

One tiny model (the CLIP towers of test_torch_pipeline.py, its UNet, and
a four-level VAE in the diffusers-canonical channel plan) is written once
in each layout that detect_format knows: native (as the port writes it,
unfused, and as a loaded reference pipeline writes it, fused qkv and
folded upsample convs), burn .mpk, the .npy dump tree, a diffusers
directory (bf16), and sgm single files (.safetensors in f16, .ckpt in
f32). The port's load_pipeline(device="cpu") must give state_dicts
bitwise equal to io/bridge.py of the reference reader's tree for the same
file (UNet in bf16), with the same alphas_cumprod, scale_factor and
configs. The port's safetensors and msgpack readers are held to the
packages; LoRA merges to the reference's (f32, within 1e-7 absolute +
1e-6 relative); textual inversion exactly. No JAX pipeline runs.
"""

import copy
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import load_file as st_load
from safetensors.numpy import save_file as st_save

import sdxl_tpu.io.checkpoint as rck
import sdxl_tpu.io.diffusers_sdxl as j_dif
import sdxl_tpu.io.hf_sdxl as j_hf
import sdxl_tpu.io.params_builder as j_pb
from sdxl_tpu.io.burn_mpk import parse_mpk_file as j_parse_mpk
from sdxl_tpu.io.params_builder import build_clip as j_build_clip
from sdxl_tpu.configs import (
    AutoencoderConfig,
    CLIPConfig,
    LatentDecoderConfig,
)
from sdxl_tpu.configs import save_cfg as j_save_cfg
from sdxl_tpu.io.burn_mpk_write import (
    write_diffuser_mpk,
    write_embedder_mpk,
    write_latent_decoder_mpk,
)
from sdxl_tpu.io.diffusers_sdxl import (
    infer_sdxl_configs_from_diffusers_dir as j_infer,
)
from sdxl_tpu.io.diffusers_sdxl import load_sdxl_diffusers_dir as j_load_dif
from sdxl_tpu.io.diffusers_write import write_diffusers_pipeline_dir
from sdxl_tpu.io.hf_sdxl import load_sdxl_safetensors as j_load_sgm
from sdxl_tpu.io.lora import apply_lora_files as j_apply_lora_files
from sdxl_tpu.io.npy_tree import write_scalar, write_shape_prefixed
from sdxl_tpu.io.textual_inversion import apply_textual_inversions as j_apply_ti
from sdxl_tpu.models.clip import init_clip
from sdxl_tpu.models.unet import fuse_unet_qkv, init_unet
from sdxl_tpu.models.vae import init_autoencoder
from sdxl_tpu.pipeline.pipeline import SDXLPipeline as JPipeline
from sdxl_tpu.pipeline.sampler import scaled_linear_alphas_cumprod
from sdxl_tpu.tokenizer import ClipTokenizer as JClip
from sdxl_tpu.tokenizer import OpenClipTokenizer as JOpenClip
from sdxl_tpu_torch.io import safetensors as sft
from sdxl_tpu_torch.io.bridge import (
    clip_state_dict,
    unet_state_dict,
    vae_decoder_state_dict,
    vae_encoder_state_dict,
)
from sdxl_tpu_torch.io.burn_mpk import ExtType, parse_mpk_file, unpackb
from sdxl_tpu_torch.io.checkpoint import save_native_pipeline
from sdxl_tpu_torch.io.params_builder import build_clip
from sdxl_tpu_torch.io.lora import apply_lora_files
from sdxl_tpu_torch.io.textual_inversion import apply_textual_inversions
from sdxl_tpu_torch.models.clip import CLIPTextModel
from sdxl_tpu_torch.pipeline import loader
from sdxl_tpu_torch.pipeline.loader import detect_format, load_pipeline
from sdxl_tpu_torch.tokenizer import ClipTokenizer, OpenClipTokenizer
from tests.test_hf_sdxl import (
    inv_linear,
    inv_norm,
    make_ldm_unet_dict,
    make_ldm_vae_dict,
)
from tests.test_io import (
    _FUZZ_MATRIX,
    TINY_CLIP,
    _enc_clip,
    write_clip_npy,
    write_unet_npy,
    write_vae_npy,
)
from tests.test_pipeline_e2e import TINY_DIFFUSER
from tests.test_torch_pipeline import TINY_EMBEDDER
from tests.test_torch_unet import random_tree
from tests.torch_parity import fast_reference_compiles  # noqa: F401

# One intra-op thread: the suite runs six workers on shared cores.
torch.set_num_threads(1)

# the diffusers-canonical decoder plan (the diffusers writer needs it),
# four levels as the sgm reader expects
TINY_VAE = AutoencoderConfig(
    encoder_channels=((16, 16), (16, 32), (32, 32), (32, 32)),
    decoder_channels=((32, 32), (32, 32), (32, 32), (32, 16)),
    n_group=4,
)
LAYOUTS = ["native", "native_fused", "mpk", "npy", "diffusers",
           "sgm_safetensors", "sgm_ckpt"]
SCALE = 0.2  # not the 0.13025 default: each layout's own value must load


@pytest.fixture(scope="module")
def trees():
    emb = {"clip": random_tree(init_clip, TINY_EMBEDDER.clip_config, seed=1),
           "open_clip": random_tree(init_clip, TINY_EMBEDDER.open_clip_config,
                                    seed=2)}
    unet = random_tree(init_unet, TINY_DIFFUSER.unet_config(), jnp.float32,
                       seed=3)
    vae = random_tree(init_autoencoder, TINY_VAE, seed=4, scale=0.05)
    # not the default table: each layout's own alphas must load
    alphas = (scaled_linear_alphas_cumprod() ** 1.01).astype(np.float32)
    return emb, unet, vae, alphas


def _jpipe(emb, unet, vae, alphas, tokenizers):
    return JPipeline(
        embedder_cfg=TINY_EMBEDDER, embedder_params=emb,
        diffuser_cfg=TINY_DIFFUSER, unet_params=unet,
        alphas_cumprod=jnp.asarray(alphas), vae_cfg=TINY_VAE,
        vae_params=vae, scale_factor=SCALE,
        clip_tokenizer=tokenizers[0], open_clip_tokenizer=tokenizers[1],
        compute_dtype=jnp.float32)


def _sgm_dict(emb, unet, vae):
    """The sgm single-file key layout (tests/test_hf_sdxl.py's writers,
    plus both CLIP towers under their conditioner prefixes)."""
    d = make_ldm_unet_dict(TINY_DIFFUSER.unet_config(), unet)
    d.update(make_ldm_vae_dict(vae))
    pre = "conditioner.embedders.0.transformer.text_model"
    p = emb["clip"]
    d[f"{pre}.embeddings.token_embedding.weight"] = p["token_embedding"]
    d[f"{pre}.embeddings.position_embedding.weight"] = p["position_embedding"]
    for i, b in enumerate(p["blocks"]):
        s = f"{pre}.encoder.layers.{i}"
        for n, k in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                     ("out_proj", "out")):
            inv_linear(d, f"{s}.self_attn.{n}", b["attn"][k])
        inv_norm(d, f"{s}.layer_norm1", b["attn_ln"])
        inv_linear(d, f"{s}.mlp.fc1", b["mlp"]["fc1"])
        inv_linear(d, f"{s}.mlp.fc2", b["mlp"]["fc2"])
        inv_norm(d, f"{s}.layer_norm2", b["mlp_ln"])
    inv_norm(d, f"{pre}.final_layer_norm", p["layer_norm"])
    d[f"{pre}.text_projection.weight"] = p["text_projection"].T
    pre = "conditioner.embedders.1.model"
    p = emb["open_clip"]
    d[f"{pre}.token_embedding.weight"] = p["token_embedding"]
    d[f"{pre}.positional_embedding"] = p["position_embedding"]
    for i, b in enumerate(p["blocks"]):
        s = f"{pre}.transformer.resblocks.{i}"
        d[f"{s}.attn.in_proj_weight"] = np.concatenate(
            [b["attn"][x]["w"].T for x in "qkv"], axis=0)
        d[f"{s}.attn.in_proj_bias"] = np.concatenate(
            [b["attn"][x]["b"] for x in "qkv"])
        inv_linear(d, f"{s}.attn.out_proj", b["attn"]["out"])
        inv_norm(d, f"{s}.ln_1", b["attn_ln"])
        inv_linear(d, f"{s}.mlp.c_fc", b["mlp"]["fc1"])
        inv_linear(d, f"{s}.mlp.c_proj", b["mlp"]["fc2"])
        inv_norm(d, f"{s}.ln_2", b["mlp_ln"])
    inv_norm(d, f"{pre}.ln_final", p["layer_norm"])
    d[f"{pre}.text_projection"] = p["text_projection"]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in d.items()}


@pytest.fixture(scope="module")
def layouts(trees, tmp_path_factory):
    """{layout: path} of the same model, each written once by the
    reference's writers."""
    emb, unet, vae, alphas = trees
    root = tmp_path_factory.mktemp("layouts")
    out = {}
    toks = JClip(None), JOpenClip(None)

    def mk(name):
        path = str(root / name)
        os.makedirs(path)
        out[name] = path
        return path

    rck.save_native_pipeline(mk("native"),
                             _jpipe(emb, unet, vae, alphas, toks))
    fused = jax.tree.map(np.asarray, fuse_unet_qkv(unet))
    rck.save_native_pipeline(mk("native_fused"),
                             _jpipe(emb, fused, vae, alphas, toks))

    d = mk("mpk")
    write_embedder_mpk(os.path.join(d, "embedder.mpk"), emb)
    write_diffuser_mpk(os.path.join(d, "diffuser.mpk"),
                       TINY_DIFFUSER.unet_config(), unet, alphas)
    write_latent_decoder_mpk(os.path.join(d, "latent_decoder.mpk"), vae)
    j_save_cfg(os.path.join(d, "embedder.cfg"), TINY_EMBEDDER)
    j_save_cfg(os.path.join(d, "diffuser.cfg"), TINY_DIFFUSER)
    j_save_cfg(os.path.join(d, "latent_decoder.cfg"),
               LatentDecoderConfig(scale_factor=SCALE))

    d = mk("npy")
    for k in ("clip", "open_clip"):
        write_clip_npy(os.path.join(d, "embedder", k), emb[k])
    write_unet_npy(os.path.join(d, "diffuser", "diffuser_base"),
                   TINY_DIFFUSER.unet_config(), unet)
    write_shape_prefixed(os.path.join(d, "diffuser", "alphas_cumprod.npy"),
                         alphas)
    write_vae_npy(os.path.join(d, "latent_decoder", "autoencoder"), vae)
    write_scalar(os.path.join(d, "latent_decoder", "scale_factor.npy"), SCALE)

    # SDXL's ViT-L tower ships without a projection in diffusers dirs
    emb_l = dict(emb, clip=dict(emb["clip"], text_projection=None))
    write_diffusers_pipeline_dir(mk("diffusers"),
                                 _jpipe(emb_l, unet, vae, alphas, toks),
                                 dtype=ml_dtypes.bfloat16)

    flat = _sgm_dict(emb, unet, vae)
    st_save({k: v.astype(np.float16) for k, v in flat.items()},
            os.path.join(mk("sgm_safetensors"), "sd_xl_base_1.0.safetensors"))
    out["sgm_ckpt"] = os.path.join(mk("sgm_ckpt_dir"), "sdxl.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in flat.items()},
                "global_step": 7}, out["sgm_ckpt"])
    return out


def _bf16(tree):
    """The reference's cast of the UNet at load (jnp bf16, round to
    nearest even), done with ml_dtypes so that no XLA convert compiles."""
    return jax.tree.map(lambda a: np.asarray(a).astype(ml_dtypes.bfloat16),
                        tree)


def reference_load(layout, path):
    """(embedder cfg, diffuser cfg, vae cfg, embedder tree, unet tree,
    vae tree, alphas, scale) through the reference's own readers, the
    UNet cast to bf16."""
    e_cfg, d_cfg, v_cfg = TINY_EMBEDDER, TINY_DIFFUSER, TINY_VAE
    alphas, scale = scaled_linear_alphas_cumprod(), 0.13025
    f32 = jnp.float32
    if layout.startswith("native"):
        def p(n):
            return os.path.join(path, n)

        emb = rck.load_native(p("embedder.safetensors"))
        unet = rck.load_native(p("diffuser.safetensors"))
        vae = rck.load_native(p("latent_decoder.safetensors"))
        alphas = rck.load_native(p("alphas_cumprod.safetensors"))[
            "alphas_cumprod"]
        scale = SCALE
    elif layout == "mpk":
        e_cfg, emb = rck.load_embedder_mpk(path)
        d_cfg, unet, alphas = rck.load_diffuser_mpk(path, "diffuser", f32)
        l_cfg, vae = rck.load_latent_decoder_mpk(path)
        scale = l_cfg.scale_factor
    elif layout == "npy":
        emb = rck.load_embedder_npy(path, e_cfg)
        unet, alphas = rck.load_diffuser_npy(path, d_cfg, False, f32)
        vae, scale = rck.load_latent_decoder_npy(path)
    elif layout == "diffusers":
        e_cfg, d_cfg, v_cfg = j_infer(path)
        emb, unet, vae, alphas, scale, d_cfg = j_load_dif(
            path, d_cfg, e_cfg, f32, vae_cfg=v_cfg)
    else:
        f = path if layout == "sgm_ckpt" else os.path.join(
            path, "sd_xl_base_1.0.safetensors")
        emb, unet, vae = j_load_sgm(f, d_cfg, e_cfg, f32)
    return (e_cfg, d_cfg, v_cfg, emb, _bf16(unet), vae, np.asarray(alphas),
            scale)


def assert_state_equal(module, want):
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        assert torch.equal(got[k], w), k


@pytest.fixture
def reference_host_casts(monkeypatch):
    """The reference readers cast each leaf on the host path that its own
    hf_sdxl._as offers (numpy and ml_dtypes): the same values as its jnp
    casts into f32, without an XLA convert compiled per shape."""
    cast = functools.partial(j_hf._as, host=True)
    for mod in (j_hf, j_dif, j_pb):
        monkeypatch.setattr(mod, "_as", cast)


@pytest.fixture
def sdxl_presets_are_tiny(monkeypatch):
    """npy and sgm files carry no configs: the loaders assume SDXL 1.0's,
    here the tiny model's."""
    monkeypatch.setattr(loader, "SDXL_EMBEDDER", TINY_EMBEDDER)
    monkeypatch.setattr(loader, "SDXL_BASE_DIFFUSER", TINY_DIFFUSER)
    monkeypatch.setattr(loader, "SDXL_VAE", TINY_VAE)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_loads_bitwise(layout, layouts, sdxl_presets_are_tiny,
                              reference_host_casts):
    path = layouts[layout]
    assert detect_format(path) == {"native_fused": "native",
                                   "sgm_ckpt": "sgm_single_file",
                                   "sgm_safetensors": "sgm_single_file"
                                   }.get(layout, layout)
    e_cfg, d_cfg, v_cfg, emb, unet, vae, alphas, scale = reference_load(
        layout, path)
    pipe = load_pipeline(path, device="cpu")

    for k in ("clip", "open_clip"):
        assert_state_equal(pipe.embedder[k], clip_state_dict(emb[k]))
    assert_state_equal(pipe.unet, unet_state_dict(unet))
    assert_state_equal(pipe.vae, vae_decoder_state_dict(vae))
    assert_state_equal(pipe.vae_encoder, vae_encoder_state_dict(vae))
    np.testing.assert_array_equal(pipe.alphas_cumprod.numpy(), alphas)
    assert pipe.alphas_cumprod.dtype == torch.float32
    assert pipe.scale_factor == pytest.approx(scale, rel=1e-7)
    for got, want in ((pipe.embedder_cfg, e_cfg), (pipe.diffuser_cfg, d_cfg),
                      (pipe.vae_cfg, v_cfg)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("unet_dtype", ["f32", "bf16"])
def test_native_writer_matches_reference(unet_dtype, layouts, f32_pipe,
                                         tmp_path):
    """The port's save_native_pipeline writes what the reference's does: a
    pipeline loaded from the reference-written native dir and written
    back by the port gives the same files, safetensors equal in keys,
    dtypes, shapes and bytes (read with the safetensors package) and .cfg
    JSON equal; with the UNet in bf16, the diffuser file is the
    reference's file cast to bf16."""
    pipe = f32_pipe if unet_dtype == "f32" else load_pipeline(
        layouts["native"], device="cpu")
    ref, out = layouts["native"], str(tmp_path / "port")
    save_native_pipeline(out, pipe)
    assert sorted(os.listdir(out)) == sorted(os.listdir(ref))
    for f in sorted(os.listdir(ref)):
        if f.endswith(".cfg"):
            with open(os.path.join(out, f)) as g, \
                    open(os.path.join(ref, f)) as w:
                assert json.load(g) == json.load(w), f
            continue
        got = st_load(os.path.join(out, f))
        want = st_load(os.path.join(ref, f))
        if f == "diffuser.safetensors" and unet_dtype == "bf16":
            want = {k: v.astype(ml_dtypes.bfloat16) for k, v in want.items()}
        assert sorted(got) == sorted(want), f
        for k, w in want.items():
            g = got[k]
            assert (g.dtype, g.shape) == (w.dtype, w.shape), (f, k)
            np.testing.assert_array_equal(g.reshape(-1).view(np.uint8),
                                          w.reshape(-1).view(np.uint8),
                                          err_msg=f"{f} {k}")


def test_diffusers_configs_are_inferred(layouts):
    """The diffusers dir's own config.json files, not the SDXL presets,
    size the model (no preset patched here)."""
    pipe = load_pipeline(layouts["diffusers"], device="cpu")
    assert dataclasses.asdict(pipe.diffuser_cfg) == dataclasses.asdict(
        j_infer(layouts["diffusers"])[1])
    assert pipe.diffuser_cfg.model_channels == 32
    assert pipe.vae_cfg.n_group == 4


def test_checkpoint_errors_name_the_key(layouts, tmp_path,
                                       reference_host_casts):
    """A native file with a missing tensor fails with the key's name; an
    LCM-distilled UNet (time_embedding.cond_proj), a 9-channel
    (inpainting) and an 8-channel (InstructPix2Pix) UNet load, their
    configs' time_cond_proj_dim 256 and in_channels 9 and 8, bitwise as
    the reference's reader gives them; a refiner asked of a dir without
    one is the reference's FileNotFoundError."""
    src = layouts["native"]
    bad = tmp_path / "bad"
    bad.mkdir()
    for f in os.listdir(src):
        data = open(os.path.join(src, f), "rb").read()
        (bad / f).write_bytes(data)
    flat = st_load(str(bad / "latent_decoder.safetensors"))
    flat.pop("decoder.conv_out.b")
    st_save(flat, str(bad / "latent_decoder.safetensors"))
    with pytest.raises(ValueError, match="decoder.conv_out.bias"):
        load_pipeline(str(bad), device="cpu")

    dif = layouts["diffusers"]
    unet = st_load(os.path.join(dif, "unet",
                                "diffusion_pytorch_model.safetensors"))
    w = unet["conv_in.weight"]
    for name, edit in (
            ("inpaint", {"conv_in.weight": np.concatenate([w, w[:, :1]] * 3,
                                                          axis=1)[:, :9]}),
            ("lcm", {"time_embedding.cond_proj.weight":
                     np.random.default_rng(0).standard_normal(
                         (w.shape[0], 256)).astype(w.dtype)}),
            ("ip2p", {"conv_in.weight": np.concatenate([w, w[:, ::-1]],
                                                       axis=1)})):
        lay = tmp_path / name
        lay.mkdir()
        for sub in os.listdir(dif):
            if sub != "unet":
                os.symlink(os.path.join(dif, sub), lay / sub)
        (lay / "unet").mkdir()
        os.symlink(os.path.join(dif, "unet", "config.json"),
                   lay / "unet" / "config.json")
        st_save(dict(unet, **edit),
                str(lay / "unet" / "diffusion_pytorch_model.safetensors"))
        pipe = load_pipeline(str(lay), device="cpu")
        e_cfg, d_cfg, v_cfg = j_infer(str(lay))
        _, j_unet, _, _, _, d_cfg = j_load_dif(str(lay), d_cfg, e_cfg,
                                               jnp.float32, vae_cfg=v_cfg)
        if name == "lcm":
            assert "cond_proj" in j_unet["time_embed"]
            assert pipe.diffuser_cfg.time_cond_proj_dim == \
                d_cfg.time_cond_proj_dim == 256
        else:
            assert pipe.diffuser_cfg.in_channels == d_cfg.in_channels == (
                9 if name == "inpaint" else 8)
        assert dataclasses.asdict(pipe.diffuser_cfg) == dataclasses.asdict(
            d_cfg)
        assert_state_equal(pipe.unet, unet_state_dict(_bf16(j_unet)))
    with pytest.raises(FileNotFoundError):
        load_pipeline(src, use_refiner=True, device="cpu")
    with pytest.raises(ValueError, match="--quantize must be int8 or int4"):
        load_pipeline(src, quantize="int3", device="cpu")


# ---------------------------------------------------------------------------
# the readers against the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
def test_safetensors_matches_package(dtype, tmp_path):
    rng = np.random.default_rng(0)
    np_dt = {"F32": np.float32, "F16": np.float16,
             "BF16": ml_dtypes.bfloat16}[dtype]
    arrays = {"a.w": rng.standard_normal((3, 5)).astype(np_dt),
              "b": rng.standard_normal((7,)).astype(np_dt),
              "scalar": np.asarray(1.5, np_dt),
              "ids": np.arange(6, dtype=np.int64).reshape(2, 3),
              "n": np.arange(3, dtype=np.int32)}
    meta = {"format": "pt", "note": "x"}

    def as_torch(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    theirs = str(tmp_path / "theirs.safetensors")
    st_save(arrays, theirs, metadata=meta)
    got = sft.load_file(theirs)
    assert sft.read_header(theirs)[0]["__metadata__"] == meta
    for k, a in arrays.items():
        assert torch.equal(got[k], as_torch(a)) and got[k].dtype == \
            as_torch(a).dtype, k

    ours = str(tmp_path / "ours.safetensors")
    sft.save_file({k: as_torch(a) for k, a in arrays.items()}, ours,
                  metadata=meta)
    back = st_load(ours)
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype and back[k].shape == a.shape, k
        np.testing.assert_array_equal(back[k].reshape(-1).view(np.uint8),
                                      a.reshape(-1).view(np.uint8),
                                      err_msg=k)
    with safe_open(ours, "np") as f:
        assert f.metadata() == meta


@pytest.mark.parametrize("single_float", [True, False])
def test_msgpack_decoder_matches_package(single_float):
    rng = np.random.default_rng(1)
    bits = (0.02 * rng.standard_normal(5000)).astype(np.float16)
    bits[::97] = 0  # fixints inside a run of uint16 headers
    record = {
        "item": {
            "clip": {"blocks": [{"weight": {"id": "param-1", "param": {
                "value": bits.view(np.uint16).tolist(), "shape": [50, 100]}},
                "bias": None}]},
            "mixed": [0, -1, -33, 127, 128, 255, 256, 65535, 65536, 2**32,
                      -129, -2**31, -2**40, 1.25, -0.1, True, False, None,
                      "x" * 40, "é", b"\x00\xff" * 200, [], {}],
            "floats": rng.standard_normal(300).tolist(),
            "ints": rng.integers(-2**40, 2**40, 300).tolist(),
            7: "int key",
        },
        "metadata": {"float": "f16", "version": "0.13.0"},
    }
    packed = msgpack.packb(record, use_single_float=single_float)

    def lists(node):  # number arrays come back as numpy arrays
        if isinstance(node, np.ndarray):
            assert node.size >= 16 and node.dtype.kind in "iuf"
            return node.tolist()
        if isinstance(node, dict):
            return {k: lists(v) for k, v in node.items()}
        if isinstance(node, list):
            return [lists(v) for v in node]
        return node

    got = unpackb(packed)
    # each array keeps the width its runs were written in: f16 bit
    # patterns (fixint, uint8 and uint16 runs) read as uint16, single
    # floats as float32
    bits_got = got["item"]["clip"]["blocks"][0]["weight"]["param"]["value"]
    assert bits_got.dtype == np.uint16
    assert got["item"]["floats"].dtype == (np.float32 if single_float
                                           else np.float64)
    assert got["item"]["ints"].dtype == np.int64
    assert lists(got) == msgpack.unpackb(packed, raw=False,
                                         strict_map_key=False)
    ext = msgpack.packb([msgpack.ExtType(5, b"abc"), 1])
    assert unpackb(ext) == [ExtType(5, b"abc"), 1]


# six cases of the reference's fuzz matrix (tests/test_io.py), which runs
# all of them against its own reader: each wrapper (bare, item first,
# metadata first), ParamSerde on and off and in both key orders, the
# extra data nesting, and each leaf encoding (f16 bits and f32 values as
# lists, f16 raw bytes untagged, f32 raw bytes and bf16 bits tagged) once
MPK_CASES = [c for c in _FUZZ_MATRIX if tuple(c.values()) in {
    ("meta_first", True, True, True, "f16_bits"),
    ("bare", False, True, False, "f32_values"),
    ("item_first", True, True, False, "f16_bytes"),
    ("item_first", True, True, True, "f32_bytes_tagged"),
    ("item_first", False, True, False, "bf16_bits_tagged"),
    ("item_first", True, False, False, "f16_bits"),
}]


@pytest.fixture(scope="module")
def tiny_clip_tree():
    return random_tree(init_clip, TINY_CLIP, seed=3)


@pytest.mark.parametrize("layout", MPK_CASES,
                         ids=lambda d: "-".join(str(v) for v in d.values()))
def test_mpk_layouts_match_reference_reader(tmp_path, layout, tiny_clip_tree):
    """burn serde layouts read to the reference reader's tree, exactly."""
    params = tiny_clip_tree
    path = str(tmp_path / "embedder.mpk")
    with open(path, "wb") as f:
        f.write(msgpack.packb(_enc_clip(params, layout)))
    want = j_build_clip(j_parse_mpk(path).child("clip"), TINY_CLIP)
    got = build_clip(parse_mpk_file(path).child("clip"), TINY_CLIP)
    assert_state_equal_trees(got, want)


def assert_state_equal_trees(got, want):
    g, w = clip_state_dict(got), clip_state_dict(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


# ---------------------------------------------------------------------------
# LoRA and textual inversion
# ---------------------------------------------------------------------------

# (base key, down shape, up shape) per module, in each naming style
def _lora_modules(style):
    if style == "te":
        return [("lora_te1_text_model_encoder_layers_0_self_attn_q_proj",
                 32, 32),
                ("lora_te2_text_model_encoder_layers_1_mlp_fc1", 32, 128),
                ("text_encoder_2.text_model.encoder.layers.0.self_attn."
                 "out_proj", 32, 32)]
    sgm = {
        "attn1_q": "input_blocks_4_1_transformer_blocks_0_attn1_to_q",
        "attn1_v": "output_blocks_1_1_transformer_blocks_0_attn1_to_v",
        "attn2_k": "middle_block_1_transformer_blocks_1_attn2_to_k",
        "ff": "input_blocks_7_1_transformer_blocks_1_ff_net_0_proj",
        "proj_in": "output_blocks_3_1_proj_in",
        "conv": "input_blocks_1_0_in_layers_2",
        "emb": "output_blocks_8_0_emb_layers_1",
    }
    dif = {
        "attn1_q": "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q",
        "attn1_v": "up_blocks.0.attentions.1.transformer_blocks.0.attn1.to_v",
        "attn2_k": "mid_block.attentions.0.transformer_blocks.1.attn2.to_k",
        "ff": "down_blocks.2.attentions.0.transformer_blocks.1.ff.net.0.proj",
        "proj_in": "up_blocks.1.attentions.0.proj_in",
        "conv": "down_blocks.0.resnets.0.conv1",
        "emb": "up_blocks.2.resnets.2.time_emb_proj",
    }
    shapes = {"attn1_q": (64, 64), "attn1_v": (128, 128),
              "attn2_k": (64, 128), "ff": (128, 1024), "proj_in": (64, 64),
              "conv": (32, 32), "emb": (128, 32)}
    names = sgm if style == "kohya_sgm" else dif
    pre = {"kohya_sgm": "lora_unet_", "kohya_diffusers": "lora_unet_",
           "peft": "unet.", "old_diffusers": "unet."}[style]
    if style == "kohya_diffusers":
        names = {k: v.replace(".", "_") for k, v in names.items()}
    return [(pre + names[k], *shapes[k]) for k in names]


LORA_STYLES = ["kohya_sgm", "kohya_diffusers", "peft", "old_diffusers", "te"]
SUFFIX = {"kohya_sgm": (".lora_down.weight", ".lora_up.weight"),
          "kohya_diffusers": (".lora_down.weight", ".lora_up.weight"),
          "te": (".lora_down.weight", ".lora_up.weight"),
          "peft": (".lora_A.weight", ".lora_B.weight"),
          "old_diffusers": (".lora.down.weight", ".lora.up.weight")}


@pytest.fixture(scope="module")
def f32_pipe(layouts):
    return load_pipeline(layouts["native"], compute_dtype=torch.float32,
                         device="cpu")


@pytest.mark.parametrize("style", LORA_STYLES)
def test_lora_merge_matches_reference(style, trees, layouts, f32_pipe,
                                      tmp_path):
    """The first style goes through load_pipeline(loras=...); the others
    merge into copies of one loaded pipeline's modules."""
    emb, unet, _, _ = trees
    rng = np.random.default_rng(LORA_STYLES.index(style))
    r = 4
    flat = {}
    for i, (base, d_in, d_out) in enumerate(_lora_modules(style)):
        conv = base.endswith(("in_layers_2", "conv1"))
        down = (r, d_in, 3, 3) if conv else (r, d_in)
        up = (d_out, r, 1, 1) if conv else (d_out, r)
        dn, un = SUFFIX[style]
        flat[base + dn] = (0.1 * rng.standard_normal(down)).astype(np.float32)
        flat[base + un] = (0.1 * rng.standard_normal(up)).astype(np.float32)
        if i % 2:
            flat[base + ".alpha"] = np.asarray(2.0 * (i + 1), np.float32)
    path = str(tmp_path / "lora.safetensors")
    st_save(flat, path)

    want_unet = copy.deepcopy(unet)
    want_emb = copy.deepcopy(emb)
    j_apply_lora_files([(path, 0.7)], unet=want_unet, te1=want_emb["clip"],
                       te2=want_emb["open_clip"])
    if style == LORA_STYLES[0]:
        pipe = load_pipeline(layouts["native"], compute_dtype=torch.float32,
                             loras=[(path, 0.7)], device="cpu")
        unet_m, emb_m = pipe.unet, pipe.embedder
    else:
        unet_m = copy.deepcopy(f32_pipe.unet)
        emb_m = copy.deepcopy(f32_pipe.embedder)
        apply_lora_files([(path, 0.7)], unet=unet_m, te1=emb_m["clip"],
                         te2=emb_m["open_clip"])
    pairs = [(unet_m.state_dict(), unet_state_dict(want_unet))]
    pairs += [(emb_m[k].state_dict(), clip_state_dict(want_emb[k]))
              for k in ("clip", "open_clip")]
    moved = 0
    for got, want in pairs:
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    for got, want in zip(pairs, [unet_state_dict(unet)] + [
            clip_state_dict(emb[k]) for k in ("clip", "open_clip")]):
        moved += sum(not torch.equal(got[0][k], want[k]) for k in want)
    # every adapter landed (attn1 q and v on their rows of the fused qkv)
    assert moved == len(_lora_modules(style))


def _towers(widths):
    """Port towers and reference trees of two CLIP configs."""
    trees, towers = {}, {}
    for k, w, seed in (("clip", widths[0], 5), ("open_clip", widths[1], 6)):
        cfg = CLIPConfig(n_vocab=49408, n_state=w, embed_dim=w, n_head=4,
                         n_ctx=77, n_layer=1)
        trees[k] = random_tree(init_clip, cfg, seed=seed)
        m = CLIPTextModel(cfg, "cpu")
        m.load_state_dict(clip_state_dict(trees[k]))
        towers[k] = m
    return trees, torch.nn.ModuleDict(towers)


@pytest.mark.parametrize("fmt", ["two_tower", "single_tower"])
def test_textual_inversion_matches_reference(fmt, tmp_path):
    widths = (32, 48)
    rng = np.random.default_rng(9)
    if fmt == "two_tower":
        path = str(tmp_path / "concept.safetensors")
        st_save({"clip_l": rng.standard_normal((2, 32)).astype(np.float32),
                 "clip_g": rng.standard_normal((2, 48)).astype(np.float32)},
                path)
        spec = path  # trigger word: the file's stem
    else:  # A1111 .pt for the bigG tower alone, trigger word given
        path = str(tmp_path / "style.pt")
        torch.save({"string_to_param": {"*": torch.from_numpy(
            rng.standard_normal((3, 48)).astype(np.float32))}}, path)
        spec = f"{path}:<my-style>"
    trees, towers = _towers(widths)
    toks = [ClipTokenizer(), OpenClipTokenizer()]
    jtoks = [JClip(None), JOpenClip(None)]
    kw = dict(tower_keys=["clip", "open_clip"], tower_widths=list(widths))
    want = j_apply_ti([spec], tokenizers=jtoks, embedder_params=trees, **kw)
    apply_textual_inversions([spec], tokenizers=toks, embedder=towers, **kw)
    word = "concept" if fmt == "two_tower" else "<my-style>"
    text = f"a photo of {word}, in the style of {word}s"
    for t, jt in zip(toks, jtoks):
        assert t.encode(text) == jt.encode(text)
        assert max(t.encode(text)) >= 49408
    for k in ("clip", "open_clip"):
        got = towers[k].token_embedding.detach().numpy()
        np.testing.assert_array_equal(got, np.asarray(
            want[k]["token_embedding"]))
        assert got.shape[0] == 49408 + (2 if fmt == "two_tower" else 3)


# ---------------------------------------------------------------------------
# the sample CLI
# ---------------------------------------------------------------------------

CLI_ARGS = ["--prompt", "a (red:1.2) cat", "--prompt", "a dog",
            "--height", "64", "--width", "64", "-steps", "2", "-gs", "5.0",
            "--seed", "3", "--negative-prompt", "blurry"]


def test_cli_writes_the_in_memory_pipelines_images(trees, layouts, tmp_path,
                                                  monkeypatch):
    """main() on the native dir writes {output_dir}{i}.png equal, pixel for
    pixel (read with PIL), to txt2img of an in-memory pipeline built
    through io/bridge.py from the same trees; its "parameters" text chunk
    is the reference CLI's for the same arguments, Backend aside."""
    from PIL import Image

    import sdxl_tpu.cli.sample as j_cli
    import sdxl_tpu.pipeline.loader as j_loader
    from sdxl_tpu_torch.cli.sample import main
    from sdxl_tpu_torch.pipeline.pipeline import random_pipeline

    emb, unet, vae, alphas = trees
    out = str(tmp_path / "port" / "img")
    args = ["--model-dir", layouts["native"], *CLI_ARGS]
    assert main(args + ["--output-dir", out], device="cpu") == 0

    pipe = random_pipeline(device="cpu", embedder_cfg=TINY_EMBEDDER,
                           diffuser_cfg=TINY_DIFFUSER, vae_cfg=TINY_VAE)
    for k in ("clip", "open_clip"):
        pipe.embedder[k].load_state_dict(clip_state_dict(emb[k]))
    pipe.unet.load_state_dict(unet_state_dict(unet))
    pipe.vae.load_state_dict(vae_decoder_state_dict(vae))
    pipe.alphas_cumprod = torch.from_numpy(alphas)
    pipe.scale_factor = SCALE
    want = pipe.txt2img(["a (red:1.2) cat", "a dog"], (64, 64), n_steps=2,
                        guidance_scale=5.0, seed=3, negative_prompt="blurry")
    pngs = [Image.open(f"{out}{i}.png") for i in range(2)]
    for png, img in zip(pngs, want):
        np.testing.assert_array_equal(np.asarray(png.convert("RGB")), img)
    assert not os.path.exists(f"{out}2.png")

    class Stub:  # the reference CLI's pipeline, without running it
        class timer:
            summary = staticmethod(lambda: "")
            total = staticmethod(lambda: 0.0)

        def txt2img(self, prompts, **kw):
            return np.zeros((len(prompts), 64, 64, 3), np.uint8)

    monkeypatch.setattr(j_loader, "load_pipeline", lambda *a, **k: Stub())
    ref_out = str(tmp_path / "ref" / "img")
    assert j_cli.main(args + ["--output-dir", ref_out]) == 0
    want_text = Image.open(f"{ref_out}0.png").text["parameters"]
    assert want_text.endswith("Backend: sdxl-tpu")
    assert pngs[0].text["parameters"] == want_text.replace(
        "Backend: sdxl-tpu", "Backend: sdxl_tpu_torch")


def test_cli_parser_is_the_references():
    """Every flag of the reference parses, with its default; each one
    main() does not run names the module that ports it."""
    from sdxl_tpu.cli.sample import build_parser as j_build_parser
    from sdxl_tpu_torch.cli.sample import _PORTED, _WAITS, build_parser

    def flags(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices)
                for a in p._actions}

    got = flags(build_parser())
    assert got == flags(j_build_parser())
    assert set(got) == _PORTED | set(_WAITS)


@pytest.mark.parametrize("extra,module", [
    (["--tp", "2", "--family", "flux", "--edit-image", "e.png"], 17),
    (["--trace", "t"], 7),
    (["--trace", "t", "--quantize", "int8"], 7),
    (["--dp", "2", "--family", "sd3"], 17),
    (["--dp", "2"], 17),
    (["--debug-nans"], 7),
])
def test_cli_unported_flag_exits_1(extra, module, tmp_path, capsys):
    from sdxl_tpu_torch.cli.sample import main

    rc = main(["--random-weights", "--prompt", "a cat", "--output-dir",
               str(tmp_path / "x"), *extra], device="cpu")
    err = capsys.readouterr().err
    assert rc == 1
    assert err.startswith(f"error: {extra[0]} ") and \
        f"is not ported yet (module {module})" in err
    assert not os.listdir(tmp_path)


def test_cli_bad_checkpoint_exits_1(tmp_path, capsys):
    from sdxl_tpu_torch.cli.sample import main

    rc = main(["--model-dir", str(tmp_path), "--prompt", "a cat",
               "--output-dir", str(tmp_path / "x")], device="cpu")
    assert rc == 1
    assert capsys.readouterr().err.startswith(
        f"error: failed to load checkpoint from {tmp_path}: no known "
        f"checkpoint layout")
