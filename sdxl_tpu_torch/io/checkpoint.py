"""Checkpoint loading: reference-compatible model dirs and npy dumps, and
the native format (the port's copy of sdxl_tpu/io/checkpoint.py).

Reference model dir layout (sample/main.rs:28-51, 217-278):
    {model_dir}/embedder.mpk        + embedder.cfg
    {model_dir}/diffuser.mpk        + diffuser.cfg
    {model_dir}/refiner.mpk         + refiner.cfg        (optional)
    {model_dir}/latent_decoder.mpk  + latent_decoder.cfg

Also accepted: the intermediate .npy dump tree consumed by the reference's
`convert` binary (convert/main.rs:72-121):
    {dump_dir}/embedder/{clip,open_clip}
    {dump_dir}/diffuser/{alphas_cumprod.npy, diffuser_base}
    {dump_dir}/diffuser/diffuser_refiner
    {dump_dir}/latent_decoder/{autoencoder, scale_factor.npy}

The mpk and npy loaders return the reference's parameter trees with numpy
f32 leaves; ``stream_state_dict`` turns a flattened tree into the port's
state_dict one leaf at a time.

The native format: one safetensors file per stage holding the reference's
flat tree keys and layouts, plus the same .cfg JSON.
``native_state_dict`` streams such a file into a port state_dict, one
tensor at a time from the mapped file to the device; ``save_native_pipeline``
writes a port pipeline back in that layout.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..configs import (
    AutoencoderConfig,
    DiffuserConfig,
    EmbedderConfig,
    LatentDecoderConfig,
    load_cfg,
    save_cfg,
)
from . import safetensors as sft
from .bridge import convert_leaf, state_dict_to_flat, to_tensor
from .burn_mpk import parse_mpk_file
from .npy_tree import NpyTreeSource
from .params_builder import build_autoencoder, build_clip, build_unet


# ---------------------------------------------------------------------------
# Reference formats
# ---------------------------------------------------------------------------

def load_embedder_mpk(model_dir: str):
    cfg = load_cfg(os.path.join(model_dir, "embedder.cfg"), EmbedderConfig)
    src = parse_mpk_file(os.path.join(model_dir, "embedder.mpk"))
    params = {
        "clip": build_clip(src.child("clip"), cfg.clip_config),
        "open_clip": build_clip(src.child("open_clip"), cfg.open_clip_config),
    }
    return cfg, params


def load_diffuser_mpk(model_dir: str, name: str = "diffuser"):
    """(config, UNet tree, alphas) of {name}.mpk + {name}.cfg: the base
    ("diffuser") or the refiner ("refiner")."""
    cfg = load_cfg(os.path.join(model_dir, f"{name}.cfg"), DiffuserConfig)
    src = parse_mpk_file(os.path.join(model_dir, f"{name}.mpk"))
    unet = build_unet(src.child("diffusion"), cfg.unet_config())
    alphas = np.asarray(src.tensor("alpha_cumulative_products", 1),
                        np.float32)
    return cfg, unet, alphas


def load_latent_decoder_mpk(model_dir: str):
    cfg = load_cfg(
        os.path.join(model_dir, "latent_decoder.cfg"), LatentDecoderConfig
    )
    src = parse_mpk_file(os.path.join(model_dir, "latent_decoder.mpk"))
    vae = build_autoencoder(src.child("autoencoder"), AutoencoderConfig())
    return cfg, vae


def load_embedder_npy(dump_dir: str, cfg: EmbedderConfig):
    root = NpyTreeSource(os.path.join(dump_dir, "embedder"))
    return {
        "clip": build_clip(root.child("clip"), cfg.clip_config),
        "open_clip": build_clip(root.child("open_clip"), cfg.open_clip_config),
    }


def load_diffuser_npy(dump_dir: str, cfg: DiffuserConfig,
                      is_refiner: bool = False):
    root = NpyTreeSource(os.path.join(dump_dir, "diffuser"))
    name = "diffuser_refiner" if is_refiner else "diffuser_base"
    unet = build_unet(root.child(name), cfg.unet_config())
    alphas = np.asarray(root.tensor("alphas_cumprod", 1), np.float32)
    return unet, alphas


def load_latent_decoder_npy(dump_dir: str):
    root = NpyTreeSource(os.path.join(dump_dir, "latent_decoder"))
    vae = build_autoencoder(root.child("autoencoder"), AutoencoderConfig())
    scale = root.scalar("scale_factor") or 0.13025
    return vae, scale


# ---------------------------------------------------------------------------
# Native format: flat safetensors + cfg JSON
# ---------------------------------------------------------------------------

def flatten_pytree(tree, prefix=""):
    """{dotted path: leaf} of a nested dict/list tree (None leaves
    dropped); leaves are kept as they are (tensors or arrays)."""
    flat = {}

    def rec(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{path}.{k}" if path else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{path}.{i}" if path else str(i))
        else:
            flat[path] = node

    rec(tree, prefix)
    return flat


def unflatten_pytree(flat):
    root: dict = {}
    for path, arr in flat.items():
        keys = path.split(".")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [listify(node[str(i)]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def save_native(path: str, tree, metadata: Optional[dict] = None) -> None:
    """Write a tree (or a flat {path: leaf} dict) of tensors or arrays."""
    flat = {k: _as_tensor(v) for k, v in flatten_pytree(tree).items()}
    sft.save_file(flat, path, metadata=metadata)


def load_native(path: str):
    """The reference's tree of a native file, CPU tensors mapped from it."""
    return unflatten_pytree(sft.load_file(path))


def stream_state_dict(flat: dict, dtype=None, device="cpu",
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """A flat {reference key: tensor or array} dict -> the port's
    state_dict, one leaf at a time: each leaf is popped from ``flat`` (so
    that the caller's host copy shrinks as the result grows), moved to
    ``device``, cast to ``dtype`` there (before any layout change, as the
    reference casts at load) and converted to the port's name and layout
    (bridge.convert_leaf). ``prefix`` keeps only the keys under it, with
    the prefix stripped; the other leaves are dropped."""
    out: Dict[str, torch.Tensor] = {}
    for key in list(flat):
        a = flat.pop(key)
        if not key.startswith(prefix):
            continue
        t = (a if isinstance(a, torch.Tensor) else to_tensor(a)).to(device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        stem, _, leaf = key[len(prefix):].rpartition(".")
        name, t = convert_leaf(leaf, t)
        out[f"{stem}.{name}" if stem else name] = t
    return out


def native_state_dict(path: str, dtype=None, device="cpu",
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """A native file -> the port's state_dict, streamed from the mapped
    file (``stream_state_dict``)."""
    return stream_state_dict(sft.load_file(path), dtype, device, prefix)


def save_native_pipeline(out_dir: str, pipe) -> str:
    """Write a port SDXLPipeline as a native checkpoint dir: the same
    {embedder,diffuser,latent_decoder}.safetensors + .cfg +
    alphas_cumprod.safetensors (+ autoencoder.cfg, + refiner.safetensors
    and refiner.cfg when it has a refiner) layout that load_pipeline()
    detects, in the reference's flat tree keys and layouts (unfused
    q/k/v, 3x3 upsample kernels), each tensor in its module's dtype."""
    os.makedirs(out_dir, exist_ok=True)

    def write(name, *modules):
        sd = {}
        for m in modules:
            if m is not None:
                sd.update(m.state_dict())
        save_native(os.path.join(out_dir, name), state_dict_to_flat(sd))

    write("embedder.safetensors", pipe.embedder)
    save_cfg(os.path.join(out_dir, "embedder.cfg"), pipe.embedder_cfg)
    write("diffuser.safetensors", pipe.unet)
    save_cfg(os.path.join(out_dir, "diffuser.cfg"), pipe.diffuser_cfg)
    save_native(os.path.join(out_dir, "alphas_cumprod.safetensors"),
                {"alphas_cumprod": pipe.alphas_cumprod.float()})
    write("latent_decoder.safetensors", pipe.vae, pipe.vae_encoder)
    save_cfg(os.path.join(out_dir, "latent_decoder.cfg"),
             LatentDecoderConfig(scale_factor=float(pipe.scale_factor)))
    # the reference's .cfg set has no autoencoder config (its VAE is
    # always full-size); persist it so non-default channel plans reload
    save_cfg(os.path.join(out_dir, "autoencoder.cfg"), pipe.vae_cfg)
    if pipe.refiner is not None:
        write("refiner.safetensors", pipe.refiner)
        save_cfg(os.path.join(out_dir, "refiner.cfg"), pipe.refiner_cfg)
    return out_dir
