"""Build the reference's parameter trees, with numpy f32 leaves, from a
reference checkpoint RecordSource (the port's copy of
sdxl_tpu/io/params_builder.py; io/bridge.py turns the trees into the
port's state_dicts).

The record field names follow the reference's Rust modules (identical for
.npy trees and .mpk records — the dump scripts mirror the struct fields):
  - CLIP:   clip/load.rs:79-115 (query/key/value/out, fc1/fc2, blocks/{i})
  - UNet:   unet/load.rs:17-401 (type-tagged block list, norm_in/conv_in/
            lin_embed/..., transformer blocks norm1/attn1/...)
  - VAE:    autoencoder/load.rs:17-201 (res1/res2(/res3), downsampler.conv,
            upsampler, mid.block_1/attn/block_2, quant/post_quant convs)

Layout conversions applied here, once, at load time:
  - conv weights OIHW -> HWIO (NHWC compute)
  - linear weights are already [d_in, d_out] in the dumps (save.py:23)
  - norm scales: npy "weight"/"bias" vs mpk "gamma"/"beta"
"""

from __future__ import annotations

import numpy as np

from ..configs import AutoencoderConfig, CLIPConfig, UNetConfig
from ..models.unet import unet_block_plan
from .record_source import RecordSource

_NPY_TYPE_TO_KIND = {
    "conv": "conv",
    "resnet": "res",
    "downsample": "down",
    "resnet_transformer": "res_t",
    "resnet_transformer_upsample": "res_t_up",
    "resnet_upsample": "res_up",
}


def _linear(src: RecordSource):
    p = {"w": src.tensor("weight", 2)}
    b = src.opt_tensor("bias", 1)
    if b is not None:
        p["b"] = b
    return p


def _conv(src: RecordSource):
    w = src.tensor("weight", 4)  # OIHW
    p = {"w": np.transpose(w, (2, 3, 1, 0))}  # -> HWIO
    b = src.opt_tensor("bias", 1)
    if b is not None:
        p["b"] = b
    return p


def _norm(src: RecordSource, n_channel=None):
    gamma = None
    beta = None
    try:
        gamma = src.tensor_any(["gamma", "weight"], 1)
    except KeyError:
        pass
    try:
        beta = src.tensor_any(["beta", "bias"], 1)
    except KeyError:
        pass
    # groupnorm loader tolerates missing affine (groupnorm/load.rs:21-28)
    if gamma is None:
        assert n_channel is not None, "affine-less norm needs channel count"
        gamma = np.ones((n_channel,), np.float32)
    if beta is None:
        beta = np.zeros_like(gamma)
    return {"gamma": gamma, "beta": beta}


def _enum_inner(entry):
    """mpk block entries are externally-tagged enums; npy dirs are flat."""
    inner = getattr(entry, "enum_inner", None)
    if inner is not None and getattr(entry, "enum_variant", lambda: None)() is not None:
        return entry.enum_inner()
    return entry


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------

def build_clip(src: RecordSource, cfg: CLIPConfig):
    def mha(s):
        return {
            "q": _linear(s.child("query")),
            "k": _linear(s.child("key")),
            "v": _linear(s.child("value")),
            "out": _linear(s.child("out")),
        }

    blocks = []
    for b in src.seq("blocks"):
        blocks.append(
            {
                "attn": mha(b.child("attn")),
                "attn_ln": _norm(b.child("attn_ln")),
                "mlp": {
                    "fc1": _linear(b.child("mlp").child("fc1")),
                    "fc2": _linear(b.child("mlp").child("fc2")),
                },
                "mlp_ln": _norm(b.child("mlp_ln")),
            }
        )

    # position_embedding: bare Param in mpk, {dir}/weight.npy in the dump
    pos = src.opt_tensor("position_embedding", 2)
    if pos is None:
        pos = src.child("position_embedding").tensor("weight", 2)

    params = {
        "token_embedding": src.child("token_embedding").tensor("weight", 2),
        "position_embedding": pos,
        "blocks": blocks,
        "layer_norm": _norm(src.child("layer_norm")),
    }
    tp = src.opt_tensor("text_projection", 2)
    params["text_projection"] = tp
    return params


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------

def _res_block(src: RecordSource):
    p = {
        "norm_in": _norm(src.child("norm_in")),
        "conv_in": _conv(src.child("conv_in")),
        "lin_embed": _linear(src.child("lin_embed")),
        "norm_out": _norm(src.child("norm_out")),
        "conv_out": _conv(src.child("conv_out")),
    }
    skip = src.opt_child("skip_connection")
    if skip is not None:
        try:
            p["skip"] = _conv(skip)
        except (KeyError, FileNotFoundError):
            pass
    return p


def _mha_nobias(src: RecordSource):
    return {
        "q": _linear(src.child("query")),
        "k": _linear(src.child("key")),
        "v": _linear(src.child("value")),
        "out": _linear(src.child("out")),
    }


def _transformer_block(src: RecordSource):
    return {
        "norm1": _norm(src.child("norm1")),
        "attn1": _mha_nobias(src.child("attn1")),
        "norm2": _norm(src.child("norm2")),
        "attn2": _mha_nobias(src.child("attn2")),
        "norm3": _norm(src.child("norm3")),
        "mlp": {
            "proj": _linear(src.child("mlp").child("geglu").child("proj")),
            "lin": _linear(src.child("mlp").child("lin")),
        },
    }


def _spatial_transformer(src: RecordSource):
    return {
        "norm": _norm(src.child("norm")),
        "proj_in": _linear(src.child("proj_in")),
        "blocks": [
            _transformer_block(b)
            for b in src.seq("blocks", alias="transformer")
        ],
        "proj_out": _linear(src.child("proj_out")),
    }


def _unet_block(kind: str, entry: RecordSource):
    inner = _enum_inner(entry)
    if kind == "conv" or kind == "down":
        return {"conv": _conv(inner)}
    if kind == "res":
        return {"res": _res_block(inner)}
    p = {"res": _res_block(inner.child("res"))}
    if kind in ("res_t", "res_t_up"):
        p["transformer"] = _spatial_transformer(inner.child("transformer"))
    if kind in ("res_up", "res_t_up"):
        p["upsample"] = _conv(inner.child("upsample").child("conv"))
    return p


def build_unet(src: RecordSource, cfg: UNetConfig):
    in_plan, _, out_plan = unet_block_plan(cfg)

    def blocks(name, plan):
        entries = src.seq(name)
        if len(entries) != len(plan):
            raise ValueError(
                f"{name}: checkpoint has {len(entries)} blocks, config expects "
                f"{len(plan)} — wrong config for these weights?"
            )
        out = []
        for spec, entry in zip(plan, entries):
            kind = _NPY_TYPE_TO_KIND[entry.block_type()]
            if kind != spec.kind:
                raise ValueError(
                    f"{name}: block kind mismatch {kind} != {spec.kind}"
                )
            out.append(_unet_block(kind, entry))
        return out

    mid = src.child("middle_block")
    return {
        "time_embed": {
            "lin1": _linear(src.child("lin1_time_embed")),
            "lin2": _linear(src.child("lin2_time_embed")),
        },
        "label_embed": {
            "lin1": _linear(src.child("lin1_label_embed")),
            "lin2": _linear(src.child("lin2_label_embed")),
        },
        "input_blocks": blocks("input_blocks", in_plan),
        "middle_block": {
            "res1": _res_block(mid.child("res1")),
            "transformer": _spatial_transformer(mid.child("transformer")),
            "res2": _res_block(mid.child("res2")),
        },
        "output_blocks": blocks("output_blocks", out_plan),
        "norm_out": _norm(src.child("norm_out"), cfg.model_channels),
        "conv_out": _conv(src.child("conv_out")),
    }


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

def _vae_resnet(src: RecordSource):
    p = {
        "norm1": _norm(src.child("norm1")),
        "conv1": _conv(src.child("conv1")),
        "norm2": _norm(src.child("norm2")),
        "conv2": _conv(src.child("conv2")),
    }
    nin = src.opt_child("nin_shortcut")
    if nin is not None:
        try:
            p["nin_shortcut"] = _conv(nin)
        except (KeyError, FileNotFoundError):
            pass
    return p


def _vae_mid(src: RecordSource):
    attn = src.child("attn")
    return {
        "block_1": _vae_resnet(src.child("block_1")),
        "attn": {
            "norm": _norm(attn.child("norm")),
            "q": _conv(attn.child("q")),
            "k": _conv(attn.child("k")),
            "v": _conv(attn.child("v")),
            "proj_out": _conv(attn.child("proj_out")),
        },
        "block_2": _vae_resnet(src.child("block_2")),
    }


def build_autoencoder(src: RecordSource, cfg: AutoencoderConfig):

    enc = src.child("encoder")
    enc_blocks = []
    for b in enc.seq("blocks"):
        bp = {
            "res1": _vae_resnet(b.child("res1")),
            "res2": _vae_resnet(b.child("res2")),
        }
        down = b.opt_child("downsampler")
        if down is not None:
            try:
                bp["downsampler"] = _conv(down.child("conv"))
            except (KeyError, FileNotFoundError):
                pass
        enc_blocks.append(bp)

    dec = src.child("decoder")
    dec_blocks = []
    for b in dec.seq("blocks"):
        bp = {
            "res1": _vae_resnet(b.child("res1")),
            "res2": _vae_resnet(b.child("res2")),
            "res3": _vae_resnet(b.child("res3")),
        }
        up = b.opt_child("upsampler")
        if up is not None:
            try:
                bp["upsampler"] = _conv(up)
            except (KeyError, FileNotFoundError):
                pass
        dec_blocks.append(bp)

    return {
        "encoder": {
            "conv_in": _conv(enc.child("conv_in")),
            "blocks": enc_blocks,
            "mid": _vae_mid(enc.child("mid")),
            "norm_out": _norm(enc.child("norm_out")),
            "conv_out": _conv(enc.child("conv_out")),
        },
        "decoder": {
            "conv_in": _conv(dec.child("conv_in")),
            "mid": _vae_mid(dec.child("mid")),
            "blocks": dec_blocks,
            "norm_out": _norm(dec.child("norm_out")),
            "conv_out": _conv(dec.child("conv_out")),
        },
        "quant_conv": _conv(src.child("quant_conv")),
        "post_quant_conv": _conv(src.child("post_quant_conv")),
    }
