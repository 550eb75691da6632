"""Reference parameter trees -> the port's state_dicts, and LoRA factors
both ways.

The reference keeps its weights as nested dicts/lists of arrays
(NHWC-era layouts). Given such a tree with numpy leaves (``np.asarray`` of
each array; ml_dtypes bfloat16 is accepted), these functions return the
``state_dict`` of the matching port module, whose parameter names mirror
the tree:

- ``w`` -> ``weight``: linear [in, out] -> [out, in]; conv HWIO -> OIHW;
- ``b`` -> ``bias``; norm ``gamma``/``beta`` -> ``weight``/``bias``;
- other leaves (embedding tables, ``text_projection``) keep name and layout;
- the self-attention projections take the layout asked for: fused
  ``qkv`` [3C, C] (inference) or separate q/k/v (training), from either
  layout of the tree;
- a folded upsample conv (``w4``, the reference's 4-phase TPU form,
  sdxl_tpu/ops/conv.py fold_upsample_conv) is unfolded back to its 3x3
  kernel in f32 numpy, the exact inverse of the fold.

LoRA factors keep the reference's flat keys (``"<module path>.lora_down"``
[d_in, r], ``"<module path>.lora_up"`` [r, d_out]) and orientation on both
sides: the reference's paths are the port's module names.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a)  # a writable copy the tensor can own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def unfold_upsample_w4(w4: np.ndarray) -> np.ndarray:
    """[2(a), 2(b), 2(r), 2(c), I, O] phase kernels -> the 3x3 HWIO kernel
    (mirrors sdxl_tpu/ops/conv.py unfold_upsample_conv)."""
    w4 = np.asarray(w4, np.float32)

    def rowtap(a, r):
        v0 = w4[a, 0, r, 0]
        v2 = w4[a, 1, r, 1]
        v1 = w4[a, 0, r, 1] - v2
        return np.stack([v0, v1, v2])

    w0, w2 = rowtap(0, 0), rowtap(1, 1)
    w1 = rowtap(0, 1) - w2
    return np.stack([w0, w1, w2])


def _leaf(name: str, a) -> tuple:
    if name == "w4":
        dtype = np.asarray(a).dtype
        name, a = "w", unfold_upsample_w4(a).astype(dtype)
    if name == "w":
        t = _to_tensor(a)
        if t.dim() == 2:
            return "weight", t.t().contiguous()
        if t.dim() == 4:
            return "weight", t.permute(3, 2, 0, 1).contiguous()
        raise ValueError(f"unexpected weight rank {t.dim()}")
    renamed = {"b": "bias", "gamma": "weight", "beta": "bias"}.get(name, name)
    return renamed, _to_tensor(a)


def tree_to_state_dict(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a reference parameter tree into port state_dict entries."""
    out: Dict[str, torch.Tensor] = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        if isinstance(value, (dict, list, tuple)):
            out.update(tree_to_state_dict(value, f"{prefix}{key}."))
        elif value is not None:
            name, t = _leaf(str(key), value)
            out[prefix + name] = t
    return out


def clip_state_dict(tree) -> Dict[str, torch.Tensor]:
    """One CLIP tower (sdxl_tpu/models/clip.py init_clip layout)."""
    return tree_to_state_dict(tree)


def unet_state_dict(tree, fused: bool = True) -> Dict[str, torch.Tensor]:
    """UNet tree, fused (fuse_unet_qkv) or not, -> the state_dict of a
    ``UNet`` (fused: self-attention q/k/v concatenated into one qkv) or of
    an ``unfuse_unet_qkv``'d one (fused=False: a fused qkv split)."""
    sd = tree_to_state_dict(tree)
    if fused:
        for key in [k for k in sd if k.endswith(".attn1.q.weight")]:
            stem = key[: -len("q.weight")]
            sd[stem + "qkv.weight"] = torch.cat(
                [sd.pop(stem + n + ".weight") for n in "qkv"], dim=0)
    else:
        for key in [k for k in sd if k.endswith(".attn1.qkv.weight")]:
            stem = key[: -len("qkv.weight")]
            w = sd.pop(key)
            for n, part in zip("qkv", w.split(w.shape[1], dim=0)):
                sd[stem + n + ".weight"] = part.contiguous()
    return sd


def vae_decoder_state_dict(tree) -> Dict[str, torch.Tensor]:
    """Autoencoder tree -> VAEDecoder state_dict (decoder + post_quant_conv)."""
    return tree_to_state_dict({"post_quant_conv": tree["post_quant_conv"],
                               "decoder": tree["decoder"]})


def vae_encoder_state_dict(tree) -> Dict[str, torch.Tensor]:
    """Autoencoder tree -> VAEEncoder state_dict (encoder + quant_conv)."""
    return tree_to_state_dict({"encoder": tree["encoder"],
                               "quant_conv": tree["quant_conv"]})


def factors_to_torch(flat, device=None) -> Dict[str, torch.Tensor]:
    """Reference LoRA factors (numpy leaves) -> f32 tensors, same keys."""
    return {k: _to_tensor(v).float().to(device) for k, v in flat.items()}


def factors_to_numpy(flat) -> Dict[str, np.ndarray]:
    """The port's LoRA factors -> f32 numpy arrays, same keys."""
    return {k: v.detach().float().cpu().numpy() for k, v in flat.items()}
