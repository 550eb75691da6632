"""Textual-inversion embeddings merged at load time (counterpart of
sdxl_tpu/io/textual_inversion.py).

A trained concept embedding file adds a trigger word that encodes to
pseudo-token ids above the base vocab; the learned vectors are appended as
new rows of the CLIP token-embedding table(s). The only changes are a
larger embedding table (a new, larger parameter replaces the old one) and
a tokenizer pre-split on the trigger word (tokenizer/bpe.py
register_custom_token).

Supported file formats:
  - SDXL safetensors:  {"clip_l": [n,768], "clip_g": [n,1280]}
  - SD1/2 safetensors: {"emb_params": [n, d]}
  - A1111 .pt:         {"string_to_param": {"*": tensor}, ...}
  - diffusers .pt/.safetensors: single 2D-tensor entry keyed by the token

The trigger word defaults to the file's stem; `PATH:word` overrides it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..utils import log


def _as_2d(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().float().numpy()
    v = np.asarray(a, np.float32)
    if v.ndim == 1:
        v = v[None, :]
    if v.ndim != 2:
        raise ValueError(f"textual-inversion tensor must be 1D/2D, got {v.shape}")
    return v


def load_ti_file(path: str) -> Dict[str, np.ndarray]:
    """Read one embedding file -> {"clip_l": [n,d_l]?, "clip_g": [n,d_g]?}.

    Single-tensor files return {"emb": [n,d]}; the caller routes it to the
    tower whose width matches.
    """
    if path.endswith(".safetensors"):
        from .safetensors import load_file

        raw = load_file(path)
    else:  # torch .pt / .bin
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and "string_to_param" in obj:
            raw = {"emb_params": obj["string_to_param"]["*"]}
        else:
            raw = {k: v for k, v in obj.items()
                   if isinstance(v, torch.Tensor)}

    if "clip_l" in raw or "clip_g" in raw:
        out = {}
        if "clip_l" in raw:
            out["clip_l"] = _as_2d(raw["clip_l"])
        if "clip_g" in raw:
            out["clip_g"] = _as_2d(raw["clip_g"])
        return out
    if "emb_params" in raw:
        return {"emb": _as_2d(raw["emb_params"])}
    two_d = {k: v for k, v in raw.items() if v.dim() in (1, 2)}
    if len(two_d) == 1:
        return {"emb": _as_2d(next(iter(two_d.values())))}
    raise ValueError(
        f"unrecognized textual-inversion layout in {path}: keys {sorted(raw)}"
    )


def parse_ti_arg(arg: str) -> Tuple[str, Optional[str]]:
    """'PATH[:word]' -> (path, word or None): a single ':' split from the
    right, unless the suffix looks like a path or the whole names a file."""
    if ":" in arg:
        path, word = arg.rsplit(":", 1)
        if word and os.sep not in word and not os.path.exists(arg):
            return path, word
    return arg, None


def _append_rows(emb: torch.Tensor, rows: np.ndarray) -> nn.Parameter:
    new = torch.from_numpy(rows).to(device=emb.device, dtype=emb.dtype)
    return nn.Parameter(torch.cat([emb.detach(), new], dim=0),
                        requires_grad=emb.requires_grad)


def apply_textual_inversions(
    specs: List[str],
    *,
    tokenizers: List,
    embedder: nn.ModuleDict,
    tower_keys: List[str],
    tower_widths: List[int],
) -> None:
    """Merge embedding files into tokenizers + embedding tables, in order,
    in place.

    tokenizers[i], tower_keys[i] (the tower in ``embedder``), and
    tower_widths[i] describe each text tower. Registration order defines
    the pseudo-token ids, so every tower registers every trigger (missing
    tower vectors fall back to zeros — the concept simply contributes
    nothing through that tower, diffusers' behavior for single-tower files
    on SDXL).
    """
    for spec in specs:
        path, word = parse_ti_arg(spec)
        word = word or os.path.splitext(os.path.basename(path))[0]
        vecs = load_ti_file(path)

        per_tower: List[Optional[np.ndarray]] = []
        n_vec = None
        for key, width in zip(tower_keys, tower_widths):
            v = None
            if key == "clip" and "clip_l" in vecs:
                v = vecs["clip_l"]
            elif key == "open_clip" and "clip_g" in vecs:
                v = vecs["clip_g"]
            elif "emb" in vecs and vecs["emb"].shape[1] == width:
                v = vecs["emb"]
            per_tower.append(v)
            if v is not None:
                if v.shape[1] != width:
                    raise ValueError(
                        f"{path}: {key} vectors are {v.shape[1]}-wide, tower "
                        f"expects {width}"
                    )
                if n_vec is not None and v.shape[0] != n_vec:
                    raise ValueError(
                        f"{path}: towers disagree on vector count "
                        f"({n_vec} vs {v.shape[0]})"
                    )
                n_vec = v.shape[0]
        if n_vec is None:
            raise ValueError(
                f"{path}: no tensor matches any text-tower width "
                f"{tower_widths}"
            )

        for tok, key, width, v in zip(
            tokenizers, tower_keys, tower_widths, per_tower
        ):
            ids = tok.register_custom_token(word, n_vec)
            tower = embedder[key]
            n_rows = int(tower.token_embedding.shape[0])
            if ids[0] != n_rows:
                raise ValueError(
                    f"{path}: trigger '{word}' already registered "
                    f"(ids start {ids[0]}, table has {n_rows} rows)"
                )
            rows = v if v is not None else np.zeros((n_vec, width), np.float32)
            tower.token_embedding = _append_rows(tower.token_embedding, rows)
        log(
            f"textual inversion {path}: trigger '{word}' -> {n_vec} vector(s)"
        )
