"""LoRA checkpoint loading and load-time weight merging (the SDXL part of
sdxl_tpu/io/lora.py).

Standard SDXL LoRA files merge into the loaded modules at load time
(W += scale * alpha/r * up @ down, in f32 on the weight's device, cast
back to the weight's dtype) — zero runtime cost, exact for inference.

Supported key formats (auto-detected per key):
  - kohya-ss / sd-scripts (the civitai-dominant format):
      lora_unet_<module>_{lora_down,lora_up}.weight + .alpha
      lora_te_/lora_te1_/lora_te2_<module>... for the text encoder(s)
    where <module> is the underscored module path in either diffusers
    naming (down_blocks_0_attentions_0_...) or sgm/ldm naming
    (input_blocks_4_1_...) — kohya's SDXL trainer emits the latter.
  - diffusers / PEFT:
      unet.<module>.lora_A.weight / lora_B.weight  (A=down, B=up)
      text_encoder. / text_encoder_2. prefixes for the towers
    and the older ".lora.down.weight/.lora.up.weight" spelling.

Module paths resolve to the reference's parameter-tree paths, which are
the port's module names; a self-attention q/k/v lands on its rows of the
fused ``qkv`` weight. SD3's MMDiT and FLUX.1's transformer take
diffusers / peft ``transformer.*`` keys, and kohya's BFL-named FLUX.1 keys
(under the unet prefix) with their fused qkv and linear1 deltas split row
by row onto the separate projections.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..utils import log


@dataclass
class LoRAEntry:
    down: torch.Tensor  # [r, in] linear | [r, in, kh, kw] conv
    up: torch.Tensor    # [out, r]      | [out, r, 1, 1]
    alpha: Optional[float]  # None -> alpha = r (kohya default)

    @property
    def rank(self) -> int:
        return self.down.shape[0]

    def delta(self, scale: float, device=None) -> torch.Tensor:
        """Merged weight delta in torch orientation ([out, in] linear or
        OIHW conv), f32, computed on ``device``."""
        a = self.rank if self.alpha is None else self.alpha
        s = scale * (a / self.rank)
        up = self.up.to(device=device, dtype=torch.float32)
        down = self.down.to(device=device, dtype=torch.float32)
        if down.dim() == 2:
            return s * (up @ down)
        # conv adapter: up [out, r, 1, 1], down [r, in, kh, kw]
        return s * torch.einsum("or,rihw->oihw", up[:, :, 0, 0], down)


# ---------------------------------------------------------------------------
# file parsing -> {canonical underscored module: LoRAEntry}
# ---------------------------------------------------------------------------

# suffix spellings: (down, up, alpha) per convention
_SUFFIXES = [
    (".lora_down.weight", ".lora_up.weight", ".alpha"),   # kohya
    (".lora_A.weight", ".lora_B.weight", ".alpha"),       # peft
    (".lora.down.weight", ".lora.up.weight", ".alpha"),   # old diffusers
]


def parse_lora_tensors(
    tensors: Dict[str, torch.Tensor],
) -> Tuple[Dict[str, LoRAEntry], List[str]]:
    """Group raw file tensors into canonical entries.

    Canonical module key = tower prefix ('unet'|'te1'|'te2') + '%' +
    the module path with every separator as '_'. Returns (entries,
    unrecognized_keys).
    """
    raw: Dict[str, dict] = {}
    bad: List[str] = []
    for key, val in tensors.items():
        matched = False
        for down_sfx, up_sfx, alpha_sfx in _SUFFIXES:
            for sfx, slot in ((down_sfx, "down"), (up_sfx, "up"),
                              (alpha_sfx, "alpha")):
                if key.endswith(sfx):
                    base = key[: -len(sfx)]
                    raw.setdefault(base, {})[slot] = val
                    matched = True
                    break
            if matched:
                break
        if not matched:
            bad.append(key)

    entries: Dict[str, LoRAEntry] = {}
    for base, slots in raw.items():
        if "down" not in slots or "up" not in slots:
            bad.append(base)
            continue
        canon = _canonical_module(base)
        if canon is None:
            bad.append(base)
            continue
        alpha = slots.get("alpha")
        entries[canon] = LoRAEntry(
            down=slots["down"],
            up=slots["up"],
            alpha=float(alpha) if alpha is not None else None,
        )
    return entries, bad


def _canonical_module(base: str) -> Optional[str]:
    """Normalize a base key to 'tower%underscored_module'."""
    b = base.replace(".", "_")
    for prefix, tower in (
        ("lora_unet_", "unet"),
        ("lora_te1_", "te1"),
        ("lora_te2_", "te2"),
        ("lora_te_", "te1"),
        ("lora_transformer_", "transformer"),
        ("transformer_", "transformer"),
        ("unet_", "unet"),
        ("text_encoder_2_", "te2"),
        ("text_encoder_", "te1"),
    ):
        if b.startswith(prefix):
            return f"{tower}%{b[len(prefix):]}"
    return None


# ---------------------------------------------------------------------------
# module path resolution into the parameter pytrees
# ---------------------------------------------------------------------------

# within a SpatialTransformer: underscored module suffix -> tree path
_T_REST = [
    (re.compile(r"^transformer_blocks_(\d+)_attn([12])_to_q$"),
     lambda m: ("blocks", int(m.group(1)), f"attn{m.group(2)}", "q")),
    (re.compile(r"^transformer_blocks_(\d+)_attn([12])_to_k$"),
     lambda m: ("blocks", int(m.group(1)), f"attn{m.group(2)}", "k")),
    (re.compile(r"^transformer_blocks_(\d+)_attn([12])_to_v$"),
     lambda m: ("blocks", int(m.group(1)), f"attn{m.group(2)}", "v")),
    (re.compile(r"^transformer_blocks_(\d+)_attn([12])_to_out_0$"),
     lambda m: ("blocks", int(m.group(1)), f"attn{m.group(2)}", "out")),
    (re.compile(r"^transformer_blocks_(\d+)_ff_net_0_proj$"),
     lambda m: ("blocks", int(m.group(1)), "mlp", "proj")),
    (re.compile(r"^transformer_blocks_(\d+)_ff_net_2$"),
     lambda m: ("blocks", int(m.group(1)), "mlp", "lin")),
    (re.compile(r"^proj_in$"), lambda m: ("proj_in",)),
    (re.compile(r"^proj_out$"), lambda m: ("proj_out",)),
]

# within a ResBlock: both diffusers and sgm/ldm member names
_R_REST = [
    (re.compile(r"^(conv1|in_layers_2)$"), lambda m: ("conv_in",)),
    (re.compile(r"^(conv2|out_layers_3)$"), lambda m: ("conv_out",)),
    (re.compile(r"^(time_emb_proj|emb_layers_1)$"), lambda m: ("lin_embed",)),
    (re.compile(r"^(conv_shortcut|skip_connection)$"), lambda m: ("skip",)),
]


def _match_rest(rest: str, table) -> Optional[tuple]:
    for rx, fn in table:
        m = rx.match(rest)
        if m:
            return fn(m)
    return None


def _resolve_unet(module: str) -> Optional[tuple]:
    """Underscored UNet module -> path tuple into the unet param tree.

    Block indices: diffusers down_blocks.L pairs attentions.j/resnets.j
    with input_blocks[1 + 3L + j] (conv_in plus, per earlier level, two
    res blocks and a downsampler — every level below L has one);
    up_blocks.i maps 3 resnets per level onto output_blocks[3i + j]
    (io/diffusers_sdxl.py:13-16 documents the same correspondence).
    """
    for rx, fn in (
        # --- diffusers naming ---
        (re.compile(r"^down_blocks_(\d+)_attentions_(\d+)_(.+)$"),
         lambda m: _t(("input_blocks", 1 + 3 * int(m.group(1)) + int(m.group(2))),
                      m.group(3))),
        (re.compile(r"^mid_block_attentions_0_(.+)$"),
         lambda m: _t(("middle_block",), m.group(1))),
        (re.compile(r"^up_blocks_(\d+)_attentions_(\d+)_(.+)$"),
         lambda m: _t(("output_blocks", 3 * int(m.group(1)) + int(m.group(2))),
                      m.group(3))),
        (re.compile(r"^down_blocks_(\d+)_resnets_(\d+)_(.+)$"),
         lambda m: _r(("input_blocks", 1 + 3 * int(m.group(1)) + int(m.group(2))),
                      m.group(3))),
        (re.compile(r"^mid_block_resnets_([01])_(.+)$"),
         lambda m: _r_mid(int(m.group(1)), m.group(2))),
        (re.compile(r"^up_blocks_(\d+)_resnets_(\d+)_(.+)$"),
         lambda m: _r(("output_blocks", 3 * int(m.group(1)) + int(m.group(2))),
                      m.group(3))),
        # --- sgm/ldm naming (kohya SDXL trainer) ---
        (re.compile(r"^input_blocks_(\d+)_1_(.+)$"),
         lambda m: _t(("input_blocks", int(m.group(1))), m.group(2))),
        (re.compile(r"^middle_block_1_(.+)$"),
         lambda m: _t(("middle_block",), m.group(1))),
        (re.compile(r"^output_blocks_(\d+)_1_(.+)$"),
         lambda m: _t(("output_blocks", int(m.group(1))), m.group(2))),
        (re.compile(r"^input_blocks_(\d+)_0_(.+)$"),
         lambda m: _r(("input_blocks", int(m.group(1))), m.group(2))),
        (re.compile(r"^middle_block_([02])_(.+)$"),
         lambda m: _r_mid(int(m.group(1)) // 2, m.group(2))),
        (re.compile(r"^output_blocks_(\d+)_0_(.+)$"),
         lambda m: _r(("output_blocks", int(m.group(1))), m.group(2))),
    ):
        m = rx.match(module)
        if m:
            return fn(m)
    return None


def _t(block_path: tuple, rest: str) -> Optional[tuple]:
    sub = _match_rest(rest, _T_REST)
    return None if sub is None else block_path + ("transformer",) + sub


def _r(block_path: tuple, rest: str) -> Optional[tuple]:
    sub = _match_rest(rest, _R_REST)
    return None if sub is None else block_path + ("res",) + sub


def _r_mid(idx: int, rest: str) -> Optional[tuple]:
    sub = _match_rest(rest, _R_REST)
    return None if sub is None else ("middle_block", f"res{idx + 1}") + sub


_TE_RX = [
    (re.compile(r"^text_model_encoder_layers_(\d+)_self_attn_(q|k|v)_proj$"),
     lambda m: ("blocks", int(m.group(1)), "attn", m.group(2))),
    (re.compile(r"^text_model_encoder_layers_(\d+)_self_attn_out_proj$"),
     lambda m: ("blocks", int(m.group(1)), "attn", "out")),
    (re.compile(r"^text_model_encoder_layers_(\d+)_mlp_fc([12])$"),
     lambda m: ("blocks", int(m.group(1)), "mlp", f"fc{m.group(2)}")),
]


def _resolve_te(module: str) -> Optional[tuple]:
    return _match_rest(module, _TE_RX)


# --- SD3 (MMDiT) / FLUX.1 transformers ------------------------------------
# diffusers/peft naming: transformer.transformer_blocks.{i}.attn.to_q etc.;
# the module names mirror diffusers', so resolution is a near-identity walk
_TR_RX = [
    (re.compile(r"^transformer_blocks_(\d+)_attn(2?)_"
                r"(to_q|to_k|to_v|add_q_proj|add_k_proj|add_v_proj"
                r"|to_add_out)$"),
     lambda m: ("blocks", int(m.group(1)), f"attn{m.group(2)}", m.group(3))),
    (re.compile(r"^transformer_blocks_(\d+)_attn(2?)_to_out_0$"),
     lambda m: ("blocks", int(m.group(1)), f"attn{m.group(2)}", "to_out")),
    (re.compile(r"^transformer_blocks_(\d+)_ff(_context)?_net_0_proj$"),
     lambda m: ("blocks", int(m.group(1)),
                f"mlp{m.group(2) or ''}", "in")),
    (re.compile(r"^transformer_blocks_(\d+)_ff(_context)?_net_2$"),
     lambda m: ("blocks", int(m.group(1)),
                f"mlp{m.group(2) or ''}", "out")),
    (re.compile(r"^transformer_blocks_(\d+)_norm1(_context)?_linear$"),
     lambda m: ("blocks", int(m.group(1)),
                f"norm1{m.group(2) or ''}", "mod")),
    (re.compile(r"^single_transformer_blocks_(\d+)_attn_(to_q|to_k|to_v)$"),
     lambda m: ("single_blocks", int(m.group(1)), "attn", m.group(2))),
    (re.compile(r"^single_transformer_blocks_(\d+)_(proj_mlp|proj_out)$"),
     lambda m: ("single_blocks", int(m.group(1)), m.group(2))),
    (re.compile(r"^single_transformer_blocks_(\d+)_norm_linear$"),
     lambda m: ("single_blocks", int(m.group(1)), "norm", "mod")),
    (re.compile(r"^proj_out$"), lambda m: ("proj_out",)),
    (re.compile(r"^x_embedder$"), lambda m: ("x_embedder",)),
    (re.compile(r"^context_embedder$"), lambda m: ("context_embedder",)),
    (re.compile(r"^norm_out_linear$"), lambda m: ("norm_out", "mod")),
]


def _resolve_transformer(module: str):
    return _match_rest(module, _TR_RX)


# kohya/sd-scripts FLUX.1 naming keeps the original BFL layout, whose
# double-block qkv and single-block linear1 (qkv + mlp) are fused linears:
# their delta rows split exactly onto the separate projections (row slices
# of up @ down are independent). The block modulations map directly.
def _resolve_bfl_flux(module: str, hidden: int):
    def split3(paths):
        return [(p, (i * hidden, (i + 1) * hidden))
                for i, p in enumerate(paths)]

    m = re.match(r"^double_blocks_(\d+)_(img|txt)_(.+)$", module)
    if m:
        i, stream, rest = int(m.group(1)), m.group(2), m.group(3)
        if rest == "attn_qkv":
            names = (("to_q", "to_k", "to_v") if stream == "img"
                     else ("add_q_proj", "add_k_proj", "add_v_proj"))
            return split3([("blocks", i, "attn", n) for n in names])
        table = {
            "attn_proj": ("attn", "to_out" if stream == "img"
                          else "to_add_out"),
            "mlp_0": ("mlp" if stream == "img" else "mlp_context", "in"),
            "mlp_2": ("mlp" if stream == "img" else "mlp_context", "out"),
            "mod_lin": ("norm1" if stream == "img" else "norm1_context",
                        "mod"),
        }
        if rest in table:
            return ("blocks", i) + table[rest]
        return None
    m = re.match(r"^single_blocks_(\d+)_(.+)$", module)
    if m:
        i, rest = int(m.group(1)), m.group(2)
        if rest == "linear1":  # fused [q | k | v | mlp] rows
            return (split3([("single_blocks", i, "attn", n)
                            for n in ("to_q", "to_k", "to_v")])
                    + [(("single_blocks", i, "proj_mlp"),
                        (3 * hidden, None))])
        if rest == "linear2":
            return ("single_blocks", i, "proj_out")
        if rest == "modulation_lin":
            return ("single_blocks", i, "norm", "mod")
    return None


def _tree_leaf(module: nn.Module, path: tuple):
    """(the Linear/Conv2d at a reference tree path, the weight rows it
    owns or None), or None when the path does not exist. A self-attention
    q/k/v resolves to its row block of the fused ``qkv``."""
    node = module
    for i, p in enumerate(path):
        if node is None:
            return None
        if isinstance(p, int):
            if not isinstance(node, nn.ModuleList) or p >= len(node):
                return None
            node = node[p]
        elif p in ("q", "k", "v") and not hasattr(node, p) and hasattr(
                node, "qkv") and i == len(path) - 1:
            c = node.qkv.weight.shape[1]
            j = "qkv".index(p)
            return node.qkv, (j * c, (j + 1) * c)
        else:
            node = getattr(node, p, None)
    if not isinstance(node, (nn.Linear, nn.Conv2d)):
        return None
    return node, None


# ---------------------------------------------------------------------------
# merging
# ---------------------------------------------------------------------------

@torch.no_grad()
def _merge_into(leaf: nn.Module, entry: LoRAEntry, scale: float, canon: str,
                rows: Optional[tuple] = None,
                delta_rows: Optional[tuple] = None) -> None:
    """Add the LoRA delta into a Linear/Conv2d weight in place (f32 math
    on the weight's device, cast back to its dtype); rows = (start, end)
    selects the weight rows it lands on (a fused qkv's q, k or v),
    delta_rows the delta's output rows it takes (a fused-projection
    format's block: BFL FLUX.1 qkv / linear1)."""
    w = leaf.weight if rows is None else leaf.weight[rows[0]:rows[1]]
    delta = entry.delta(scale, w.device)  # [out, in] or OIHW
    if delta_rows is not None:
        delta = delta[delta_rows[0]:delta_rows[1]]
    if delta.dim() == 2 and w.dim() == 4:  # 1x1-conv-stored linear
        delta = delta[:, :, None, None]
    if delta.shape != w.shape:
        raise ValueError(
            f"LoRA shape mismatch at {canon}: delta {tuple(delta.shape)} vs "
            f"weight {tuple(w.shape)} — adapter trained for a different "
            f"architecture?"
        )
    w.copy_((w.float() + delta).to(w.dtype))


def apply_lora(
    entries: Dict[str, LoRAEntry],
    unet=None,
    te1=None,
    te2=None,
    transformer=None,
    scale: float = 1.0,
) -> Dict[str, list]:
    """Merge parsed LoRA entries into the loaded modules in place.

    unet is the port's UNet, te1 / te2 the CLIP ViT-L and OpenCLIP bigG
    towers, transformer SD3's MMDiT or FLUX.1's transformer: diffusers
    'transformer.*' keys resolve into it, and kohya's BFL-named FLUX.1
    keys (under the unet prefix) fall through to it when no UNet is
    given. Returns {'applied': [...], 'skipped': [...]}.
    """
    hidden = (transformer.blocks[0].attn.to_q.weight.shape[0]
              if transformer is not None else 0)
    applied, skipped = [], []
    for canon, entry in sorted(entries.items()):
        tower, module = canon.split("%", 1)
        if tower == "transformer":
            tree, path = transformer, _resolve_transformer(module)
        elif tower == "unet" and unet is None and transformer is not None:
            tree, path = transformer, _resolve_bfl_flux(module, hidden)
        elif tower == "unet":
            tree, path = unet, _resolve_unet(module)
        elif tower == "te1":
            tree, path = te1, _resolve_te(module)
        else:
            tree, path = te2, _resolve_te(module)
        if tree is None or path is None:
            skipped.append(canon)
            continue
        # fused-projection formats resolve to [(path, delta rows), ...]
        targets = path if isinstance(path, list) else [(path, None)]
        found = [(_tree_leaf(tree, p), rows) for p, rows in targets]
        if any(leaf is None for leaf, _ in found):
            skipped.append(canon)
            continue
        for (module_, rows), delta_rows in found:
            _merge_into(module_, entry, scale, canon, rows=rows,
                        delta_rows=delta_rows)
        applied.append(canon)
    return {"applied": applied, "skipped": skipped}


def load_lora_file(path: str) -> Dict[str, LoRAEntry]:
    """Read a .safetensors LoRA file into parsed entries."""
    from .safetensors import load_file

    entries, bad = parse_lora_tensors(load_file(path))
    if not entries:
        raise ValueError(
            f"{path}: no LoRA tensors recognized "
            f"({len(bad)} unrecognized keys, e.g. {bad[:3]})"
        )
    if bad:
        log(f"lora {path}: {len(bad)} unrecognized keys ignored (e.g. {bad[:3]})")
    return entries


def parse_lora_specs(specs) -> List[Tuple[str, float]]:
    """CLI 'PATH[:SCALE]' specs -> (path, scale) pairs.

    A spec that names an existing file verbatim is NEVER split: a filename
    containing a colon followed by digits (style:2.safetensors) loads as a
    path rather than misparsing as PATH:SCALE. Shared by the sample and
    serve CLIs."""
    out = []
    for spec in specs:
        path, sep, scale = spec.rpartition(":")
        if sep and path and not os.path.exists(spec):
            try:
                out.append((path, float(scale)))
                continue
            except ValueError:
                pass
        out.append((spec, 1.0))
    return out


def apply_lora_files(
    loras: List[Tuple[str, float]],
    unet=None,
    te1=None,
    te2=None,
    transformer=None,
) -> None:
    """Load and merge a list of (path, scale) LoRA files, logging a summary."""
    for path, scale in loras:
        entries = load_lora_file(path)
        stats = apply_lora(entries, unet=unet, te1=te1, te2=te2,
                           transformer=transformer, scale=scale)
        log(
            f"lora {path} (scale {scale}): merged {len(stats['applied'])} "
            f"modules, skipped {len(stats['skipped'])}"
        )
        if stats["skipped"]:
            log(f"  skipped e.g.: {stats['skipped'][:5]}")
        if not stats["applied"]:
            raise ValueError(
                f"{path}: no LoRA modules matched the loaded model "
                f"(first skipped: {stats['skipped'][:3]})"
            )
