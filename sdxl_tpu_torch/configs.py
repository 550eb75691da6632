"""Model configurations (the port's copy of the SDXL part of sdxl_tpu/configs.py).

Frozen dataclasses with the reference's field names and defaults, and the
SDXL 1.0 and SD 1.x / 2.x presets, so a config describes the same model
in both packages (a CPU test holds ``dataclasses.asdict`` of each against
the reference's), and ``load_cfg`` / ``save_cfg`` for the ``.cfg`` JSON
files of a checkpoint directory. The SD3, T5 and Flux configs wait for
their slices.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class CLIPConfig:
    n_vocab: int = 49408
    n_state: int = 768
    embed_dim: int = 768
    n_head: int = 12
    n_ctx: int = 77
    n_layer: int = 12
    quick_gelu: bool = True

    @property
    def head_dim(self) -> int:
        return self.n_state // self.n_head


@dataclass(frozen=True)
class UNetConfig:
    adm_in_channels: int = 2816  # 0 = no label embedding (SD 1.x/2.x)
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mults: Tuple[int, ...] = (1, 2, 4)
    n_head_channels: int = 64
    transformer_depths: Tuple[int, ...] = (1, 2, 10)
    context_dim: int = 2048
    # levels that carry SpatialTransformers (SDXL: 1 and 2)
    transformer_levels: Tuple[int, ...] = (1, 2)
    # fixed head count; 0 = derive from n_head_channels
    n_heads: int = 0
    # FreeU (b1, b2, s1, s2) at the two deepest decoder levels; None = off
    freeu: Optional[Tuple[float, float, float, float]] = None
    # LCM-distilled UNets: the width of the guidance embedding that
    # time_embed.cond_proj projects onto the timestep sinusoid; 0 = none
    time_cond_proj_dim: int = 0

    def __post_init__(self):
        object.__setattr__(self, "channel_mults", tuple(self.channel_mults))
        object.__setattr__(self, "transformer_depths",
                           tuple(self.transformer_depths))
        object.__setattr__(self, "transformer_levels",
                           tuple(self.transformer_levels))
        if self.freeu is not None:
            object.__setattr__(self, "freeu", tuple(self.freeu))
        if self.n_heads == 0:
            assert self.model_channels % self.n_head_channels == 0, (
                "The number of head channels must evenly divide the model "
                "channels.")

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * 4


@dataclass(frozen=True)
class DiffuserConfig:
    adm_in_channels: int = 2816
    model_channels: int = 320
    channel_mults: Tuple[int, ...] = (1, 2, 4)
    num_head_channels: int = 64
    transformer_depths: Tuple[int, ...] = (1, 2, 10)
    context_dim: int = 2048
    is_refiner: bool = False
    n_steps: int = 1000  # DDPM table length
    transformer_levels: Tuple[int, ...] = (1, 2)
    n_heads: int = 0
    # "eps" or "v": what the UNet predicts
    prediction_type: str = "eps"
    in_channels: int = 4
    freeu: Optional[Tuple[float, float, float, float]] = None
    time_cond_proj_dim: int = 0

    def __post_init__(self):
        object.__setattr__(self, "channel_mults", tuple(self.channel_mults))
        object.__setattr__(self, "transformer_depths",
                           tuple(self.transformer_depths))
        object.__setattr__(self, "transformer_levels",
                           tuple(self.transformer_levels))
        if self.freeu is not None:
            object.__setattr__(self, "freeu", tuple(self.freeu))

    def unet_config(self) -> UNetConfig:
        return UNetConfig(
            adm_in_channels=self.adm_in_channels,
            in_channels=self.in_channels,
            out_channels=4,
            model_channels=self.model_channels,
            channel_mults=self.channel_mults,
            n_head_channels=self.num_head_channels,
            transformer_depths=self.transformer_depths,
            context_dim=self.context_dim,
            transformer_levels=self.transformer_levels,
            n_heads=self.n_heads,
            freeu=self.freeu,
            time_cond_proj_dim=self.time_cond_proj_dim,
        )


@dataclass(frozen=True)
class EmbedderConfig:
    clip_config: CLIPConfig = field(default_factory=CLIPConfig)
    open_clip_config: CLIPConfig = field(
        default_factory=lambda: OPEN_CLIP_BIGG_CONFIG)


@dataclass(frozen=True)
class LatentDecoderConfig:
    scale_factor: float = 0.13025


@dataclass(frozen=True)
class AutoencoderConfig:
    """VAE channel plan."""

    encoder_channels: Tuple[Tuple[int, int], ...] = (
        (128, 128),
        (128, 256),
        (256, 512),
        (512, 512),
    )
    decoder_channels: Tuple[Tuple[int, int], ...] = (
        (512, 512),
        (512, 512),
        (512, 256),
        (256, 128),
    )
    n_group: int = 32
    n_channels_out: int = 8  # encoder quant channels (4 mean + 4 logvar)
    latent_channels: int = 4


# FreeU per-family defaults (b1, b2, s1, s2) from the official repo's
# recommended settings (github.com/ChenyangSi/FreeU README)
FREEU_DEFAULTS = {
    "sdxl": (1.3, 1.4, 0.9, 0.2),
    "sd1": (1.5, 1.6, 0.9, 0.2),
    "sd2": (1.4, 1.6, 0.9, 0.2),
}


def parse_freeu_spec(spec: str, family: str) -> Tuple[float, float, float,
                                                      float]:
    """CLI --freeu value -> (b1, b2, s1, s2). "auto" (bare --freeu) picks
    the family default; otherwise a comma list of four floats."""
    if spec == "auto":
        return FREEU_DEFAULTS[family]
    parts = spec.split(",")
    if len(parts) != 4:
        raise ValueError(f"--freeu expects B1,B2,S1,S2 (got {spec!r})")
    return tuple(float(v) for v in parts)


# ---------------------------------------------------------------------------
# SDXL 1.0 presets
# ---------------------------------------------------------------------------

CLIP_VIT_L_CONFIG = CLIPConfig(
    n_vocab=49408, n_state=768, embed_dim=768, n_head=12, n_ctx=77, n_layer=12,
    quick_gelu=True,
)

OPEN_CLIP_BIGG_CONFIG = CLIPConfig(
    n_vocab=49408, n_state=1280, embed_dim=1280, n_head=20, n_ctx=77,
    n_layer=32, quick_gelu=False,
)

SDXL_BASE_DIFFUSER = DiffuserConfig(
    adm_in_channels=2816,
    model_channels=320,
    channel_mults=(1, 2, 4),
    num_head_channels=64,
    transformer_depths=(1, 2, 10),
    context_dim=2048,
    is_refiner=False,
)

SDXL_REFINER_DIFFUSER = DiffuserConfig(
    adm_in_channels=2560,
    model_channels=384,
    channel_mults=(1, 2, 4, 4),
    num_head_channels=64,
    transformer_depths=(4, 4, 4, 4),
    context_dim=1280,
    is_refiner=True,
)

SDXL_EMBEDDER = EmbedderConfig(
    clip_config=CLIP_VIT_L_CONFIG, open_clip_config=OPEN_CLIP_BIGG_CONFIG)


# ---------------------------------------------------------------------------
# SD 1.x / 2.x presets: the same UNet generator with other knobs
# ---------------------------------------------------------------------------

# SD 1.4/1.5: 4 levels, transformers at 0-2 (depth 1), FIXED 8 heads at
# every width, single CLIP ViT-L context (768), no label embedding.
SD15_DIFFUSER = DiffuserConfig(
    adm_in_channels=0,
    model_channels=320,
    channel_mults=(1, 2, 4, 4),
    num_head_channels=64,  # unused (n_heads set)
    transformer_depths=(1, 1, 1, 1),
    context_dim=768,
    transformer_levels=(0, 1, 2),
    n_heads=8,
)

# SD 2.x (512-base, eps-prediction): OpenCLIP ViT-H context (1024),
# 64-wide heads like SDXL, transformers at levels 0-2.
SD2_DIFFUSER = DiffuserConfig(
    adm_in_channels=0,
    model_channels=320,
    channel_mults=(1, 2, 4, 4),
    num_head_channels=64,
    transformer_depths=(1, 1, 1, 1),
    context_dim=1024,
    transformer_levels=(0, 1, 2),
)

# SD 2.1-768: the same architecture, v-prediction objective
SD21_768_DIFFUSER = DiffuserConfig(
    adm_in_channels=0,
    model_channels=320,
    channel_mults=(1, 2, 4, 4),
    num_head_channels=64,
    transformer_depths=(1, 1, 1, 1),
    context_dim=1024,
    transformer_levels=(0, 1, 2),
    prediction_type="v",
)

# SD 1.x's text tower is OpenAI CLIP ViT-L (SDXL's first tower); SD 2.x's
# is OpenCLIP ViT-H (1024 wide, its penultimate hidden of 24 layers).
OPEN_CLIP_VITH_CONFIG = CLIPConfig(
    n_vocab=49408, n_state=1024, embed_dim=1024, n_head=16, n_ctx=77,
    n_layer=24, quick_gelu=False,
)

SD15_VAE_SCALE = 0.18215  # SDXL's is 0.13025


# ---------------------------------------------------------------------------
# burn .cfg JSON interop
# ---------------------------------------------------------------------------

def _from_dict(cls, data):
    if dataclasses.is_dataclass(cls) and isinstance(data, dict):
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in data.items():
            if k not in names:
                continue  # tolerate extra keys (burn serializes all fields)
            if k.endswith("_config"):
                kwargs[k] = _from_dict(CLIPConfig, v)
            else:
                kwargs[k] = _deep_tuple(v) if isinstance(v, list) else v
        return cls(**kwargs)
    return data


def _deep_tuple(v):
    """Lists -> tuples recursively: nested channel plans (e.g.
    AutoencoderConfig's tuple-of-pairs) load back hashable."""
    return tuple(_deep_tuple(x) if isinstance(x, list) else x for x in v)


def load_cfg(path: str, cls):
    """Load a burn-format .cfg JSON file into a config dataclass."""
    with open(path, "r", encoding="utf-8") as f:
        return _from_dict(cls, json.load(f))


def save_cfg(path: str, cfg) -> None:
    def encode(obj):
        if dataclasses.is_dataclass(obj):
            return {f.name: encode(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)}
        if isinstance(obj, tuple):
            return list(obj)
        return obj

    with open(path, "w", encoding="utf-8") as f:
        json.dump(encode(cfg), f, indent=2)
